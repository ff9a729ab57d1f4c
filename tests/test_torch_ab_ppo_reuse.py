"""The PPO-reuse A/B's twin (dotaclient_tpu_torch/scripts/ab_ppo_reuse.py)
against the reference (scripts/ab_ppo_reuse.py): the same flags, each
arm's learner and actor configs the reference's field by field,
window_stats equal on the same returns, the verdict of the committed
PPO_REUSE_AB.json's runs its own and the bar at both edges, and a cut CPU
closed loop (2 updates, one seed) whose arms both take every update."""

import json
from pathlib import Path

import numpy as np
import pytest

from dotaclient_tpu_torch.scripts import ab_ppo_reuse as PR
from torch_ab_learning import reference_configs, same_config
from torch_ab_reference import load_reference, reference_args

REPO = Path(__file__).resolve().parents[1]
COMMITTED = json.loads((REPO / "PPO_REUSE_AB.json").read_text())


@pytest.fixture(scope="module")
def ref():
    return load_reference("ab_ppo_reuse")


def test_flags_and_defaults_are_the_references(ref, monkeypatch):
    want = reference_args(monkeypatch, ref, [], "run_arm")
    got = vars(PR.parse_args([]))
    assert got.pop("out") == "ppo_reuse_ab_torch.json" and want.pop("out") == "PPO_REUSE_AB.json"
    assert got.pop("platform") == ""
    assert got == want
    assert PR.arms_of(PR.parse_args([])) == COMMITTED["knobs"]


@pytest.mark.parametrize("arm", ["single_update", "reuse"])
@pytest.mark.parametrize("seed", [0, 1])
def test_each_arms_configs_are_the_references(ref, monkeypatch, arm, seed):
    knobs = PR.arms_of(PR.parse_args([]))[arm]
    lcfg, acfgs = reference_configs(monkeypatch, ref, lambda: ref.run_arm("x", 3, seed, **knobs))
    same_config(PR.learner_config(seed, "cpu", **knobs), lcfg)
    assert len(acfgs) == PR.N_ACTORS == 3
    for i, theirs in enumerate(acfgs):
        same_config(PR.actor_config(seed, i, "cpu"), theirs)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 30])
def test_window_stats_are_the_references(ref, n):
    rets = np.random.RandomState(100 + n).randn(n) * 3
    assert PR.window_stats(rets) == ref.window_stats(rets)


def test_the_committed_runs_give_the_committed_verdict():
    for k, want in PR.verdict_of(COMMITTED["runs"]).items():
        assert COMMITTED[k] == want, k


def test_the_bar_at_both_edges():
    def runs(late_reuse):
        return {"single_update": [dict(late_mean=1.0, improvement=0.0)],
                "reuse": [dict(late_mean=late_reuse, improvement=0.0)]}

    assert PR.verdict_of(runs(1.0 - PR.NOISE + 1e-9))["equal_or_better_per_env_step"]
    assert not PR.verdict_of(runs(1.0 - PR.NOISE - 1e-9))["equal_or_better_per_env_step"]


@pytest.fixture(scope="module")
def artifact():
    return PR.run(PR.parse_args(["--updates", "2", "--seeds", "1", "--platform", "cpu"]))


def test_cut_run_takes_every_update_in_both_arms(artifact):
    rows = {n: rs[0] for n, rs in artifact["runs"].items()}
    assert all(r["learner_steps"] == 2 and r["dead_actors"] == 0 and r["episodes"] > 0 for r in rows.values())
    assert rows["single_update"]["ppo_epochs"] == 1 and rows["reuse"]["ppo_epochs"] == 2
    assert set(COMMITTED) <= set(artifact) and artifact["env_steps_per_arm"] == 2 * 16 * 16
