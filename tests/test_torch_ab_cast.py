"""The cast A/B's twin (dotaclient_tpu_torch/scripts/ab_cast.py) against
the reference (scripts/ab_cast.py): the same flags, each arm's learner and
actor configs the reference's field by field, window_stats equal on the same
returns, the verdict of the committed CAST_AB.json's runs its own and each
bar at both edges, and a cut CPU closed loop (2 updates, one seed) whose
ablation casts nothing and whose env never lands more casts than it was
sent."""

import json
from pathlib import Path

import numpy as np
import pytest

from dotaclient_tpu_torch.scripts import ab_cast as C
from torch_ab_learning import reference_configs, same_config
from torch_ab_reference import load_reference, reference_args

REPO = Path(__file__).resolve().parents[1]
COMMITTED = json.loads((REPO / "CAST_AB.json").read_text())


@pytest.fixture(scope="module")
def ref():
    return load_reference("ab_cast")


def test_flags_and_defaults_are_the_references(ref, monkeypatch):
    want = reference_args(monkeypatch, ref, [], "run_arm")
    got = vars(C.parse_args([]))
    assert got.pop("out") == "cast_ab_torch.json" and want.pop("out") == "CAST_AB.json"
    assert got.pop("platform") == ""
    assert got == want
    cut = vars(C.cut_args())
    assert cut.pop("updates") == C.SMOKE_CUT["updates"] == 2 and cut.pop("seeds") == 1
    assert {k: v for k, v in vars(C.parse_args([])).items() if k not in ("updates", "seeds")} == cut


@pytest.mark.parametrize("disable", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_each_arms_configs_are_the_references(ref, monkeypatch, disable, seed):
    lcfg, acfgs = reference_configs(monkeypatch, ref, lambda: ref.run_arm("x", 3, seed, disable))
    same_config(C.learner_config(seed, "cpu"), lcfg)
    assert len(acfgs) == 3
    for i, theirs in enumerate(acfgs):
        same_config(C.cast_actor_config(seed, i, disable, "cpu"), theirs)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 30])
def test_window_stats_are_the_references(ref, n):
    rets = np.random.RandomState(n).randn(n) * 3
    assert C.window_stats(rets) == ref.window_stats(rets)


def test_the_committed_runs_give_the_committed_verdict():
    v = C.verdict_of(COMMITTED["runs"])
    for k, want in v.items():
        assert COMMITTED[k] == want, k


def _runs(rate=0.1, landed=5, late_on=1.0, late_off=1.0, ablation_casts=0):
    on = dict(late_mean=late_on, cast_action_rate=rate, casts_landed=landed, cast_actions=10)
    off = dict(late_mean=late_off, cast_action_rate=0.0, casts_landed=0, cast_actions=ablation_casts)
    return {"cast_enabled": [on], "cast_disabled": [off]}


def test_each_bar_at_both_edges():
    assert C.verdict_of(_runs(rate=0.0101))["cast_rate_nonzero"]
    assert not C.verdict_of(_runs(rate=0.01))["cast_rate_nonzero"]
    assert not C.verdict_of(_runs(landed=0))["cast_rate_nonzero"]
    assert C.verdict_of(_runs(late_on=1.0 - C.NOISE + 1e-9))["cast_equal_or_better_return"]
    assert not C.verdict_of(_runs(late_on=1.0 - C.NOISE - 1e-9))["cast_equal_or_better_return"]
    assert C.verdict_of(_runs())["ablation_clean_zero_casts"]
    assert not C.verdict_of(_runs(ablation_casts=1))["ablation_clean_zero_casts"]


@pytest.fixture(scope="module")
def artifact():
    return C.run(C.parse_args(["--updates", "2", "--seeds", "1", "--platform", "cpu"]))


def test_cut_run_counts_are_exact(artifact):
    rows = [r for rs in artifact["runs"].values() for r in rs]
    assert all(r["learner_steps"] == 2 and r["dead_actors"] == 0 and r["episodes"] > 0 for r in rows)
    assert artifact["ablation_clean_zero_casts"]
    assert all(r["cast_actions"] == 0 for r in artifact["runs"]["cast_disabled"])
    assert all(r["casts_landed"] <= r["cast_actions"] <= r["actions_total"] for r in rows)
    assert artifact["runs"]["cast_enabled"][0]["cast_actions"] > 0  # the enabled arm's policy samples CAST
    assert set(COMMITTED) <= set(artifact)
