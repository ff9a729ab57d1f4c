"""The replay A/B's twin (dotaclient_tpu_torch/scripts/ab_replay.py)
against the reference (scripts/ab_replay.py): the same flags, each arm's
learner and actor configs the reference's field by field, window_stats
equal on the same returns (an empty run included), the verdict of the
committed REPLAY_AB.json's runs its own and the bar at its edges, and a cut
CPU closed loop (2 updates, one seed): the off arm replays nothing, the on
arm's hit ratio stays within its ratio."""

import json
from pathlib import Path

import numpy as np
import pytest

from dotaclient_tpu_torch.scripts import ab_replay as RP
from torch_ab_learning import reference_configs, same_config
from torch_ab_reference import load_reference, reference_args

REPO = Path(__file__).resolve().parents[1]
COMMITTED = json.loads((REPO / "REPLAY_AB.json").read_text())


@pytest.fixture(scope="module")
def ref():
    return load_reference("ab_replay")


def test_flags_and_defaults_are_the_references(ref, monkeypatch):
    want = reference_args(monkeypatch, ref, [], "run_arm")
    got = vars(RP.parse_args([]))
    assert got.pop("out") == "replay_ab_torch.json" and want.pop("out") == "REPLAY_AB.json"
    assert got.pop("platform") == ""
    assert got == want


@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_each_arms_configs_are_the_references(ref, monkeypatch, on, seed):
    lcfg, acfgs = reference_configs(monkeypatch, ref, lambda: ref.run_arm("x", 3, seed, on, 0.25))
    same_config(RP.replay_learner_config(seed, on, 0.25, "cpu"), lcfg)
    assert len(acfgs) == 3
    for i, theirs in enumerate(acfgs):
        same_config(RP.actor_config(seed, i, "cpu"), theirs)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 30])
def test_window_stats_are_the_references(ref, n):
    rets = np.random.RandomState(200 + n).randn(n) * 3
    assert RP.window_stats(rets) == ref.window_stats(rets)


def test_the_committed_runs_give_the_committed_verdict():
    v = RP.verdict_of(COMMITTED["runs"], COMMITTED["replay_ratio"], COMMITTED["updates_per_arm"])
    for k, want in v.items():
        assert COMMITTED[k] == want, k


def _verdict(off_dropped, on_dropped, hit):
    row = dict(env_steps_per_sec=1.0, learner_steps_per_sec=1.0, late_mean=0.0)
    runs = {"replay_off": [dict(row, dropped_stale=off_dropped)],
            "replay_on": [dict(row, dropped_stale=on_dropped, replay_hit_ratio=hit)]}
    return RP.verdict_of(runs, 0.25, 4)


def test_the_bar_at_its_edges():
    assert _verdict(0, 0, 0.0)["stale_drops_recovered"] and _verdict(0, 0, 0.0)["no_staleness_observed"]
    assert _verdict(5, 4, 0.01)["stale_drops_recovered"]
    assert not _verdict(5, 5, 0.2)["stale_drops_recovered"]
    assert not _verdict(5, 0, 0.0)["stale_drops_recovered"]


@pytest.fixture(scope="module")
def artifact():
    return RP.run(RP.parse_args(["--updates", "2", "--seeds", "1", "--platform", "cpu"]))


def test_cut_run_counts_are_exact(artifact):
    off, on = artifact["runs"]["replay_off"][0], artifact["runs"]["replay_on"][0]
    assert off["learner_steps"] == on["learner_steps"] == 2 and off["dead_actors"] == on["dead_actors"] == 0
    assert off["rows_replayed"] == 0 and not any(k in off for k in RP.REPLAY_KEYS)
    assert 0 <= on["replay_hit_ratio"] <= artifact["replay_ratio"]
    assert on["rows_replayed"] <= on["rows_packed"] and on["replay_sampled"] >= 0
    assert set(COMMITTED) <= set(artifact)


@pytest.mark.nightly
@pytest.mark.slow
def test_ab_replay_on_the_cpu(tmp_path):
    """The reference's nightly lane on the twin: 12 updates, one seed."""
    out = tmp_path / "replay.json"
    assert RP.main(["--updates", "12", "--seeds", "1", "--platform", "cpu", "--out", str(out)]) == 0
    assert json.loads(out.read_text())["stale_drops_recovered"]
