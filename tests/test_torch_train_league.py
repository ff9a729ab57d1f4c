"""The port's league run (dotaclient_tpu_torch/scripts/train_league.py)
against the reference's scripts/train_league.py: the same flags and
defaults, the same learner and actor configs field by field, the same
liveness bar deciding the exit code on the same run results, and a short
run on the CPU that writes the reference's LEAGUE.md fields."""

import dataclasses
import importlib.util
import re
import types
from pathlib import Path

import pytest
import torch

from dotaclient_tpu_torch.scripts import train_league as TL

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("ref_train_league", REPO / "scripts" / "train_league.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fields(md: str) -> list:
    """The summary's field labels: `- label:` lines, in order."""
    return re.findall(r"^- ([a-z ]+(?:\([^)]*\))?):", md, flags=re.M)


def test_flags_and_defaults_equal_the_reference(ref):
    ours, theirs = vars(TL.parse_args([])), vars(ref.parse_args([]))
    assert ours.pop("out_dir") == "league_run_torch" and theirs.pop("out_dir") == "league_run"
    assert ours.pop("platform") == ""  # the card, unless the caller asks for the CPU
    assert ours == theirs
    assert TL.BROKER == ref.BROKER


class _Stop(Exception):
    pass


def _reference_configs(ref, monkeypatch, seed, team_size, n_actors, out_dir, ppo_reuse):
    """The configs the reference's train_config5 builds, caught at its
    actors' and learner's constructors."""
    seen = {"actors": []}

    def actor(acfg, broker, actor_id, stub):
        seen["actors"].append(acfg)
        return types.SimpleNamespace()

    class Pool:
        def __init__(self, make_actor, n, on_episode=None):
            self.actors = [make_actor(i) for i in range(n)]

        def start(self):
            return self

    def learner(lcfg, broker):
        seen["learner"] = lcfg
        raise _Stop

    monkeypatch.setattr(ref, "SelfPlayActor", actor)
    monkeypatch.setattr(ref, "ActorPool", Pool)
    monkeypatch.setattr(ref, "Learner", learner)
    with pytest.raises(_Stop):
        ref.train_config5(seed, 5, team_size, n_actors, out_dir, ppo_reuse=ppo_reuse)
    return seen


@pytest.mark.parametrize("seed,team_size,n_actors,ppo_reuse", [(0, 1, 2, False), (3, 5, 3, True)])
def test_configs_equal_the_reference_field_by_field(ref, monkeypatch, tmp_path, seed, team_size, n_actors, ppo_reuse):
    seen = _reference_configs(ref, monkeypatch, seed, team_size, n_actors, str(tmp_path), ppo_reuse)
    policy, lcfg, acfgs = TL.config5(seed, team_size, n_actors, str(tmp_path), ppo_reuse, platform="cpu")
    want = dataclasses.asdict(seen["learner"])
    got = dataclasses.asdict(lcfg)
    assert got.pop("platform") == "cpu" and want.pop("platform") == ""
    assert got == want
    assert dataclasses.asdict(policy) == want["policy"] and policy.aux_heads
    assert len(acfgs) == len(seen["actors"]) == n_actors
    for mine, theirs in zip(acfgs, seen["actors"]):
        a, b = dataclasses.asdict(mine), dataclasses.asdict(theirs)
        assert a.pop("platform") == "cpu"  # the reference's ActorConfig defaults to "cpu" too (ROADMAP §C)
        b.pop("platform")
        assert a == b


RESULTS = {
    "ok": dict(pool_dead=0, version=4, aux_keys=["aux_loss"], league_sizes=[1, 2], episodes=9),
    "dead_actor": dict(pool_dead=1, version=4, aux_keys=["aux_loss"], league_sizes=[1, 2], episodes=9),
    "short": dict(pool_dead=0, version=3, aux_keys=["aux_loss"], league_sizes=[1, 2], episodes=9),
    "no_aux": dict(pool_dead=0, version=4, aux_keys=[], league_sizes=[1, 2], episodes=9),
    "no_pool": dict(pool_dead=0, version=4, aux_keys=["aux_loss"], league_sizes=[0, 0], episodes=9),
    "no_episode": dict(pool_dead=0, version=4, aux_keys=["aux_loss"], league_sizes=[1, 2], episodes=0),
}


@pytest.mark.parametrize("case", sorted(RESULTS))
def test_liveness_bar_is_the_references(ref, monkeypatch, tmp_path, case):
    """The reference's main on a canned run result exits as the twin's
    league_ok says, and both summaries carry the same fields."""
    res = dict(RESULTS[case], env_steps=123, policy=None, init_params=None, final_params=None, ppo="1x1 kl_stop 0.0")
    monkeypatch.setattr(ref, "train_config5", lambda *a, **k: res)
    monkeypatch.setattr(TL, "train_config5", lambda *a, **k: res)
    rc_ref = ref.main(["--updates", "4", "--out_dir", str(tmp_path / "ref")])
    rc = TL.main(["--updates", "4", "--platform", "cpu", "--out_dir", str(tmp_path / "port")])
    assert rc == rc_ref == (0 if TL.league_ok(res, 4) else 1) == (0 if case == "ok" else 1)
    md, md_ref = (tmp_path / "port" / "LEAGUE.md").read_text(), (tmp_path / "ref" / "LEAGUE.md").read_text()
    assert _fields(md) == _fields(md_ref) == _fields((REPO / "league_run" / "LEAGUE.md").read_text())


def test_short_run_on_the_cpu(tmp_path):
    out = tmp_path / "lr"
    assert TL.main(["--platform", "cpu", "--updates", "2", "--out_dir", str(out)]) == 0
    md = (out / "LEAGUE.md").read_text()
    assert "**OK**" in md and "learner updates: 2 (aux-head loss terms in metrics: ['aux_loss'])" in md
    assert "min (CPU)" in md and "--platform cpu`" in md
    assert (out / "learner_logs" / "metrics.jsonl").exists()


def test_train_config5_returns_frozen_nets_of_the_learner(tmp_path):
    res = TL.train_config5(1, 2, 1, 2, str(tmp_path), platform="cpu")
    assert res["version"] >= 2 and res["pool_dead"] == 0 and res["episodes"] > 0
    assert res["aux_keys"] == ["aux_loss"] and any(s > 0 for s in res["league_sizes"])
    init, final = res["init_params"], res["final_params"]
    assert not any(p.requires_grad for p in init.parameters()) and not final.training
    moved = [not torch.equal(a, b) for a, b in zip(init.parameters(), final.parameters())]
    assert any(moved)  # the initial copy was frozen before training moved the learner's net
    assert res["ppo"] == "1x1 kl_stop 0.0"
