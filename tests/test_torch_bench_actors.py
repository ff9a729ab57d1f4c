"""The actor-fleet bench's twin (dotaclient_tpu_torch/scripts/
bench_actors.py) against the reference (scripts/bench_actors.py): the same
flags, the actors' config field by field, the derived values (speedups,
the 2x bar, the 256-actor extrapolation) computed from the same arm rows
by the reference's main and by the twin's, and a cut CPU run at the small
policy whose artifact, baseline and curve-row keys are those of the
reference's main run on the same canned rows."""

import dataclasses
import json
import types

import pytest

from dotaclient_tpu.config import ActorConfig as JActorConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu_torch.scripts import bench_actors as BA
from torch_ab_reference import load_reference, reference_args

CANNED_SINGLE = {"mode": "single_thread_single_env", "offered_steps_per_sec": 40.0, "steps": 200, "seconds": 5.0}


def _canned_fleet(n):
    return {"threads": n, "offered_steps_per_sec": 30.0 * n ** 0.5, "steps": 10, "seconds": 5.0, "dead_threads": 0}


def _canned_vector(n):
    return {"envs_per_process": n, "offered_steps_per_sec": 40.0 * n ** 0.8 if n < 16 else 300.0, "steps": 10,
            "seconds": 5.0, "batch_occupancy": 1.0, "gather_wait_ms": 0.1, "jit_step_ms": 2.0}


@pytest.fixture(scope="module")
def ref():
    return load_reference("bench_actors")


def test_flags_and_defaults_are_the_references(ref, monkeypatch):
    want = reference_args(monkeypatch, ref, [], "bench_single")
    got = vars(BA.parse_args([]))
    assert got.pop("out") == "actor_fleet_torch.json" and want.pop("out") == "ACTOR_FLEET.json"
    assert got.pop("platform") == ""
    assert got == want


@pytest.mark.parametrize("policy", ["flagship", "small"])
def test_the_actors_config_is_the_references(ref, policy):
    got = dataclasses.asdict(BA._cfg(BA._policy(policy), "cpu"))
    want = dataclasses.asdict(ref._cfg("127.0.0.1:1", ref._policy(policy)))
    assert got.pop("platform") == "cpu" and want.pop("platform") == "cpu"  # the reference's actors are CPU processes
    assert want.pop("env_addr") == "127.0.0.1:1" and got.pop("env_addr") == JActorConfig().env_addr  # in-process env
    assert got == want
    assert dataclasses.asdict(BA._policy("small")) == dataclasses.asdict(JPolicyConfig(
        unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32"))


def _reference_artifact(ref, monkeypatch, tmp_path, envs):
    """The reference's main on canned arms (no env server, no actors)."""
    monkeypatch.setattr(ref, "bench_single", lambda *a: dict(CANNED_SINGLE))
    monkeypatch.setattr(ref, "bench_thread_fleet", lambda addr, pol, n, s, w: _canned_fleet(n))
    monkeypatch.setattr(ref, "bench_vector", lambda addr, pol, n, s, w: _canned_vector(n))
    import dotaclient_tpu.env.service as jservice

    monkeypatch.setattr(jservice, "serve", lambda servicer: (types.SimpleNamespace(stop=lambda grace: None), 1))
    monkeypatch.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")
    out = tmp_path / "ref.json"
    assert ref.main(["--out", str(out), "--envs", envs]) == 0
    return json.loads(out.read_text())


def _twin_artifact(monkeypatch, tmp_path, envs):
    monkeypatch.setattr(BA, "bench_single", lambda *a: dict(CANNED_SINGLE))
    monkeypatch.setattr(BA, "bench_thread_fleet", lambda svc, pol, plat, n, s, w: _canned_fleet(n))
    monkeypatch.setattr(BA, "bench_vector", lambda svc, pol, plat, n, s, w: _canned_vector(n))
    monkeypatch.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")
    out = tmp_path / "twin.json"
    assert BA.main(["--out", str(out), "--envs", envs, "--platform", "cpu"]) == 0
    return json.loads(out.read_text())


@pytest.mark.parametrize("envs", ["1,2,4,8,16", "1,4"])
def test_the_derived_values_are_the_references(ref, monkeypatch, tmp_path, envs):
    theirs = _reference_artifact(ref, monkeypatch, tmp_path, envs)
    mine = _twin_artifact(monkeypatch, tmp_path, envs)
    for key in ("baseline_single", "curve", "meets_2x_bar_at_8_envs", "extrapolation", "policy",
                "seconds_per_config"):
        assert mine[key] == theirs[key], key
    assert set(mine) == set(theirs)
    assert set(mine["host"]) == set(theirs["host"]) - {"jax"} | {"torch", "device"}


@pytest.fixture(scope="module")
def cut_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("ba") / "af.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")
        args = ["--platform", "cpu", "--policy", "small", "--envs", "1,2", "--seconds", "0.4", "--warmup_seconds",
                "0.4", "--out", str(out)]
        assert BA.main(args) == 0
    return json.loads(out.read_text())


def test_a_cut_cpu_run_has_the_references_keys(ref, monkeypatch, tmp_path, cut_run):
    theirs = _reference_artifact(ref, monkeypatch, tmp_path, "1,2")
    assert set(cut_run) == set(theirs)
    assert set(cut_run["baseline_single"]) == set(theirs["baseline_single"])
    assert [set(r) for r in cut_run["curve"]] == [set(r) for r in theirs["curve"]]
    assert set(cut_run["extrapolation"]) == set(theirs["extrapolation"])


def test_a_cut_cpu_run_steps_every_arm(cut_run):
    assert cut_run["baseline_single"]["offered_steps_per_sec"] > 0
    for row in cut_run["curve"]:
        assert row["offered_steps_per_sec"] > 0 and row["thread_fleet_steps_per_sec"] > 0
        assert row["thread_fleet_dead_threads"] == 0 and 0 < row["batch_occupancy"] <= 1.0


def test_the_cut_is_one_and_four_envs_with_short_windows():
    args = BA.cut_args(["--platform", "cpu"])
    assert (args.envs, args.seconds, args.warmup_seconds, args.platform) == ("1,4", 0.5, 0.5, "cpu")
