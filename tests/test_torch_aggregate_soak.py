"""The many-actor aggregate soak's twin (dotaclient_tpu_torch/scripts/
aggregate_soak.py) against the reference (scripts/aggregate_soak.py): the
same flags and defaults, the same learner and genuine-actor configs field
by field, the replayers' frames byte for byte the reference's bench
generator's, the verdict recomputed from the committed AGGREGATE_SOAK.json
equal to its own, and a cut CPU run (4 replayer processes in phase A, 2
replayers and a genuine actor against a live learner in phase B) whose
artifact carries the committed artifact's keys with every count exact."""

import argparse
import dataclasses
import importlib.util
import json
import socket
from pathlib import Path

import pytest

import bench
import dotaclient_tpu.runtime.actor as jactor
import dotaclient_tpu.transport.base as jbase
from dotaclient_tpu.config import LearnerConfig as JLearnerConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu_torch.scripts import aggregate_soak as A

REPO = Path(__file__).resolve().parents[1]
REFERENCE = json.loads((REPO / "AGGREGATE_SOAK.json").read_text())


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("ref_aggregate_soak", REPO / "scripts" / "aggregate_soak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


@pytest.mark.parametrize("argv", [[], ["--policy", "flagship", "--batch-size", "64", "--replayers", "8"]])
def test_flags_defaults_and_learner_config_are_the_references(ref, monkeypatch, argv):
    box = {}
    parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        box["args"] = parse(self, args, namespace)
        return box["args"]

    def frames(cfg, n):
        box["lcfg"], box["n"] = cfg, n
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    monkeypatch.setattr(bench, "_make_frames", frames)
    monkeypatch.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")  # the fixed port may be another run's
    with pytest.raises(_Stop):
        ref.main(argv)
    want, got = vars(box["args"]), vars(A.parse_args(argv))
    assert got.pop("out") == "aggregate_soak_torch.json" and want.pop("out") == "AGGREGATE_SOAK.json"
    # the learner's device: "" is the card, "cpu" the host; the reference's
    # are "cpu" (its default) and "tpu"
    assert got.pop("platform") == "" and want.pop("platform") == "cpu"
    assert got == want
    lcfg = dataclasses.asdict(A.learner_config(A.parse_args(argv + ["--platform", "cpu"])))
    assert lcfg.pop("platform") == "cpu"
    theirs = dataclasses.asdict(box["lcfg"])
    theirs.pop("platform")
    assert lcfg == theirs and box["n"] == 64
    assert (A.PORT, A.SENTINEL_WARM_ID) == (ref.PORT, 999_999)


@pytest.mark.parametrize("policy", ["tiny", "flagship"])
def test_real_actor_config_is_the_references(ref, monkeypatch, policy):
    seen = []

    def actor(cfg, broker, actor_id=0, stub=None):
        seen.append(cfg)
        raise _Stop

    monkeypatch.setattr(jactor, "Actor", actor)
    monkeypatch.setattr(jbase, "connect", lambda url: None)
    args = A.parse_args(["--real-actor", "--actor-id", "3", "--policy", policy])
    with pytest.raises(_Stop):
        ref.run_real_actor(args)
    mine, theirs = dataclasses.asdict(A.real_actor_config(args)), dataclasses.asdict(seen[0])
    assert mine == theirs  # both on the CPU
    assert mine["platform"] == "cpu"


@pytest.mark.parametrize("policy,batch", [("tiny", 256), ("flagship", 256)])
def test_frames_are_the_reference_benchs_byte_for_byte(policy, batch):
    args = A.parse_args(["--policy", policy, "--batch-size", str(batch), "--platform", "cpu"])
    mine = A.make_frames(A.learner_config(args), 6)
    pol = dataclasses.asdict(A.policy_for(policy))
    theirs = bench._make_frames(JLearnerConfig(batch_size=batch, seq_len=16, policy=JPolicyConfig(**pol)), 6)
    assert mine == theirs


def test_verdict_of_the_committed_artifact_is_its_own():
    assert A.verdict_of(REFERENCE) == REFERENCE["verdict"] and A.verdict_ok(REFERENCE["verdict"])
    a_only = {k: v for k, v in REFERENCE.items() if k != "phase_b_closed_loop"}
    assert list(A.verdict_of(a_only)) == ["offered_50k_bar_no_learner"]
    slow = json.loads(json.dumps(REFERENCE))
    slow["phase_a_fan_in"]["meets_50k_bar"] = False
    assert not A.verdict_ok(A.verdict_of(slow))
    dead = json.loads(json.dumps(REFERENCE))
    dead["phase_b_closed_loop"]["learner_versions_published"] = 1
    assert not A.verdict_of(dead)["closed_loop_live"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


CUT = ["--platform", "cpu", "--replayers", "4", "--phase-a-duration", "1", "--real-actors", "1", "--replayers-b", "2",
       "--duration", "6", "--batch-size", "32"]


@pytest.fixture(scope="module")
def artifact():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")  # other test processes may listen on this host
        yield A.run_soak(A.parse_args(CUT), port=_free_port())


def test_artifact_has_the_references_keys(artifact):
    assert set(REFERENCE) <= set(artifact)
    for part in ("phase_0_transport_calibration", "phase_a_fan_in", "phase_b_closed_loop"):
        assert set(REFERENCE[part]) <= set(artifact[part]), part
    assert set(artifact["verdict"]) == set(REFERENCE["verdict"])
    assert artifact["frame_bytes_mean"] == REFERENCE["frame_bytes_mean"]  # the same frames, tiny policy


def test_counts_are_exact_and_the_loop_lives(artifact):
    a, b = artifact["phase_a_fan_in"], artifact["phase_b_closed_loop"]
    assert a["senders_reporting"] == a["active_actors_peak"] == 4
    assert b["replayers_reporting"] == 2 and b["active_actors_peak"] == 3
    assert a["dropped_bad"] == b["staleness"]["dropped_bad"] == 0
    assert a["offered_env_steps_per_sec"] > 0 and a["frames_consumed"] > 0
    assert artifact["verdict"]["closed_loop_live"] and A.verdict_ok({"closed_loop_live": True})
    assert artifact["learner_steps"] == b["learner_versions_published"] > 1
    assert b["genuine_actor_liveness"]["episodes_completed"] > 0
