"""The bf16 experience-wire soak's twin (dotaclient_tpu_torch/scripts/
soak_wire_bf16.py) against the reference (scripts/soak_wire_bf16.py): the
same flags, defaults and --quick values, the same learner and actor
configs field by field, the per-phase checks and the bytes-per-frame band
recomputed from the committed WIRE_SOAK.json equal to its own, and a cut
CPU run (tiny f32 policy, 3 s phases) whose artifact carries the
committed artifact's keys with `ok` true."""

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

import dotaclient_tpu.runtime.actor as jactor
import dotaclient_tpu.runtime.harness as jharness
import dotaclient_tpu.runtime.learner as jlearner
import dotaclient_tpu.transport.tcp as jtcp
from dotaclient_tpu_torch.scripts import soak_wire_bf16 as W

REPO = Path(__file__).resolve().parents[1]
REFERENCE = json.loads((REPO / "WIRE_SOAK.json").read_text())


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("ref_soak_wire_bf16", REPO / "scripts" / "soak_wire_bf16.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


def _reference_args(ref, monkeypatch, argv):
    box = {}
    parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        box["args"] = parse(self, args, namespace)
        return box["args"]

    def stop():
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    monkeypatch.setattr(ref, "_tiny_policy", stop)
    with pytest.raises(_Stop):
        ref.main(argv)
    return box["args"]


@pytest.mark.parametrize("quick", [False, True])
def test_flags_defaults_and_quick_are_the_references(ref, monkeypatch, quick):
    argv = ["--quick"] if quick else []
    want = vars(_reference_args(ref, monkeypatch, argv))
    got = vars(W.parse_args(argv))
    assert got.pop("out") == "wire_soak_torch.json" and want.pop("out") == "WIRE_SOAK.json"
    assert got.pop("platform") == ""  # the card, unless the caller asks for the CPU
    assert got == want
    cut, q = vars(W.cut_args()), vars(W.parse_args(["--quick"]))
    assert cut.pop("phase_s") > q.pop("phase_s") and cut == q  # the smoke's cut only lengthens the phases


def test_learner_config_is_the_references(ref, monkeypatch):
    seen = {}

    def learner(cfg, broker):
        seen["cfg"] = cfg
        raise _Stop

    monkeypatch.setattr(jlearner, "Learner", learner)
    monkeypatch.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")
    with pytest.raises(_Stop):
        ref.main(["--out", os.devnull])
    got = dataclasses.asdict(W.learner_config(W.parse_args(["--platform", "cpu"]), W.tiny_policy()))
    want = dataclasses.asdict(seen["cfg"])
    assert got.pop("platform") == "cpu" and want.pop("platform") == ""
    assert got == want


@pytest.mark.parametrize("dtypes", [["f32"], ["f32", "bf16"], ["bf16"]])
def test_actor_configs_are_the_references(ref, monkeypatch, dtypes):
    seen = []

    class Pool:
        def __init__(self, make_actor, n):
            self.actors = [make_actor(i) for i in range(n)]

        def start(self):
            return self

        def stop(self, timeout=30.0, raise_on_dead=False):
            pass

        def publish_stats(self):
            return {"published": 0, "shed": 0, "failed": 0, "dead_actors": 0}

    def actor(cfg, broker, actor_id=0, stub=None):
        seen.append(cfg)
        return types.SimpleNamespace()

    monkeypatch.setattr(jharness, "ActorPool", Pool)
    monkeypatch.setattr(jactor, "Actor", actor)
    monkeypatch.setattr(jtcp, "TcpBroker", lambda **k: None)
    args = ref.argparse.Namespace(seq_len=8)
    ref._run_actor_phase(args, 1, 0.0, 3, 200, dtypes)
    mine = W.parse_args(["--platform", "cpu"])
    for i, theirs in enumerate(seen):
        a, b = dataclasses.asdict(W.actor_config(mine, W.tiny_policy(), i, 200, dtypes)), dataclasses.asdict(theirs)
        assert a.pop("platform") == "cpu"  # the reference's ActorConfig defaults to "cpu" (ROADMAP §C)
        b.pop("platform")
        assert a == b
    assert [c.wire.obs_dtype for c in seen] == [dtypes[i % len(dtypes)] for i in range(3)]


def test_checks_and_band_of_the_committed_artifact_are_its_own():
    for name, dtypes in W.PHASES:
        ph = REFERENCE[name]
        assert ph["wire_dtypes"] == dtypes
        d = {"consumed": ph["consumed_delta"], "quarantined": ph["quarantined_delta"],
             "dropped_bad": ph["dropped_bad_delta"], "wire_frames_obs_f32": ph["frames_f32"],
             "wire_frames_obs_bf16": ph["frames_bf16"]}
        assert W.phase_checks(dtypes, d, ph["versions_advanced"], ph["loss"]) == ph["checks"], name
        # a poisoned frame, a silent learner or a meter that lies each fail
        assert not W.phase_checks(dtypes, dict(d, dropped_bad=1), 1, 0.0)["no_quarantine"]
        assert not W.phase_checks(dtypes, d, 0, 0.0)["trained"]
        assert not W.phase_checks(dtypes, d, 1, None)["loss_finite"]
    ratio, ok = W.bytes_ratio(REFERENCE["phase_1_all_f32"]["bytes_per_frame"],
                              REFERENCE["phase_3_all_bf16"]["bytes_per_frame"])
    assert (ratio, ok) == (REFERENCE["wire_bytes_per_frame_ratio_bf16_vs_f32"], REFERENCE["verdict"]["ok"])
    assert W.bytes_ratio(1000.0, 900.0) == (0.9, False) and W.bytes_ratio(None, 1.0) == (None, False)


@pytest.fixture(scope="module")
def artifact():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")  # other test processes may listen on this host
        args = W.parse_args(["--quick", "--platform", "cpu"])
        args.phase_s = 3.0
        yield W.run_soak(args)


def test_artifact_has_the_references_keys(artifact):
    assert set(REFERENCE) <= set(artifact)
    for name, _ in W.PHASES:
        assert set(REFERENCE[name]) <= set(artifact[name]), name
        assert set(REFERENCE[name]["checks"]) == set(artifact[name]["checks"]), name
    assert set(artifact["verdict"]) == set(REFERENCE["verdict"])


def test_every_phase_is_clean_and_the_wire_halves(artifact):
    assert artifact["verdict"] == {"ok": True, "problems": []}, [artifact[n]["checks"] for n, _ in W.PHASES]
    for name, dtypes in W.PHASES:
        ph = artifact[name]
        assert ph["quarantined_delta"] == ph["dropped_bad_delta"] == 0
        assert ph["publish"]["attempted"] == ph["publish"]["published"] + ph["publish"]["shed"] + ph["publish"]["failed"]
    assert 0.4 <= artifact["wire_bytes_per_frame_ratio_bf16_vs_f32"] <= 0.8
    assert artifact["learner_steps"] >= 4


@pytest.mark.nightly
@pytest.mark.slow
def test_wire_soak_quick_on_the_cpu(tmp_path):
    out = tmp_path / "wire.json"
    env = dict(os.environ, DOTACLIENT_TPU_ALLOW_STRAYS="1")
    proc = subprocess.run([sys.executable, "-m", "dotaclient_tpu_torch.scripts.soak_wire_bf16", "--quick", "--platform",
                           "cpu", "--out", str(out)], cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    v = json.loads(out.read_text())["verdict"]
    assert proc.returncode == 0 and v["ok"], (v, proc.stderr[-4000:])
