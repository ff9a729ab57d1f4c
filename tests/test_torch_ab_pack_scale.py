"""The pack-scale A/B's twin (dotaclient_tpu_torch/scripts/ab_pack_scale.py)
against the reference (scripts/ab_pack_scale.py): the same flags, the
parity frames and bench.py's producer frames byte for byte, the transfer
buffers the port's StagingBuffer stages at every worker count (1-4) on
both packers bitwise the reference's, the closed loop's learner configs
the reference's, the memcpy probe's keys, the verdict from the committed
PACK_SCALE_AB.json its own and each bar at both edges, and a cut CPU run
all green with the ring seen overlapping."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import threading
import types
from pathlib import Path

import pytest
import torch

import dotaclient_tpu.runtime.learner as jlearner
from dotaclient_tpu.transport import serialize as jser
from dotaclient_tpu_torch.scripts import ab_pack_scale as PS
from torch_ab_reference import load_reference, reference_args

REPO = Path(__file__).resolve().parents[1]
COMMITTED = json.loads((REPO / "PACK_SCALE_AB.json").read_text())
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref():
    return load_reference("ab_pack_scale")


@pytest.mark.parametrize("quick", [False, True])
def test_flags_and_defaults_are_the_references(ref, monkeypatch, quick):
    argv = ["--quick"] if quick else []
    want = reference_args(monkeypatch, ref, argv, "preflight_check")
    got = vars(PS.parse_args(argv))
    assert got.pop("out") == "pack_scale_ab_torch.json" and want.pop("out").endswith("PACK_SCALE_AB.json")
    assert got.pop("platform") == ""
    assert got == want
    assert vars(PS.cut_args()) == vars(PS.parse_args(["--quick"]))  # the smoke runs --quick


def test_parity_frames_are_the_references(ref):
    """The reference builds its parity frames inside section_parity: the
    same construction from its generator gives the twin's bytes."""
    import numpy as np

    frames = []
    for i, r in enumerate(ref.make_rollouts(8, 8, 8, seed=3)):
        L = 3 + (i % 5)
        r = r._replace(obs=type(r.obs)(*[np.ascontiguousarray(a[: L + 1]) for a in r.obs]),
                       actions=type(r.actions)(*[np.ascontiguousarray(a[:L]) for a in r.actions]),
                       behavior_logp=r.behavior_logp[:L], behavior_value=r.behavior_value[:L], rewards=r.rewards[:L],
                       dones=r.dones[:L])
        frames.append(jser.serialize_rollout(jser.cast_rollout_obs_bf16(r) if i % 2 else r))
    assert PS.partial_frames() == frames


def test_producer_frames_are_bench_pys():
    spec = importlib.util.spec_from_file_location("ref_bench", REPO / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    cfg = PS.e2e_config(1, 0, 6)
    from dotaclient_tpu.config import LearnerConfig, PolicyConfig

    jcfg = LearnerConfig(batch_size=64, seq_len=16, policy=PolicyConfig(**PS.E2E_POLICY))
    assert PS.make_frames(cfg, 5) == bench._make_frames(jcfg, 5)


@pytest.mark.parametrize("workers", [1, 2, 3, 4])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_staged_transfer_buffers_are_the_references(ref, workers, native):
    frames = PS.partial_frames()
    mine = PS.payload_sha256(PS.staged_payload(f"t{workers}{native}", list(frames), workers, native, CPU))
    assert mine == ref._staged_hash(f"r{workers}{native}", list(frames), workers, native)


def test_the_closed_loops_learners_are_the_references(ref, monkeypatch):
    """The reference's section_e2e against recording fakes of bench.py's
    producers and of the Learner: both arms' configs, field by field."""
    seen = []

    class FakeLearner:
        def __init__(self, cfg, broker):
            seen.append(cfg)
            self.metrics = types.SimpleNamespace(latest=lambda: {})
            self.staging = types.SimpleNamespace(stats=lambda: {})

        def run(self, num_steps=None, batch_timeout=None):
            return num_steps

        def close(self):
            pass

    monkeypatch.setitem(sys.modules, "bench", types.SimpleNamespace(_start_producers=lambda *a, **k: threading.Event()))
    monkeypatch.setattr(jlearner, "Learner", FakeLearner)
    ref.section_e2e(seed=0, steps=6)
    assert [c.staging.pack_workers for c in seen] == [1, 4]
    for cfg in seen:
        got = dataclasses.asdict(PS.e2e_config(cfg.staging.pack_workers, 0, 6, "cpu"))
        want = dataclasses.asdict(cfg)
        assert got.pop("platform") == "cpu" and want.pop("platform") == ""
        assert got == want


def test_memcpy_probe_keys_are_the_references(ref):
    assert set(PS.section_host_copy_scaling(2)) == set(ref.section_host_copy_scaling(2))


def test_the_committed_verdict_is_the_twins_rule():
    want = {k: v for k, v in COMMITTED["verdict"].items() if k != "scaling_caveat"}
    got = PS.verdict_of(COMMITTED)
    assert got.pop("scaling_caveat") and {k: v for k, v in got.items()} == want


def _with(scaling, copy_4t, ring_wait=0.1, occupancy=0.0):
    res = json.loads(json.dumps(COMMITTED))
    for w in ("f32_wire", "bf16_wire"):
        res["packer_scale"][w]["scaling_1_to_4_x"] = scaling
    res["host_copy_scaling"]["copy_scaling_4t"] = copy_4t
    res["e2e"]["workers_4"]["staging_pack"]["pack_ring_wait_s"] = ring_wait
    res["e2e"]["workers_4"]["ring_occupancy_max_observed"] = occupancy
    return PS.verdict_of(res)


def test_the_2x_bar_arms_only_where_the_probe_shows_parallel_copy():
    assert _with(2.0, 1.5)["scaling_ok"] and _with(2.0, 1.5)["all_green"]
    v = _with(1.999, 1.5)
    assert not v["scaling_ok"] and not v["all_green"] and v["host_can_express_parallel_copy"]
    v = _with(1.999, 1.499)
    assert v["scaling_ok"] and v["all_green"] and v["scaling_caveat"] and not v["host_can_express_parallel_copy"]


def test_ring_overlap_needs_a_wait_or_an_occupied_slot():
    assert not _with(2.0, 1.5, ring_wait=0.0, occupancy=0.0)["ring_overlap_observed"]
    assert _with(2.0, 1.5, ring_wait=0.0, occupancy=1.0)["ring_overlap_observed"]
    assert _with(2.0, 1.5, ring_wait=1e-6, occupancy=0.0)["ring_overlap_observed"]


@pytest.fixture(scope="module")
def artifact():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")
        return PS.run(PS.cut_args(["--platform", "cpu"]))


def test_cut_run_is_all_green_with_the_references_keys(artifact):
    v = artifact["verdict"]
    assert v["all_green"], v
    assert set(v) == set(COMMITTED["verdict"])
    assert set(COMMITTED) <= set(artifact)
    assert artifact["parity"]["all_identical"] and artifact["parity"]["w1_matches_direct_head_pack"]


def test_cut_run_trains_both_arms_and_meters_the_pool(artifact):
    e2e = artifact["e2e"]
    assert e2e["workers_1"]["steps"] == e2e["workers_4"]["steps"] == 6
    pack = e2e["workers_4"]["staging_pack"]
    assert pack["pack_workers"] == 4.0 and pack["pack_ring_depth"] == 2.0
    assert "staging_pack" not in e2e["workers_1"]  # the classic path adds no pool meters


def test_cut_run_splits_the_sharded_pack(artifact):
    """Each wire's split: kept plans pay one marshal and no per-worker
    arguments; a plan per call pays its arguments on the workers; every
    part is a share of its wall."""
    for wire in ("f32_wire", "bf16_wire"):
        split = artifact["packer_scale"][wire]["split"]
        assert set(split) == {"w2", "w4", "per_call_w4"}
        for arm, parts in split.items():
            assert parts["wall_ms"] > 0 and parts["pack_ms_per_worker"] > 0
            assert parts["marshal_ms"] + parts["args_ms_per_worker"] + parts["pack_ms_per_worker"] <= parts["wall_ms"]
            kept = arm != "per_call_w4"
            assert (parts["marshal_ms"] > 0) == kept and (parts["args_ms_per_worker"] > 0) != kept


@pytest.mark.nightly
@pytest.mark.slow
def test_ab_pack_scale_quick_on_the_cpu(tmp_path):
    out = tmp_path / "ps.json"
    env = dict(os.environ, DOTACLIENT_TPU_ALLOW_STRAYS="1")
    proc = subprocess.run([sys.executable, "-m", "dotaclient_tpu_torch.scripts.ab_pack_scale", "--quick", "--platform",
                           "cpu", "--out", str(out)], cwd=REPO, capture_output=True, text=True, timeout=570, env=env)
    v = json.loads(out.read_text())["verdict"]
    assert proc.returncode == 0 and v["all_green"], (v, proc.stderr[-4000:])
