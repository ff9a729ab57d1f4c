"""The wire-quant A/B's twin (dotaclient_tpu_torch/scripts/ab_wire_quant.py)
against the reference (scripts/ab_wire_quant.py): the same flags, seeded
rollouts whose DTR1 and DTR3 frames are byte for byte the reference's, the
wire-bytes and H2D-layout sections equal to the reference's, the batch the
port's StagingBuffer stages from a frame list bitwise (leaf by leaf) the one
the reference's stages on both packers, the closed loop's learner config
the reference's, the verdict from the committed WIRE_QUANT_AB.json its own
and each bar at both edges, and a cut CPU run all green."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import dotaclient_tpu.parallel.train_step as jts
from dotaclient_tpu.config import LearnerConfig as JLearnerConfig
from dotaclient_tpu.runtime.staging import StagingBuffer as JStagingBuffer
from dotaclient_tpu.transport import memory as jmem
from dotaclient_tpu.transport import serialize as jser
from dotaclient_tpu.transport.base import connect as jconnect
from dotaclient_tpu_torch.ops.batch import tree_flatten
from dotaclient_tpu_torch.scripts import ab_wire_quant as W
from dotaclient_tpu_torch.transport import serialize as tser
from torch_ab_reference import Stop, load_reference, reference_args

REPO = Path(__file__).resolve().parents[1]
COMMITTED = json.loads((REPO / "WIRE_QUANT_AB.json").read_text())


@pytest.fixture(scope="module")
def ref():
    return load_reference("ab_wire_quant")


@pytest.mark.parametrize("quick", [False, True])
def test_flags_and_defaults_are_the_references(ref, monkeypatch, quick):
    argv = ["--quick"] if quick else []
    want = reference_args(monkeypatch, ref, argv, "make_rollouts")
    got = vars(W.parse_args(argv))
    assert got.pop("out") == "wire_quant_ab_torch.json" and want.pop("out").endswith("WIRE_QUANT_AB.json")
    assert got.pop("platform") == ""  # the card, unless the caller asks for the CPU
    assert got.pop("e2e_iters") == (0 if quick else 12)  # the reference runs its 12-iteration loop unless --quick
    assert got == want
    cut = vars(W.cut_args())
    assert cut.pop("e2e_iters") == W.SMOKE_CUT["e2e_iters"] > 0
    q = vars(W.parse_args(["--quick"]))
    q.pop("e2e_iters")
    assert cut == q


@pytest.mark.parametrize("n,T,H,seed", [(3, 16, 128, 0), (5, 8, 8, 3), (2, 4, 16, 11)])
def test_rollout_frames_are_byte_for_byte_the_references(ref, n, T, H, seed):
    mine, theirs = W.make_rollouts(n, T, H, seed), ref.make_rollouts(n, T, H, seed)
    for a, b in zip(mine, theirs):
        assert tser.serialize_rollout(a) == jser.serialize_rollout(b)
        assert tser.serialize_rollout(tser.cast_rollout_obs_bf16(a)) == jser.serialize_rollout(jser.cast_rollout_obs_bf16(b))


def test_wire_bytes_and_h2d_sections_are_the_references(ref):
    rollouts = W.make_rollouts(2, W.FLAGSHIP_T, W.FLAGSHIP_H, 0)
    assert W.section_wire_bytes(rollouts) == ref.section_wire_bytes(ref.make_rollouts(2, 16, 128, 0))
    assert W.section_h2d() == ref.section_h2d()


def _reference_batch(tag, frames, native):
    """The reference's staged_batch_hash, returning the batch."""
    name = f"twq_ref_{tag}"
    jmem.reset(name)
    cfg = JLearnerConfig(batch_size=len(frames), seq_len=W.FLAGSHIP_T)
    cfg.native_packer = native
    pub = jconnect(f"mem://{name}")
    for f in frames:
        pub.publish_experience(f)
    sb = JStagingBuffer(cfg, jconnect(f"mem://{name}"), version_fn=lambda: 0).start()
    try:
        return sb.get_batch(timeout=60.0)
    finally:
        sb.stop()


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_the_staged_batch_is_the_references_leaf_by_leaf(ref, wire, native):
    """The same frames through the port's and the reference's
    StagingBuffer: every leaf's bytes equal, so the parity hash is the
    reference's too."""
    rollouts = ref.make_rollouts(8, W.FLAGSHIP_T, W.FLAGSHIP_H, seed=5)
    frames = [jser.serialize_rollout(jser.cast_rollout_obs_bf16(r) if wire == "bf16" else r) for r in rollouts]
    mine = W.staged_batch(f"leaf_{wire}_{native}", list(frames), native)
    theirs = _reference_batch(f"{wire}_{native}", list(frames), native)
    import jax

    got, want = tree_flatten(mine)[0], jax.tree.leaves(theirs)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert W.leaf_bytes(a) == np.ascontiguousarray(np.asarray(b)).tobytes(), i
    assert W.batch_sha256(mine) == ref.batch_sha256(theirs)


def test_the_closed_loops_learner_is_the_references(ref, monkeypatch):
    seen = {}

    def build(cfg, mesh):
        seen["cfg"] = cfg
        raise Stop

    monkeypatch.setattr(jts, "build_fused_train_step", build)
    with pytest.raises(Stop):
        ref.section_e2e([], n_iters=1, seed=3)
    got, want = dataclasses.asdict(W.e2e_config(3, "cpu")), dataclasses.asdict(seen["cfg"])
    assert got.pop("platform") == "cpu" and want.pop("platform") == ""
    assert got == want


def test_the_committed_verdict_is_the_twins_rule():
    assert W.verdict_of(COMMITTED) == COMMITTED["verdict"]


@pytest.mark.parametrize("key,path,bar", [
    ("obs_wire_bytes_halved", ("wire_bytes", "obs_share_reduction_x"), 1.9),
    ("h2d_obs_bytes_halved", ("h2d", "obs_share_reduction_x"), 1.9),
    ("packer_speedup_ge_1p5x", ("packer_only", "speedup_x"), 1.5),
])
def test_each_bar_at_both_edges(key, path, bar):
    res = json.loads(json.dumps(COMMITTED))
    res[path[0]][path[1]] = bar
    assert W.verdict_of(res)[key] and W.verdict_of(res)["all_green"]
    res[path[0]][path[1]] = round(bar - 0.001, 3)
    assert not W.verdict_of(res)[key] and not W.verdict_of(res)["all_green"]
    res["parity"]["all_identical"] = False
    assert not W.verdict_of(res)["trainbatch_bitwise_identical"]


@pytest.fixture(scope="module")
def artifact():
    return W.run(W.cut_args(["--platform", "cpu"]))


def test_cut_run_is_all_green_with_the_references_keys(artifact):
    assert artifact["verdict"]["all_green"], artifact["verdict"]
    assert set(COMMITTED) - {"e2e"} <= set(artifact)
    for key in ("wire_bytes", "packer_only", "h2d", "parity", "verdict"):
        assert set(COMMITTED[key]) <= set(artifact[key]), key
    assert artifact["parity"]["native"]["cast_at_actor_sha256"] == artifact["parity"]["python"]["cast_at_actor_sha256"]


def test_cut_runs_the_closed_loop_on_bitwise_batches(artifact):
    """Both wires feed the learner the same staged batches: the two arms'
    losses after the same steps are equal."""
    e2e = artifact["e2e"]
    assert e2e["steps"] == W.SMOKE_CUT["e2e_iters"] + 1
    assert e2e["f32_wire"]["loss"] == e2e["bf16_wire"]["loss"] and np.isfinite(e2e["f32_wire"]["loss"])
    assert e2e["f32_wire"]["env_steps_per_sec"] > 0 and e2e["bf16_wire"]["env_steps_per_sec"] > 0


@pytest.mark.nightly
@pytest.mark.slow
def test_ab_wire_quant_quick_on_the_cpu(tmp_path):
    out = tmp_path / "wq.json"
    proc = subprocess.run([sys.executable, "-m", "dotaclient_tpu_torch.scripts.ab_wire_quant", "--quick", "--platform",
                           "cpu", "--out", str(out)], cwd=REPO, capture_output=True, text=True, timeout=570,
                          env=dict(os.environ))
    v = json.loads(out.read_text())["verdict"]
    assert proc.returncode == 0 and v["all_green"], (v, proc.stderr[-4000:])
