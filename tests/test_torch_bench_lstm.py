"""The LSTM micro-bench's twin (dotaclient_tpu_torch/scripts/bench_lstm.py)
against the reference (scripts/bench_lstm.py): the same flags, the same
RandomState(0) inputs bit for bit (f32 and bf16), the recurrence rows'
outputs and their forward + backward gradients against the reference's
`lstm_recurrence` (scan) within f32 tolerances, the kernel check run on
its plain arm, and a cut CPU run (tiny shapes) that writes the reference's
artifact and row keys (read from its source) with scan rows only."""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.ops import lstm as JL
from dotaclient_tpu_torch.scripts import bench_lstm as BL
from torch_ab_reference import load_reference, reference_args

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
# f32 on one host: the same products in other orders
TOL_F32 = 1e-5


@pytest.fixture(scope="module")
def ref():
    return load_reference("bench_lstm")


def test_flags_and_defaults_are_the_references(ref, monkeypatch):
    want = reference_args(monkeypatch, ref, [], "bench_config")
    got = vars(BL.parse_args([]))
    assert got.pop("out") == "lstm_bench_torch.json" and want.pop("out") == "LSTM_BENCH.json"
    assert got.pop("platform") == ""
    assert got == want
    assert BL.SHAPES == tuple((256, 16, H) for H in (128, 256, 512))


def _reference_inputs(B, T, H, dtype):
    r = np.random.RandomState(0)
    x_proj = jnp.asarray(r.randn(B, T, 4 * H), dtype)
    w_h = jnp.asarray(r.randn(H, 4 * H) / np.sqrt(H), dtype)
    return x_proj, w_h


def _bits(x):
    x = np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))
    return x.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inputs_are_the_references_bit_for_bit(dtype):
    x, w, c0, h0 = BL.inputs(4, 5, 8, getattr(torch, dtype), CPU)
    jx, jw = _reference_inputs(4, 5, 8, getattr(jnp, dtype))
    assert _bits(x) == _bits(jx) and _bits(w) == _bits(jw)
    assert not c0.any() and not h0.any() and c0.dtype == h0.dtype == torch.float32


def _jax_rows(B, T, H):
    x, w = _reference_inputs(B, T, H, jnp.float32)
    c0 = h0 = jnp.zeros((B, H), jnp.float32)

    def loss(xp, wh):
        h_seq, (cT, hT) = JL.lstm_recurrence(xp, wh, c0, h0, "scan")
        return jnp.sum(h_seq) + jnp.sum(cT) + jnp.sum(hT)

    h_seq = JL.lstm_recurrence(x, w, c0, h0, "scan")[0]
    return np.asarray(h_seq), [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(x, w)]


@pytest.mark.parametrize("impl", ["torch", "scan_recompute"])
def test_the_rows_outputs_and_gradients_are_the_references(impl):
    ins = BL.inputs(4, 5, 8, torch.float32, CPU)
    h_seq, grads = _jax_rows(4, 5, 8)
    assert np.abs(BL.fwd(ins, impl).numpy() - h_seq).max() <= TOL_F32
    for mine, theirs in zip(BL.fwdbwd(ins, impl), grads):
        assert np.abs(mine.numpy() - theirs).max() <= TOL_F32 * max(1.0, np.abs(theirs).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_kernel_check_runs_on_its_plain_arm(dtype):
    """On the CPU the check's forward is the plain scan: every difference is
    exactly 0 and every key is there (the card runs the kernel)."""
    out = BL.kernel_vs_scan(4, 5, 8, getattr(torch, dtype), CPU, forward="scan_recompute")
    assert out["shape"] == [4, 5, 8] and out["dtype"] == dtype
    assert out["fwd_max_abs"] == 0.0
    for name in ("x_proj", "w_h"):
        assert out[f"grad_{name}_max_abs"] == 0.0 and out[f"grad_{name}_rel"] == 0.0


def _reference_keys():
    """The reference's artifact keys and its CPU row keys, from its source."""
    tree = ast.parse((REPO / "scripts" / "bench_lstm.py").read_text())
    dicts = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            dicts[node.targets[0].id] = {k.value for k in node.value.keys}
    return dicts["artifact"], dicts["row"]


def test_a_cut_cpu_run_writes_the_references_keys(monkeypatch, tmp_path):
    monkeypatch.setattr(BL, "SHAPES", ((4, 5, 8), (4, 5, 16)))
    out = tmp_path / "lstm.json"
    assert BL.main(["--platform", "cpu", "--iters", "1", "--out", str(out)]) == 0
    art = json.loads(out.read_text())
    artifact_keys, row_keys = _reference_keys()
    assert set(art) == artifact_keys
    assert [set(r) for r in art["rows"]] == [row_keys, row_keys]  # scan rows only on the CPU
    assert art["backend"] == "cpu" and art["valid_for_dispatcher"] is False and "kernel rows omitted" in art["note"]
    assert [r["dtype"] for r in art["rows"]] == ["float32", "float32"] and [r["H"] for r in art["rows"]] == [8, 16]
