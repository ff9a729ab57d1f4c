"""LSTM recurrence of the PyTorch port: the plain `lstm_scan` against the
JAX reference (the Pallas kernel in interpret mode, and lax.scan), its
recompute backward against the reference's custom VJP, the device
dispatch, and the kernel wrapper's CPU-side contract. The CUDA kernel
itself is held against `lstm_scan` on the GPU by tests/test_torch_cuda.py
and chip_smoke.py."""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.ops import lstm as JL
from dotaclient_tpu_torch.ops import _kernels
from dotaclient_tpu_torch.ops import lstm as L

REPO = Path(__file__).resolve().parents[1]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: both frameworks compute the same f32 products; only the order of
# a 32-term sum differs (a few ulp, ~1e-7). bf16: h is rounded to bf16
# before every product, identically in both, but a last-ulp difference of
# the f32 sum can move a rounding of h by one bf16 ulp (2^-8 ≈ 4e-3 at
# |h| < 1) and the later steps carry it; 1e-2 allows for that.
ATOL = {"float32": 1e-5, "bfloat16": 1e-2}


def make_inputs(B=4, T=5, H=32, seed=0):
    r = np.random.RandomState(seed)
    x_proj = r.randn(B, T, 4 * H).astype(np.float32)
    w_h = (r.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)
    c0 = (0.5 * r.randn(B, H)).astype(np.float32)
    h0 = (0.5 * r.randn(B, H)).astype(np.float32)
    return x_proj, w_h, c0, h0


def both(inputs, dtype):
    jdt, tdt = DTYPES[dtype]
    x_proj, w_h, c0, h0 = inputs
    j = (jnp.asarray(x_proj, jdt), jnp.asarray(w_h, jdt), jnp.asarray(c0), jnp.asarray(h0))
    t = (torch.tensor(x_proj).to(tdt), torch.tensor(w_h).to(tdt), torch.tensor(c0), torch.tensor(h0))
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_matches_jax_pallas_interpret(dtype):
    j, t = both(make_inputs(seed=1), dtype)
    jh, jc, jcT, jhT = JL._pallas_forward(*j, interpret=True)
    got = L.lstm_scan(*t)
    for ref, out in zip((jh, jc, jcT, jhT), got):
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["pallas_interpret", "scan"])
def test_recurrence_matches_jax(dtype, impl):
    j, t = both(make_inputs(B=3, T=4, seed=2), dtype)
    jh, (jcT, jhT) = JL.lstm_recurrence(*j, impl=impl)
    th, (tcT, thT) = L.lstm_recurrence(*t, impl="torch")
    for ref, out in ((jh, th), (jcT, tcT), (jhT, thT)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=ATOL[dtype])


def test_gates_match_jax():
    r = np.random.RandomState(3)
    z, c = r.randn(5, 4 * 8).astype(np.float32), r.randn(5, 8).astype(np.float32)
    jc, jh = JL.gates(jnp.asarray(z), jnp.asarray(c))
    tc, th = L.gates(torch.tensor(z), torch.tensor(c))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6, atol=1e-6)


def test_scan_is_stepwise_gates_and_last_step_is_final_carry():
    x_proj, w_h, c0, h0 = (torch.tensor(a) for a in make_inputs(T=3, seed=4))
    h_seq, c_seq, c_T, h_T = L.lstm_scan(x_proj, w_h, c0, h0)
    c, h = c0, h0
    for t in range(3):
        c, h = L.gates(x_proj[:, t] + h @ w_h, c)
        torch.testing.assert_close(h_seq[:, t], h, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(c_seq[:, t], c, rtol=1e-6, atol=1e-6)
    assert torch.equal(h_seq[:, -1], h_T) and torch.equal(c_seq[:, -1], c_T)


def _cotangents(B, T, H, which, seed):
    r = np.random.RandomState(seed)
    dh_seq, dc_T, dh_T = r.randn(B, T, H), r.randn(B, H), r.randn(B, H)
    if which == "h_seq":  # a loss of h_seq alone: c_T and h_T get zero cotangents
        dc_T, dh_T = 0 * dc_T, 0 * dh_T
    return tuple(a.astype(np.float32) for a in (dh_seq, dc_T, dh_T))


def _jax_vjp(inputs, cot, dtype):
    j, _ = both(inputs, dtype)
    _, vjp = jax.vjp(lambda *a: JL.lstm_recurrence(*a, impl="pallas_interpret"), *j)
    dh_seq, dc_T, dh_T = (jnp.asarray(c) for c in cot)
    return vjp((dh_seq, (dc_T, dh_T)))


def _torch_grads(inputs, cot, dtype, impl):
    _, t = both(inputs, dtype)
    t = [x.requires_grad_() for x in t]
    h_seq, (c_T, h_T) = L.lstm_recurrence(*t, impl=impl)
    torch.autograd.backward([h_seq, c_T, h_T], [torch.tensor(c) for c in cot])
    return [x.grad for x in t]


# Backward vs the reference VJP. f32: the same arithmetic up to the order
# of f32 sums (z and dW_h are one batched product here, per-step products
# there). bf16: dx_proj and dW_h are rounded to bf16 at the end, so a
# last-ulp difference of the f32 value may move them by one bf16 ulp
# (2^-7 relative at most); dc0/dh0 stay f32.
BWD_RTOL = {"float32": 1e-5, "bfloat16": 2**-7}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["all", "h_seq"])
def test_recompute_backward_matches_jax_vjp(dtype, which):
    inputs = make_inputs(B=6, T=5, seed=7)
    cot = _cotangents(6, 5, 32, which, seed=8)
    want = _jax_vjp(inputs, cot, dtype)
    # the plain function on the residuals the forward saves ...
    _, t = both(inputs, dtype)
    h_seq, c_seq, _, _ = L.lstm_scan(*t)
    direct = L.recompute_backward((*t, h_seq, c_seq), (torch.tensor(cot[0]), (torch.tensor(cot[1]), torch.tensor(cot[2]))))
    # ... and the autograd.Function with the plain forward
    through = _torch_grads(inputs, cot, dtype, "scan_recompute")
    for k, (ref, a, b) in enumerate(zip(want, direct, through)):
        assert a.dtype == b.dtype == (t[k].dtype)
        assert torch.equal(a, b)
        rtol = BWD_RTOL[dtype] if k < 2 else 1e-5
        np.testing.assert_allclose(a.float().numpy(), np.asarray(ref, np.float32), rtol=rtol, atol=1e-5)


def test_recompute_backward_matches_autograd_in_f32():
    """In f32 the recompute backward and autograd through lstm_scan
    differentiate the same function: only the order of f32 sums differs.
    (In bf16 they differ by design; see recompute_backward.)"""
    inputs = make_inputs(B=5, T=6, seed=9)
    cot = _cotangents(5, 6, 32, "all", seed=10)
    for a, b in zip(_torch_grads(inputs, cot, "float32", "scan_recompute"), _torch_grads(inputs, cot, "float32", "torch")):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_dispatch_on_cpu():
    t = tuple(torch.tensor(a) for a in make_inputs())
    auto = L.lstm_recurrence(*t)
    plain = L.lstm_recurrence(*t, impl="torch")
    recompute = L.lstm_recurrence(*t, impl="scan_recompute")
    assert torch.equal(auto[0], plain[0]) and torch.equal(recompute[0], plain[0])
    with pytest.raises(ValueError, match="CUDA"):
        L.lstm_recurrence(*t, impl="kernel")
    with pytest.raises(ValueError, match="unknown lstm impl"):
        L.lstm_recurrence(*t, impl="pallas")


def test_kernel_wrapper_does_not_count_a_refused_call():
    before = L.LAUNCHES
    with pytest.raises(ValueError):
        L.lstm_kernel(*(torch.tensor(a) for a in make_inputs()))
    assert L.LAUNCHES == before


H100_SMS, H100_SMEM_OPTIN = 132, 232_448
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize(
    "B,H,dtype,optin,want",
    [
        # the learner's shapes: 16 clusters of 8 CTAs, 16 units each
        (256, 128, BF16, H100_SMEM_OPTIN, ("cluster_mma", 8, 16, 128, 256, 44_560)),
        (256, 128, F32, H100_SMEM_OPTIN, ("cluster_ffma", 8, 16, 128, 256, 67_600)),
        (37, 128, BF16, H100_SMEM_OPTIN, ("cluster_mma", 8, 16, 24, 256, 44_560)),
        (1, 128, F32, H100_SMEM_OPTIN, ("cluster_ffma", 8, 16, 8, 256, 67_600)),
        (100_000, 128, BF16, H100_SMEM_OPTIN, ("cluster_mma", 8, 16, 50_000, 256, 44_560)),
        # narrow and wide H: cluster of 2, of 8 with 32 units, of 3 (48 = 3 x 16)
        (256, 32, BF16, H100_SMEM_OPTIN, ("cluster_mma", 2, 16, 32, 256, 24_592)),
        (9, 256, F32, H100_SMEM_OPTIN, ("cluster_ffma", 8, 16, 8, 512, 200_720)),
        (9, 256, BF16, H100_SMEM_OPTIN, ("cluster_mma", 8, 16, 8, 512, 120_336)),
        (21, 48, F32, H100_SMEM_OPTIN, ("cluster_ffma", 3, 16, 6, 256, 33_040)),
        # the per-thread design: H not a multiple of 16, or a slice too large
        (4, 40, BF16, H100_SMEM_OPTIN, ("per_thread", 1, 1, 4, 40, 12_960)),
        (256, 512, BF16, H100_SMEM_OPTIN, ("per_thread", 1, 2, 128, 1024, 4_096)),
        (300, 1024, F32, H100_SMEM_OPTIN, ("per_thread", 1, 1, 300, 1024, 8_192)),
        (300, 1024, BF16, H100_SMEM_OPTIN, ("per_thread", 1, 1, 300, 1024, 4_096)),
        (256, 128, F32, 48 * 1024, ("per_thread", 1, 2, 128, 256, 2_048)),
    ],
)
def test_launch_geometry(B, H, dtype, optin, want):
    geo = L.launch_geometry(B, H, dtype, H100_SMS, optin)
    assert tuple(geo) == want
    assert geo.grid % geo.cluster == 0
    assert (geo.grid // geo.cluster) * geo.rows >= B > (geo.grid // geo.cluster - 1) * geo.rows  # covers B, no spare slab
    assert geo.smem_bytes <= optin and geo.threads <= 1024
    if geo.design == "per_thread":
        assert geo.threads == geo.rows * H
    else:
        assert geo.rows == L.CLUSTER_ROWS and geo.cluster <= 8 and H % (16 * geo.cluster) == 0
    # the design (and so every row's arithmetic) does not depend on B
    for other in (1, 3, 37, 4096):
        alt = L.launch_geometry(other, H, dtype, H100_SMS, optin)
        assert (alt.design, alt.cluster, alt.threads) == (geo.design, geo.cluster, geo.threads) or geo.design == "per_thread"


@pytest.mark.parametrize("B,H", [(0, 128), (4, 0), (4, 1025)])
def test_launch_geometry_refuses_shapes_the_kernel_cannot_take(B, H):
    with pytest.raises(ValueError, match="lstm kernel takes"):
        L.launch_geometry(B, H, BF16, H100_SMS, H100_SMEM_OPTIN)


@pytest.mark.parametrize(
    "c_name,py_name",
    [("ROWS", "CLUSTER_ROWS"), ("MAX_CLUSTER", "MAX_CLUSTER"), ("CLUSTER_THREADS", "CLUSTER_THREADS"),
     ("F32_HS", "F32_HS"), ("BAR_BYTES", "BAR_BYTES"), ("KSPLIT", "KSPLIT"), ("X_AHEAD", "X_AHEAD")],
)
def test_geometry_constants_match_the_kernel_source(c_name, py_name):
    """launch_geometry sizes shared memory from the Python twins of the
    .cu file's layout constants; the C side refuses any other size."""
    text = (_kernels.CSRC / "lstm_recurrence.cu").read_text()
    found = re.findall(rf"constexpr int {c_name} = (\d+);", text)
    assert found == [str(getattr(L, py_name))]


def test_kernel_build_is_for_sm90a_and_keyed_by_source():
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS
    for name, (src, fns) in _kernels.KERNELS.items():
        assert (_kernels.CSRC / src).is_file()
        path = _kernels.lib_path(name)
        assert path.parent == _kernels.BUILD_DIR and path.name.startswith(f"lib{name}_")
    text = (_kernels.CSRC / "lstm_recurrence.cu").read_text()
    # the recurrent product is written by hand: no library GEMM/RNN calls
    for banned in ("cublas", "cudnn", "torch/", "ATen"):
        assert banned not in text
    assert "dotaclient_tpu/ops/lstm.py" in text  # names the TPU kernel it replaces


def test_build_dir_is_git_ignored():
    assert "build/torch_kernels/" in (REPO / ".gitignore").read_text().splitlines()


def test_chip_smoke_fails_without_the_package(tmp_path):
    """Alone in a directory (or on a machine without a GPU) the smoke
    script must exit non-zero and print no result line."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
