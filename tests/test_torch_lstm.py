"""LSTM recurrence of the PyTorch port: the plain `lstm_scan` against the
JAX reference (the Pallas kernel in interpret mode, and lax.scan), the
device dispatch, and the kernel wrapper's CPU-side contract. The CUDA
kernel itself is held against `lstm_scan` on the GPU by
tests/test_torch_cuda.py and chip_smoke.py."""

import subprocess
import sys
from pathlib import Path

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


def test_dispatch_on_cpu():
    t = tuple(torch.tensor(a) for a in make_inputs())
    auto = L.lstm_recurrence(*t)
    plain = L.lstm_recurrence(*t, impl="torch")
    assert torch.equal(auto[0], plain[0])
    with pytest.raises(ValueError, match="CUDA"):
        L.lstm_recurrence(*t, impl="kernel")
    with pytest.raises(ValueError, match="unknown lstm impl"):
        L.lstm_recurrence(*t, impl="pallas")


def test_kernel_wrapper_does_not_count_a_refused_call():
    before = L.LAUNCHES
    with pytest.raises(ValueError):
        L.lstm_kernel(*(torch.tensor(a) for a in make_inputs()))
    assert L.LAUNCHES == before


@pytest.mark.parametrize(
    "B,H,n_sm,rows",
    [(256, 128, 132, 2), (37, 128, 132, 1), (64, 128, 132, 1), (100_000, 128, 132, 8), (300, 1024, 132, 1), (5, 32, 132, 1)],
)
def test_rows_per_cta(B, H, n_sm, rows):
    assert L.rows_per_cta(B, H, n_sm) == rows
    assert rows * H <= 1024


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
