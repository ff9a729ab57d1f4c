"""GPU-only checks of the port's CUDA kernels against their plain PyTorch
versions. Every test here needs an NVIDIA GPU and the CUDA toolkit and
skips without one. This file imports neither JAX nor the JAX package, so
on a GPU machine without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from dotaclient_tpu_torch.ops import lstm as L

pytestmark = pytest.mark.cuda

# Same tolerances and reasons as chip_smoke.py: f32 sums in another
# order over 17 dependent steps; in bf16 one ulp flip of a rounded h.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def inputs(B, T, H, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    x_proj = torch.randn(B, T, 4 * H, generator=g).to(device, dtype)
    w_h = (torch.randn(H, 4 * H, generator=g) / H**0.5).to(device, dtype)
    c0 = (0.5 * torch.randn(B, H, generator=g)).to(device)
    h0 = (0.5 * torch.randn(B, H, generator=g)).to(device)
    return x_proj, w_h, c0, h0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,H", [(256, 17, 128), (37, 17, 128), (5, 3, 32), (3, 1, 64), (9, 4, 256)])
def test_kernel_matches_scan(cuda, dtype, B, T, H):
    ins = inputs(B, T, H, dtype, cuda)
    before = L.LAUNCHES
    with torch.no_grad():
        got = L.lstm_kernel(*ins)
        ref = L.lstm_scan(*ins)
    torch.cuda.synchronize()
    assert L.LAUNCHES == before + 1
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert (a - b).abs().max().item() <= TOL[dtype]


def test_auto_dispatch_launches_kernel(cuda):
    ins = inputs(8, 5, 128, torch.bfloat16, cuda)
    before = L.LAUNCHES
    with torch.no_grad():
        L.lstm_recurrence(*ins)
    assert L.LAUNCHES == before + 1


def test_kernel_refuses_grad(cuda):
    x_proj, w_h, c0, h0 = inputs(4, 3, 32, torch.float32, cuda)
    w_h.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        L.lstm_kernel(x_proj, w_h, c0, h0)


def test_kernel_rejects_bad_inputs(cuda):
    x_proj, w_h, c0, h0 = inputs(4, 3, 32, torch.bfloat16, cuda)
    with torch.no_grad():
        with pytest.raises(ValueError, match="w_h"):
            L.lstm_kernel(x_proj, w_h.float(), c0, h0)
        with pytest.raises(ValueError, match="contiguous"):
            L.lstm_kernel(x_proj.transpose(0, 1).contiguous().transpose(0, 1), w_h, c0, h0)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            L.lstm_kernel(x_proj.half(), w_h.half(), c0, h0)
