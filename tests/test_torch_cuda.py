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
@pytest.mark.parametrize(
    "B,T,H",
    # B=128: a minibatch of the reuse step; H=48: a cluster of 3; H=40: the
    # per-thread design; H=1024: per-thread, W_h from global memory
    [(256, 17, 128), (128, 17, 128), (37, 17, 128), (5, 3, 32), (3, 1, 64), (9, 4, 256), (21, 5, 48), (4, 3, 40), (2, 2, 1024)],
)
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rows_are_bitwise_invariant(cuda, dtype):
    """A row's outputs do not depend on the launch it is in: B=256 vs the
    row alone (B=1) and vs the row among others in a B=37 launch."""
    x_proj, w_h, c0, h0 = inputs(256, 17, 128, dtype, cuda, seed=5)
    idx = list(range(40, 77))
    idx[3], idx[20], idx[36] = 255, 0, 17
    sel = torch.tensor(idx, device=cuda)
    with torch.no_grad():
        full = L.lstm_kernel(x_proj, w_h, c0, h0)
        mixed = L.lstm_kernel(x_proj[sel], w_h, c0[sel], h0[sel])
        for r in (0, 17, 255):
            alone = L.lstm_kernel(x_proj[r : r + 1], w_h, c0[r : r + 1], h0[r : r + 1])
            for f, a, m in zip(full, alone, mixed):
                assert torch.equal(f[r], a[0])
                assert torch.equal(f[r], m[idx.index(r)])


@pytest.mark.parametrize("dtype,design", [(torch.bfloat16, "cluster_mma"), (torch.float32, "cluster_ffma")])
@pytest.mark.parametrize("B", [256, 37])
def test_flagship_shapes_run_the_cluster_design(cuda, dtype, design, B):
    geo = L.kernel_geometry(B, 128, dtype, cuda)
    assert geo.design == design and geo.cluster == 8 and geo.rows == 16


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_takes_misaligned_inputs(cuda, dtype):
    """Contiguous views that start off a 16-byte boundary give the same bits
    as aligned copies (the wrapper re-homes W_h; x_proj is read in place)."""
    ins = inputs(37, 5, 128, dtype, cuda, seed=6)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view

    x_proj, w_h, c0, h0 = ins
    with torch.no_grad():
        want = L.lstm_kernel(*ins)
        got = L.lstm_kernel(shifted(x_proj), shifted(w_h), shifted(c0), shifted(h0))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_auto_dispatch_launches_kernel(cuda):
    ins = inputs(8, 5, 128, torch.bfloat16, cuda)
    before = L.LAUNCHES
    with torch.no_grad():
        L.lstm_recurrence(*ins)
    assert L.LAUNCHES == before + 1


def test_kernel_refuses_grad(cuda):
    """The raw launch stays forward-only; gradients go through LSTMRecurrence."""
    x_proj, w_h, c0, h0 = inputs(4, 3, 32, torch.float32, cuda)
    w_h.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        L.lstm_kernel(x_proj, w_h, c0, h0)


def _grads(impl, ins, cot):
    ins = [x.detach().clone().requires_grad_() for x in ins]
    h_seq, (c_T, h_T) = L.lstm_recurrence(*ins, impl=impl)
    torch.autograd.backward([h_seq, c_T, h_T], list(cot))
    return [x.grad for x in ins]


# Gradients through the kernel forward vs through the plain forward, both
# with the recompute backward: the backward recomputes z from the saved
# h/c, so it inherits the forward's differences (TOL) and carries them
# through 17 reverse steps; as a share of each gradient's largest value.
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [256, 128, 37])
def test_kernel_gradients_match_the_plain_forward(cuda, dtype, B):
    ins = inputs(B, 17, 128, dtype, cuda, seed=7)
    g = torch.Generator().manual_seed(8)
    cot = [torch.randn(B, 17, 128, generator=g).to(cuda), *(torch.randn(B, 128, generator=g).to(cuda) for _ in range(2))]
    before = L.LAUNCHES
    got = _grads("kernel", ins, cot)
    assert L.LAUNCHES == before + 1
    want = _grads("scan_recompute", ins, cot)
    for a, b, x in zip(got, want, ins):
        assert a.dtype == b.dtype == x.dtype and a.shape == x.shape and torch.isfinite(a).all()
        assert (a.float() - b.float()).abs().max().item() <= GRAD_TOL[dtype] * b.float().abs().max().item()


def test_auto_dispatch_is_differentiable_through_the_kernel(cuda):
    x_proj, w_h, c0, h0 = inputs(8, 5, 128, torch.bfloat16, cuda)
    w_h.requires_grad_(True)
    before = L.LAUNCHES
    h_seq, (c_T, h_T) = L.lstm_recurrence(x_proj, w_h, c0, h0)
    (h_seq.sum() + c_T.sum()).backward()
    assert L.LAUNCHES == before + 1
    assert w_h.grad is not None and w_h.grad.dtype == torch.bfloat16 and torch.isfinite(w_h.grad.float()).all()


def test_single_train_step_on_the_card_matches_the_plain_arm(cuda):
    """A small learner, one step through the kernel and one through the
    plain forward, from the same start: metrics within the learner
    forward's bf16 tolerance, Adam's mu and nu leaf by leaf within the
    recurrence gradients' bf16 tolerance (nu twice), params within lr/2
    (the reasons are chip_smoke.py's)."""
    import dataclasses

    from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig
    from dotaclient_tpu_torch.ops.batch import make_train_batch
    from dotaclient_tpu_torch.parallel import train_step as ts
    from dotaclient_tpu_torch.runtime.staging import cast_obs_to_compute_dtype
    from dotaclient_tpu_torch.transport.params import named_params

    cfg = LearnerConfig(batch_size=32, seq_len=8, policy=PolicyConfig(unit_embed_dim=64, lstm_hidden=128, mlp_hidden=64))
    plain = dataclasses.replace(cfg, policy=dataclasses.replace(cfg.policy, lstm_impl="scan_recompute"))
    out = []
    for c in (cfg, plain):
        step, io = ts.build_single_train_step(c, cuda)
        payload = io.to_device(io.pack_transfer(cast_obs_to_compute_dtype(c, make_train_batch(c, 0))))
        before = L.LAUNCHES
        state, metrics = step(ts.init_train_state(c, cuda), payload)
        out.append((state, metrics, L.LAUNCHES - before))
    (sk, mk, nk), (sp, mp, np_) = out
    assert (nk, np_) == (1, 0)
    for k in mk:
        assert torch.isfinite(mk[k]) and abs(mk[k].item() - mp[k].item()) <= 5e-3 * (1 + abs(mp[k].item())), k
    for name, tol in (("mu", GRAD_TOL[torch.bfloat16]), ("nu", 2 * GRAD_TOL[torch.bfloat16])):
        mk, mp = getattr(sk.opt_state, name), getattr(sp.opt_state, name)
        for n in mp:
            assert (mk[n] - mp[n]).abs().max().item() <= tol * mp[n].abs().max().item(), (name, n)
    for (_, a), (_, b) in zip(named_params(sk.net), named_params(sp.net)):
        assert abs(a - b).max() <= 0.5 * cfg.ppo.lr


def test_kernel_rejects_bad_inputs(cuda):
    x_proj, w_h, c0, h0 = inputs(4, 3, 32, torch.bfloat16, cuda)
    with torch.no_grad():
        with pytest.raises(ValueError, match="w_h"):
            L.lstm_kernel(x_proj, w_h.float(), c0, h0)
        with pytest.raises(ValueError, match="contiguous"):
            L.lstm_kernel(x_proj.transpose(0, 1).contiguous().transpose(0, 1), w_h, c0, h0)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            L.lstm_kernel(x_proj.half(), w_h.half(), c0, h0)
