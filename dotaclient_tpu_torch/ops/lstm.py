"""LSTM time recurrence — the one sequential op in the policy (torch twin
of dotaclient_tpu/ops/lstm.py).

The caller hoists the input projection out of the loop (one
[B·T, in]×[in, 4H] matmul), so each step here is the [B, H]×[H, 4H]
hidden product plus the f32 gate tail:

    z_t = x_proj_t + rnd(h_{t-1}) @ W_h        (f32 accumulation)
    i, f, g, o = split(z_t);  c_t = σ(f+1)·c_{t-1} + σ(i)·tanh(g)
    h_t = σ(o)·tanh(c_t)

rnd() rounds h to W_h's dtype (the compute dtype). Two implementations of
the forward:
- `lstm_scan`: plain torch, a Python loop over T — the CPU path and the
  reference the CUDA kernel is held against;
- `lstm_kernel`: the hand-written CUDA kernel (csrc/lstm_recurrence.cu),
  forward only.
`LSTMRecurrence` makes either forward differentiable with the reference's
gate-recompute backward (`recompute_backward`, the `custom_vjp` of
dotaclient_tpu/ops/lstm.py): z_t is rebuilt from the saved h/c sequences,
so the 4H-wide gate activations are never stored. `lstm_recurrence`
dispatches by the tensors' device.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from dotaclient_tpu_torch.ops import _kernels

LSTMState = Tuple[torch.Tensor, torch.Tensor]  # (c, h), each [B, H] f32

# Launches of the CUDA kernel in this process; read and reset by callers
# that must show a run went through the kernel.
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_THREADS = 1024


def gates(z: torch.Tensor, c: torch.Tensor) -> LSTMState:
    """f32 gate tail shared verbatim by every implementation."""
    i, f, g, o = torch.chunk(z.float(), 4, dim=-1)
    new_c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    return new_c, new_h


def lstm_scan(x_proj, w_h, c0, h0):
    """Plain version of the kernel. x_proj [B, T, 4H] (bias added) and
    w_h [H, 4H] in the compute dtype, c0/h0 [B, H] f32 →
    (h_seq, c_seq [B, T, H] f32, c_T, h_T [B, H] f32)."""
    w32 = w_h.float()  # exact upcast: products of compute-dtype values, f32 sums
    c, h = c0.float(), h0.float()
    hs, cs = [], []
    for t in range(x_proj.shape[1]):
        z = x_proj[:, t].float() + h.to(w_h.dtype).float() @ w32
        c, h = gates(z, c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1), c, h


class Geometry(NamedTuple):
    """How one launch of the CUDA kernel is laid out (csrc/lstm_recurrence.cu
    checks every field and refuses a launch it cannot take)."""

    design: str  # "cluster_mma" (bf16), "cluster_ffma" (f32) or "per_thread"
    cluster: int  # CTAs per thread-block cluster (1 for per_thread)
    rows: int  # batch rows per cluster (per CTA for per_thread)
    grid: int  # CTAs in the launch, a multiple of `cluster`
    threads: int  # threads per CTA
    smem_bytes: int  # dynamic shared memory per CTA


# Twins of the constants of the same names in csrc/lstm_recurrence.cu
# (CLUSTER_ROWS is ROWS there); tests/test_torch_lstm.py checks they agree.
CLUSTER_ROWS = 16  # batch rows per cluster: one m16 tile of the tensor-core product
MAX_CLUSTER = 8  # the portable cluster size
CLUSTER_THREADS = 512  # launch bound of the cluster kernels
F32_HS = 20  # f32 h buffer: floats per k row (16 rows + bank pad)
BAR_BYTES = 16  # the cluster kernels' two mbarriers, first in shared memory
KSPLIT = 4  # bf16: k quarters, one warp each per unit group
X_AHEAD = 3  # steps between fetching a cell's x_proj and adding it
_DESIGN_CODES = {"per_thread": 0, "cluster_mma": 1, "cluster_ffma": 1}


def _cluster_smem_bytes(H: int, U: int, elt: int) -> int:
    """Shared memory of a cluster kernel's CTA, as the .cu file's
    cluster_smem_bytes computes it: the mbarriers, the W_h slice [H, 4U + pad],
    double-buffered h, and in bf16 the k quarters' partial sums
    [KSPLIT, 16, U + 1] float4, in f32 the x_proj ring [X_AHEAD, 16, 4, U]."""
    w = H * (4 * U + (8 if elt == 2 else 4)) * elt
    h = 2 * CLUSTER_ROWS * (H + 8) * 2 if elt == 2 else 2 * H * F32_HS * 4
    x = KSPLIT * CLUSTER_ROWS * (U + 1) * 16 if elt == 2 else X_AHEAD * CLUSTER_ROWS * 4 * U * 4
    return BAR_BYTES + w + h + x


@functools.lru_cache(maxsize=1024)  # the wrapper asks on every launch
def launch_geometry(B: int, H: int, dtype: torch.dtype, n_sm: int, smem_optin: int) -> Geometry:
    """The launch for x_proj [B, T, 4H] of `dtype` on a card with `n_sm` SMs
    and `smem_optin` bytes of shared memory per block.

    The cluster design takes every H that is a multiple of 16 whose W_h
    slice fits one block: C = the largest cluster size <= 8 with 16·C
    dividing H, so each CTA owns U = H/C units (a multiple of 16), and a
    cluster owns 16 batch rows. Otherwise the per-thread design (one thread
    per row and unit, enough rows per CTA to cover B in about one wave).
    The design never depends on B, so a row computes the same bits in a
    launch of any size."""
    if B < 1 or not 1 <= H <= _MAX_THREADS:
        raise ValueError(f"lstm kernel takes 1 <= B and 1 <= H <= {_MAX_THREADS}, got B={B} H={H}")
    elt = torch.finfo(dtype).bits // 8
    if H % 16 == 0:
        C = max(c for c in range(1, MAX_CLUSTER + 1) if H % (16 * c) == 0)
        U = H // C
        threads = 16 * U  # bf16: 4 warps (k quarters) per 8 units; f32: 2 row groups x 8 k lanes per unit
        smem = _cluster_smem_bytes(H, U, elt)
        if threads <= CLUSTER_THREADS and smem <= smem_optin:
            design = "cluster_mma" if elt == 2 else "cluster_ffma"
            return Geometry(design, C, CLUSTER_ROWS, -(-B // CLUSTER_ROWS) * C, threads, smem)
    rows = max(1, min(_MAX_THREADS // H, -(-B // n_sm)))
    h_bytes, w_bytes = 2 * rows * H * elt, 4 * H * H * elt
    smem = w_bytes + h_bytes if w_bytes + h_bytes <= smem_optin else h_bytes
    return Geometry("per_thread", 1, rows, -(-B // rows), rows * H, smem)


_device_limits: Dict[int, Tuple[int, int]] = {}


def kernel_geometry(B: int, H: int, dtype: torch.dtype, device) -> Geometry:
    """`launch_geometry` on the given CUDA device's limits (read once)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    limits = _device_limits.get(index)
    if limits is None:
        lib = _kernels.load("lstm_recurrence")
        n_sm, optin, clusters = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(index):
            rc = lib.lstm_recurrence_device_limits(ctypes.byref(n_sm), ctypes.byref(optin), ctypes.byref(clusters))
        if rc != 0:
            raise RuntimeError(f"lstm kernel: reading device limits failed: {lib.lstm_recurrence_error_string(rc).decode()}")
        if not clusters.value:
            raise RuntimeError(f"lstm kernel: device {index} cannot launch thread-block clusters (needs sm_90)")
        limits = _device_limits[index] = (n_sm.value, optin.value)
    return launch_geometry(B, H, dtype, *limits)


def lstm_kernel(x_proj, w_h, c0, h0):
    """Launch the CUDA kernel; same contract as `lstm_scan`. Forward only:
    raises NotImplementedError if autograd would need to track it."""
    global LAUNCHES
    if x_proj.device.type != "cuda":
        raise ValueError(f"lstm kernel needs CUDA tensors, got x_proj on {x_proj.device}")
    if x_proj.dim() != 3 or x_proj.shape[-1] % 4:
        raise ValueError(f"x_proj must be [B, T, 4H], got {tuple(x_proj.shape)}")
    B, T, H4 = x_proj.shape
    H = H4 // 4
    if x_proj.dtype not in _DTYPE_CODES:
        raise ValueError(f"lstm kernel takes float32 or bfloat16 x_proj, got {x_proj.dtype}")
    if w_h.dtype != x_proj.dtype or tuple(w_h.shape) != (H, H4):
        raise ValueError(f"w_h must be [{H}, {H4}] {x_proj.dtype}, got {tuple(w_h.shape)} {w_h.dtype}")
    for name, s in (("c0", c0), ("h0", h0)):
        if s.dtype != torch.float32 or tuple(s.shape) != (B, H):
            raise ValueError(f"{name} must be [{B}, {H}] float32, got {tuple(s.shape)} {s.dtype}")
    ins = (x_proj, w_h, c0, h0)
    if any(t.device != x_proj.device for t in ins):
        raise ValueError("lstm kernel inputs must share one CUDA device")
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("lstm kernel inputs must be contiguous")
    if H > _MAX_THREADS or B == 0:
        raise ValueError(f"lstm kernel takes 1 <= B and H <= {_MAX_THREADS}, got B={B} H={H}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        raise NotImplementedError(
            "the CUDA LSTM kernel is forward-only: differentiate through "
            "lstm_recurrence(impl='kernel') (LSTMRecurrence), or call it under torch.no_grad()"
        )
    lib = _kernels.load("lstm_recurrence")
    dev = x_proj.device
    geo = kernel_geometry(B, H, x_proj.dtype, dev)
    if geo.design != "per_thread" and w_h.data_ptr() % 16:  # the cluster kernels copy W_h 16 bytes at a time
        w_h = w_h.clone()
    h_seq = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    c_seq = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    c_T = torch.empty((B, H), dtype=torch.float32, device=dev)
    h_T = torch.empty((B, H), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.lstm_recurrence_fwd(
            *(t.data_ptr() for t in (x_proj, w_h, c0, h0, h_seq, c_seq, c_T, h_T)),
            B,
            T,
            H,
            _DTYPE_CODES[x_proj.dtype],
            _DESIGN_CODES[geo.design],
            geo.cluster,
            geo.rows,
            geo.grid,
            geo.threads,
            geo.smem_bytes,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.lstm_recurrence_error_string(rc).decode()
        raise RuntimeError(f"lstm_recurrence kernel launch failed: {msg} (cudaError {rc})")
    LAUNCHES += 1
    return h_seq, c_seq, c_T, h_T


def recompute_backward(res, grads):
    """Gate-recompute backward of the recurrence (the reference's
    `_recompute_backward`). `res` = (x_proj, w_h, c0, h0, h_seq, c_seq) as
    the forward saw and wrote them; `grads` = (dh_seq, (dc_T, dh_T)).
    Returns (dx_proj, dW_h, dc0, dh0).

    Its precision is the reference's, not autograd's through `lstm_scan`:
    z is rebuilt from rnd(h) with f32 sums, as the forward computed it;
    dh_prev = dz @ W_hᵀ stays f32 (no rounding at the cast); dW_h sums
    unrounded f32 h_prev ⊗ dz; dx_proj and dW_h are cast to the compute
    dtype only at the end. In bf16 autograd differs at all four points.

    z and the gate activations do not depend on the backward's carry, so
    they are computed for all T at once; only the dc/dh chain walks time
    in reverse."""
    x_proj, w_h, c0, h0, h_seq, c_seq = res
    dh_seq, (dc_T, dh_T) = grads
    B, T, H = h_seq.shape
    w32 = w_h.float()
    h_prev = torch.cat([h0[:, None], h_seq[:, :-1]], 1)  # [B, T, H] f32
    c_prev = torch.cat([c0[:, None], c_seq[:, :-1]], 1)
    z = x_proj.float() + h_prev.to(w_h.dtype).float() @ w32  # [B, T, 4H]
    zi, zf, zg, zo = torch.chunk(z, 4, dim=-1)
    i, f, g, o = torch.sigmoid(zi), torch.sigmoid(zf + 1.0), torch.tanh(zg), torch.sigmoid(zo)
    tanh_c = torch.tanh(c_seq)
    dc_from_dh = o * (1.0 - tanh_c**2)  # dc_t += dh_t · this
    # dz_t = [dc·g·i(1-i), dc·c_prev·f(1-f), dc·i(1-g²), dh·tanh_c·o(1-o)]
    dz_coef = torch.cat([g * i * (1.0 - i), c_prev * f * (1.0 - f), i * (1.0 - g**2), tanh_c * o * (1.0 - o)], -1)
    dh_out = dh_seq.float()
    w32_t = w32.t()
    dc, dh_next = dc_T.float(), dh_T.float()
    dz = [None] * T
    for t in reversed(range(T)):
        dh = dh_out[:, t] + dh_next
        dc = dc + dh * dc_from_dh[:, t]
        dz[t] = torch.cat([dc, dc, dc, dh], -1) * dz_coef[:, t]
        dh_next = dz[t] @ w32_t
        dc = dc * f[:, t]
    dz_seq = torch.stack(dz, 1)  # [B, T, 4H] f32
    dw_h = h_prev.reshape(B * T, H).t() @ dz_seq.reshape(B * T, 4 * H)
    return dz_seq.to(x_proj.dtype), dw_h.to(w_h.dtype), dc, dh_next


class LSTMRecurrence(torch.autograd.Function):
    """The recurrence as one differentiable op: `forward_fn` (`lstm_kernel`
    or `lstm_scan`) computes (h_seq, c_seq, c_T, h_T) with autograd off,
    the saved (x_proj, w_h, c0, h0, h_seq, c_seq) feed
    `recompute_backward`. The twin of the reference's `_lstm_pallas`
    custom_vjp; with `lstm_scan` as the forward, of its interpret mode.
    Returns (h_seq, c_T, h_T)."""

    @staticmethod
    def forward(ctx, x_proj, w_h, c0, h0, forward_fn):
        h_seq, c_seq, c_T, h_T = forward_fn(x_proj, w_h, c0, h0)
        ctx.save_for_backward(x_proj, w_h, c0, h0, h_seq, c_seq)
        return h_seq, c_T, h_T

    @staticmethod
    def backward(ctx, dh_seq, dc_T, dh_T):
        res = ctx.saved_tensors
        h_seq = res[4]
        zero = lambda g, like: torch.zeros_like(like) if g is None else g  # an output nobody used
        grads = (zero(dh_seq, h_seq), (zero(dc_T, h_seq[:, -1]), zero(dh_T, h_seq[:, -1])))
        return (*recompute_backward(res, grads), None)


def lstm_recurrence(x_proj, w_h, c0, h0, impl: str = "auto"):
    """Returns (h_seq [B, T, H] f32, (c_T, h_T)), differentiable in every
    input. `impl` (the reference dispatcher's twins):
    - "kernel": `LSTMRecurrence` with the CUDA kernel as its forward
      ("pallas"); a build or launch failure raises, there is no fallback;
    - "torch": autograd through `lstm_scan` ("scan");
    - "scan_recompute": `LSTMRecurrence` with `lstm_scan` as its forward
      ("pallas_interpret"): the kernel path's arithmetic without the
      kernel, for the CPU tests and the GPU smoke's plain arm;
    - "auto": "kernel" on CUDA tensors, "torch" on CPU tensors."""
    if impl == "auto":
        impl = "kernel" if x_proj.device.type == "cuda" else "torch"
    if impl == "torch":
        h_seq, _, c_T, h_T = lstm_scan(x_proj, w_h, c0, h0)
    elif impl == "kernel":
        h_seq, c_T, h_T = LSTMRecurrence.apply(x_proj, w_h, c0, h0, lstm_kernel)
    elif impl == "scan_recompute":
        h_seq, c_T, h_T = LSTMRecurrence.apply(x_proj, w_h, c0, h0, lstm_scan)
    else:
        raise ValueError(f"unknown lstm impl {impl!r}")
    return h_seq, (c_T, h_T)
