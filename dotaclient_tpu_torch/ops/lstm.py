"""LSTM time recurrence — the one sequential op in the policy (torch twin
of dotaclient_tpu/ops/lstm.py).

The caller hoists the input projection out of the loop (one
[B·T, in]×[in, 4H] matmul), so each step here is the [B, H]×[H, 4H]
hidden product plus the f32 gate tail:

    z_t = x_proj_t + rnd(h_{t-1}) @ W_h        (f32 accumulation)
    i, f, g, o = split(z_t);  c_t = σ(f+1)·c_{t-1} + σ(i)·tanh(g)
    h_t = σ(o)·tanh(c_t)

rnd() rounds h to W_h's dtype (the compute dtype). Two implementations of
the same function:
- `lstm_scan`: plain torch, a Python loop over T — the CPU path and the
  reference the CUDA kernel is held against;
- `lstm_kernel`: the hand-written CUDA kernel (csrc/lstm_recurrence.cu),
  forward only in this slice.
`lstm_recurrence` dispatches between them by the tensors' device.
"""

from __future__ import annotations

from typing import Tuple

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


def rows_per_cta(B: int, H: int, n_sm: int) -> int:
    """Batch rows per CTA: enough to cover B in about one wave over the
    card's SMs (W_h in shared memory allows one CTA per SM), capped by the
    1024-thread block limit (one thread per row and hidden unit)."""
    cap = max(1, _MAX_THREADS // H)
    return max(1, min(cap, -(-B // n_sm)))


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
            "the CUDA LSTM kernel is forward-only until the training slice adds its "
            "recompute backward; run under torch.no_grad() or use impl='torch'"
        )
    lib = _kernels.load("lstm_recurrence")
    dev = x_proj.device
    h_seq = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    c_seq = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    c_T = torch.empty((B, H), dtype=torch.float32, device=dev)
    h_T = torch.empty((B, H), dtype=torch.float32, device=dev)
    rows = rows_per_cta(B, H, torch.cuda.get_device_properties(dev).multi_processor_count)
    with torch.cuda.device(dev):
        rc = lib.lstm_recurrence_fwd(
            *(t.data_ptr() for t in (x_proj, w_h, c0, h0, h_seq, c_seq, c_T, h_T)),
            B,
            T,
            H,
            _DTYPE_CODES[x_proj.dtype],
            rows,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.lstm_recurrence_error_string(rc).decode()
        raise RuntimeError(f"lstm_recurrence kernel launch failed: {msg} (cudaError {rc})")
    LAUNCHES += 1
    return h_seq, c_seq, c_T, h_T


def lstm_recurrence(x_proj, w_h, c0, h0, impl: str = "auto"):
    """Returns (h_seq [B, T, H] f32, (c_T, h_T)). `impl`: "auto" runs the
    kernel on CUDA tensors and the plain scan on CPU tensors; "kernel" and
    "torch" force one ("kernel" on a CPU tensor raises)."""
    if impl == "auto":
        impl = "kernel" if x_proj.device.type == "cuda" else "torch"
    if impl == "torch":
        h_seq, _, c_T, h_T = lstm_scan(x_proj, w_h, c0, h0)
    elif impl == "kernel":
        h_seq, _, c_T, h_T = lstm_kernel(x_proj, w_h, c0, h0)
    else:
        raise ValueError(f"unknown lstm impl {impl!r}")
    return h_seq, (c_T, h_T)
