"""Causal attention over the time axis, the transformer family's core op
(torch twin of dotaclient_tpu/ops/attention.py).

- Positions are data and masking is arithmetic: every variant takes
  absolute int32 positions for queries and keys and attends where
  `k_pos <= q_pos`. An empty KV-cache slot carries EMPTY_POS, which no
  query position reaches, so the same code serves the unroll, the
  KV-cache step and padded key blocks.
- The streaming softmax is the shared primitive: `accumulate_block`
  carries the running max `m`, normalizer `l` and unnormalized output
  `acc` (all f32); dense attention is the one-block case, blockwise
  attention a loop over key blocks. A row with no valid key gives zeros,
  not NaN.
- Scores are f32 whatever the input dtype: q and k are cast to f32 and
  the products run in full f32 (TF32 off inside `_full_f32`), as the
  reference's `einsum(..., preferred_element_type=f32)` does. A bf16
  product would round the scores to bf16.
- RoPE encodes positions: its angles depend only on absolute positions,
  so cached keys, rotated when written, stay valid.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
import torch

# Position of "no key here" (an empty KV-cache slot, a pad key): int32 max,
# which no query position reaches.
EMPTY_POS = 2**31 - 1

# Score of a masked slot: finite, so a fully masked row's exp stays finite
# before the explicit mask zeroes it.
_NEG = -1e30


@contextlib.contextmanager
def _full_f32():
    """f32 matrix products in full f32 precision (no TF32) for the block.
    TF32 is off by default and then nothing is touched; a process that
    turned it on gets it off here and back on after (the flag is
    process-wide, so such a process must not run this beside another
    thread's f32 products)."""
    if not torch.backends.cuda.matmul.allow_tf32:
        yield
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


def rope(x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding. x [.., T, N, Dh] (Dh even), positions
    [.., T] int32 absolute positions. Angles in f32; EMPTY_POS positions
    rotate by 0 (their scores are masked anyway); result in x.dtype."""
    half = x.shape[-1] // 2
    freqs = torch.pow(base, -torch.arange(half, dtype=torch.float32, device=x.device) / half)  # [half]
    pos = positions.masked_fill(positions == EMPTY_POS, 0).float()
    ang = pos[..., None] * freqs  # [.., T, half]
    cos = torch.cos(ang)[..., None, :]  # [.., T, 1, half]: broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


def _scale(dh: int) -> float:
    """1/sqrt(Dh) rounded as the reference computes it, in f32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def accumulate_block(q, k, v, q_pos, k_pos, m, l, acc) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One streaming-softmax step over a K/V block.

    q [.., Tq, N, Dh]; k, v [.., Tk, N, Dh]; q_pos [.., Tq]; k_pos [.., Tk].
    Carries (f32): m [.., N, Tq] running max, l [.., N, Tq] normalizer,
    acc [.., N, Tq, Dh] unnormalized output. Returns the updated carries.
    """
    with _full_f32():
        s = torch.einsum("...qnd,...knd->...nqk", q.float(), k.float()) * _scale(q.shape[-1])
        valid = (k_pos[..., None, None, :] <= q_pos[..., None, :, None]) & (k_pos[..., None, None, :] != EMPTY_POS)
        s = s.masked_fill(~valid, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # explicit mask: in a fully masked row m_new is _NEG and exp(s - m_new) is 1
        p = torch.exp(s - m_new[..., None]).masked_fill(~valid, 0.0)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum("...nqk,...knd->...nqd", p, v.float())
    return m_new, l_new, acc_new


def init_carry(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Zero-state (m, l, acc) for a streaming pass with query block `q`."""
    lead = tuple(q.shape[:-3])
    Tq, N, Dh = q.shape[-3:]
    m = torch.full(lead + (N, Tq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros(lead + (N, Tq), dtype=torch.float32, device=q.device)
    acc = torch.zeros(lead + (N, Tq, Dh), dtype=torch.float32, device=q.device)
    return m, l, acc


def finalize_attention(m, l, acc, dtype=None) -> torch.Tensor:
    """(m, l, acc) carries → attention output [.., Tq, N, Dh]."""
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # fully masked rows → 0
    out = out.movedim(-3, -2)  # [.., N, Tq, Dh] → [.., Tq, N, Dh]
    return out.to(dtype) if dtype is not None else out


def causal_attention(q, k, v, q_pos, k_pos) -> torch.Tensor:
    """Position-masked causal attention in one block: q [.., Tq, N, Dh],
    k/v [.., Tk, N, Dh], q_pos [.., Tq], k_pos [.., Tk] → [.., Tq, N, Dh]
    in q.dtype."""
    m, l, acc = accumulate_block(q, k, v, q_pos, k_pos, *init_carry(q))
    return finalize_attention(m, l, acc, dtype=q.dtype)


def blockwise_causal_attention(q, k, v, q_pos, k_pos, kv_block: int) -> torch.Tensor:
    """`causal_attention` as a loop over key blocks of `kv_block`: a
    forward without autograd holds intermediates of [.., N, Tq, kv_block]
    instead of [.., N, Tq, Tk]; under autograd every block's are kept for
    the backward unless the caller recomputes them (tf_remat). A ragged
    last block is padded with EMPTY_POS keys, which the masking erases.
    The reference scans the blocks; here it is a Python loop over the
    same carries."""
    Tk = k.shape[-3]
    nb = -(-Tk // kv_block)
    pad = nb * kv_block - Tk
    if pad:
        lead = tuple(k.shape[:-3])
        zeros = k.new_zeros(lead + (pad,) + tuple(k.shape[-2:]))
        k = torch.cat([k, zeros], dim=-3)
        v = torch.cat([v, zeros.to(v.dtype)], dim=-3)
        k_pos = torch.cat([k_pos, k_pos.new_full(lead + (pad,), EMPTY_POS)], dim=-1)
    carry = init_carry(q)
    for i in range(nb):
        blk = slice(i * kv_block, (i + 1) * kv_block)
        carry = accumulate_block(q, k[..., blk, :, :], v[..., blk, :, :], q_pos, k_pos[..., blk], *carry)
    return finalize_attention(*carry, dtype=q.dtype)
