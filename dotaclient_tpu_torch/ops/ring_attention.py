"""The attention dispatch of the transformer family, and sequence-parallel
causal attention over a group of ranks (torch twin of
dotaclient_tpu/ops/ring_attention.py).

The reference shards the time axis over a mesh axis inside one SPMD
program (`shard_map`) and differentiates through its collectives. The port
runs one process per card, so the time axis is split over the ranks of an
sp group (parallel/dist.py Group), each rank holding a [B, T/n, N, Dh]
shard of Q, K and V and the matching absolute positions, and every
collective is an autograd Function with its backward written out:

- ring (`ring_causal_attention`): Q stays put; K/V and their positions
  rotate one hop per step (`_Shift`: to s+1, from s−1; its backward is the
  reverse rotation), through the streaming softmax of ops/attention.py.
  The rotation comes after the accumulation, so the local block counts
  once, and the n-th rotation, which would bring each block home, is not
  made. Causality needs no block bookkeeping: positions travel with the
  blocks and `accumulate_block` masks by `k_pos <= q_pos`.
- Ulysses (`ulysses_causal_attention`): two all-to-alls (`_AllToAll`,
  each the other's backward) trade the time shard of every head for the
  whole time axis of N/n heads, local attention runs (blockwise with
  `kv_block`), and the output goes back. The positions are all-gathered
  (no gradient). Needs the head count divisible by n.

`attend` dispatches as the reference's does: sequence-parallel when a
group is given, `sp_mode` picking the pattern; otherwise local attention,
blockwise when `kv_block` is set and the key axis exceeds it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from dotaclient_tpu_torch.ops import attention as A

SP_MODES = ("ring", "ulysses")


class SeqParallel(NamedTuple):
    """The learner unroll's sequence parallelism: the sp ranks
    (parallel/dist.py Group; member s holds the s-th time block) and the
    attention pattern."""

    group: object
    mode: str = "ring"


class _Shift(torch.autograd.Function):
    """The ring hop: `x` to member index + hops, the result from member
    index − hops; the gradient goes back the other way."""

    @staticmethod
    def forward(ctx, x, group, hops):
        ctx.group, ctx.hops = group, hops
        return group.shift(x, hops)

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.shift(grad.contiguous(), -ctx.hops), None, None


class _AllToAll(torch.autograd.Function):
    """Split `scatter_dim` into n chunks, chunk j to member j; concatenate
    what arrives along `gather_dim` in member order. The backward is the
    same exchange with the two dims swapped."""

    @staticmethod
    def forward(ctx, x, group, scatter_dim, gather_dim):
        ctx.group, ctx.dims = group, (scatter_dim, gather_dim)
        return _all_to_all(x, group, scatter_dim, gather_dim)

    @staticmethod
    def backward(ctx, grad):
        scatter_dim, gather_dim = ctx.dims
        return _all_to_all(grad, ctx.group, gather_dim, scatter_dim), None, None, None


class _GatherTime(torch.autograd.Function):
    """Every member's `x` concatenated along dim 1 in member order. Its
    backward is this member's own slice of the gradient: whatever follows
    the gather runs identically on every member, so each member passes
    back the part that its own shard produced, and the sum of the members'
    parameter gradients counts every path once."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[1]
        return group.all_gather(x, dim=1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(1, ctx.group.index * ctx.width, ctx.width), None


def gather_time(group, tensors: Sequence[torch.Tensor]):
    """[B, T/n, ...] f32 shards → [B, T, ...], all in one collective."""
    flat = [t.reshape(t.shape[0], t.shape[1], -1) for t in tensors]
    full = _GatherTime.apply(torch.cat(flat, dim=-1), group)
    out = full.split([f.shape[-1] for f in flat], dim=-1)
    return [o.reshape((o.shape[0], o.shape[1]) + tuple(t.shape[2:])) for o, t in zip(out, tensors)]


def _all_to_all(x, group, scatter_dim: int, gather_dim: int):
    n = group.size
    chunks = torch.stack(x.chunk(n, dim=scatter_dim))  # [n, ...]: chunk j for member j
    got = group.all_to_all(chunks)  # got[i]: member i's chunk for us
    return torch.cat(got.unbind(0), dim=gather_dim)


def ring_causal_attention(q, k, v, q_pos, k_pos, group) -> torch.Tensor:
    """Causal attention with time split over `group`: q/k/v [B, T/n, N, Dh]
    and q_pos/k_pos [B, T/n] are this rank's shards (rank s holds the s-th
    time block); returns its [B, T/n, N, Dh] shard of
    `ops.attention.causal_attention` over the whole time axis."""
    n = group.size
    kv = torch.stack([k, v])  # one message per hop
    carry = A.init_carry(q)
    for step in range(n):
        carry = A.accumulate_block(q, kv[0], kv[1], q_pos, k_pos, *carry)
        if step < n - 1:
            kv = _Shift.apply(kv, group, 1)
            k_pos = group.shift(k_pos, 1)
    return A.finalize_attention(*carry, dtype=q.dtype)


def ulysses_causal_attention(q, k, v, q_pos, k_pos, group, kv_block: int = 0) -> torch.Tensor:
    """All-to-all sequence parallelism, the ring's dual: time-sharded
    [B, T/n, N, Dh] → head-sharded [B, T, N/n, Dh], full-context attention
    on this rank's heads (blockwise when `kv_block` is set and T exceeds
    it), and back. Same function as the ring."""
    if q.shape[-2] % group.size:
        raise ValueError(f"ulysses: heads {q.shape[-2]} not divisible by sp={group.size} (use tf_sp_mode='ring', "
                         f"which has no head constraint)")
    to_heads = lambda x: _AllToAll.apply(x, group, -2, -3)
    qg, kg, vg = to_heads(q), to_heads(k), to_heads(v)
    q_full = group.all_gather(q_pos, dim=-1)
    k_full = group.all_gather(k_pos, dim=-1)
    if kv_block and kg.shape[-3] > kv_block:
        out = A.blockwise_causal_attention(qg, kg, vg, q_full, k_full, kv_block)
    else:
        out = A.causal_attention(qg, kg, vg, q_full, k_full)
    return _AllToAll.apply(out, group, -3, -2)


def attend(q, k, v, q_pos, k_pos, group: Optional[object] = None, sp_mode: str = "ring",
           kv_block: int = 0) -> torch.Tensor:
    """Sequence-parallel attention over `group` (a parallel/dist.py Group
    of sp ranks) when one is given, `sp_mode` picking the pattern ("ring"
    or "ulysses"); otherwise local attention: blockwise when `kv_block` is
    set and the key axis exceeds it, dense else."""
    if group is not None:
        if sp_mode == "ulysses":
            return ulysses_causal_attention(q, k, v, q_pos, k_pos, group, kv_block)
        if sp_mode != "ring":
            raise ValueError(f"unknown sp_mode {sp_mode!r} (ring|ulysses)")
        return ring_causal_attention(q, k, v, q_pos, k_pos, group)
    if kv_block and k.shape[-3] > kv_block:
        return A.blockwise_causal_attention(q, k, v, q_pos, k_pos, kv_block)
    return A.causal_attention(q, k, v, q_pos, k_pos)
