"""Transformer actor-critic, the long-context policy family (torch twin of
dotaclient_tpu/models/transformer_policy.py).

Same interface as the LSTM family, so the train step, staging and the
wire stay family-agnostic:

- step (actor): the carried state is a `KVCache`; one step writes the new
  token's K/V into each row's next slot and attends over the cache;
- unroll (learner): teacher-forced causal attention over the whole
  [B, T, ...] chunk. The passed state is ignored: context is chunk-local,
  and the actor resets its cache at every chunk boundary
  (models.policy.reset_between_chunks). With sequence parallelism (`sp`,
  an ops.ring_attention.SeqParallel) each sp rank runs the trunk, the
  blocks and the heads on its own block of the frames, at their global
  positions, the attention spanning the ranks; the per-token outputs are
  then gathered along time, so what follows (GAE, the loss) sees the
  whole chunk on every sp rank.

The observation trunk and the heads are the LSTM family's
(`TransformerPolicyCore` is `PolicyCore` with the temporal core swapped).
Module names give the flax paths `core.tf.block{i}.{ln1,qkv,attn_out,
ln2,mlp_up,mlp_down}`, so weights cross with transport/params.py.
Numerics follow the reference: matmuls in the compute dtype, LayerNorm,
the softmax and the residual stream in f32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from dotaclient_tpu_torch import resolve_device
from dotaclient_tpu_torch.config import PolicyConfig
from dotaclient_tpu_torch.models.policy import Dense, PolicyCore, PolicyOutput, _dtype, action_heads, obs_trunk
from dotaclient_tpu_torch.ops import attention as A
from dotaclient_tpu_torch.ops import ring_attention as RA


class KVCache(NamedTuple):
    """Actor-side attention state, every leaf batch-leading like the
    LSTM's (c, h): k/v [B, L, C, N, Dh] in the compute dtype; pos [B, C]
    int32 absolute positions, EMPTY_POS in unwritten slots (shared by
    every layer); idx [B] int32, each row's next absolute position."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    idx: torch.Tensor


def check_width(cfg: PolicyConfig) -> int:
    """The head dim Dh = lstm_hidden / tf_heads; ValueError unless the
    width divides by the heads and Dh is even (RoPE rotates half-pairs)."""
    D, N = cfg.lstm_hidden, cfg.tf_heads
    if D % N:
        raise ValueError(f"transformer width lstm_hidden={D} must divide by tf_heads={N}")
    if (D // N) % 2:
        raise ValueError(f"head dim {D // N} must be even (RoPE rotates half-pairs)")
    return D // N


def init_cache(cfg: PolicyConfig, batch_shape, device=None) -> KVCache:
    """An empty cache for `batch_shape[0]` rows (1 for an empty shape)."""
    B = int(batch_shape[0]) if len(batch_shape) else 1
    L, C, N = cfg.tf_layers, cfg.tf_context, cfg.tf_heads
    Dh = check_width(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    return KVCache(
        k=torch.zeros((B, L, C, N, Dh), dtype=dt, device=dev),
        v=torch.zeros((B, L, C, N, Dh), dtype=dt, device=dev),
        pos=torch.full((B, C), A.EMPTY_POS, dtype=torch.int32, device=dev),
        idx=torch.zeros((B,), dtype=torch.int32, device=dev),
    )


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm(dtype=float32)`: f32 statistics with the fast
    variance E[x²] − E[x]² (clipped at 0), ε = 1e-6, params `scale` and
    `bias`."""

    def __init__(self, d: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, device=device))
        self.bias = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * (torch.rsqrt(var + 1e-6) * self.scale) + self.bias


def _rounded(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype` (on the host)."""
    return torch.tensor(value, dtype=torch.float32).to(dtype).item()


class Gelu(nn.Module):
    """flax `nn.gelu` (tanh approximation) op by op in the input's dtype,
    its constants rounded to that dtype, as the reference evaluates it. In
    bf16 `F.gelu(approximate="tanh")` rounds once at the end instead and
    lands one bf16 ulp away on ~45% of elements."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.c = _rounded(math.sqrt(2.0 / math.pi), dtype)
        self.k = _rounded(0.044715, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * (0.5 * (1.0 + torch.tanh(self.c * (x + self.k * (x * x * x)))))


class Block(nn.Module):
    """Pre-LN block: LN → causal multi-head attention (+ residual) → LN →
    tanh-GELU MLP (+ residual)."""

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype, kv_block: int, device):
        super().__init__()
        D = d_model
        self.n_heads, self.dtype, self.kv_block = n_heads, dtype, kv_block
        self.ln1 = LayerNorm(D, device)
        self.qkv = Dense(D, 3 * D, dtype, device)
        self.attn_out = Dense(D, D, dtype, device)
        self.ln2 = LayerNorm(D, device)
        self.mlp_up = Dense(D, 4 * D, dtype, device)
        self.mlp_down = Dense(4 * D, D, dtype, device)
        self.gelu = Gelu(dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, cache=None, sp=None):
        """x [B, T, D] f32, positions [B, T] int32. cache=None: causal
        self-attention over T (unroll; with `sp`, this rank's time block of
        it); returns (x', None). Otherwise
        cache = (k_cache [B, C, N, Dh], v_cache, cache_pos [B, C] already
        holding this token's position, write [B, C] bool one-hot), T = 1:
        the fresh K/V are written at `write` and the query attends over
        the merged cache; returns (x', (k_cache', v_cache'))."""
        N, dt = self.n_heads, self.dtype
        D = x.shape[-1]
        Dh = D // N
        h = self.ln1(x)
        q, k, v = self.qkv(h.to(dt)).split(D, dim=-1)
        # RoPE at the token's absolute position; cached keys were rotated
        # when written, so the angles agree across modes
        q = A.rope(q.reshape(q.shape[:-1] + (N, Dh)), positions)
        k = A.rope(k.reshape(k.shape[:-1] + (N, Dh)), positions)
        v = v.reshape(v.shape[:-1] + (N, Dh))
        new_cache = None
        if cache is None:
            group, mode = (sp.group, sp.mode) if sp is not None else (None, "ring")
            attn = RA.attend(q, k, v, positions, positions, group, mode, kv_block=self.kv_block)
        else:
            k_cache, v_cache, cache_pos, write = cache
            sel = write[:, :, None, None]  # [B, C, 1, 1]
            k_cache = torch.where(sel, k.to(k_cache.dtype), k_cache)
            v_cache = torch.where(sel, v.to(v_cache.dtype), v_cache)
            attn = RA.attend(q, k_cache, v_cache, positions, cache_pos)
            new_cache = (k_cache, v_cache)
        out = self.attn_out(attn.to(dt).reshape(attn.shape[:-2] + (D,)))
        x = x + out.float()
        h = self.ln2(x)
        h = self.gelu(self.mlp_up(h.to(dt)))
        h = self.mlp_down(h)
        return x + h.float(), new_cache


class TransformerCore(nn.Module):
    """Temporal core: trunk features → context features. Unroll: x
    [B, T, D] → [B, T, D], the carry passed through untouched. Step: x
    [B, D] → [B, D] with a KVCache carry."""

    def __init__(self, cfg: PolicyConfig, device):
        super().__init__()
        check_width(cfg)
        self.cfg = cfg
        dt = _dtype(cfg)
        for i in range(cfg.tf_layers):
            setattr(self, f"block{i}", Block(cfg.lstm_hidden, cfg.tf_heads, dt, cfg.tf_attn_block, device))

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.cfg.tf_layers)]

    def forward(self, carry, x: torch.Tensor, unroll: bool = False, sp=None):
        if unroll:
            B, T = x.shape[0], x.shape[1]
            # global positions: sp rank s holds frames [s·T, (s+1)·T)
            first = sp.group.index * T if sp is not None else 0
            positions = torch.arange(first, first + T, dtype=torch.int32, device=x.device).expand(B, T)
            h = x.float()
            for block in self.blocks():
                if self.cfg.tf_remat:
                    # activations recomputed in the backward instead of stored (nn.remat)
                    h, _ = checkpoint(block, h, positions, None, sp, use_reentrant=False)
                else:
                    h, _ = block(h, positions, sp=sp)
            return carry, h

        if not isinstance(carry, KVCache):
            raise TypeError(f"transformer step mode needs a KVCache carry, got {type(carry).__name__}")
        C = carry.pos.shape[1]
        positions = carry.idx[:, None]  # [B, 1]: this step's absolute position
        # Ring-buffer write at idx % C: past capacity the oldest slot is
        # overwritten (a sliding window over the last C tokens); a one-hot of
        # an out-of-range index would drop the write instead.
        write = torch.arange(C, dtype=torch.int32, device=x.device)[None, :] == (carry.idx % C)[:, None]
        new_pos = torch.where(write, positions, carry.pos)
        h = x.float()[:, None, :]
        ks, vs = [], []
        for i, block in enumerate(self.blocks()):
            h, (k_i, v_i) = block(h, positions, cache=(carry.k[:, i], carry.v[:, i], new_pos, write))
            ks.append(k_i)
            vs.append(v_i)
        new_carry = KVCache(k=torch.stack(ks, dim=1), v=torch.stack(vs, dim=1), pos=new_pos, idx=carry.idx + 1)
        return new_carry, h[:, 0, :]


class TransformerPolicyCore(PolicyCore):
    """The shared trunk and heads around the transformer core (`tf`)."""

    def add_temporal_core(self, cfg: PolicyConfig, device) -> str:
        self.tf = TransformerCore(cfg, device)
        return "tf"

    def forward(self, carry, obs, unroll: bool = False, sp=None):
        if sp is None or not unroll:
            return super().forward(carry, obs, unroll)
        T = obs.unit_feats.shape[1] // sp.group.size
        local = type(obs)(*(x.narrow(1, sp.group.index * T, T) for x in obs))
        trunk, unit_emb = obs_trunk(self, local)
        carry, out = self.tf(carry, trunk, unroll=True, sp=sp)
        pol = action_heads(self, out, unit_emb, local)
        parts = list(pol.dist) + [pol.value] + (list(pol.aux) if pol.aux is not None else [])
        parts = RA.gather_time(sp.group, parts)
        n = len(pol.dist)
        aux = type(pol.aux)(*parts[n + 1 :]) if pol.aux is not None else None
        return carry, PolicyOutput(dist=type(pol.dist)(*parts[:n]), value=parts[n], aux=aux)
