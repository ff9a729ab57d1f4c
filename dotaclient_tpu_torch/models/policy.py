"""LSTM actor-critic (torch twin of dotaclient_tpu/models/policy.py, LSTM
family).

Per-unit MLP embeddings pooled over nearby units + hero/global stats →
trunk → LSTM → heads {action type, move x, move y, target via dot-product
attention over unit embeddings, value (+ aux)}. One module, two modes:
`net(state, obs)` is the actor's single step (obs leaves [B, ...]);
`net(state, obs, unroll=True)` is the learner's teacher-forced unroll
(obs leaves [B, T, ...]) whose recurrence runs through ops/lstm.py.

Numerics follow the reference: Dense layers in the compute dtype cast
input, kernel and bias to it and return it (flax `Dense(dtype=...)`);
the LSTM output, every head and the target attention are f32. Module and
parameter names are the flax ones (`core.unit_mlp1.kernel` ↔
`params/core/unit_mlp1/kernel`), and Dense kernels keep flax's [in, out]
layout, so weights cross between the packages without transposes
(transport/params.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from dotaclient_tpu_torch import resolve_device
from dotaclient_tpu_torch.config import PolicyConfig
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.ops import lstm as L
from dotaclient_tpu_torch.ops.action_dist import BIG_NEG, Dist, masked_log_softmax

LSTMState = Tuple[torch.Tensor, torch.Tensor]  # (c, h), each [B, H] f32


class AuxOutputs(NamedTuple):
    """Auxiliary value heads: win-prob logit, predicted last-hit rate,
    predicted net-worth (both normalized)."""

    win_logit: torch.Tensor
    last_hit: torch.Tensor
    net_worth: torch.Tensor


class PolicyOutput(NamedTuple):
    dist: Dist
    value: torch.Tensor  # [...] f32
    aux: Optional[AuxOutputs]


def _dtype(cfg: PolicyConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def check_arch(cfg: PolicyConfig) -> None:
    """Raise for a policy family the port does not have yet."""
    if cfg.arch != "lstm":
        raise NotImplementedError(f"arch={cfg.arch!r}: only the LSTM family is ported")


class Dense(nn.Module):
    """flax `nn.Dense(dtype=dtype)`: kernel [in, out], bias [out]; input,
    kernel and bias are cast to `dtype` and the result is in `dtype`."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.bias = nn.Parameter(torch.zeros(d_out, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


class LSTMCell(nn.Module):
    """LSTM with a split gate matmul: the x half is one [.., in]×[in, 4H]
    product hoisted out of the time loop, the hidden half + gate tail run
    through ops/lstm.py in unroll mode. Forget-gate bias +1; gate math f32,
    matmuls in `dtype`."""

    def __init__(self, d_in: int, features: int, dtype: torch.dtype, impl: str, device):
        super().__init__()
        H = features
        self.dtype = dtype
        self.impl = impl
        self.w_x = nn.Parameter(torch.empty(d_in, 4 * H, device=device))
        self.w_h = nn.Parameter(torch.empty(H, 4 * H, device=device))
        self.bias = nn.Parameter(torch.zeros(4 * H, device=device))

    def forward(self, carry: LSTMState, x: torch.Tensor, unroll: bool = False):
        dt = self.dtype
        c, h = carry
        # bias added in the compute dtype, as the reference does
        x_proj = x.to(dt) @ self.w_x.to(dt) + self.bias.to(dt)
        if not unroll:
            z = x_proj + h.to(dt) @ self.w_h.to(dt)
            new_c, new_h = L.gates(z, c)
            return (new_c, new_h), new_h
        h_seq, (c_T, h_T) = L.lstm_recurrence(
            x_proj.contiguous(),
            self.w_h.to(dt).contiguous(),
            c.float().contiguous(),
            h.float().contiguous(),
            impl=self.impl,
        )
        return (c_T, h_T), h_seq


def obs_trunk(core: "PolicyCore", obs: F.Observation):
    """Embeddings + masked max/mean pooling + trunk MLP. Returns (trunk
    [.., H] in the compute dtype, unit_emb [.., U, D])."""
    dt = core.dtype
    unit_mask = obs.unit_mask
    x = torch.relu(core.unit_mlp1(obs.unit_feats.to(dt)))
    unit_emb = core.unit_mlp2(x)  # [.., U, D]

    m = unit_mask[..., None]
    neg = torch.tensor(BIG_NEG, dtype=dt, device=unit_emb.device)
    pool_max = torch.where(m, unit_emb, neg).amax(dim=-2)
    any_unit = unit_mask.any(dim=-1, keepdim=True)
    pool_max = torch.where(any_unit, pool_max, torch.zeros_like(pool_max))
    denom = torch.clamp(m.sum(dim=-2), min=1).to(dt)
    pool_mean = torch.where(m, unit_emb, torch.zeros_like(unit_emb)).sum(dim=-2) / denom

    hero = core.hero_mlp(obs.hero_feats.to(dt))
    glob = core.global_mlp(obs.global_feats.to(dt))
    trunk = torch.cat([torch.relu(hero), torch.relu(glob), pool_max, pool_mean], dim=-1)
    trunk = torch.relu(core.trunk(trunk))
    return trunk, unit_emb


def action_heads(core: "PolicyCore", out: torch.Tensor, unit_emb: torch.Tensor, obs: F.Observation) -> PolicyOutput:
    """Masked action heads + value (+aux); `out` is the LSTM output in f32."""
    D = core.cfg.unit_embed_dim
    type_logits = core.type_head(out)
    move_x = core.move_x_head(out)
    move_y = core.move_y_head(out)
    query = core.target_query(out)
    target_logits = torch.einsum("...d,...ud->...u", query, unit_emb.float()) / math.sqrt(D)

    dist = Dist(
        type_logp=masked_log_softmax(type_logits, obs.action_mask),
        move_x_logp=torch.log_softmax(move_x, dim=-1),
        move_y_logp=torch.log_softmax(move_y, dim=-1),
        target_logp=masked_log_softmax(target_logits, obs.target_mask),
    )
    value = core.value_head(out)[..., 0]
    aux = None
    if core.cfg.aux_heads:
        aux = AuxOutputs(
            win_logit=core.aux_win(out)[..., 0],
            last_hit=core.aux_lh(out)[..., 0],
            net_worth=core.aux_nw(out)[..., 0],
        )
    return PolicyOutput(dist=dist, value=value, aux=aux)


class PolicyCore(nn.Module):
    """The LSTM policy network: obs + (c, h) → action dist + value."""

    def __init__(self, cfg: PolicyConfig, device):
        super().__init__()
        self.cfg = cfg
        self.dtype = dt = _dtype(cfg)
        f32 = torch.float32
        D, M, H = cfg.unit_embed_dim, cfg.mlp_hidden, cfg.lstm_hidden
        self.unit_mlp1 = Dense(F.UNIT_FEATURES, M, dt, device)
        self.unit_mlp2 = Dense(M, D, dt, device)
        self.hero_mlp = Dense(F.HERO_FEATURES, M, dt, device)
        self.global_mlp = Dense(F.GLOBAL_FEATURES, M // 4, dt, device)
        self.trunk = Dense(M + M // 4 + 2 * D, H, dt, device)
        self.lstm = LSTMCell(H, H, dt, cfg.lstm_impl, device)
        self.type_head = Dense(H, F.N_ACTION_TYPES, f32, device)
        self.move_x_head = Dense(H, cfg.n_move_bins, f32, device)
        self.move_y_head = Dense(H, cfg.n_move_bins, f32, device)
        self.target_query = Dense(H, D, f32, device)
        self.value_head = Dense(H, 1, f32, device)
        if cfg.aux_heads:
            self.aux_win = Dense(H, 1, f32, device)
            self.aux_lh = Dense(H, 1, f32, device)
            self.aux_nw = Dense(H, 1, f32, device)

    def forward(self, carry: LSTMState, obs: F.Observation, unroll: bool = False):
        trunk, unit_emb = obs_trunk(self, obs)
        carry, out = self.lstm(carry, trunk, unroll=unroll)
        return carry, action_heads(self, out, unit_emb, obs)


class PolicyNet(nn.Module):
    """Public policy module.

    - `net(state, obs)` — single step, obs leaves [B, ...];
    - `net(state, obs_seq, unroll=True)` — teacher-forced unroll, obs
      leaves [B, T, ...]; outputs carry a [B, T] time axis, plus the final
      (c, h).
    Parameters live on `device` (default: the current CUDA device) and are
    left uninitialised here: use `init_params` or `transport.params.load_named`.
    """

    def __init__(self, cfg: PolicyConfig, device=None):
        super().__init__()
        check_arch(cfg)
        self.cfg = cfg
        self.core = PolicyCore(cfg, resolve_device(device))

    def forward(self, state: LSTMState, obs: F.Observation, unroll: bool = False):
        if tuple(obs.unit_feats.shape[-2:]) != (F.MAX_UNITS, F.UNIT_FEATURES):
            raise ValueError(f"unit_feats must end in {(F.MAX_UNITS, F.UNIT_FEATURES)}, got {tuple(obs.unit_feats.shape)}")
        return self.core(state, obs, unroll)


def initial_state(cfg: PolicyConfig, batch_shape, device=None) -> LSTMState:
    """Fresh LSTM (c, h) zeros, each [*batch_shape, H] f32."""
    check_arch(cfg)
    shape = tuple(batch_shape) + (cfg.lstm_hidden,)
    dev = resolve_device(device)
    return (torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))


def wire_state(cfg: PolicyConfig, state: LSTMState) -> LSTMState:
    """The (c, h) [B, H] f32 pair shipped with each rollout: the LSTM's
    state is that pair."""
    check_arch(cfg)
    return state


def reset_between_chunks(cfg: PolicyConfig, state: LSTMState) -> LSTMState:
    """Chunk-boundary transition: the LSTM carries its state across chunks."""
    check_arch(cfg)
    return state


@torch.no_grad()
def init_params(cfg: PolicyConfig, generator: torch.Generator, device=None) -> PolicyNet:
    """A PolicyNet with fresh parameters: flax's lecun_normal (truncated
    normal at ±2σ, σ = 1/sqrt(fan_in) / 0.8796…) for every kernel and
    LSTM matrix, zeros for biases. Draws on the generator's device."""
    net = PolicyNet(cfg, device)
    for name, p in net.named_parameters():
        if name.endswith("bias"):
            p.zero_()
            continue
        std = 1.0 / math.sqrt(p.shape[0]) / 0.87962566103423978
        tmp = torch.empty(p.shape, device=generator.device)
        nn.init.trunc_normal_(tmp, std=std, a=-2 * std, b=2 * std, generator=generator)
        p.copy_(tmp)
    return net
