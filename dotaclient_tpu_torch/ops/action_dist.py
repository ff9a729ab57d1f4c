"""Masked factorized action distribution (torch twin of
dotaclient_tpu/ops/action_dist.py).

Pure functions over a `Dist` of already-masked log-probs; every function
broadcasts over leading axes ([B] actor step, [B, T] learner unroll).
Masking uses a large finite negative so an all-masked head is uniform,
never NaN. Sampling is Gumbel-max, as JAX's `categorical`: `sample` draws
the noise from a torch.Generator, `sample_gumbel` takes it as an argument
so a test can feed both frameworks the same noise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dotaclient_tpu_torch.env.featurizer import ACT_ATTACK, ACT_CAST, ACT_MOVE

BIG_NEG = -1e9


class Dist(NamedTuple):
    """Masked log-probabilities for each head; leading axes arbitrary."""

    type_logp: torch.Tensor  # [..., N_ACTION_TYPES]
    move_x_logp: torch.Tensor  # [..., n_move_bins]
    move_y_logp: torch.Tensor  # [..., n_move_bins]
    target_logp: torch.Tensor  # [..., MAX_UNITS]


class Action(NamedTuple):
    """One sampled (or stored) action; int64 leaves, leading axes match the Dist."""

    type: torch.Tensor
    move_x: torch.Tensor
    move_y: torch.Tensor
    target: torch.Tensor


def masked_log_softmax(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """log-softmax with masked entries pinned to BIG_NEG (all-masked rows
    degrade to uniform)."""
    logits = torch.where(mask, logits, torch.full_like(logits, BIG_NEG))
    return torch.log_softmax(logits, dim=-1)


def _gather(logp: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(logp, -1, idx.long().unsqueeze(-1)).squeeze(-1)


def _entropy(logp: torch.Tensor) -> torch.Tensor:
    # p·logp with p==0 and logp==BIG_NEG is 0·(-1e9) == -0.0 — finite.
    return -(torch.exp(logp) * logp).sum(-1)


def gumbel_noise(generator: torch.Generator, dist: Dist) -> Dist:
    """Standard Gumbel noise shaped like each head, drawn on the Dist's device."""

    def g(logp):
        tiny = torch.finfo(torch.float32).tiny
        u = torch.rand(logp.shape, generator=generator, device=logp.device, dtype=torch.float32)
        return -torch.log(-torch.log(u.clamp_min(tiny)))

    return Dist(*(g(x) for x in dist))


def sample_gumbel(dist: Dist, noise: Dist) -> Action:
    """Gumbel-max sample of every head given its noise."""
    return Action(*(torch.argmax(logp + n, dim=-1) for logp, n in zip(dist, noise)))


def sample(generator: torch.Generator, dist: Dist) -> Action:
    """Sample each head independently; unselected heads' samples are valid
    indices but contribute nothing to log_prob (factorized semantics)."""
    return sample_gumbel(dist, gumbel_noise(generator, dist))


def mode(dist: Dist) -> Action:
    """Greedy action (argmax per head)."""
    return Action(*(torch.argmax(x, dim=-1) for x in dist))


def log_prob(dist: Dist, action: Action) -> torch.Tensor:
    """Joint log-prob: type head always; move grids only under MOVE;
    target head under ATTACK and CAST."""
    lp = _gather(dist.type_logp, action.type)
    is_move = (action.type == ACT_MOVE).to(lp.dtype)
    is_targeted = ((action.type == ACT_ATTACK) | (action.type == ACT_CAST)).to(lp.dtype)
    lp = lp + is_move * (_gather(dist.move_x_logp, action.move_x) + _gather(dist.move_y_logp, action.move_y))
    lp = lp + is_targeted * _gather(dist.target_logp, action.target)
    return lp


def entropy(dist: Dist) -> torch.Tensor:
    """Exact entropy of the factorized joint distribution."""
    p = torch.exp(dist.type_logp)
    h = _entropy(dist.type_logp)
    h = h + p[..., ACT_MOVE] * (_entropy(dist.move_x_logp) + _entropy(dist.move_y_logp))
    h = h + (p[..., ACT_ATTACK] + p[..., ACT_CAST]) * _entropy(dist.target_logp)
    return h
