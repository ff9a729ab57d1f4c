"""Masked Generalized Advantage Estimation (torch twin of
dotaclient_tpu/ops/gae.py). `values` has T+1 entries per row, the last
being the bootstrap value; padded steps contribute exactly nothing. The
reverse-time scan is a Python loop over T (16 on the learner path)."""

from __future__ import annotations

from typing import Tuple

import torch


def gae(
    rewards: torch.Tensor,  # [B, T]
    values: torch.Tensor,  # [B, T+1] — includes bootstrap value
    dones: torch.Tensor,  # [B, T]
    mask: torch.Tensor,  # [B, T]
    gamma: float,
    lam: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (advantages [B, T], returns [B, T]); padded steps are 0."""
    nonterminal = 1.0 - dones
    delta = (rewards + gamma * nonterminal * values[:, 1:] - values[:, :-1]) * mask
    T = rewards.shape[1]
    carry = torch.zeros_like(rewards[:, 0])
    adv = [None] * T
    for t in reversed(range(T)):
        carry = (delta[:, t] + gamma * lam * nonterminal[:, t] * carry) * mask[:, t]
        adv[t] = carry
    advantages = torch.stack(adv, dim=1)
    returns = advantages + values[:, :-1] * mask
    return advantages, returns


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def masked_std(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    mean = masked_mean(x, mask)
    var = masked_mean((x - mean) ** 2, mask)
    return torch.sqrt(var + eps)
