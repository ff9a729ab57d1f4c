"""Masked Generalized Advantage Estimation (torch twin of
dotaclient_tpu/ops/gae.py). `values` has T+1 entries per row, the last
being the bootstrap value; padded steps contribute exactly nothing. The
reverse-time scan is a Python loop over T (16 on the learner path).

Across data-parallel ranks (parallel/dist.py) a masked statistic is taken
over every dp index's real steps, not over each rank's own:
`global_masked_moments` reads the count, mean and std of the union
through one all-reduce over the dp group (the ranks of one dp index hold
the same rows, so a sum over them would count each row again)."""

from __future__ import annotations

from typing import Callable, Tuple

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


def global_masked_moments(x: torch.Tensor, mask: torch.Tensor, all_reduce: Callable[[torch.Tensor], torch.Tensor],
                          eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(max(count, 1), mean, std) of `x` over the real steps of every
    rank: masked_mean / masked_std of the ranks' rows taken together.
    Σmask, Σmask·x and Σmask·x² cross in one all-reduce, in float64 so the
    one-pass variance keeps the two-pass one's f32 accuracy. Detached."""
    m, v = mask.detach().double(), x.detach().double()
    n, s1, s2 = all_reduce(torch.stack([m.sum(), (v * m).sum(), (v * v * m).sum()])).unbind()
    count = torch.clamp(n, min=1.0)
    mean = s1 / count
    var = torch.clamp((s2 - 2.0 * mean * s1 + mean * mean * n) / count, min=0.0)
    dtype = x.dtype
    return count.to(dtype), mean.to(dtype), torch.sqrt(var + eps).to(dtype)
