"""Actor-side policy step (torch twin of the inference half of
dotaclient_tpu/runtime/actor.py): policy forward + masked Gumbel-max
sample + joint log-prob in one call, gradients off.

The reference's batched step runs each row through `lax.map` so a row is
bitwise the B=1 step whatever else shares the tick. This port batches
the rows in one forward instead: a row agrees with its B=1 step within
the float tolerance of a batched matmul, not bitwise.
"""

from __future__ import annotations

import torch

from dotaclient_tpu_torch.config import PolicyConfig
from dotaclient_tpu_torch.models.policy import check_arch
from dotaclient_tpu_torch.ops import action_dist as ad


def _actor_step_row(net, state, obs, generator: torch.Generator):
    with torch.no_grad():
        new_state, out = net(state, obs)
        action = ad.sample(generator, out.dist)
        logp = ad.log_prob(out.dist, action)
    return new_state, action, logp, out.value


def make_actor_step(cfg: PolicyConfig):
    """Single-env step: `step(net, state, obs, generator)` with obs leaves
    [1, ...] → (state', action, logp, value). The generator lives on the
    net's device and advances with every draw."""
    check_arch(cfg)
    return _actor_step_row


def make_batched_actor_step(cfg: PolicyConfig):
    """M-row tick for a vectorized fleet or the serve tier: stacked
    per-env (state, obs) rows in ([M, ...] leaves), per-row (state',
    action, logp, value) out, one forward for the whole tick; one
    generator draws every row's noise."""
    check_arch(cfg)
    return _actor_step_row
