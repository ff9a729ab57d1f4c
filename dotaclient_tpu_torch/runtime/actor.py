"""Actor-side policy step (torch twin of the inference half of
dotaclient_tpu/runtime/actor.py): policy forward + masked Gumbel-max
sample + joint log-prob in one call, gradients off.

The batched step keeps the reference's `lax.map` contract: each row runs
as its own B=1 step, in sequence, with its own generator, so a row's
state, action, logp and value are bitwise its `make_actor_step` result
whatever other envs share the tick (the occupancy invariance partial
batches rely on). A row's inputs are copied out first, so a row computes
from freshly allocated tensors wherever it sits in the tick.
"""

from __future__ import annotations

from typing import Sequence

import torch

from dotaclient_tpu_torch.config import PolicyConfig
from dotaclient_tpu_torch.models.policy import check_arch
from dotaclient_tpu_torch.ops import action_dist as ad
from dotaclient_tpu_torch.ops.batch import tree_map


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
    """M-row tick for a vectorized fleet or the serve tier:
    `step(net, state, obs, generators)` with stacked per-env (state, obs)
    rows ([M, ...] leaves) and one generator per row → per-row (state',
    action, logp, value), stacked. Row i is `make_actor_step`'s result on
    (state[i:i+1], obs[i:i+1], generators[i]), bit for bit."""
    check_arch(cfg)

    def step(net, state, obs, generators: Sequence[torch.Generator]):
        M = obs.unit_feats.shape[0]
        if len(generators) != M:
            raise ValueError(f"batched actor step: {M} rows but {len(generators)} generators")
        rows = [
            _actor_step_row(net, *tree_map(lambda x: x[i : i + 1].clone(), (state, obs)), generators[i])
            for i in range(M)
        ]
        states, actions, logps, values = zip(*rows)
        state = tuple(torch.cat(s) for s in zip(*states))
        return state, ad.Action(*(torch.cat(a) for a in zip(*actions))), torch.cat(logps), torch.cat(values)

    return step
