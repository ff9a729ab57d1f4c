"""PPO clipped-surrogate loss over the teacher-forced re-evaluation
(torch twin of dotaclient_tpu/ops/ppo.py).

Re-run the policy over the shipped sequences from the shipped initial
(c, h) (the transformer family's unroll ignores it), form ratio = exp(logp_new − logp_old), and combine clipped
surrogate + PPO2-clipped value loss + entropy bonus (+ aux), all masked
means over real steps. The metric keys are the reference's. Gradients
come through autograd; the reference's stop_gradients are `detach()`.

Data parallel across ranks (`all_reduce`, a sum over the dp group): every
masked mean divides the rank's local masked sum by the GLOBAL count of
real steps, and the advantages are normalized by the global mean and std
(ops/gae.py global_masked_moments, one all-reduce in the forward). The
loss and each metric are then this dp index's share of the global value:
summed over the dp group (train_step's gradient bucket) they are the
reference's statistics over the global batch, or minibatch. The ranks of
one dp index (the model axes) hold the same rows, so the statistics never
sum over them. `sp` (ops.ring_attention.SeqParallel) runs the transformer
unroll split over time (models/transformer_policy.py); the outputs come
back whole, so everything here is the same on every sp rank.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from dotaclient_tpu_torch.config import PPOConfig
from dotaclient_tpu_torch.ops import action_dist as ad
from dotaclient_tpu_torch.ops.batch import TrainBatch
from dotaclient_tpu_torch.ops.gae import gae, global_masked_moments, masked_mean, masked_std

AllReduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _surrogate(
    out,
    actions,
    behavior_logp,
    behavior_value,
    advantages,
    returns,
    mask,
    aux_targets,
    cfg: PPOConfig,
    aux_coef: float,
    staleness=None,
    all_reduce: AllReduce = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped surrogate + value + entropy (+aux) given a completed unroll
    `out` and fixed advantages/returns. Rows with `staleness` > 0 were
    replayed off-policy: their IS ratio is truncated at
    cfg.replay_rho_bar (ACER's c-bar) before the surrogate; fresh rows and
    staleness=None use the raw ratio. With `all_reduce` the statistics are
    global and the loss and metrics this rank's shares (module doc)."""
    T = actions.type.shape[1]
    values = out.value  # [B, T+1]
    dist_t = ad.Dist(*(x[:, :T] for x in out.dist))

    new_logp = ad.log_prob(dist_t, actions)
    ratio = torch.exp(new_logp - behavior_logp)

    if all_reduce is None:
        count = torch.clamp(mask.sum(), min=1.0)
        adv_mean, adv_std = masked_mean(advantages, mask), masked_std(advantages, mask)
    else:
        count, adv_mean, adv_std = global_masked_moments(advantages, mask, all_reduce)

    def mean(x):  # a masked mean over the (global) count of real steps
        return (x * mask).sum() / count

    norm_adv = (advantages - adv_mean) / adv_std
    norm_adv = (norm_adv * mask).detach()

    if staleness is not None:
        stale_row = (staleness > 0.0).to(ratio.dtype)[:, None]  # [B, 1] over T
        surr_ratio = torch.where(stale_row > 0, torch.clamp(ratio, max=cfg.replay_rho_bar), ratio)
        trunc_frac = mean((stale_row * (ratio > cfg.replay_rho_bar)).float())
    else:
        surr_ratio = ratio
        trunc_frac = torch.zeros((), dtype=torch.float32, device=ratio.device)

    unclipped = surr_ratio * norm_adv
    clipped = torch.clamp(surr_ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * norm_adv
    policy_loss = -mean(torch.minimum(unclipped, clipped))

    v_pred = values[:, :T]
    v_clipped = behavior_value + torch.clamp(v_pred - behavior_value, -cfg.value_clip, cfg.value_clip)
    v_err = torch.maximum((v_pred - returns) ** 2, (v_clipped - returns) ** 2)
    value_loss = 0.5 * mean(v_err)

    entropy = mean(ad.entropy(dist_t))

    loss = policy_loss + cfg.value_coef * value_loss - cfg.entropy_coef * entropy

    metrics = {
        "loss": loss,
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "entropy": entropy,
        "ratio_mean": mean(ratio),
        "ratio_clip_frac": mean(((ratio - 1.0).abs() > cfg.clip_eps).float()),
        "approx_kl": mean(behavior_logp - new_logp),
        "advantage_mean": mean(advantages),
        "return_mean": mean(returns),
        "value_mean": mean(v_pred),
        "replay_trunc_frac": trunc_frac,
    }

    if aux_targets is not None and out.aux is not None:
        aux_t = type(out.aux)(*(x[:, :T] for x in out.aux))
        win_prob_loss = mean(
            # ±1 labels → BCE on the win logit; 0 labels mean "unknown yet"
            torch.where(
                aux_targets.win != 0.0,
                torch.logaddexp(torch.zeros_like(aux_t.win_logit), -aux_targets.win * aux_t.win_logit),
                torch.zeros_like(aux_t.win_logit),
            )
        )
        lh_loss = mean((aux_t.last_hit - aux_targets.last_hit) ** 2)
        nw_loss = mean((aux_t.net_worth - aux_targets.net_worth) ** 2)
        aux_loss = win_prob_loss + lh_loss + nw_loss
        loss = loss + aux_coef * aux_loss
        metrics["loss"] = loss
        metrics["aux_loss"] = aux_loss

    return loss, metrics


def ppo_loss(net, batch: TrainBatch, cfg: PPOConfig, aux_coef: float = 0.25, all_reduce: AllReduce = None, sp=None):
    """Returns (scalar loss, metrics dict). `net` is a PolicyNet and
    `batch` a TrainBatch of tensors on the net's device (ops.batch.as_tensors).
    One forward serves both GAE (detached) and the surrogate. `all_reduce`:
    the batch is this dp index's share of the global one; `sp`: the unroll
    split over time (module doc)."""
    mask = batch.mask
    _, out = net(batch.initial_state, batch.obs, unroll=True, sp=sp)
    advantages, returns = gae(batch.rewards, out.value.detach(), batch.dones, mask, cfg.gamma, cfg.gae_lambda)
    return _surrogate(
        out,
        batch.actions,
        batch.behavior_logp,
        batch.behavior_value,
        advantages,
        returns,
        mask,
        batch.aux,
        cfg,
        aux_coef,
        staleness=batch.behavior_staleness,
        all_reduce=all_reduce,
    )


class ReuseBatch(NamedTuple):
    """A consumed batch with advantages/returns frozen from the pre-update
    policy: what the epochs × minibatches reuse loop shuffles and slices
    (classic PPO computes GAE once per batch, not once per update)."""

    obs: object
    actions: object
    behavior_logp: torch.Tensor
    behavior_value: torch.Tensor
    advantages: torch.Tensor
    returns: torch.Tensor
    mask: torch.Tensor
    initial_state: tuple
    aux: object  # AuxTargets or None
    staleness: Optional[torch.Tensor] = None  # [B] replay staleness stamp, or None


def precompute_reuse(net, batch: TrainBatch, cfg: PPOConfig, sp=None) -> ReuseBatch:
    """One forward with the current (pre-update) params → frozen
    advantages/returns for the whole reuse loop."""
    with torch.no_grad():
        _, out = net(batch.initial_state, batch.obs, unroll=True, sp=sp)
        advantages, returns = gae(batch.rewards, out.value, batch.dones, batch.mask, cfg.gamma, cfg.gae_lambda)
    return ReuseBatch(
        obs=batch.obs,
        actions=batch.actions,
        behavior_logp=batch.behavior_logp,
        behavior_value=batch.behavior_value,
        advantages=advantages,
        returns=returns,
        mask=batch.mask,
        initial_state=batch.initial_state,
        aux=batch.aux,
        staleness=batch.behavior_staleness,
    )


def ppo_minibatch_loss(net, mb: ReuseBatch, cfg: PPOConfig, aux_coef: float = 0.25, all_reduce: AllReduce = None,
                       sp=None):
    """The reuse loop's per-update loss: a fresh forward on the minibatch,
    surrogate against the frozen advantages/returns (normalized over the
    minibatch, every dp index's share of it with `all_reduce`)."""
    _, out = net(mb.initial_state, mb.obs, unroll=True, sp=sp)
    return _surrogate(
        out,
        mb.actions,
        mb.behavior_logp,
        mb.behavior_value,
        mb.advantages,
        mb.returns,
        mb.mask,
        mb.aux,
        cfg,
        aux_coef,
        staleness=mb.staleness,
        all_reduce=all_reduce,
    )
