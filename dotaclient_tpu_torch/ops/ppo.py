"""PPO clipped-surrogate loss over the teacher-forced LSTM re-evaluation
(torch twin of dotaclient_tpu/ops/ppo.py, forward).

Re-run the policy over the shipped sequences from the shipped initial
(c, h), form ratio = exp(logp_new − logp_old), and combine clipped
surrogate + PPO2-clipped value loss + entropy bonus (+ aux), all masked
means over real steps. The metric keys are the reference's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from dotaclient_tpu_torch.config import PPOConfig
from dotaclient_tpu_torch.ops import action_dist as ad
from dotaclient_tpu_torch.ops.batch import TrainBatch
from dotaclient_tpu_torch.ops.gae import gae, masked_mean, masked_std


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
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped surrogate + value + entropy (+aux) given a completed unroll
    `out` and fixed advantages/returns. Rows with `staleness` > 0 were
    replayed off-policy: their IS ratio is truncated at
    cfg.replay_rho_bar (ACER's c-bar) before the surrogate; fresh rows and
    staleness=None use the raw ratio."""
    T = actions.type.shape[1]
    values = out.value  # [B, T+1]
    dist_t = ad.Dist(*(x[:, :T] for x in out.dist))

    new_logp = ad.log_prob(dist_t, actions)
    ratio = torch.exp(new_logp - behavior_logp)

    norm_adv = (advantages - masked_mean(advantages, mask)) / masked_std(advantages, mask)
    norm_adv = (norm_adv * mask).detach()

    if staleness is not None:
        stale_row = (staleness > 0.0).to(ratio.dtype)[:, None]  # [B, 1] over T
        surr_ratio = torch.where(stale_row > 0, torch.clamp(ratio, max=cfg.replay_rho_bar), ratio)
        trunc_frac = masked_mean((stale_row * (ratio > cfg.replay_rho_bar)).float(), mask)
    else:
        surr_ratio = ratio
        trunc_frac = torch.zeros((), dtype=torch.float32, device=ratio.device)

    unclipped = surr_ratio * norm_adv
    clipped = torch.clamp(surr_ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * norm_adv
    policy_loss = -masked_mean(torch.minimum(unclipped, clipped), mask)

    v_pred = values[:, :T]
    v_clipped = behavior_value + torch.clamp(v_pred - behavior_value, -cfg.value_clip, cfg.value_clip)
    v_err = torch.maximum((v_pred - returns) ** 2, (v_clipped - returns) ** 2)
    value_loss = 0.5 * masked_mean(v_err, mask)

    entropy = masked_mean(ad.entropy(dist_t), mask)

    loss = policy_loss + cfg.value_coef * value_loss - cfg.entropy_coef * entropy

    metrics = {
        "loss": loss,
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "entropy": entropy,
        "ratio_mean": masked_mean(ratio, mask),
        "ratio_clip_frac": masked_mean(((ratio - 1.0).abs() > cfg.clip_eps).float(), mask),
        "approx_kl": masked_mean(behavior_logp - new_logp, mask),
        "advantage_mean": masked_mean(advantages, mask),
        "return_mean": masked_mean(returns, mask),
        "value_mean": masked_mean(v_pred, mask),
        "replay_trunc_frac": trunc_frac,
    }

    if aux_targets is not None and out.aux is not None:
        aux_t = type(out.aux)(*(x[:, :T] for x in out.aux))
        win_prob_loss = masked_mean(
            # ±1 labels → BCE on the win logit; 0 labels mean "unknown yet"
            torch.where(
                aux_targets.win != 0.0,
                torch.logaddexp(torch.zeros_like(aux_t.win_logit), -aux_targets.win * aux_t.win_logit),
                torch.zeros_like(aux_t.win_logit),
            ),
            mask,
        )
        lh_loss = masked_mean((aux_t.last_hit - aux_targets.last_hit) ** 2, mask)
        nw_loss = masked_mean((aux_t.net_worth - aux_targets.net_worth) ** 2, mask)
        aux_loss = win_prob_loss + lh_loss + nw_loss
        loss = loss + aux_coef * aux_loss
        metrics["loss"] = loss
        metrics["aux_loss"] = aux_loss

    return loss, metrics


def ppo_loss(net, batch: TrainBatch, cfg: PPOConfig, aux_coef: float = 0.25):
    """Returns (scalar loss, metrics dict). `net` is a PolicyNet and
    `batch` a TrainBatch of tensors on the net's device (ops.batch.as_tensors).
    One forward serves both GAE (detached) and the surrogate."""
    mask = batch.mask
    _, out = net(batch.initial_state, batch.obs, unroll=True)
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
    )
