"""The PPO train step on one device (torch twin of
dotaclient_tpu/parallel/train_step.py, without the mesh).

consume → teacher-forced re-eval → GAE → PPO backward → global-norm clip
→ Adam, then the caller publishes `weights_frame(state)`. The reference
compiles this into one SPMD program over a device mesh; here it is eager
PyTorch on one GPU (data parallelism is a later slice). Two shapes of
step, as in the reference:
- one update per consumed batch (ppo.epochs = ppo.minibatches = 1, the
  default);
- sample reuse: epochs × minibatches updates against advantages frozen
  from one pre-update forward, a fresh permutation per epoch, and an
  apply-then-stop approx-KL early stop.
A step updates the state's parameters and optimizer tensors in place (the
reference donates its state) and returns the new TrainState and a dict of
0-dim metric tensors on the device.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from dotaclient_tpu_torch import resolve_device
from dotaclient_tpu_torch.config import LearnerConfig
from dotaclient_tpu_torch.models.policy import PolicyNet, check_arch, init_params
from dotaclient_tpu_torch.ops.batch import TrainBatch, tree_map, zeros_train_batch
from dotaclient_tpu_torch.ops.clip_adam import AdamState, ClipAdam
from dotaclient_tpu_torch.ops.ppo import ppo_loss, ppo_minibatch_loss, precompute_reuse
from dotaclient_tpu_torch.parallel.fused_io import FusedBatchIO
from dotaclient_tpu_torch.runtime.staging import cast_obs_to_compute_dtype
from dotaclient_tpu_torch.transport.params import named_params, named_tensors
from dotaclient_tpu_torch.transport.serialize import serialize_weights


class TrainState(NamedTuple):
    net: PolicyNet  # the params live in the module
    opt_state: AdamState
    step: int  # updates applied so far; doubles as the published model version


def make_optimizer(cfg: LearnerConfig) -> ClipAdam:
    """optax.chain(clip_by_global_norm(max_grad_norm), adam(lr, eps=adam_eps))."""
    return ClipAdam(cfg.ppo.max_grad_norm, cfg.ppo.lr, cfg.ppo.adam_eps)


def init_train_state(cfg: LearnerConfig, device=None) -> TrainState:
    """Fresh params drawn from `cfg.seed` (a CPU generator, so every device
    starts from the same values), zero Adam state, step 0."""
    net = init_params(cfg.policy, torch.Generator().manual_seed(cfg.seed), resolve_device(device))
    return TrainState(net, make_optimizer(cfg).init(named_tensors(net)), 0)


def weights_frame(state: TrainState, boot_epoch: int = 0) -> bytes:
    """The DTW2 frame to publish after `state.step` updates (version 0 is
    the fresh params, published before the first batch is consumed)."""
    return serialize_weights(named_params(state.net), version=state.step, boot_epoch=boot_epoch)


def _update(net, opt: ClipAdam, opt_state: AdamState, loss_fn: Callable):
    """One gradient step: loss_fn() → (loss, metrics); grads by autograd
    (a param the loss does not reach gets zeros, as jax.grad gives);
    clip + Adam in place. Returns (opt_state', metrics with grad_norm,
    the global norm before the clip)."""
    params = named_tensors(net)
    loss, metrics = loss_fn()
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g for (n, p), g in zip(params.items(), grads)}
    opt_state, g_norm = opt.apply(params, grads, opt_state)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = g_norm
    return opt_state, metrics


def _metric_keys(cfg: LearnerConfig):
    keys = ["loss", "policy_loss", "value_loss", "entropy", "ratio_mean", "ratio_clip_frac", "approx_kl",
            "advantage_mean", "return_mean", "value_mean", "replay_trunc_frac", "grad_norm"]
    return keys + (["aux_loss"] if cfg.policy.aux_heads else [])


def epoch_permutations(cfg: LearnerConfig, step: int, device=None) -> torch.Tensor:
    """[epochs, B] int64: the reuse loop's per-epoch shuffles for update
    `step`, drawn from a CPU torch.Generator seeded from (cfg.seed, step)
    (hashed to the generator's 32-bit seed by numpy's SeedSequence), so a
    step's shuffles are the same on every device and need no rng in the
    TrainState."""
    g = torch.Generator().manual_seed(int(np.random.SeedSequence([cfg.seed, step]).generate_state(1)[0]))
    perms = torch.stack([torch.randperm(cfg.batch_size, generator=g) for _ in range(cfg.ppo.epochs)])
    return perms.to(resolve_device(device))


def build_train_step(cfg: LearnerConfig, device=None):
    """`step(state, batch) -> (state', metrics)` over a TrainBatch of
    tensors on `device` (ops.batch.as_tensors). The reuse step also takes
    `perms` ([epochs][B] indices) to replay given shuffles."""
    check_arch(cfg.policy)
    R, M = cfg.ppo.epochs, cfg.ppo.minibatches
    if R < 1 or M < 1:
        raise ValueError(f"ppo.epochs={R} and ppo.minibatches={M} must be >= 1")
    if cfg.batch_size % M:
        raise ValueError(f"batch_size={cfg.batch_size} must divide by ppo.minibatches={M}")
    opt = make_optimizer(cfg)
    device = resolve_device(device)

    if R * M == 1:

        def step_fn(state: TrainState, batch: TrainBatch):
            loss_fn = lambda: ppo_loss(state.net, batch, cfg.ppo)
            opt_state, metrics = _update(state.net, opt, state.opt_state, loss_fn)
            return TrainState(state.net, opt_state, state.step + 1), metrics

        return step_fn
    return _build_reuse_step_fn(cfg, opt, device)


def _build_reuse_step_fn(cfg: LearnerConfig, opt: ClipAdam, device):
    """The sample-reuse step: R epochs × M minibatches per consumed batch.

    Advantages and returns are frozen by one pre-update forward
    (precompute_reuse). Each epoch permutes the batch (`perms[e]`, by
    default `epoch_permutations`) and walks its M contiguous slices. With
    ppo.kl_stop > 0 the loop stops after the first update whose approx_kl
    exceeds it (apply-then-stop: that update lands). The reference decides
    this on the device with lax.cond; eager torch decides on the host, so
    each update then waits for its approx_kl (one device sync per
    minibatch, and none when kl_stop is 0). Metrics are summed over the
    updates that ran, then averaged; `ppo_updates_done` and
    `ppo_kl_stopped` say how many ran and whether the stop fired."""
    R, M, B = cfg.ppo.epochs, cfg.ppo.minibatches, cfg.batch_size
    kl_stop = cfg.ppo.kl_stop
    keys = _metric_keys(cfg)

    def step_fn(state: TrainState, batch: TrainBatch, perms: Optional[Sequence[torch.Tensor]] = None):
        rb = precompute_reuse(state.net, batch, cfg.ppo)
        if perms is None:
            perms = epoch_permutations(cfg, state.step, device)
        opt_state, n_upd, active = state.opt_state, 0, True
        summed: Dict[str, torch.Tensor] = {}
        for e in range(R):
            perm = torch.as_tensor(perms[e], device=batch.mask.device)
            shuf = tree_map(lambda x: x.index_select(0, perm), rb)
            for m in range(M):
                if not active:
                    break
                mb = tree_map(lambda x: x[m * (B // M) : (m + 1) * (B // M)], shuf)
                opt_state, mm = _update(state.net, opt, opt_state, lambda: ppo_minibatch_loss(state.net, mb, cfg.ppo))
                summed = {k: summed[k] + mm[k] for k in keys} if summed else {k: mm[k] for k in keys}
                n_upd += 1
                if kl_stop > 0 and not mm["approx_kl"].item() <= kl_stop:  # NaN stops too, as in the reference
                    active = False
        metrics = {k: v / max(n_upd, 1) for k, v in summed.items()}
        like = metrics["loss"]
        metrics["ppo_updates_done"] = torch.full_like(like, float(n_upd))
        metrics["ppo_kl_stopped"] = torch.full_like(like, 0.0 if active else 1.0)
        return TrainState(state.net, opt_state, state.step + 1), metrics

    return step_fn


def build_single_train_step(cfg: LearnerConfig, device=None):
    """Returns (step, io): the train step over the batch as ONE
    [B, row_bytes] u8 buffer on the device, the reference's default
    learner path (fused_h2d and fused_single_h2d). Host side:
    `payload = io.to_device(io.pack_transfer(cast_obs_to_compute_dtype(cfg,
    batch)))`; then `step(state, payload)`, which unpacks with views
    (FusedBatchIO.unpack_single) and runs build_train_step's step."""
    if not cfg.fused_h2d:
        raise ValueError("fused_h2d=False: the batch crosses as a tree of tensors; use build_train_step")
    if not cfg.fused_single_h2d:
        raise NotImplementedError("fused_single_h2d=False: the grouped four-buffer transfer is not ported")
    step_fn = build_train_step(cfg, device)
    if cfg.replay.enabled:
        raise ValueError(
            "fused H2D transfer is incompatible with the replay reservoir: the per-row "
            "behavior_staleness stamp is not part of the dtype-grouped transfer layout; "
            "use build_train_step"
        )
    p = cfg.policy
    template = cast_obs_to_compute_dtype(cfg, zeros_train_batch(cfg.batch_size, cfg.seq_len, p.lstm_hidden, p.aux_heads))
    io = FusedBatchIO(template, device)

    def step(state: TrainState, payload: torch.Tensor, *perms):
        return step_fn(state, io.unpack_single(payload), *perms)

    return step, io
