"""The PPO train step (torch twin of dotaclient_tpu/parallel/train_step.py).

consume → teacher-forced re-eval → GAE → PPO backward → global-norm clip
→ Adam, then the caller publishes `weights_frame(state)`. The reference
compiles this into one SPMD program over a device mesh; here it is eager
PyTorch, one process per card, and the mesh is laid over the ranks
(parallel/mesh.py, parallel/dist.py). Two shapes of step, as in the
reference:
- one update per consumed batch (ppo.epochs = ppo.minibatches = 1, the
  default);
- sample reuse: epochs × minibatches updates against advantages frozen
  from one pre-update forward, a fresh permutation per epoch, and an
  apply-then-stop approx-KL early stop.
The batch reaches the step as a tree of tensors (build_train_step), or as
transfer buffers the step unpacks: four dtype groups
(build_fused_train_step) or one u8 buffer (build_single_train_step). A
step updates the state's parameters and optimizer tensors in place (the
reference donates its state) and returns the new TrainState and a dict of
0-dim metric tensors on the device.

Over the ranks (`dist`), each rank brings its B / world rows:
- the ranks of one dp index (the model axes) gather theirs, so each trains
  on that dp index's B / dp rows, the global batch being the dp indices'
  rows in rank order;
- the loss statistics are global over the dp group (ops/ppo.py), and each
  update all-reduces one flat bucket of the gradients and the metrics
  before the clip, so the clip, `grad_norm` and every metric are global;
- sequence parallelism (`policy.tf_sp_axis`, the transformer family):
  each sp rank unrolls its block of the frames and the outputs are
  gathered along time (ops/ring_attention.py). Each sp rank's gradient is
  then the part that its block produced, and the bucket is summed over the
  dp and sp ranks; the metrics, the same on every sp rank, come from sp
  rank 0 alone;
- tensor parallelism (a tp axis, `shard_state`): each tp rank keeps its
  column slices of the sharded params and Adam moments
  (transport/params.py TensorShards); before each forward the tp group
  gathers the whole leaves, the forward and backward run replicated over
  tp on the same rows (the reference's tp devices see the same batch too),
  the norm is the whole gradient's and Adam runs on the slices.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from dotaclient_tpu_torch import resolve_device
from dotaclient_tpu_torch.config import LearnerConfig
from dotaclient_tpu_torch.models.policy import PolicyNet, check_arch, init_params
from dotaclient_tpu_torch.ops.batch import TrainBatch, tree_map, zeros_train_batch
from dotaclient_tpu_torch.ops.clip_adam import AdamState, ClipAdam
from dotaclient_tpu_torch.ops.ppo import ppo_loss, ppo_minibatch_loss, precompute_reuse
from dotaclient_tpu_torch.ops.ring_attention import SP_MODES, SeqParallel
from dotaclient_tpu_torch.parallel.dist import Dist, Group
from dotaclient_tpu_torch.parallel.fused_io import FusedBatchIO
from dotaclient_tpu_torch.parallel.mesh import local_config
from dotaclient_tpu_torch.runtime.staging import cast_obs_to_compute_dtype
from dotaclient_tpu_torch.transport.params import TensorShards, host_named, named_tensors, state_tensors
from dotaclient_tpu_torch.transport.serialize import serialize_weights


class TrainState(NamedTuple):
    net: PolicyNet  # the params live in the module
    opt_state: AdamState
    step: int  # updates applied so far; doubles as the published model version
    tp: Optional[TensorShards] = None  # the tp layout of the sharded leaves; None: every leaf whole


def make_optimizer(cfg: LearnerConfig) -> ClipAdam:
    """optax.chain(clip_by_global_norm(max_grad_norm), adam(lr, eps=adam_eps))."""
    return ClipAdam(cfg.ppo.max_grad_norm, cfg.ppo.lr, cfg.ppo.adam_eps)


def init_train_state(cfg: LearnerConfig, device=None) -> TrainState:
    """Fresh params drawn from `cfg.seed` (a CPU generator, so every device
    starts from the same values), zero Adam state, step 0."""
    net = init_params(cfg.policy, torch.Generator().manual_seed(cfg.seed), resolve_device(device))
    return TrainState(net, make_optimizer(cfg).init(named_tensors(net)), 0)


@torch.no_grad()
def shard_state(state: TrainState, dist: Dist) -> TrainState:
    """`state` (whole leaves) laid over `dist`'s tp group: this rank keeps
    its column slices of the sharded params and Adam moments. The same
    state without a tp axis of two or more."""
    group = dist.group("tp")
    if group.size == 1:
        return state
    params = named_tensors(state.net)
    tp = TensorShards(group, {n: tuple(p.shape) for n, p in params.items()})
    for n, p in params.items():
        p.data = tp.shard(n, p.data)
    opt = state.opt_state
    cut = lambda moments: {n: tp.shard(n, t) for n, t in moments.items()}
    return state._replace(opt_state=AdamState(opt.count, cut(opt.mu), cut(opt.nu)), tp=tp)


def whole_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """flax name -> the whole param; under tp gathered over the tp group (a
    collective: every tp rank calls it)."""
    return state_tensors(state.net, tp=state.tp)


def weights_frame(state: TrainState, boot_epoch: int = 0) -> bytes:
    """The DTW2 frame to publish after `state.step` updates (version 0 is
    the fresh params, published before the first batch is consumed)."""
    return serialize_weights(host_named(whole_params(state)), version=state.step, boot_epoch=boot_epoch)


def is_sequence_parallel(cfg: LearnerConfig, axes: Dict[str, int]) -> bool:
    """THE definition of 'sp is active', as the reference's: used by the
    builders and by the Learner's fused-vs-tree choice. Raises on a
    tf_sp_axis that names no mesh axis (silent disablement would
    masquerade as a perf bug); the LSTM family ignores the axis."""
    sp = cfg.policy.tf_sp_axis
    if sp and sp not in axes:
        raise ValueError(
            f"tf_sp_axis={sp!r} names no axis of mesh {dict(axes)!r} — sequence parallelism would be silently "
            f"disabled; add the axis to --mesh_shape or clear tf_sp_axis"
        )
    return cfg.policy.arch == "transformer" and bool(sp)


def _whole(state: TrainState):
    """The net holds its whole leaves inside the block (tp), else as is."""
    return state.tp.gathered(state.net) if state.tp is not None else contextlib.nullcontext()


def _update(state: TrainState, opt: ClipAdam, opt_state: AdamState, loss_fn: Callable, red: Group,
            own_metrics: bool):
    """One gradient step: loss_fn() → (loss, metrics) on the whole params;
    grads by autograd (a param the loss does not reach gets zeros, as
    jax.grad gives); one all-reduce over `red` of a flat bucket of the
    grads and the metrics (zeros where `own_metrics` is off); clip + Adam in
    place, on the slices under tp with the whole gradient's norm. Returns
    (opt_state', metrics with grad_norm: the global norm before the clip)."""
    with _whole(state):
        params = named_tensors(state.net)
        loss, metrics = loss_fn()
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params.values(), grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    if red.size > 1:
        values = torch.stack(list(metrics.values())).float()
        if not own_metrics:
            values = torch.zeros_like(values)
        bucket = torch.cat([g.reshape(-1).float() for g in grads] + [values])
        parts = red.all_reduce_(bucket).split([g.numel() for g in grads] + [len(metrics)])
        grads = [x.view_as(g).to(g.dtype) for x, g in zip(parts, grads)]
        metrics = dict(zip(metrics, parts[-1].unbind()))
    grads = dict(zip(params, grads))
    kw = {}
    if state.tp is not None:
        kw["g_norm"] = ClipAdam.global_norm([grads[n] for n in opt_state.mu])
        grads = {n: state.tp.shard(n, g) for n, g in grads.items()}
    opt_state, g_norm = opt.apply(named_tensors(state.net), grads, opt_state, **kw)
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


class _Plan(NamedTuple):
    """Where a step's collectives run (module doc)."""

    rows: Group  # the ranks of this dp index: gather their rows
    dp: Group  # the loss statistics, the reuse step's frozen batch
    red: Group  # the gradient bucket
    own_metrics: bool  # this rank's metrics go into the bucket
    sp: Optional[SeqParallel]


def _plan(cfg: LearnerConfig, dist: Dist) -> _Plan:
    """The reference's build-time validation (`_build_core`, and the
    multi-process learner's batch split), then the groups of the step."""
    dp, world = dist.layout.size("dp"), dist.world
    if cfg.batch_size % dp:
        raise ValueError(f"batch_size={cfg.batch_size} must be divisible by the mesh dp axis ({dp}); adjust "
                         f"--batch_size or --mesh_shape")
    if cfg.batch_size % world:
        raise ValueError(f"batch_size={cfg.batch_size} must divide by the process count ({world}) — each host "
                         f"stages an equal share")
    sp_axis = cfg.policy.tf_sp_axis
    use_sp = is_sequence_parallel(cfg, dist.axes)
    if use_sp:
        n = dist.axes[sp_axis]
        if (cfg.seq_len + 1) % n:
            raise ValueError(f"sequence parallelism: seq_len+1={cfg.seq_len + 1} frames must divide by mesh axis "
                             f"{sp_axis}={n} (pick seq_len = k*{n}-1)")
        if cfg.policy.tf_sp_mode not in SP_MODES:
            raise ValueError(f"unknown tf_sp_mode {cfg.policy.tf_sp_mode!r} (ring|ulysses)")
        if cfg.policy.tf_sp_mode == "ulysses" and cfg.policy.tf_heads % n:
            raise ValueError(f"ulysses: tf_heads={cfg.policy.tf_heads} not divisible by mesh axis {sp_axis}={n} "
                             f"(use tf_sp_mode='ring')")
    R, M = cfg.ppo.epochs, cfg.ppo.minibatches
    if R < 1 or M < 1:
        raise ValueError(f"ppo.epochs={R} and ppo.minibatches={M} must be >= 1")
    if cfg.batch_size % M:
        raise ValueError(f"batch_size={cfg.batch_size} must divide by ppo.minibatches={M}")
    if (cfg.batch_size // M) % dp:
        raise ValueError(f"minibatch size {cfg.batch_size // M} (batch_size/minibatches) must divide by the mesh dp "
                         f"axis ({dp}) so each update stays dp-sharded")
    if not use_sp:
        return _Plan(dist.model, dist.group("dp"), dist.group("dp"), True, None)
    sp = dist.group(sp_axis)
    return _Plan(dist.model, dist.group("dp"), dist.group("dp", sp_axis), sp.index == 0,
                 SeqParallel(sp, cfg.policy.tf_sp_mode))


def _check_layout(state: TrainState, dist: Dist) -> None:
    if dist.group("tp").size > 1 and state.tp is None:
        raise ValueError("the mesh has a tp axis but the state's leaves are whole: lay it out with shard_state")


def build_train_step(cfg: LearnerConfig, device=None, dist: Optional[Dist] = None):
    """`step(state, batch) -> (state', metrics)` over a TrainBatch of
    tensors on `device` (ops.batch.as_tensors): the whole batch, or this
    rank's B / world rows of it with `dist` (a tp axis needs the state
    from `shard_state`). The reuse step also takes `perms` ([epochs][B]
    indices into the global batch) to replay given shuffles. Either policy
    family; sequence parallelism with `policy.tf_sp_axis`."""
    check_arch(cfg.policy)
    dist = dist if dist is not None else Dist()
    plan = _plan(cfg, dist)
    opt = make_optimizer(cfg)
    device = resolve_device(device)
    stats = plan.dp.all_reduce_ if plan.dp.size > 1 else None

    if cfg.ppo.epochs * cfg.ppo.minibatches == 1:

        def step_fn(state: TrainState, batch: TrainBatch):
            _check_layout(state, dist)
            batch = plan.rows.all_gather_rows(batch)
            loss_fn = lambda: ppo_loss(state.net, batch, cfg.ppo, all_reduce=stats, sp=plan.sp)
            opt_state, metrics = _update(state, opt, state.opt_state, loss_fn, plan.red, plan.own_metrics)
            return state._replace(opt_state=opt_state, step=state.step + 1), metrics

        return step_fn
    return _build_reuse_step_fn(cfg, opt, device, dist, plan, stats)


def _build_reuse_step_fn(cfg: LearnerConfig, opt: ClipAdam, device, dist: Dist, plan: _Plan, stats):
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
    `ppo_kl_stopped` say how many ran and whether the stop fired.

    Across the dp group the permutation is the reference's global one (the
    same generator on every rank): each dp index precomputes its own rows,
    the frozen batch is gathered over the dp group in rank order (the global
    batch), and dp index k trains on the k-th of dp equal parts of each
    minibatch. The minibatch's statistics are global (ops/ppo.py), its
    gradient and metrics all-reduced, so the KL stop reads the global
    approx_kl and every rank stops after the same update."""
    R, M, B = cfg.ppo.epochs, cfg.ppo.minibatches, cfg.batch_size
    share = B // M // plan.dp.size  # rows of each minibatch on this dp index
    lo = plan.dp.index * share
    kl_stop = cfg.ppo.kl_stop
    keys = _metric_keys(cfg)

    def step_fn(state: TrainState, batch: TrainBatch, perms: Optional[Sequence[torch.Tensor]] = None):
        _check_layout(state, dist)
        batch = plan.rows.all_gather_rows(batch)
        with _whole(state):
            rb = plan.dp.all_gather_rows(precompute_reuse(state.net, batch, cfg.ppo, sp=plan.sp))
        if perms is None:
            perms = epoch_permutations(cfg, state.step, device)
        opt_state, n_upd, active = state.opt_state, 0, True
        summed: Dict[str, torch.Tensor] = {}
        for e in range(R):
            perm = torch.as_tensor(perms[e], device=batch.mask.device)
            for m in range(M):
                if not active:
                    break
                rows = perm[m * (B // M) + lo : m * (B // M) + lo + share]
                mb = tree_map(lambda x: x.index_select(0, rows), rb)
                loss_fn = lambda: ppo_minibatch_loss(state.net, mb, cfg.ppo, all_reduce=stats, sp=plan.sp)
                opt_state, mm = _update(state, opt, opt_state, loss_fn, plan.red, plan.own_metrics)
                summed = {k: summed[k] + mm[k] for k in keys} if summed else {k: mm[k] for k in keys}
                n_upd += 1
                if kl_stop > 0 and not mm["approx_kl"].item() <= kl_stop:  # NaN stops too, as in the reference
                    active = False
        metrics = {k: v / max(n_upd, 1) for k, v in summed.items()}
        like = metrics["loss"]
        metrics["ppo_updates_done"] = torch.full_like(like, float(n_upd))
        metrics["ppo_kl_stopped"] = torch.full_like(like, 0.0 if active else 1.0)
        return state._replace(opt_state=opt_state, step=state.step + 1), metrics

    return step_fn


def batch_template(cfg: LearnerConfig) -> TrainBatch:
    """The TrainBatch staging emits for `cfg` (zeros, obs in the staged
    dtype): with replay on it carries the [B] f32 behavior_staleness stamp,
    so every layout derived from it does too."""
    p = cfg.policy
    return cast_obs_to_compute_dtype(
        cfg, zeros_train_batch(cfg.batch_size, cfg.seq_len, p.lstm_hidden, p.aux_heads, with_staleness=cfg.replay.enabled)
    )


def _build_fused(cfg: LearnerConfig, device, single: bool, dist: Optional[Dist]):
    """The two fused-transfer builders' shared body: one FusedBatchIO of
    the staged template in the requested layout, sized at this rank's
    B / N rows, and build_train_step's step behind its unpack."""
    if not cfg.fused_h2d:
        raise ValueError("fused_h2d=False: the batch crosses as a tree of tensors; use build_train_step")
    step_fn = build_train_step(cfg, device, dist)
    if is_sequence_parallel(cfg, (dist if dist is not None else Dist()).axes):
        raise ValueError(f"{'single-buffer' if single else 'fused'} H2D transfer is incompatible with sequence "
                         f"parallelism (tf_sp_axis set); use build_train_step")
    if cfg.replay.enabled:
        raise ValueError(
            "fused H2D transfer is incompatible with the replay reservoir: the per-row "
            "behavior_staleness stamp is not part of the dtype-grouped transfer layout; "
            "use build_train_step"
        )
    io = FusedBatchIO(batch_template(local_config(cfg, dist.world if dist is not None else 1)), device, single=single)
    unpack = io.unpack_single if single else io.unpack

    def step(state: TrainState, payload, *perms):
        return step_fn(state, unpack(payload), *perms)

    return step, io


def build_fused_train_step(cfg: LearnerConfig, device=None, dist: Optional[Dist] = None):
    """Returns (step, io): the train step over the batch as FOUR
    dtype-grouped [B, cols] buffers (`fused_single_h2d` off; B / N rows
    on each of `dist`'s ranks). Host side:
    `payload = io.consume(*io.transfer(io.pack_transfer(batch)))`, one copy per
    group on the io's side stream; the step unpacks with column views
    (FusedBatchIO.unpack) and runs build_train_step's step."""
    return _build_fused(cfg, device, single=False, dist=dist)


def build_single_train_step(cfg: LearnerConfig, device=None, dist: Optional[Dist] = None):
    """Returns (step, io): the train step over the batch as ONE
    [B, row_bytes] u8 buffer on the device (B / N rows on each of
    `dist`'s ranks), the reference's default learner path (fused_h2d and
    fused_single_h2d). Host side:
    `payload = io.consume(*io.transfer(io.pack_transfer(
    cast_obs_to_compute_dtype(cfg, batch))))`, the copy on the io's side
    stream and the current stream ordered after it; then
    `step(state, payload)`, which unpacks with views
    (FusedBatchIO.unpack_single) and runs build_train_step's step."""
    return _build_fused(cfg, device, single=True, dist=dist)
