"""Fixed-shape training batch (torch twin of dotaclient_tpu/ops/batch.py,
plus the random-batch generator of dotaclient_tpu/parallel/train_step.py).

Shape conventions (B sequences, T action steps):
- `obs` leaves are [B, T+1, ...]: slot T holds the bootstrap observation,
  so the teacher-forced unroll yields V(s_t) for t in [0, T] at once;
- everything else is [B, T]; `mask[b, t]` marks real steps;
- `initial_state` is the actor-side (c, h) at the chunk start.

Batches are built as numpy on the host (the wire/staging contract) and
moved to the device with `as_tensors`, which maps float leaves to f32,
integer leaves to int64 (torch gathers index with int64) and bool leaves
to torch.bool.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dotaclient_tpu_torch import resolve_device
from dotaclient_tpu_torch.config import LearnerConfig
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.env.featurizer import Observation
from dotaclient_tpu_torch.ops.action_dist import Action


class BatchLayoutError(ValueError):
    """A batch or transfer layout disagrees with its template or config
    (shape, dtype, width): a builder/staging mismatch that would fail
    every batch, unlike one malformed frame."""


class AuxTargets(NamedTuple):
    """Targets for the auxiliary value heads."""

    win: object  # [B, T] — ±1 final result (0 while unknown)
    last_hit: object  # [B, T] — normalized last-hit count
    net_worth: object  # [B, T] — normalized net worth


class TrainBatch(NamedTuple):
    obs: Observation  # leaves [B, T+1, ...]
    actions: Action  # leaves [B, T]
    behavior_logp: object  # [B, T] f32 — actor-side joint log-prob
    behavior_value: object  # [B, T] f32 — actor-side value estimate
    rewards: object  # [B, T] f32
    dones: object  # [B, T] f32 — 1.0 where the episode terminated
    mask: object  # [B, T] f32 — 1.0 on real steps
    initial_state: tuple  # (c, h) each [B, H] f32
    aux: Optional[AuxTargets] = None  # present iff the policy has aux heads
    # [B] f32 behavior-policy staleness (> 0 on replayed rows); None when
    # replay is off.
    behavior_staleness: Optional[object] = None


def zeros_train_batch(B: int, T: int, lstm_hidden: int, with_aux: bool, with_staleness: bool = False) -> TrainBatch:
    """The canonical all-zeros numpy TrainBatch. Padded rows keep NOOP
    legal in the action mask so masked log-softmax stays uniform-safe."""
    obs = Observation(
        global_feats=np.zeros((B, T + 1, F.GLOBAL_FEATURES), np.float32),
        hero_feats=np.zeros((B, T + 1, F.HERO_FEATURES), np.float32),
        unit_feats=np.zeros((B, T + 1, F.MAX_UNITS, F.UNIT_FEATURES), np.float32),
        unit_mask=np.zeros((B, T + 1, F.MAX_UNITS), bool),
        target_mask=np.zeros((B, T + 1, F.MAX_UNITS), bool),
        action_mask=np.tile(F.zeros_observation().action_mask, (B, T + 1, 1)),
    )
    z = np.zeros((B, T), np.float32)
    zi = np.zeros((B, T), np.int32)
    return TrainBatch(
        obs=obs,
        actions=Action(type=zi.copy(), move_x=zi.copy(), move_y=zi.copy(), target=zi.copy()),
        behavior_logp=z.copy(),
        behavior_value=z.copy(),
        rewards=z.copy(),
        dones=z.copy(),
        mask=z.copy(),
        initial_state=(np.zeros((B, lstm_hidden), np.float32), np.zeros((B, lstm_hidden), np.float32)),
        aux=AuxTargets(win=z.copy(), last_hit=z.copy(), net_worth=z.copy()) if with_aux else None,
        behavior_staleness=np.zeros((B,), np.float32) if with_staleness else None,
    )


def make_train_batch(cfg: LearnerConfig, rng_seed: int = 0, with_staleness: bool = False) -> TrainBatch:
    """Random but self-consistent numpy batch. Draws the numpy
    RandomState(rng_seed) stream in the reference's exact order, so the
    same seed gives the reference's batch value for value."""
    r = np.random.RandomState(rng_seed)
    B, T = cfg.batch_size, cfg.seq_len
    U = F.MAX_UNITS
    unit_mask = r.rand(B, T + 1, U) < 0.6
    target_mask = unit_mask & (r.rand(B, T + 1, U) < 0.5)
    action_mask = np.ones((B, T + 1, F.N_ACTION_TYPES), bool)
    action_mask[..., F.ACT_ATTACK] = target_mask.any(-1)
    action_mask[..., F.ACT_CAST] = False
    obs = Observation(
        global_feats=r.randn(B, T + 1, F.GLOBAL_FEATURES).astype(np.float32),
        hero_feats=r.randn(B, T + 1, F.HERO_FEATURES).astype(np.float32),
        unit_feats=r.randn(B, T + 1, U, F.UNIT_FEATURES).astype(np.float32),
        unit_mask=unit_mask,
        target_mask=target_mask,
        action_mask=action_mask,
    )
    lengths = r.randint(max(1, T // 2), T + 1, size=B)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    dones = np.zeros((B, T), np.float32)
    dones[r.rand(B) < 0.3, -1] = 1.0
    dones *= mask
    # Only legal actions: ATTACK only where a target exists, targets
    # drawn from the valid slots.
    can_attack = target_mask[:, :T].any(-1)
    atype = r.randint(0, 2, size=(B, T)).astype(np.int32)
    atype = np.where(can_attack & (r.rand(B, T) < 0.33), F.ACT_ATTACK, atype).astype(np.int32)
    first_valid = np.argmax(target_mask[:, :T], axis=-1).astype(np.int32)
    target = np.where(can_attack, first_valid, 0).astype(np.int32)
    H = cfg.policy.lstm_hidden
    aux = (
        AuxTargets(
            win=np.sign(r.randn(B, T)).astype(np.float32),
            last_hit=r.rand(B, T).astype(np.float32),
            net_worth=r.rand(B, T).astype(np.float32),
        )
        if cfg.policy.aux_heads
        else None
    )
    return TrainBatch(
        obs=obs,
        actions=Action(
            type=atype,
            move_x=r.randint(0, cfg.policy.n_move_bins, (B, T)).astype(np.int32),
            move_y=r.randint(0, cfg.policy.n_move_bins, (B, T)).astype(np.int32),
            target=target,
        ),
        behavior_logp=(-1.5 + 0.1 * r.randn(B, T)).astype(np.float32),
        behavior_value=r.randn(B, T).astype(np.float32) * 0.1,
        rewards=r.randn(B, T).astype(np.float32) * 0.1 * mask,
        dones=dones,
        mask=mask,
        initial_state=(np.zeros((B, H), np.float32), np.zeros((B, H), np.float32)),
        aux=aux,
        behavior_staleness=np.zeros((B,), np.float32) if with_staleness else None,
    )


def tree_map(fn, tree):
    """Apply `fn` to every leaf of a NamedTuple/tuple tree; None stays None
    (as `jax.tree.map` treats it: no leaf)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        vals = [tree_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree)


_LEAF = "*"


def tree_flatten(tree):
    """(leaves, structure) in `jax.tree.flatten`'s order: NamedTuple fields
    in declaration order, depth first, None dropped. `structure` compares
    equal for trees of the same shape and rebuilds with `tree_unflatten`."""
    leaves = []

    def leaf(x):
        leaves.append(x)
        return _LEAF

    return leaves, tree_map(leaf, tree)


def tree_unflatten(structure, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), structure)


def _leaf_to_tensor(x, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.bool_:
        dt = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dt = torch.int64
    else:
        dt = torch.float32
    return torch.as_tensor(a).to(device=device, dtype=dt)


def as_tensors(tree, device=None):
    """Map a numpy NamedTuple/tuple tree (Observation, TrainBatch, …) to
    torch tensors on `device` (default: the current CUDA device)."""
    device = resolve_device(device)
    return tree_map(lambda x: _leaf_to_tensor(x, device), tree)
