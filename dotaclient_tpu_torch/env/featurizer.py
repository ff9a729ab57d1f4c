"""Feature-schema constants and the fixed-shape `Observation` container.

A copy of the schema half of dotaclient_tpu/env/featurizer.py; turning
protobuf worldstates into features lands with the actor slice. Leaves are
numpy on the host; the same structure stacked to [B] or [B, T] and
converted with `ops.batch.as_tensors` is what the policy consumes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

MAX_UNITS = 16
UNIT_FEATURES = 16
N_ABILITY_SLOTS = 4
HERO_FEATURES = 16 + 3 * N_ABILITY_SLOTS + 1 + 8  # = 37
GLOBAL_FEATURES = 8

# Action-type head ordering.
ACT_NOOP, ACT_MOVE, ACT_ATTACK, ACT_CAST = 0, 1, 2, 3
N_ACTION_TYPES = 4


class Observation(NamedTuple):
    """One featurized observation; every leaf has a static shape."""

    global_feats: np.ndarray  # [GLOBAL_FEATURES] f32
    hero_feats: np.ndarray  # [HERO_FEATURES] f32
    unit_feats: np.ndarray  # [MAX_UNITS, UNIT_FEATURES] f32
    unit_mask: np.ndarray  # [MAX_UNITS] bool — slot holds a unit
    target_mask: np.ndarray  # [MAX_UNITS] bool — legal attack target
    action_mask: np.ndarray  # [N_ACTION_TYPES] bool — legal action types


def zeros_observation() -> Observation:
    action_mask = np.zeros(N_ACTION_TYPES, bool)
    action_mask[ACT_NOOP] = True
    return Observation(
        global_feats=np.zeros(GLOBAL_FEATURES, np.float32),
        hero_feats=np.zeros(HERO_FEATURES, np.float32),
        unit_feats=np.zeros((MAX_UNITS, UNIT_FEATURES), np.float32),
        unit_mask=np.zeros(MAX_UNITS, bool),
        target_mask=np.zeros(MAX_UNITS, bool),
        action_mask=action_mask,
    )


def stack(observations) -> Observation:
    """Stack a list of Observations along a new leading axis."""
    return Observation(*(np.stack(xs) for xs in zip(*observations)))
