"""World state → fixed-shape feature arrays (own copy of
dotaclient_tpu/env/featurizer.py): the schema constants, the `Observation`
container and the featurizer over the port's World messages.

Shapes are static: the MAX_UNITS units nearest the controlled hero fill
the unit slots, with validity masks. `unit_mask` (slot holds a unit),
`target_mask` (legal attack target) and `action_mask` (legal action
types) are decided here on the host. Stat features are clamped, so a
corrupt world state cannot inject huge activations. Leaves are numpy on
the host; the same structure stacked to [B] or [B, T] and converted with
`ops.batch.as_tensors` is what the policy consumes.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np

from dotaclient_tpu_torch.env.heroes import hero_id_features
from dotaclient_tpu_torch.protos import worldstate as ws

# Bumped whenever a feature's meaning, order or width changes; stamped
# into checkpoints so a restore under another schema refuses loudly.
FEATURE_SCHEMA_VERSION = 3

MAX_UNITS = 16
UNIT_FEATURES = 16
N_ABILITY_SLOTS = 4
HERO_FEATURES = 16 + 3 * N_ABILITY_SLOTS + 1 + 8  # = 37
GLOBAL_FEATURES = 8

# Action-type head ordering.
ACT_NOOP, ACT_MOVE, ACT_ATTACK, ACT_CAST = 0, 1, 2, 3
N_ACTION_TYPES = 4

# Spatial normalization scales (the map is roughly ±8000 units).
_MAP_SCALE = 8000.0
_LOCAL_SCALE = 3000.0  # neighbourhood radius for unit offsets
_CREEP_WAVE_PERIOD = 30.0  # seconds between creep waves
# Every stat-derived feature is clamped to ±this.
_CLAMP = 8.0
_TARGET_TYPES = (ws.Unit.HERO, ws.Unit.LANE_CREEP, ws.Unit.JUNGLE_CREEP, ws.Unit.TOWER, ws.Unit.BARRACKS,
                 ws.Unit.FORT, ws.Unit.ROSHAN)
_BUILDING_TYPES = (ws.Unit.TOWER, ws.Unit.BARRACKS, ws.Unit.FORT)


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


def find_hero(world: ws.World, player_id: int) -> Optional[ws.Unit]:
    for u in world.units:
        if u.unit_type == ws.Unit.HERO and u.player_id == player_id:
            return u
    return None


def _sorted_others(world: ws.World, hero: ws.Unit):
    """All non-self units, nearest first: the one source of the feature
    slot ↔ unit correspondence (featurize and handles_for_slots agree)."""
    others = [u for u in world.units if u.handle != hero.handle]
    others.sort(key=lambda u: (u.x - hero.x) ** 2 + (u.y - hero.y) ** 2)
    return others[:MAX_UNITS]


def finite_or_zero(x: float) -> float:
    """0.0 for nan/±inf: the wire can carry any float bits, and math.sin /
    math.cos raise on inf."""
    return x if math.isfinite(x) else 0.0


def _sanitize(arr: np.ndarray, clamp: float) -> None:
    """In place: nan→0, ±inf→±clamp, then clip to ±clamp (np.clip alone
    passes NaN through)."""
    np.nan_to_num(arr, copy=False, nan=0.0, posinf=clamp, neginf=-clamp)
    np.clip(arr, -clamp, clamp, out=arr)


def _unit_row(u: ws.Unit, hero: ws.Unit, out: np.ndarray) -> None:
    dx = u.x - hero.x
    dy = u.y - hero.y
    dist = math.hypot(dx, dy)
    is_enemy = u.team_id != hero.team_id
    hp_max = max(u.health_max, 1.0)
    out[0] = 1.0 if is_enemy else 0.0
    out[1] = 0.0 if is_enemy else 1.0
    out[2] = 1.0 if u.unit_type == ws.Unit.HERO else 0.0
    out[3] = 1.0 if u.unit_type == ws.Unit.LANE_CREEP else 0.0
    out[4] = 1.0 if u.unit_type in _BUILDING_TYPES else 0.0
    out[5] = 1.0 if u.unit_type not in (ws.Unit.HERO, ws.Unit.LANE_CREEP) + _BUILDING_TYPES else 0.0
    out[6] = u.health / hp_max
    out[7] = math.log1p(max(u.health, 0.0)) / 8.0
    out[8] = np.clip(dx / _LOCAL_SCALE, -1.0, 1.0)
    out[9] = np.clip(dy / _LOCAL_SCALE, -1.0, 1.0)
    out[10] = min(dist / _LOCAL_SCALE, 1.0)
    out[11] = 1.0 if dist <= hero.attack_range else 0.0
    out[12] = u.attack_damage / 200.0
    out[13] = u.speed / 500.0
    out[14] = math.cos(finite_or_zero(u.facing))
    out[15] = 1.0 if u.is_alive else 0.0


def norm_gold(gold: float) -> float:
    """Gold / net-worth normalization (features and aux targets)."""
    return math.log1p(max(gold, 0)) / 10.0


def norm_last_hits(last_hits: float) -> float:
    """Last-hit count normalization (features and aux targets)."""
    return last_hits / 100.0


def castable(hero: ws.Unit) -> bool:
    """Any ability off cooldown and affordable now: the one predicate
    behind the CAST action mask and the hero features."""
    return any(
        a.is_castable and a.cooldown_remaining <= 0.0 and a.mana_cost <= hero.mana
        for a in hero.abilities
    )


def _hero_row(h: ws.Unit, out: np.ndarray) -> None:
    hp_max = max(h.health_max, 1.0)
    mana_max = max(h.mana_max, 1.0)
    out[0] = h.level / 25.0
    out[1] = h.health / hp_max
    out[2] = math.log1p(max(h.health, 0.0)) / 8.0
    out[3] = h.health_regen / 20.0
    out[4] = h.mana / mana_max
    out[5] = np.clip(h.x / _MAP_SCALE, -1.0, 1.0)
    out[6] = np.clip(h.y / _MAP_SCALE, -1.0, 1.0)
    out[7] = math.sin(finite_or_zero(h.facing))
    out[8] = math.cos(finite_or_zero(h.facing))
    out[9] = h.attack_damage / 200.0
    out[10] = h.attack_range / 1000.0
    out[11] = h.speed / 500.0
    out[12] = norm_gold(h.gold)
    out[13] = math.log1p(max(h.xp, 0)) / 10.0
    out[14] = norm_last_hits(h.last_hits)
    out[15] = 1.0 if h.is_alive else 0.0
    # per ability slot (ready, cooldown, mana cost), then any-castable and
    # the hero-identity code
    for a in h.abilities:
        s = a.slot
        if 0 <= s < N_ABILITY_SLOTS:
            base = 16 + 3 * s
            out[base + 0] = 1.0 if a.level > 0 and a.is_castable else 0.0
            out[base + 1] = min(a.cooldown_remaining / 10.0, 1.0)
            out[base + 2] = a.mana_cost / max(h.mana_max, 1.0)
    base = 16 + 3 * N_ABILITY_SLOTS
    out[base] = 1.0 if castable(h) else 0.0
    out[base + 1 : base + 9] = hero_id_features(h.name)


def featurize_with_handles(world: ws.World, player_id: int):
    """(Observation, handles) for one world state, where `handles[i]` is
    the unit handle behind feature slot i (0 = empty): one nearest-first
    sort makes both, so the target head's index → handle map cannot drift
    from the features. A hero that is absent or dead gives the zero
    observation (only NOOP legal) and zero handles."""
    hero = find_hero(world, player_id)
    obs = zeros_observation()
    gf = obs.global_feats
    t = finite_or_zero(world.dota_time)
    gf[0] = t / 600.0
    gf[1] = math.sin(2.0 * math.pi * t / _CREEP_WAVE_PERIOD)
    gf[2] = math.cos(2.0 * math.pi * t / _CREEP_WAVE_PERIOD)
    gf[3] = world.game_state / 10.0
    gf[4] = 1.0 if world.team_id == 2 else -1.0  # radiant/dire indicator
    gf[5] = world.tick / 1e5
    _sanitize(gf, _CLAMP)
    handles = np.zeros(MAX_UNITS, np.uint32)
    if hero is None or not hero.is_alive:
        return obs, handles

    _hero_row(hero, obs.hero_feats)
    for i, u in enumerate(_sorted_others(world, hero)):
        _unit_row(u, hero, obs.unit_feats[i])
        obs.unit_mask[i] = True
        handles[i] = u.handle
        obs.target_mask[i] = u.team_id != hero.team_id and u.is_alive and u.unit_type in _TARGET_TYPES
    _sanitize(obs.hero_feats, _CLAMP)
    _sanitize(obs.unit_feats, _CLAMP)

    obs.action_mask[ACT_NOOP] = True
    obs.action_mask[ACT_MOVE] = True
    obs.action_mask[ACT_ATTACK] = bool(obs.target_mask.any())
    # CAST is unit-targeted (it shares the target head): it needs a ready
    # ability and a legal target.
    obs.action_mask[ACT_CAST] = castable(hero) and bool(obs.target_mask.any())
    return obs, handles


def featurize(world: ws.World, player_id: int) -> Observation:
    """The Observation alone (see featurize_with_handles)."""
    return featurize_with_handles(world, player_id)[0]


def handles_for_slots(world: ws.World, player_id: int) -> np.ndarray:
    """The unit handle per feature slot alone (see featurize_with_handles)."""
    return featurize_with_handles(world, player_id)[1]


def stack(observations) -> Observation:
    """Stack a list of Observations along a new leading axis."""
    return Observation(*(np.stack(xs) for xs in zip(*observations)))
