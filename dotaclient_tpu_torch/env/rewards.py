"""Shaped component rewards from consecutive world-state deltas (own copy
of dotaclient_tpu/env/rewards.py): a weighted sum of the xp, hp, mana,
last-hit, deny, kill/death and enemy-tower-damage deltas, plus a terminal
win bonus. Host-side Python, once per env step on the actor."""

from __future__ import annotations

import math
from typing import Dict, Optional

from dotaclient_tpu_torch.env.featurizer import find_hero, finite_or_zero
from dotaclient_tpu_torch.protos import worldstate as ws

REWARD_WEIGHTS: Dict[str, float] = {
    "xp": 0.002,  # per xp point
    "hp": 0.5,  # per health fraction
    "mana": 0.25,  # per mana fraction
    "last_hits": 0.16,
    "denies": 0.15,
    "kills": 0.5,
    "deaths": -0.5,
    "tower_hp": 1.0,  # per enemy-tower health fraction destroyed
    "win": 2.5,
}


def _tower_hp_frac(world: ws.World, enemy_team: int) -> float:
    total = 0.0
    for u in world.units:
        if u.team_id == enemy_team and u.unit_type in (ws.Unit.TOWER, ws.Unit.FORT, ws.Unit.BARRACKS):
            total += u.health / max(u.health_max, 1.0)
    return total


def component_rewards(
    prev: Optional[ws.World],
    world: ws.World,
    player_id: int,
    last_hero: Optional[ws.Unit] = None,
) -> Dict[str, float]:
    """Per-component reward deltas for `player_id` between two observations.

    `prev` None (the first step) gives zero deltas except `win`. A dead
    hero contributes through its deaths counter, not an hp delta. When the
    hero is missing from `prev`, `last_hero` (the last snapshot of it the
    caller saw) stands in, so counter deltas across the gap are kept. A
    non-finite component (a corrupt float on the wire) counts zero.
    """
    out = {k: 0.0 for k in REWARD_WEIGHTS}
    hero = find_hero(world, player_id)
    prev_hero = find_hero(prev, player_id) if prev is not None else None
    if prev_hero is None:
        prev_hero = last_hero

    if world.winning_team:
        out["win"] = 1.0 if world.winning_team == world.team_id else -1.0

    if hero is None or prev_hero is None:
        return out

    out["xp"] = float(hero.xp - prev_hero.xp)
    if hero.is_alive and prev_hero.is_alive:
        hp_frac = hero.health / max(hero.health_max, 1.0)
        prev_hp_frac = prev_hero.health / max(prev_hero.health_max, 1.0)
        out["hp"] = hp_frac - prev_hp_frac
        mana_frac = hero.mana / max(hero.mana_max, 1.0)
        prev_mana_frac = prev_hero.mana / max(prev_hero.mana_max, 1.0)
        out["mana"] = mana_frac - prev_mana_frac
    out["last_hits"] = float(hero.last_hits - prev_hero.last_hits)
    out["denies"] = float(hero.denies - prev_hero.denies)
    out["kills"] = float(hero.kills - prev_hero.kills)
    out["deaths"] = float(hero.deaths - prev_hero.deaths)

    if prev is not None:
        enemy_team = 3 if hero.team_id == 2 else 2
        out["tower_hp"] = _tower_hp_frac(prev, enemy_team) - _tower_hp_frac(world, enemy_team)
    return {k: finite_or_zero(v) for k, v in out.items()}


def total_reward(components: Dict[str, float]) -> float:
    return math.fsum(REWARD_WEIGHTS[k] * v for k, v in components.items())


def reward(
    prev: Optional[ws.World],
    world: ws.World,
    player_id: int,
    last_hero: Optional[ws.Unit] = None,
) -> float:
    return total_reward(component_rewards(prev, world, player_id, last_hero))
