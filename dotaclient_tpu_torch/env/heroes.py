"""Hero registry: the 1v1 hero pool with per-hero stat profiles (own copy
of dotaclient_tpu/env/heroes.py).

BASELINE config 3 is "1v1 hero-pool self-play with a shared LSTM": one
policy plays many heroes, conditioned on who it is playing. The reference
passes hero names straight through to Dota (`GameConfig.hero_picks`,
SURVEY.md §2 env protos); the stats below drive the fake env's MDP and
the identity features the shared policy conditions on.

Two identity signals reach the policy:
- the stat profile itself (hp/damage/range/speed flow through the
  existing worldstate→feature path — a melee hero FEELS different);
- an 8-dim hashed embedding of the hero name (stable across processes,
  no vocabulary to sync — new heroes get a deterministic code for free).
"""

from __future__ import annotations

import functools
import hashlib
from typing import Dict, NamedTuple

import numpy as np

HERO_ID_DIM = 8


class HeroProfile(NamedTuple):
    hp: float
    damage: float
    attack_range: float
    speed: float
    regen: float


DEFAULT_HERO = "npc_dota_hero_nevermore"

# A laning-relevant spread: ranged glass cannons, long-range pokers, and
# tanky melee bruisers. Values are coarse 2018-era level-1 ballparks — the
# MDP needs contrast between heroes, not patch-accurate numbers.
HEROES: Dict[str, HeroProfile] = {
    # nevermore keeps the legacy single-hero MDP's exact stats (range 600)
    # so pre-pool TrueSkill/win-rate curves stay comparable
    "npc_dota_hero_nevermore": HeroProfile(hp=650, damage=53, attack_range=600, speed=310, regen=4.0),
    "npc_dota_hero_drow_ranger": HeroProfile(hp=600, damage=58, attack_range=625, speed=300, regen=3.0),
    "npc_dota_hero_sniper": HeroProfile(hp=570, damage=45, attack_range=550, speed=290, regen=3.0),
    "npc_dota_hero_lina": HeroProfile(hp=580, damage=52, attack_range=670, speed=295, regen=3.5),
    "npc_dota_hero_viper": HeroProfile(hp=620, damage=50, attack_range=575, speed=280, regen=4.5),
    "npc_dota_hero_axe": HeroProfile(hp=700, damage=55, attack_range=150, speed=310, regen=5.5),
    "npc_dota_hero_sven": HeroProfile(hp=660, damage=62, attack_range=150, speed=325, regen=4.5),
    "npc_dota_hero_bloodseeker": HeroProfile(hp=640, damage=60, attack_range=150, speed=300, regen=5.0),
}


def profile(name: str) -> HeroProfile:
    """Stat profile for `name`; unknown names get the default hero's
    (the real dotaservice would reject them — the fake env shrugs)."""
    return HEROES.get(name, HEROES[DEFAULT_HERO])


def parse_pool(spec: str) -> list[str]:
    """An ActorConfig.hero value is one name or a comma-separated pool."""
    names = [n.strip() for n in spec.split(",") if n.strip()]
    return names or [DEFAULT_HERO]


@functools.lru_cache(maxsize=None)
def hero_id_features(name: str, dim: int = HERO_ID_DIM) -> np.ndarray:
    """Deterministic ±1 code for a hero name (md5-seeded, process- and
    language-stable — NOT python hash(), which is salted per process).
    Cached and read-only: this runs once per observation in the actor hot
    loop, and callers only ever copy it into their feature rows."""
    if not name:
        code = np.zeros(dim, np.float32)
    else:
        digest = hashlib.md5(name.encode()).digest()
        bits = np.unpackbits(np.frombuffer(digest, np.uint8))[:dim]
        code = bits.astype(np.float32) * 2.0 - 1.0
    code.setflags(write=False)
    return code
