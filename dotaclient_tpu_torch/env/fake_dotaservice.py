"""In-process fake dotaservice (own copy of
dotaclient_tpu/env/fake_dotaservice.py): a synthetic 1v1-mid MDP behind the
DotaService API, on the port's own messages.

The same game, step for step: for one GameConfig and one action sequence
it emits the reference fake env's world states, byte for byte
(tests/test_torch_env.py). Served in-process through
`LocalDotaServiceStub`, or over gRPC by `main`
(`python -m dotaclient_tpu_torch.env.fake_dotaservice`, the k8s fake-env
sidecar's twin).

The MDP ("last-hit lane"): two heroes face each other over a two-sided
creep lane.

- Both teams' creep waves spawn every 30 dota-seconds and advance toward
  the enemy side; each wave chips the opposing wave down, opening
  last-hit windows: killing blows grant last_hits, gold and xp.
- Each hero is policy-controlled or scripted, per
  `GameConfig.hero_picks[].control_mode`:
    0 = scripted (passive laner: trades when the enemy hero is close,
        otherwise holds its side of the lane);
    1 = policy-controlled (actions applied per player_id from `act`);
    2 = scripted HARD (also last-hits low creeps in range and retreats at
        low hp).
- Standing in range of enemies bleeds hp.
- Killing the enemy hero wins; at max_dota_time the higher net worth
  (gold+xp) wins.

`observe` advances the world only when the requesting team has already
seen the current tick, so two teams each observing per tick step it once.
All randomness flows from GameConfig.seed (`np.random.RandomState`, drawn
in the reference's order).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional

import numpy as np

from dotaclient_tpu_torch.env import heroes
from dotaclient_tpu_torch.env.service import DotaServiceServicer
from dotaclient_tpu_torch.protos import dotaservice as ds
from dotaclient_tpu_torch.protos import worldstate as ws

TEAM_RADIANT, TEAM_DIRE = 2, 3

# Scripted-AI control modes (HeroPick.control_mode values).
CONTROL_SCRIPTED = 0
CONTROL_POLICY = 1
CONTROL_SCRIPTED_HARD = 2

RADIANT_PLAYER, DIRE_PLAYER = 0, 5

# Dota player-slot convention: radiant 0-4, dire 5-9. Hero handles are
# 1+player_id (creep handles start at 100, far above).
_TEAM_BASE = {TEAM_RADIANT: RADIANT_PLAYER, TEAM_DIRE: DIRE_PLAYER}
_MAX_TEAM_SIZE = 5
# lane y-offsets fanning a team's heroes out around the mid lane
_SPAWN_SPREAD = (0.0, -140.0, 140.0, -280.0, 280.0)
_TICKS_PER_SEC = 30.0

_CREEP_HP = 550.0
_CREEP_DMG = 21.0
# Hero stats live in env/heroes.py profiles (per-pick); creeps below.
_WAVE_PERIOD = 30.0
_CREEP_AGGRO_RADIUS = 150.0
_ENEMY_PURSUE_RADIUS = 700.0
_WAVE_SIZE = 4
_XP_PER_CREEP = 60
_GOLD_PER_CREEP = 40

# One targeted nuke in slot 0 for every hero (the CAST action path). A burst that beats
# auto-attack dps while it's off cooldown, priced in mana so spamming it
# starves future casts; worth learning, not strictly dominant.
_ABILITY_ID = 5059
_ABILITY_SLOT = 0
_ABILITY_MANA_COST = 90.0
_ABILITY_COOLDOWN = 8.0
_ABILITY_DAMAGE = 160.0
_ABILITY_CAST_RANGE = 600.0
_HERO_MANA = 300.0
_HERO_MANA_REGEN = 1.5


class _Unit:
    __slots__ = (
        "handle",
        "unit_type",
        "team",
        "x",
        "y",
        "hp",
        "hp_max",
        "alive",
        "player_id",
        "name",
        "damage",
        "atk_range",
        "move_speed",
        "regen",
        "mana",
        "mana_max",
        "mana_regen",
        "next_cast_time",
    )

    def __init__(
        self,
        handle,
        unit_type,
        team,
        x,
        y,
        hp,
        player_id=-1,
        name="",
        damage=_CREEP_DMG,
        atk_range=120.0,
        move_speed=325.0,
        regen=0.0,
    ):
        self.handle = handle
        self.unit_type = unit_type
        self.team = team
        self.x, self.y = x, y
        self.hp = self.hp_max = hp
        self.alive = True
        self.player_id = player_id
        self.name = name
        self.damage = damage
        self.atk_range = atk_range
        self.move_speed = move_speed
        self.regen = regen
        # ability state (heroes only; creeps keep zero mana and never cast)
        self.mana = self.mana_max = _HERO_MANA if unit_type == ws.Unit.HERO else 0.0
        self.mana_regen = _HERO_MANA_REGEN if unit_type == ws.Unit.HERO else 0.0
        self.next_cast_time = 0.0


class LastHitLaneGame:
    """Pure-python MDP state; stepped by FakeDotaService."""

    def __init__(self, config: ds.GameConfig):
        self.rng = np.random.RandomState(config.seed or 0)
        self.dt = max(config.ticks_per_observation, 1) / _TICKS_PER_SEC
        self.max_time = config.max_dota_time if config.max_dota_time > 0 else 120.0
        self.dota_time = 0.0
        self.tick = 0
        self.next_handle = 100
        self.next_wave_time = 0.0
        self.winning_team = 0  # 0 while running, and still 0 on a draw
        self.ended = False
        # Hero picks: one pick = one hero; N picks per team = NvN (5v5).
        # Player ids assign per Dota convention — radiant 0..4, dire 5..9,
        # in pick order. Teams with no picks get
        # the legacy 1v1 default (radiant policy vs dire scripted).
        picks_by_team = {TEAM_RADIANT: [], TEAM_DIRE: []}
        for pick in config.hero_picks:
            if pick.team_id in picks_by_team and len(picks_by_team[pick.team_id]) < _MAX_TEAM_SIZE:
                picks_by_team[pick.team_id].append(pick)

        self.heroes: Dict[int, _Unit] = {}
        self.stats_by: Dict[int, dict] = {}
        self.control: Dict[int, int] = {}
        self._xp_trickle: Dict[int, float] = {}
        # Ground-truth action accounting: per-player action-type counts, plus casts
        # that actually FIRED (in range, off cooldown, mana paid).
        self.action_counts: Dict[int, Dict[int, int]] = {}
        self.casts_landed: Dict[int, int] = {}
        for team, picks in picks_by_team.items():
            sign = -1.0 if team == TEAM_RADIANT else 1.0
            default_control = CONTROL_POLICY if team == TEAM_RADIANT else CONTROL_SCRIPTED
            if not picks:
                picks = [None]
            for i, pick in enumerate(picks):
                pid = _TEAM_BASE[team] + i
                name = pick.hero_name if pick is not None and pick.hero_name else heroes.DEFAULT_HERO
                prof = heroes.profile(name)
                self.heroes[pid] = _Unit(
                    1 + pid,
                    ws.Unit.HERO,
                    team,
                    sign * 1500.0,
                    _SPAWN_SPREAD[i],
                    prof.hp,
                    player_id=pid,
                    name=name,
                    damage=prof.damage,
                    atk_range=prof.attack_range,
                    move_speed=prof.speed,
                    regen=prof.regen,
                )
                self.stats_by[pid] = {"xp": 0, "gold": 600, "last_hits": 0, "denies": 0, "kills": 0, "deaths": 0}
                self.control[pid] = pick.control_mode if pick is not None else default_control
                self._xp_trickle[pid] = 0.0
        # 1v1 aliases (first hero of each side) — the scripted retreat
        # logic, worldstate stats and several tests address them directly
        self.hero = self.heroes[RADIANT_PLAYER]
        self.enemy_hero = self.heroes[DIRE_PLAYER]
        self.stats = self.stats_by[RADIANT_PLAYER]
        self.enemy_stats = self.stats_by[DIRE_PLAYER]
        self.creeps: list[_Unit] = []
        # pending action per player, applied on next step
        self.pending: Dict[int, ds.Action] = {}
        # highest tick each team has been served (observe steps the world
        # only when the requesting team is already up to date)
        self.seen_tick: Dict[int, int] = {TEAM_RADIANT: -1, TEAM_DIRE: -1}
        # per-game lock so N peers step their games concurrently
        self.lock = threading.Lock()
        self._maybe_spawn_wave()

    # ------------------------------------------------------------- stepping

    def step(self) -> None:
        """Advance the world by one observation interval."""
        if self.ended:
            return
        dt = self.dt
        self.dota_time += dt
        self.tick += int(dt * _TICKS_PER_SEC)
        self._maybe_spawn_wave()
        for pid in self.heroes:
            if self.control[pid] == CONTROL_POLICY:
                self._apply_hero_action(pid, dt)
            else:
                self._scripted_hero(pid, dt, hard=self.control[pid] == CONTROL_SCRIPTED_HARD)
        self._creep_combat(dt)
        self._regen(dt)
        self._check_end()

    def _maybe_spawn_wave(self) -> None:
        if self.dota_time >= self.next_wave_time:
            self.next_wave_time += _WAVE_PERIOD
            for team in (TEAM_DIRE, TEAM_RADIANT):
                sign = -1.0 if team == TEAM_RADIANT else 1.0
                for i in range(_WAVE_SIZE):
                    x = sign * (200.0 + 40.0 * i) + self.rng.uniform(-20, 20)
                    y = self.rng.uniform(-120, 120)
                    self.creeps.append(
                        _Unit(self.next_handle, ws.Unit.LANE_CREEP, team, x, y, _CREEP_HP)
                    )
                    self.next_handle += 1

    # ------------------------------------------------------------ hero acts

    def _deal_damage(self, pid: int, target: _Unit, dmg: float) -> None:
        """Apply damage from `pid`'s hero; killing blows credit its stats."""
        h = self.heroes[pid]
        stats = self.stats_by[pid]
        target.hp -= max(dmg, 0.0)
        if target.hp <= 0:
            target.alive = False
            if target.unit_type == ws.Unit.LANE_CREEP:
                if target.team != h.team:
                    stats["last_hits"] += 1
                    stats["gold"] += _GOLD_PER_CREEP
                    stats["xp"] += _XP_PER_CREEP
                else:  # denied own creep: counter only, no gold/xp
                    stats["denies"] += 1
            elif target.unit_type == ws.Unit.HERO:
                stats["kills"] += 1
                self.stats_by[target.player_id]["deaths"] += 1

    def _hero_attack(self, pid: int, target: _Unit, dt: float) -> None:
        """Attack-or-approach; killing blows credit `pid`'s stats."""
        h = self.heroes[pid]
        if self._dist(h, target) <= h.atk_range:
            self._deal_damage(pid, target, h.damage * dt * 1.4 * (1.0 + 0.1 * self.rng.randn()))
        else:
            self._move_toward(h, target.x, target.y, h.move_speed * dt)

    def _hero_cast(self, pid: int, target: _Unit, dt: float) -> None:
        """Slot-0 nuke: burst damage at cast range, gated on cooldown and
        mana; out of range approaches (like attack), not-ready is a no-op
        (the featurizer's castable mask makes not-ready unsampleable for
        policy heroes, so the no-op only guards scripted/raw callers)."""
        h = self.heroes[pid]
        if self.dota_time < h.next_cast_time or h.mana < _ABILITY_MANA_COST:
            return
        if self._dist(h, target) <= _ABILITY_CAST_RANGE:
            h.mana -= _ABILITY_MANA_COST
            h.next_cast_time = self.dota_time + _ABILITY_COOLDOWN
            self.casts_landed[pid] = self.casts_landed.get(pid, 0) + 1
            self._deal_damage(pid, target, _ABILITY_DAMAGE)
        else:
            self._move_toward(h, target.x, target.y, h.move_speed * dt)

    def _apply_hero_action(self, pid: int, dt: float) -> None:
        act = self.pending.pop(pid, None)
        h = self.heroes[pid]
        if not h.alive or act is None:
            return
        per = self.action_counts.setdefault(pid, {})
        per[act.type] = per.get(act.type, 0) + 1
        if act.type == ds.Action.MOVE:
            self._move_toward(h, act.move_x, act.move_y, h.move_speed * dt)
        elif act.type == ds.Action.ATTACK:
            target = self._find(act.target_handle)
            if target is not None and target.alive and target is not h:
                self._hero_attack(pid, target, dt)
        elif act.type == ds.Action.CAST and act.ability_slot == _ABILITY_SLOT:
            target = self._find(act.target_handle)
            if target is not None and target.alive and target is not h:
                self._hero_cast(pid, target, dt)

    def _scripted_hero(self, pid: int, dt: float, hard: bool = False) -> None:
        """Scripted laner. Base: trade with the enemy hero when close,
        otherwise hold lane. Hard additionally retreats at low hp and
        last-hits low-hp enemy creeps in range (it farms, so beating it
        on net worth requires genuinely better laning)."""
        me = self.heroes[pid]
        if not me.alive:
            return
        # nearest living enemy hero (NvN-aware; None once they're all down)
        foes = [h for h in self.heroes.values() if h.team != me.team and h.alive]
        foe = min(foes, key=lambda f: self._dist(me, f)) if foes else None
        home_x = -1200.0 if me.team == TEAM_RADIANT else 1200.0
        if hard and me.hp < 0.25 * me.hp_max:
            self._move_toward(me, home_x * 1.3, 0.0, me.move_speed * dt)
            return
        if hard:
            lastable = [
                c
                for c in self.creeps
                if c.alive
                and c.team != me.team
                and c.hp <= 2.2 * me.damage * dt * 1.4
                and self._dist(me, c) <= me.atk_range
            ]
            if lastable:
                self._hero_attack(pid, min(lastable, key=lambda c: c.hp), dt)
                return
        if foe is not None and self._dist(me, foe) <= me.atk_range:
            self._hero_attack(pid, foe, dt)
        elif foe is not None and self._dist(me, foe) < _ENEMY_PURSUE_RADIUS:
            self._move_toward(me, foe.x, foe.y, me.move_speed * 0.8 * dt)
        else:
            # hold position on its own side — diving it is punished,
            # farming the creep line in the middle of the lane is safe
            self._move_toward(me, home_x, 0.0, me.move_speed * 0.5 * dt)

    # ---------------------------------------------------------- creep phase

    def _creep_combat(self, dt: float) -> None:
        # Opposing waves chip each other down (aggregate dps — opens
        # last-hit windows); creeps poke enemy heroes within aggro radius.
        for c in self.creeps:
            if not c.alive:
                continue
            c.hp -= (14.0 + 6.0 * self.rng.rand()) * dt  # opposing-wave dps
            if c.hp <= 0:
                c.alive = False  # chipped down by the wave — no credit
                continue
            goal_x = -800.0 if c.team == TEAM_DIRE else 800.0
            self._move_toward(c, goal_x, 0.0, 40.0 * dt)
            for h in self.heroes.values():
                if h.alive and h.team != c.team and self._dist(c, h) <= _CREEP_AGGRO_RADIUS:
                    h.hp -= _CREEP_DMG * dt * 0.2
                    if h.hp <= 0:
                        h.alive = False
                        self.stats_by[h.player_id]["deaths"] += 1
        self.creeps = [c for c in self.creeps if c.alive and abs(c.x) < 1800.0]

    def _regen(self, dt: float) -> None:
        for pid, u in self.heroes.items():
            if u.alive:
                u.hp = min(u.hp + u.regen * dt, u.hp_max)
                u.mana = min(u.mana + u.mana_regen * dt, u.mana_max)
            # passive xp trickle so standing safely far away is weakly
            # positive (float-accumulated so the rate survives any dt, then
            # credited in whole points since the proto field is integral)
            self._xp_trickle[pid] += 2.0 * dt
            whole = int(self._xp_trickle[pid])
            if whole:
                self.stats_by[pid]["xp"] += whole
                self._xp_trickle[pid] -= whole

    def _team_net_worth(self, team: int) -> int:
        return sum(
            self.stats_by[pid]["gold"] + self.stats_by[pid]["xp"]
            for pid, h in self.heroes.items()
            if h.team == team
        )

    def _check_end(self) -> None:
        rad_alive = any(h.alive for h in self.heroes.values() if h.team == TEAM_RADIANT)
        dire_alive = any(h.alive for h in self.heroes.values() if h.team == TEAM_DIRE)
        if not rad_alive:
            self.winning_team, self.ended = TEAM_DIRE, True
        elif not dire_alive:
            self.winning_team, self.ended = TEAM_RADIANT, True
        elif self.dota_time >= self.max_time:
            mine = self._team_net_worth(TEAM_RADIANT)
            theirs = self._team_net_worth(TEAM_DIRE)
            self.ended = True
            if mine != theirs:  # exact tie = draw (winning_team stays 0) —
                # mirror self-play with identical play must not hand
                # radiant a free TrueSkill win
                self.winning_team = TEAM_RADIANT if mine > theirs else TEAM_DIRE

    # ------------------------------------------------------------- helpers

    def _find(self, handle: int) -> Optional[_Unit]:
        for h in self.heroes.values():
            if h.handle == handle:
                return h
        for c in self.creeps:
            if c.handle == handle:
                return c
        return None

    @staticmethod
    def _dist(a: _Unit, b: _Unit) -> float:
        return math.hypot(a.x - b.x, a.y - b.y)

    @staticmethod
    def _move_toward(u: _Unit, x: float, y: float, dist: float) -> None:
        dx, dy = x - u.x, y - u.y
        norm = math.hypot(dx, dy)
        if norm <= dist or norm == 0:
            u.x, u.y = x, y
        else:
            u.x += dx / norm * dist
            u.y += dy / norm * dist

    # ---------------------------------------------------------- worldstate

    def worldstate(self, team_id: int) -> ws.World:
        w = ws.World(
            dota_time=self.dota_time,
            game_state=5,
            tick=self.tick,
            team_id=team_id,
            winning_team=self.winning_team,
        )
        w.player_ids.extend(pid for pid, h in self.heroes.items() if h.team == team_id)
        for pid, u in self.heroes.items():
            stats = self.stats_by[pid]
            w.units.add(
                handle=u.handle,
                unit_type=ws.Unit.HERO,
                team_id=u.team,
                player_id=u.player_id,
                name=u.name,
                x=u.x,
                y=u.y,
                health=max(u.hp, 0.0),
                health_max=u.hp_max,
                health_regen=u.regen,
                mana=u.mana,
                mana_max=u.mana_max,
                attack_damage=u.damage,
                attack_range=u.atk_range,
                speed=u.move_speed,
                is_alive=u.alive,
                level=1 + stats["xp"] // 240,
                gold=stats["gold"],
                xp=stats["xp"],
                last_hits=stats.get("last_hits", 0),
                denies=stats.get("denies", 0),
                kills=stats["kills"],
                deaths=stats["deaths"],
                abilities=[
                    ws.Ability(
                        ability_id=_ABILITY_ID,
                        slot=_ABILITY_SLOT,
                        level=1,
                        cooldown_remaining=max(0.0, u.next_cast_time - self.dota_time),
                        mana_cost=_ABILITY_MANA_COST,
                        is_castable=True,
                    )
                ],
            )
        for c in self.creeps:
            w.units.add(
                handle=c.handle,
                unit_type=ws.Unit.LANE_CREEP,
                team_id=c.team,
                x=c.x,
                y=c.y,
                health=max(c.hp, 0.0),
                health_max=c.hp_max,
                attack_damage=c.damage,
                attack_range=c.atk_range,
                speed=c.move_speed,
                is_alive=c.alive,
            )
        return w


class FakeDotaService(DotaServiceServicer):
    """gRPC servicer wrapping LastHitLaneGame.

    The dotaservice loop semantics:
    `reset` starts a fresh game and returns the first observation;
    `act` queues per-player actions; `observe` returns the requesting
    team's worldstate, advancing the world one observation interval only
    when that team is already up to date with the current tick (so in
    self-play, two teams observing per tick step the world exactly once).
    Trace replay (feeding recorded real-game protos) plugs in here later
    by swapping LastHitLaneGame for a trace reader.
    """

    _MAX_SESSIONS = 1024

    def __init__(self):
        self._lock = threading.Lock()
        # One independent game per gRPC peer, so N actors can share one
        # fake server without interleaving each other's episodes (the real
        # dotaservice is one-game-per-instance; peers emulate instances).
        self._games: Dict[str, LastHitLaneGame] = {}
        # Lifetime action telemetry, accumulated from finished/evicted
        # games (per-player-id across all sessions) — ground truth for
        # ability-usage evidence.
        self.total_action_counts: Dict[int, Dict[int, int]] = {}
        self.total_casts_landed: Dict[int, int] = {}

    def _fold_counters(self, game: "LastHitLaneGame") -> None:
        """Accumulate a retiring game's action telemetry (holding _lock).
        The game's own lock guards its counter dicts against a stepping
        thread (another peer's game can be evicted mid-step)."""
        with game.lock:
            counts = {pid: dict(per) for pid, per in game.action_counts.items()}
            casts = dict(game.casts_landed)
        for pid, per in counts.items():
            tot = self.total_action_counts.setdefault(pid, {})
            for t, n in per.items():
                tot[t] = tot.get(t, 0) + n
        for pid, n in casts.items():
            self.total_casts_landed[pid] = self.total_casts_landed.get(pid, 0) + n

    def action_telemetry(self):
        """(action_counts, casts_landed) per player id, totals INCLUDING
        live sessions — the ground-truth read for ability-usage evidence.
        Live games are snapshotted under their own locks: a concurrent
        _apply_hero_action inserting a key mid-iteration would otherwise
        raise 'dictionary changed size' or tear counts."""
        with self._lock:
            tot_a = {p: dict(d) for p, d in self.total_action_counts.items()}
            tot_c = dict(self.total_casts_landed)
            games = list(self._games.values())
        for game in games:
            with game.lock:
                counts = {pid: dict(per) for pid, per in game.action_counts.items()}
                casts = dict(game.casts_landed)
            for pid, per in counts.items():
                t = tot_a.setdefault(pid, {})
                for k, n in per.items():
                    t[k] = t.get(k, 0) + n
            for pid, n in casts.items():
                tot_c[pid] = tot_c.get(pid, 0) + n
        return tot_a, tot_c

    @staticmethod
    def _key(context) -> str:
        return context.peer() if context is not None else "local"

    def _evict_if_full(self) -> None:
        """Prefer evicting finished games; fall back to the oldest. Reconnects
        change a client's peer key, so finished/abandoned sessions accumulate
        and must be reclaimable without destroying someone's live game."""
        if len(self._games) < self._MAX_SESSIONS:
            return
        for key, game in self._games.items():
            if game.ended:
                self._fold_counters(self._games.pop(key))
                return
        self._fold_counters(self._games.pop(next(iter(self._games))))

    def reset(self, request: ds.GameConfig, context=None) -> ds.Observation:
        game = LastHitLaneGame(request)
        with self._lock:
            self._evict_if_full()
            old = self._games.get(self._key(context))
            if old is not None:
                self._fold_counters(old)
            self._games[self._key(context)] = game
        with game.lock:
            game.seen_tick[TEAM_RADIANT] = game.tick
            return ds.Observation(
                status=ds.Observation.OK,
                world_state=game.worldstate(TEAM_RADIANT),
                team_id=TEAM_RADIANT,
            )

    def observe(self, request: ds.ObserveRequest, context=None) -> ds.Observation:
        team = request.team_id or TEAM_RADIANT
        with self._lock:
            game = self._games.get(self._key(context))
        if game is None:
            return ds.Observation(status=ds.Observation.RESOURCE_EXHAUSTED)
        with game.lock:  # games step concurrently; only the dict is global
            if game.seen_tick.get(team, -1) >= game.tick and not game.ended:
                game.step()
            game.seen_tick[team] = game.tick
            status = ds.Observation.EPISODE_DONE if game.ended else ds.Observation.OK
            return ds.Observation(status=status, world_state=game.worldstate(team), team_id=team)

    def act(self, request: ds.Actions, context=None) -> ds.Empty:
        with self._lock:
            game = self._games.get(self._key(context))
        if game is not None:
            with game.lock:
                for a in request.actions:
                    if a.player_id in game.heroes:
                        game.pending[a.player_id] = a
        return ds.Empty()


def main(argv=None):
    """Standalone fake env server over gRPC:
    python -m dotaclient_tpu_torch.env.fake_dotaservice [--port P]"""
    import argparse
    import time

    from dotaclient_tpu_torch.env.service import serve

    p = argparse.ArgumentParser(description="fake dotaservice (synthetic 1v1 lane MDP)")
    p.add_argument("--port", type=int, default=13337)
    args = p.parse_args(argv)
    server, port = serve(FakeDotaService(), port=args.port)
    print(f"fake dotaservice listening on 127.0.0.1:{port}", flush=True)
    try:
        while True:
            time.sleep(60)
    except KeyboardInterrupt:
        server.stop(0)


if __name__ == "__main__":
    main()
