"""The valve dialect (own copy of dotaclient_tpu/env/valve_adapter.py):
adapters between a real dotaservice's schema (`CMsgBotWorldState`,
protos/valve_worldstate.py; the `/dotaservice.DotaService/...` service,
protos/valve_dotaservice.py) and the framework's internal env messages.

The Valve schema nests locations, splits gold into reliable and
unreliable, keeps kills and deaths on Player messages and omits hero xp
and the winning team; this module is the one place that knowledge lives:

- `world_from_valve`: CMsgBotWorldState → internal `World`;
- `actions_to_valve`: internal `Actions` → dotaservice `Actions` (MOVE →
  DOTA_UNIT_ORDER_MOVE_DIRECTLY, ATTACK → ATTACK_TARGET, CAST →
  CAST_TARGET: the order types the reference emits);
- `game_config_to_valve`: internal `GameConfig` → dotaservice config;
- `ValveDotaServiceStub`: the actor's env stub in the real wire dialect,
  converting at the boundary, so `runtime.actor.Actor` plays a real
  dotaservice unchanged (`--env_dialect valve`, `connect_valve_async`);
- the inverse direction (`world_to_valve`, `action_from_valve`,
  `game_config_from_valve`) and `ValveFrontend` / `serve_valve`, which
  present any internal servicer (the fake env) in the real dialect;
  `LocalValveChannel` joins a stub to a frontend in one process, over
  the wire bytes but without grpc.

The port imports no `grpc` here: `connect_valve_async` and `serve_valve`
take it through env/service.py's helpers, inside themselves, and without
it stop with an error that names it. A gRPC failure of the stub reaches
the actor as `EnvRpcError`, as the internal stub's does.
"""

from __future__ import annotations

import inspect
from collections import Counter
from typing import Optional

from dotaclient_tpu_torch.env.service import EnvRpcError, _grpc, _LocalContext, _unique_options
from dotaclient_tpu_torch.protos import dotaservice as ds
from dotaclient_tpu_torch.protos import valve_dotaservice as vds
from dotaclient_tpu_torch.protos import valve_worldstate as vw
from dotaclient_tpu_torch.protos import worldstate as ws

VAction = vw.CMsgBotWorldState.Action

TEAM_RADIANT, TEAM_DIRE = 2, 3
_TICKS_PER_SEC = 30.0

# Cumulative xp required to reach each level (index = level, [1] = 0); the
# xp reward uses deltas of this reconstruction, so only monotonicity and
# rough scale matter (the real worldstate carries no total xp).
_XP_TO_REACH = [0, 0]
for _need in (230, 370, 480, 580, 600, 720, 750, 890, 930, 970, 1010, 1050,
              1090, 1130, 1170, 1210, 1250, 1290, 1330, 1870, 2120, 2370, 2620, 2870):
    _XP_TO_REACH.append(_XP_TO_REACH[-1] + _need)


def _xp_from_level(level: int, xp_needed_to_level: int) -> int:
    """Total xp from (level, xp still needed to level up)."""
    level = max(1, min(level, len(_XP_TO_REACH) - 2))
    next_total = _XP_TO_REACH[level + 1]
    need = max(0, min(xp_needed_to_level, next_total - _XP_TO_REACH[level]))
    return next_total - need


def _xp_needed_for(level: int, xp: int) -> int:
    """Inverse of _xp_from_level (world_to_valve): the remainder to the
    next level, clamped into the level's bracket."""
    level = max(1, min(level, len(_XP_TO_REACH) - 2))
    next_total = _XP_TO_REACH[level + 1]
    bracket = next_total - _XP_TO_REACH[level]
    return max(0, min(next_total - xp, bracket))


_W = vw.CMsgBotWorldState
_UNIT_TYPE = {
    _W.INVALID: ws.Unit.INVALID,
    _W.HERO: ws.Unit.HERO,
    _W.CREEP_HERO: ws.Unit.CREEP_HERO,
    _W.LANE_CREEP: ws.Unit.LANE_CREEP,
    _W.JUNGLE_CREEP: ws.Unit.JUNGLE_CREEP,
    _W.ROSHAN: ws.Unit.ROSHAN,
    _W.TOWER: ws.Unit.TOWER,
    _W.BARRACKS: ws.Unit.BARRACKS,
    _W.SHRINE: ws.Unit.SHRINE,
    _W.FORT: ws.Unit.FORT,
    _W.BUILDING: ws.Unit.BUILDING,
    _W.COURIER: ws.Unit.COURIER,
    _W.WARD: ws.Unit.WARD,
}


def _winning_team(v: vw.CMsgBotWorldState) -> int:
    """The Valve worldstate has no winner field: a dead ancient (FORT)
    decides it."""
    for u in v.units:
        if u.unit_type == _W.FORT and (not u.is_alive or u.health <= 0):
            return TEAM_DIRE if u.team_id == TEAM_RADIANT else TEAM_RADIANT
    return 0


def _hero_xp(u) -> int:
    """xp only for heroes (creeps and buildings carry level 0 and would be
    credited phantom xp); a hero without `xp_needed_to_level` gets the
    bottom of its level's bracket."""
    if u.unit_type != _W.HERO:
        return 0
    if u.HasField("xp_needed_to_level"):
        return _xp_from_level(u.level, u.xp_needed_to_level)
    return _XP_TO_REACH[max(1, min(u.level, len(_XP_TO_REACH) - 1))]


def world_from_valve(v: vw.CMsgBotWorldState, team_id: Optional[int] = None) -> ws.World:
    """Flatten one CMsgBotWorldState into the internal World."""
    team = team_id if team_id is not None else v.team_id
    out = ws.World(
        dota_time=v.dota_time,
        game_state=v.game_state,
        tick=max(int(v.game_time * _TICKS_PER_SEC), 0),
        team_id=team,
        winning_team=_winning_team(v),
    )
    kd = {p.player_id: (p.kills, p.deaths) for p in v.players}
    for p in v.players:
        if p.team_id == team:
            out.player_ids.append(p.player_id)
    for u in v.units:
        kills, deaths = kd.get(u.player_id, (0, 0)) if u.unit_type == _W.HERO else (0, 0)
        o = out.units.add(
            handle=u.handle,
            unit_type=_UNIT_TYPE.get(u.unit_type, ws.Unit.INVALID),
            team_id=u.team_id,
            name=u.name,
            player_id=u.player_id if u.HasField("player_id") else -1,
            x=u.location.x,
            y=u.location.y,
            z=u.location.z,
            facing=u.facing,
            speed=float(u.current_movement_speed or u.base_movement_speed),
            level=u.level,
            health=float(u.health),
            health_max=float(u.health_max),
            health_regen=u.health_regen,
            mana=u.mana,
            mana_max=u.mana_max,
            attack_damage=float(u.attack_damage or u.base_damage),
            attack_range=u.attack_range,
            attack_speed=u.attack_speed,
            armor=u.armor,
            is_alive=u.is_alive,
            is_attacking=u.attack_target_handle != 0,
            attack_target_handle=u.attack_target_handle,
            gold=u.reliable_gold + u.unreliable_gold,
            xp=_hero_xp(u),
            xp_needed_to_level=u.xp_needed_to_level,
            last_hits=u.last_hits,
            denies=u.denies,
            kills=kills,
            deaths=deaths,
        )
        for a in u.abilities:
            # the real worldstate carries no mana costs: is_fully_castable
            # already folds mana in, so a ready ability is (castable, cost 0)
            o.abilities.add(ability_id=a.ability_id, slot=a.slot, level=a.level,
                            cooldown_remaining=a.cooldown_remaining, mana_cost=0.0, is_castable=a.is_fully_castable)
    return out


def action_to_valve(a: ds.Action) -> vw.Action:
    """One internal action → one bot order (MOVE_DIRECTLY, ATTACK_TARGET,
    CAST_TARGET, or NONE for a no-op)."""
    v = VAction(player=a.player_id)
    if a.type == ds.Action.MOVE:
        v.actionType = VAction.DOTA_UNIT_ORDER_MOVE_DIRECTLY
        v.moveDirectly.location.x = a.move_x
        v.moveDirectly.location.y = a.move_y
        v.moveDirectly.location.z = 0.0
    elif a.type == ds.Action.ATTACK:
        v.actionType = VAction.DOTA_UNIT_ORDER_ATTACK_TARGET
        v.attackTarget.target = a.target_handle
        v.attackTarget.once = False
    elif a.type == ds.Action.CAST:
        v.actionType = VAction.DOTA_UNIT_ORDER_CAST_TARGET
        v.castTarget.abilitySlot = a.ability_slot
        v.castTarget.target = a.target_handle
    else:
        v.actionType = VAction.DOTA_UNIT_ORDER_NONE
    return v


def actions_to_valve(acts: ds.Actions) -> vds.Actions:
    return vds.Actions(dota_time=acts.dota_time, team_id=acts.team_id,
                       actions=[action_to_valve(a) for a in acts.actions])


_CONTROL_MODE = {
    # internal: 0 scripted, 1 policy, 2 scripted hard; the dotaservice's
    # built-in bot plays DEFAULT heroes, CONTROLLED ones take our orders
    0: vds.HERO_CONTROL_MODE_DEFAULT,
    1: vds.HERO_CONTROL_MODE_CONTROLLED,
    2: vds.HERO_CONTROL_MODE_DEFAULT,
}


def game_config_to_valve(cfg: ds.GameConfig) -> vds.GameConfig:
    out = vds.GameConfig(
        host_timescale=cfg.host_timescale,
        ticks_per_observation=cfg.ticks_per_observation,
        host_mode=vds.HOST_MODE_DEDICATED,
        game_mode=cfg.game_mode,
        max_dota_time=cfg.max_dota_time,  # extensions a stock dotaservice skips
        seed=cfg.seed,
    )
    for p in cfg.hero_picks:
        try:
            hero = vds.Hero.Value(p.hero_name.upper()) if p.hero_name else vds.NPC_DOTA_HERO_NEVERMORE
        except ValueError:  # a hero outside the enum's subset
            hero = vds.NPC_DOTA_HERO_NEVERMORE
        out.hero_picks.add(
            team_id=p.team_id,
            hero_id=hero,
            control_mode=_CONTROL_MODE.get(p.control_mode, vds.HERO_CONTROL_MODE_CONTROLLED),
            # keeps the hard bot (mode 2) across the dialect, which only
            # knows DEFAULT
            bot_difficulty=p.control_mode if p.control_mode != 1 else 0,
        )
    return out


_STATUS = {
    vds.OK: ds.Observation.OK,
    vds.RESOURCE_EXHAUSTED: ds.Observation.RESOURCE_EXHAUSTED,
    vds.FAILED_PRECONDITION: ds.Observation.RESOURCE_EXHAUSTED,
}


def observation_from_valve(o: vds.Observation) -> ds.Observation:
    out = ds.Observation(status=_STATUS.get(o.status, ds.Observation.OK), team_id=o.team_id)
    if o.HasField("world_state"):
        out.world_state.CopyFrom(world_from_valve(o.world_state, o.team_id or None))
        # a finished game is EPISODE_DONE internally: a dead ancient, or
        # post-game state (>= 6), the only end signal of a draw
        if out.world_state.winning_team or o.world_state.game_state >= 6:
            out.status = ds.Observation.EPISODE_DONE
    return out


VALVE_SERVICE = "dotaservice.DotaService"

VALVE_METHODS = {
    # name: (request class, response class)
    "reset": (vds.GameConfig, vds.InitialObservation),
    "observe": (vds.ObserveConfig, vds.Observation),
    "act": (vds.Actions, vds.Empty),
}


class ValveDotaServiceStub:
    """The actor's env stub in the real dotaservice dialect: internal
    messages in and out, Valve messages on the channel. Works over a sync
    channel (its multicallable returns the reply) and an aio one (it
    returns an awaitable). `rpc_error` is the channel's error class, which
    reaches the caller as `EnvRpcError`."""

    def __init__(self, channel, rpc_error: Optional[type] = None):
        self.channel = channel
        self._rpc_error = rpc_error
        self._calls = {
            name: channel.unary_unary(f"/{VALVE_SERVICE}/{name}", request_serializer=req.SerializeToString,
                                      response_deserializer=resp.FromString)
            for name, (req, resp) in VALVE_METHODS.items()
        }

    async def _call(self, name: str, request):
        try:
            result = self._calls[name](request)
            return await result if inspect.isawaitable(result) else result
        except Exception as e:
            if self._rpc_error is not None and isinstance(e, self._rpc_error):
                raise EnvRpcError(name, e) from e
            raise

    async def reset(self, config: ds.GameConfig) -> ds.Observation:
        init = await self._call("reset", game_config_to_valve(config))
        out = ds.Observation(status=ds.Observation.OK, team_id=TEAM_RADIANT)
        if init.HasField("world_state"):
            out.world_state.CopyFrom(world_from_valve(init.world_state, TEAM_RADIANT))
            del out.world_state.player_ids[:]
            out.world_state.player_ids.extend(init.player_ids)
        return out

    async def observe(self, req: ds.ObserveRequest) -> ds.Observation:
        return observation_from_valve(await self._call("observe", vds.ObserveConfig(team_id=req.team_id)))

    async def act(self, acts: ds.Actions) -> ds.Empty:
        await self._call("act", actions_to_valve(acts))
        return ds.Empty()


def connect_valve_async(addr: str) -> ValveDotaServiceStub:
    """The stub of a real dotaservice at `addr`. Call inside the running
    event loop: an aio channel binds to it."""
    grpc = _grpc()
    return ValveDotaServiceStub(grpc.aio.insecure_channel(addr, options=_unique_options()), grpc.RpcError)


# --------------------------------------------------------------------------
# Internal → Valve: lets the fake env present the real dialect
# (ValveFrontend), so an actor under --env_dialect valve runs the adapter
# path it would run against a stock dotaservice.

_UNIT_TYPE_INV = {v: k for k, v in _UNIT_TYPE.items()}


def world_to_valve(w: ws.World) -> vw.CMsgBotWorldState:
    out = vw.CMsgBotWorldState(team_id=w.team_id, game_time=w.tick / _TICKS_PER_SEC, dota_time=w.dota_time,
                               game_state=w.game_state)
    for u in w.units:
        if u.unit_type == ws.Unit.HERO:
            out.players.add(player_id=u.player_id, is_alive=u.is_alive, kills=u.kills, deaths=u.deaths,
                            team_id=u.team_id)
        v = out.units.add(
            handle=u.handle,
            unit_type=_UNIT_TYPE_INV.get(u.unit_type, _W.INVALID),
            name=u.name,
            team_id=u.team_id,
            level=u.level,
            is_alive=u.is_alive,
            facing=u.facing,
            current_movement_speed=int(u.speed),
            health=int(u.health),
            health_max=int(u.health_max),
            health_regen=u.health_regen,
            mana=u.mana,
            mana_max=u.mana_max,
            attack_damage=int(u.attack_damage),
            attack_range=u.attack_range,
            attack_speed=u.attack_speed,
            armor=u.armor,
            attack_target_handle=u.attack_target_handle,
            unreliable_gold=u.gold,
            last_hits=u.last_hits,
            denies=u.denies,
            # total xp as the only thing the schema can carry: the remainder
            # to the next level, so world_from_valve's reconstruction is
            # exact whenever xp falls inside its level's bracket
            xp_needed_to_level=_xp_needed_for(u.level, u.xp),
        )
        if u.player_id >= 0:
            v.player_id = u.player_id
        v.location.x, v.location.y, v.location.z = u.x, u.y, u.z
        for a in u.abilities:
            # the internal mana-cost gate folds into Valve's ready-now bit
            v.abilities.add(ability_id=a.ability_id, slot=a.slot, level=a.level,
                            cooldown_remaining=a.cooldown_remaining,
                            is_fully_castable=bool(a.is_castable and a.cooldown_remaining <= 0.0
                                                   and a.mana_cost <= u.mana))
    # a decided game becomes the signal world_from_valve reads: a dead ancient
    if w.winning_team:
        loser = TEAM_DIRE if w.winning_team == TEAM_RADIANT else TEAM_RADIANT
        fort = out.units.add(handle=0xF0F0, unit_type=_W.FORT, team_id=loser, is_alive=False, health=0,
                             health_max=4500)
        fort.location.x = -7200.0 if loser == TEAM_RADIANT else 7200.0
    return out


def action_from_valve(v: vw.Action) -> ds.Action:
    a = ds.Action(player_id=v.player)
    if v.actionType in (VAction.DOTA_UNIT_ORDER_MOVE_DIRECTLY, VAction.DOTA_UNIT_ORDER_MOVE_TO_POSITION):
        loc = v.moveDirectly.location if v.HasField("moveDirectly") else v.moveToLocation.location
        a.type = ds.Action.MOVE
        a.move_x, a.move_y = loc.x, loc.y
    elif v.actionType == VAction.DOTA_UNIT_ORDER_ATTACK_TARGET:
        a.type = ds.Action.ATTACK
        a.target_handle = v.attackTarget.target
    elif v.actionType == VAction.DOTA_UNIT_ORDER_CAST_TARGET:
        a.type = ds.Action.CAST
        a.ability_slot = v.castTarget.abilitySlot
        a.target_handle = v.castTarget.target
    else:
        a.type = ds.Action.NOOP
    return a


def game_config_from_valve(cfg: vds.GameConfig) -> ds.GameConfig:
    out = ds.GameConfig(host_timescale=cfg.host_timescale, ticks_per_observation=cfg.ticks_per_observation,
                        game_mode=cfg.game_mode, max_dota_time=cfg.max_dota_time, seed=cfg.seed)
    for p in cfg.hero_picks:
        if p.control_mode == vds.HERO_CONTROL_MODE_CONTROLLED:
            mode = 1
        else:  # DEFAULT / IDLE: bot_difficulty restores the hard bot (2)
            mode = p.bot_difficulty if p.bot_difficulty in (0, 2) else 0
        out.hero_picks.add(team_id=p.team_id, hero_name=vds.Hero.Name(p.hero_id).lower(), control_mode=mode)
    return out


_STATUS_TO_VALVE = {
    ds.Observation.OK: vds.OK,
    ds.Observation.EPISODE_DONE: vds.OK,  # the worldstate carries the end
    ds.Observation.RESOURCE_EXHAUSTED: vds.RESOURCE_EXHAUSTED,
}


class ValveFrontend:
    """Serves the real `/dotaservice.DotaService/...` dialect in front of
    any internal servicer (the fake env): the mirror image of
    ValveDotaServiceStub."""

    def __init__(self, inner):
        self.inner = inner

    def reset(self, request: vds.GameConfig, context=None) -> vds.InitialObservation:
        obs = self.inner.reset(game_config_from_valve(request), context)
        out = vds.InitialObservation(player_ids=obs.world_state.player_ids)
        out.world_state.CopyFrom(world_to_valve(obs.world_state))
        return out

    def observe(self, request: vds.ObserveConfig, context=None) -> vds.Observation:
        obs = self.inner.observe(ds.ObserveRequest(team_id=request.team_id), context)
        out = vds.Observation(status=_STATUS_TO_VALVE[obs.status], team_id=obs.team_id)
        if obs.HasField("world_state"):
            w = world_to_valve(obs.world_state)
            if obs.status == ds.Observation.EPISODE_DONE:
                w.game_state = 6  # post-game: a draw's only end signal
            out.world_state.CopyFrom(w)
        return out

    def act(self, request: vds.Actions, context=None) -> vds.Empty:
        internal = ds.Actions(dota_time=request.dota_time, team_id=request.team_id,
                              actions=[action_from_valve(a) for a in request.actions])
        self.inner.act(internal, context)
        return vds.Empty()


class LocalValveChannel:
    """What ValveDotaServiceStub uses of a grpc channel, in one process and
    without grpc (the valve twin of env/service.py's LocalDotaServiceStub):
    each call serializes its request, parses the bytes as the request class
    of `requests` (method name -> class; default this module's), hands it
    to `frontend`'s method with a context whose peer() is `peer`, and
    parses the serialized reply; so the stub and the frontend exchange the
    wire bytes a dotaservice would. Counts its calls and the act calls'
    orders by actionType. Either package's stub and frontend take it."""

    def __init__(self, frontend, peer: str, requests=None):
        self.frontend, self._ctx = frontend, _LocalContext(peer)
        self.requests = requests or {name: req for name, (req, _) in VALVE_METHODS.items()}
        self.calls = 0
        self.orders = Counter()

    def unary_unary(self, path: str, request_serializer, response_deserializer):
        name = path.rsplit("/", 1)[1]
        method, parse = getattr(self.frontend, name), self.requests[name].FromString

        def call(request):
            req = parse(request_serializer(request))
            self.calls += 1
            if name == "act":
                self.orders.update(a.actionType for a in req.actions)
            return response_deserializer(method(req, self._ctx).SerializeToString())

        return call

    async def close(self) -> None:  # a channel's teardown (reset_env_stub)
        pass


def add_valve_frontend_to_server(frontend: ValveFrontend, server) -> None:
    grpc = _grpc()
    handlers = {
        name: grpc.unary_unary_rpc_method_handler(getattr(frontend, name), request_deserializer=req.FromString,
                                                  response_serializer=resp.SerializeToString)
        for name, (req, resp) in VALVE_METHODS.items()
    }
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(VALVE_SERVICE, handlers),))


def serve_valve(inner, port: int = 0, max_workers: int = 4):
    """Start a valve-dialect server on 127.0.0.1 in front of an internal
    servicer; returns (server, bound port)."""
    from concurrent import futures

    grpc = _grpc()
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    add_valve_frontend_to_server(ValveFrontend(inner), server)
    bound = server.add_insecure_port(f"127.0.0.1:{port}")
    server.start()
    return server, bound
