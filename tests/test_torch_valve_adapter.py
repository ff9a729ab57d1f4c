"""The port's valve dialect (dotaclient_tpu_torch/env/valve_adapter.py)
against the reference's (dotaclient_tpu/env/valve_adapter.py), with
tests/test_valve_adapter.py as the parity source: every adapter function
on the same inputs, compared through wire bytes; the world round trip's
featurization; a draw's termination; configs that keep the horizon, the
seed and the hard bot; the frontends' replies; a port actor against the
reference's valve server over gRPC and the other way round; the port's
valve actor step for step against the JAX one; 5v5 self-play over the
dialect; and the stub's gRPC plumbing."""

from __future__ import annotations

import asyncio
import sys

import numpy as np
import pytest

from dotaclient_tpu.env import featurizer as JF
from dotaclient_tpu.env import valve_adapter as JVA
from dotaclient_tpu.env.fake_dotaservice import FakeDotaService as JFakeDotaService
from dotaclient_tpu.protos import dotaservice_pb2 as jds
from dotaclient_tpu.protos import valve_dotaservice_pb2 as rvds
from dotaclient_tpu.protos import valve_worldstate_pb2 as rvw
from dotaclient_tpu.protos import worldstate_pb2 as jws
from dotaclient_tpu.transport import memory as jmem
from dotaclient_tpu_torch.config import ActorConfig, PolicyConfig
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.env import rewards as R
from dotaclient_tpu_torch.env import valve_adapter as VA
from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
from dotaclient_tpu_torch.env.service import EnvRpcError
from dotaclient_tpu_torch.protos import dotaservice as ds
from dotaclient_tpu_torch.protos import valve_dotaservice as vds
from dotaclient_tpu_torch.protos import valve_worldstate as vw
from dotaclient_tpu_torch.protos import worldstate as tws
from dotaclient_tpu_torch.runtime.selfplay import SelfPlayActor
from dotaclient_tpu_torch.transport import memory as tmem
from dotaclient_tpu_torch.transport.serialize import deserialize_rollout
from test_torch_actor import TOL_LOGP, _cfgs, _frames, _jax_params, _JTraceActor, _near_tie, _steps, _TraceActor
from test_valve_adapter import valve_world

SMALL = dict(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32")
JREQUESTS = {"reset": rvds.GameConfig, "observe": rvds.ObserveConfig, "act": rvds.Actions}
# the mana-cost features of each ability slot (hero_feats 16 + 3s + 2):
# Valve's worldstate carries no mana costs (the gate folds into
# is_fully_castable), the one group the reference's round trip exempts too
COST_IDX = [16 + 3 * s + 2 for s in range(F.N_ABILITY_SLOTS)]


def _port(ref_msg, cls):
    """The port's message of a reference message, through its bytes."""
    return cls.FromString(ref_msg.SerializeToString())


def _bytes_equal(ours, theirs):
    assert ours.SerializeToString() == theirs.SerializeToString()


def _obs_close(a, b, atol=0.0, skip_cost=False):
    for x, y, name in zip(a, b, a._fields):
        x, y = np.asarray(x), np.asarray(y)
        if name == "hero_feats" and skip_cost:
            keep = [i for i in range(F.HERO_FEATURES) if i not in COST_IDX]
            x, y = x[..., keep], y[..., keep]
        np.testing.assert_allclose(x, y, atol=atol, rtol=0, err_msg=name)


VARIANTS = {
    "default": {}, "hurt_no_enemy": dict(hero_health=120, enemy=False), "no_creeps": dict(creeps=0),
    "fort_dead": dict(fort_dead=True), "cooldown": dict(cooldown=4.0), "many_creeps": dict(creeps=5),
}


@pytest.mark.parametrize("team", [None, 2, 3])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_world_from_valve_equals_the_reference(variant, team):
    ref = valve_world(**VARIANTS[variant])
    ours = VA.world_from_valve(_port(ref, vw.CMsgBotWorldState), team)
    theirs = JVA.world_from_valve(ref, team)
    _bytes_equal(ours, theirs)
    for pid in (0, 5):
        _obs_close(F.featurize(ours, pid), JF.featurize(theirs, pid))


def test_world_from_valve_field_mapping_and_presence():
    """The reference test's pinned values on the port, and the presence
    rules: a unit without player_id maps to -1, a hero without
    xp_needed_to_level to the bottom of its level's bracket, a creep to 0."""
    w = VA.world_from_valve(_port(valve_world(), vw.CMsgBotWorldState))
    hero = F.find_hero(w, 0)
    assert hero.name == "npc_dota_hero_nevermore" and hero.x == -900.0 and hero.health == 450.0
    assert (hero.gold, hero.kills, hero.deaths, hero.speed, hero.level) == (630, 3, 1, 315.0, 6)
    assert hero.xp == VA._XP_TO_REACH[7] - 100 and w.tick == int(135.0 * 30) and list(w.player_ids) == [0]
    v = vw.CMsgBotWorldState(team_id=2)
    v.units.add(handle=1, unit_type=v.HERO, level=4)  # no player_id, no xp_needed_to_level
    v.units.add(handle=2, unit_type=v.LANE_CREEP, level=4, xp_needed_to_level=5)
    ref = rvw.CMsgBotWorldState.FromString(v.SerializeToString())
    ours, theirs = VA.world_from_valve(v), JVA.world_from_valve(ref)
    _bytes_equal(ours, theirs)
    assert [u.player_id for u in ours.units] == [-1, -1]
    assert [u.xp for u in ours.units] == [VA._XP_TO_REACH[4], 0]


def test_golden_featurization_of_the_real_schema():
    obs = F.featurize(VA.world_from_valve(_port(valve_world(), vw.CMsgBotWorldState)), player_id=0)
    hf = obs.hero_feats
    assert abs(hf[0] - 6 / 25.0) < 1e-6 and abs(hf[1] - 0.5) < 1e-6 and abs(hf[4] - 273.0 / 435.0) < 1e-6
    assert abs(hf[12] - np.log1p(630) / 10.0) < 1e-5 and abs(hf[14] - 0.28) < 1e-6
    assert hf[28] == 1.0 and hf[16] == 1.0
    assert obs.unit_mask.sum() == 3 and obs.target_mask.sum() == 3 and obs.action_mask.tolist() == [True] * 4
    cool = F.featurize(VA.world_from_valve(_port(valve_world(cooldown=4.0), vw.CMsgBotWorldState)), player_id=0)
    assert not cool.action_mask[F.ACT_CAST] and cool.hero_feats[28] == 0.0 and abs(cool.hero_feats[17] - 0.4) < 1e-6


def test_rewards_run_on_adapted_worlds():
    prev = VA.world_from_valve(_port(valve_world(hero_health=500), vw.CMsgBotWorldState))
    nxt = VA.world_from_valve(_port(valve_world(hero_health=400, fort_dead=True), vw.CMsgBotWorldState))
    assert nxt.winning_team == 2
    comps = R.component_rewards(prev, nxt, player_id=0)
    assert comps["win"] == 1.0 and abs(comps["hp"] - (400 - 500) / 900.0) < 1e-6
    assert np.isfinite(R.total_reward(comps))


def _internal_actions(rng, n):
    acts = ds.Actions(dota_time=float(rng.uniform(-90, 600)), team_id=int(rng.choice([2, 3])))
    for _ in range(n):
        acts.actions.add(type=int(rng.randint(0, 5)) % 4, player_id=int(rng.randint(0, 10)),
                         move_x=float(rng.uniform(-8000, 8000)), move_y=float(rng.uniform(-8000, 8000)),
                         target_handle=int(rng.randint(0, 2**31)), ability_slot=int(rng.randint(0, 4)))
    return acts


@pytest.mark.parametrize("seed", range(4))
def test_action_adapters_equal_the_reference(seed):
    rng = np.random.RandomState(seed)
    internal = _internal_actions(rng, 12)
    ref_internal = jds.Actions.FromString(internal.SerializeToString())
    ours, theirs = VA.actions_to_valve(internal), JVA.actions_to_valve(ref_internal)
    _bytes_equal(ours, theirs)
    for a, b in zip(ours.actions, theirs.actions):
        assert a.WhichOneof("actionData") == b.WhichOneof("actionData")
        _bytes_equal(VA.action_from_valve(a), JVA.action_from_valve(b))
    # orders the adapter never emits: MOVE_TO_POSITION with moveToLocation, and others → NOOP
    extra = rvds.Actions()
    to_pos = extra.actions.add(actionType=rvw.CMsgBotWorldState.Action.DOTA_UNIT_ORDER_MOVE_TO_POSITION, player=3)
    to_pos.moveToLocation.location.x, to_pos.moveToLocation.location.y = 5.0, -7.5
    extra.actions.add(actionType=rvw.CMsgBotWorldState.Action.DOTA_UNIT_ORDER_STOP, player=1)
    for a, b in zip(_port(extra, vds.Actions).actions, extra.actions):
        _bytes_equal(VA.action_from_valve(a), JVA.action_from_valve(b))
    assert VA.action_from_valve(_port(extra, vds.Actions).actions[0]).type == ds.Action.MOVE
    # a handle past int32 (the order's target field) raises in both
    big = ds.Action(type=ds.Action.ATTACK, target_handle=2**31)
    with pytest.raises(ValueError):
        VA.action_to_valve(big)
    with pytest.raises(ValueError):
        JVA.action_to_valve(jds.Action.FromString(big.SerializeToString()))


def test_action_round_trip_keeps_each_order():
    internal = ds.Actions(dota_time=12.5, team_id=2, actions=[
        ds.Action(type=ds.Action.MOVE, player_id=0, move_x=100.0, move_y=-50.0),
        ds.Action(type=ds.Action.ATTACK, player_id=0, target_handle=200),
        ds.Action(type=ds.Action.CAST, player_id=0, target_handle=102, ability_slot=0),
        ds.Action(type=ds.Action.NOOP, player_id=0)])
    v = vds.Actions.FromString(VA.actions_to_valve(internal).SerializeToString())
    A = vw.CMsgBotWorldState.Action
    assert [a.actionType for a in v.actions] == [A.DOTA_UNIT_ORDER_MOVE_DIRECTLY, A.DOTA_UNIT_ORDER_ATTACK_TARGET,
                                                 A.DOTA_UNIT_ORDER_CAST_TARGET, A.DOTA_UNIT_ORDER_NONE]
    assert v.actions[3].HasField("actionType") and v.actions[0].moveDirectly.location.HasField("z")
    back = [VA.action_from_valve(a) for a in v.actions]
    for orig, rt in zip(internal.actions, back):
        assert (rt.type, rt.target_handle, rt.ability_slot) == (orig.type, orig.target_handle, orig.ability_slot)
    assert (back[0].move_x, back[0].move_y) == (100.0, -50.0)


CONFIGS = [
    dict(host_timescale=10.0, ticks_per_observation=30, picks=[(2, "npc_dota_hero_nevermore", 1),
                                                               (3, "npc_dota_hero_sniper", 0)]),
    dict(host_timescale=3.0, ticks_per_observation=10, max_dota_time=45.0, seed=12345, game_mode=22,
         picks=[(2, "npc_dota_hero_lina", 1), (3, "npc_dota_hero_sniper", 2)]),
    dict(seed=2**64 - 1, picks=[(2, "", 1), (3, "npc_dota_hero_pudge", 2), (2, "NPC_DOTA_HERO_AXE", 5),
                                (3, "npc_dota_hero_viper", 0)]),
]


@pytest.mark.parametrize("i", range(len(CONFIGS)))
def test_game_config_adapters_equal_the_reference(i):
    spec = dict(CONFIGS[i])
    picks = spec.pop("picks")
    cfg = ds.GameConfig(**spec, hero_picks=[ds.HeroPick(team_id=t, hero_name=h, control_mode=m) for t, h, m in picks])
    ref = jds.GameConfig.FromString(cfg.SerializeToString())
    ours, theirs = VA.game_config_to_valve(cfg), JVA.game_config_to_valve(ref)
    _bytes_equal(ours, theirs)
    _bytes_equal(VA.game_config_from_valve(ours), JVA.game_config_from_valve(theirs))


def test_config_round_trip_preserves_horizon_seed_and_hard_bot():
    cfg = ds.GameConfig(host_timescale=10.0, ticks_per_observation=30, max_dota_time=45.0, seed=12345, hero_picks=[
        ds.HeroPick(team_id=2, hero_name="npc_dota_hero_nevermore", control_mode=1),
        ds.HeroPick(team_id=3, hero_name="npc_dota_hero_sniper", control_mode=2)])
    v = vds.GameConfig.FromString(VA.game_config_to_valve(cfg).SerializeToString())
    assert v.hero_picks[0].hero_id == vds.NPC_DOTA_HERO_NEVERMORE
    assert v.hero_picks[0].control_mode == vds.HERO_CONTROL_MODE_CONTROLLED
    assert v.hero_picks[1].control_mode == vds.HERO_CONTROL_MODE_DEFAULT
    back = VA.game_config_from_valve(v)
    assert (back.max_dota_time, back.seed, back.ticks_per_observation) == (45.0, 12345, 30)
    assert [(p.hero_name, p.control_mode) for p in back.hero_picks] == [("npc_dota_hero_nevermore", 1),
                                                                       ("npc_dota_hero_sniper", 2)]


def _valve_observations():
    out = []
    for status in (0, 1, 2, 7):
        for team in (0, 2, 3):
            out.append(rvds.Observation(status=status, team_id=team))
    for kw, gs in ((dict(), 5), (dict(fort_dead=True), 5), (dict(), 6), (dict(creeps=0), 7)):
        w = valve_world(**kw)
        w.game_state = gs
        for team in (0, 3):
            out.append(rvds.Observation(status=0, team_id=team, world_state=w))
    return out


@pytest.mark.parametrize("i", range(len(_valve_observations())))
def test_observation_from_valve_equals_the_reference(i):
    ref = _valve_observations()[i]
    _bytes_equal(VA.observation_from_valve(_port(ref, vds.Observation)), JVA.observation_from_valve(ref))


def test_draw_terminates_over_the_valve_dialect():
    internal = ds.Observation(status=ds.Observation.EPISODE_DONE, team_id=2)
    internal.world_state.dota_time = 10.0
    internal.world_state.game_state = 5
    internal.world_state.team_id = 2  # no winning_team: a draw

    class _Inner:
        def observe(self, request, context=None):
            return internal

    wire = vds.Observation.FromString(VA.ValveFrontend(_Inner()).observe(vds.ObserveConfig(team_id=2))
                                      .SerializeToString())
    back = VA.observation_from_valve(wire)
    assert wire.world_state.game_state == 6
    assert back.status == ds.Observation.EPISODE_DONE and back.world_state.winning_team == 0


@pytest.mark.parametrize("seed", [3, 11])
def test_world_round_trip_preserves_featurization(seed):
    """internal → valve → internal over the fake env's worlds: world_to_valve
    and the way back give the reference's bytes at every step, and at the
    reset (whole-number stats) the round trip featurizes equal within 1e-5
    but for the mana-cost group. Later worlds lose what the Valve schema
    holds as integers (health, damage, speed) in both packages alike."""
    svc, rng = FakeDotaService(), np.random.RandomState(seed)
    obs = svc.reset(ds.GameConfig(ticks_per_observation=30, seed=seed, max_dota_time=60.0,
                                  hero_picks=[ds.HeroPick(team_id=2, control_mode=1),
                                              ds.HeroPick(team_id=3, control_mode=2)]))
    for step in range(8):
        w0 = obs.world_state
        v, ref_v = VA.world_to_valve(w0), JVA.world_to_valve(jws.World.FromString(w0.SerializeToString()))
        _bytes_equal(v, ref_v)
        w1 = VA.world_from_valve(vw.CMsgBotWorldState.FromString(v.SerializeToString()), w0.team_id)
        _bytes_equal(w1, JVA.world_from_valve(ref_v, w0.team_id))
        if step == 0:
            a, _ = F.featurize_with_handles(w0, 0)
            b, _ = F.featurize_with_handles(w1, 0)
            _obs_close(a, b, atol=1e-5, skip_cost=True)
            assert all(b.hero_feats[i] == 0.0 for i in COST_IDX)
        svc.act(_internal_actions(rng, 1), None)
        obs = svc.observe(ds.ObserveRequest(team_id=2), None)


def test_the_frontends_reply_with_the_reference_bytes():
    """The same requests to the port's ValveFrontend over the port's fake
    env and the reference's over its own: equal reply bytes."""
    ours, theirs = VA.ValveFrontend(FakeDotaService()), JVA.ValveFrontend(JFakeDotaService())
    cfg = rvds.GameConfig(ticks_per_observation=30, seed=5, max_dota_time=20.0, hero_picks=[
        rvds.HeroPick(team_id=2, hero_id=rvds.NPC_DOTA_HERO_NEVERMORE, control_mode=rvds.HERO_CONTROL_MODE_CONTROLLED),
        rvds.HeroPick(team_id=3, hero_id=rvds.NPC_DOTA_HERO_SNIPER, control_mode=rvds.HERO_CONTROL_MODE_DEFAULT,
                      bot_difficulty=2)])
    _bytes_equal(ours.reset(_port(cfg, vds.GameConfig)), theirs.reset(cfg))
    rng = np.random.RandomState(1)
    for _ in range(25):
        acts = JVA.actions_to_valve(jds.Actions.FromString(_internal_actions(rng, 1).SerializeToString()))
        _bytes_equal(ours.act(_port(acts, vds.Actions)), theirs.act(acts))
        req = rvds.ObserveConfig(team_id=2)
        _bytes_equal(ours.observe(_port(req, vds.ObserveConfig)), theirs.observe(req))


# ------------------------------------------------------------- actors


def _valve_frames_ok(frames):
    assert frames, "no rollouts published over the valve dialect"
    total = casts = 0
    for f in frames:
        r = deserialize_rollout(f)
        assert np.isfinite(r.behavior_logp).all() and np.isfinite(r.rewards).all()
        total += r.length
        casts += int((r.actions.type == F.ACT_CAST).sum())
    assert total > 5 and casts > 0  # CAST orders crossed as CAST_TARGET and back
    assert deserialize_rollout(frames[-1]).dones[-1] == 1.0


@pytest.mark.parametrize("direction", ["port_actor_on_reference_server", "reference_actor_on_port_server"])
def test_an_actor_plays_a_full_episode_across_the_packages_over_grpc(direction):
    """Either package's Actor with env_dialect "valve" dials the other's
    serve_valve(FakeDotaService()) over loopback gRPC and plays a whole
    episode: finite frames, CAST orders, the last one done."""
    from dotaclient_tpu.config import ActorConfig as JActorConfig
    from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
    from dotaclient_tpu.runtime.actor import Actor as JActor
    from dotaclient_tpu_torch.runtime.actor import Actor

    port_actor = direction == "port_actor_on_reference_server"
    server, port = JVA.serve_valve(JFakeDotaService()) if port_actor else VA.serve_valve(FakeDotaService())
    try:
        kw = dict(env_addr=f"127.0.0.1:{port}", env_dialect="valve", rollout_len=8, max_dota_time=30.0, seed=4)
        name = f"valve_x_{direction}"
        if port_actor:
            tmem.reset(name)
            actor = Actor(ActorConfig(policy=PolicyConfig(**SMALL), platform="cpu", **kw), tmem.MemoryBroker(name),
                          actor_id=7)
        else:
            jmem.reset(name)
            actor = JActor(JActorConfig(policy=JPolicyConfig(**SMALL), **kw), jmem.MemoryBroker(name), actor_id=7)
        asyncio.new_event_loop().run_until_complete(actor.run_episode())
        _valve_frames_ok(_frames(tmem if port_actor else jmem, name))
    finally:
        server.stop(0)


@pytest.mark.parametrize("seed,actor_id", [(0, 0), (3, 5)])
def test_valve_actor_step_for_step_against_the_jax_valve_actor(seed, actor_id):
    """The port's Actor and the JAX Actor, same f32 params, seed and
    actor_id, each on its package's valve stub and frontend over its fake
    env (in-process channels carrying the wire bytes): equal obs, actions,
    rewards, dones and jax keys step by step, logp and value within
    TOL_LOGP; a sampled index that flips on a near-tie ends the comparison
    there (the tie is asserted)."""
    tcfg, jcfg = _cfgs(seed=seed, rollout_len=8, max_dota_time=40.0, opponent="scripted_hard", env_dialect="valve")
    tname, jname = f"vpar_t{seed}", f"vpar_j{seed}"
    tmem.reset(tname)
    jmem.reset(jname)
    tstub = VA.ValveDotaServiceStub(VA.LocalValveChannel(VA.ValveFrontend(FakeDotaService()), "port"))
    jstub = JVA.ValveDotaServiceStub(VA.LocalValveChannel(JVA.ValveFrontend(JFakeDotaService()), "reference",
                                                          JREQUESTS))
    ours = _TraceActor(tcfg, tmem.MemoryBroker(tname), actor_id=actor_id, stub=tstub)
    theirs = _JTraceActor(jcfg, jmem.MemoryBroker(jname), actor_id=actor_id, stub=jstub,
                          params=_jax_params(ours.params, jcfg))
    asyncio.run(ours.run(num_episodes=2))
    asyncio.run(theirs.run(num_episodes=2))
    ts, js = _steps(_frames(tmem, tname)), _steps(_frames(jmem, jname))
    assert len(ts) == ours.steps_done and len(js) == theirs.steps_done and len(ts) > 40
    assert tstub.channel.orders[VA.VAction.DOTA_UNIT_ORDER_CAST_TARGET] > 0
    if len(ts) == len(js):
        assert tstub.channel.calls == jstub.channel.calls
    compared = 0
    for k, (a, b) in enumerate(zip(ts, js)):
        assert np.array_equal(ours.trace[k][2], theirs.keys[k]), f"step {k}: jax key"
        if a[1] != b[1]:
            state, obs, key = ours.trace[k]
            _near_tie(ours.params, tcfg.policy, state, obs, key, a[1], b[1])
            break
        for x, y in zip(a[0], b[0]):
            assert x.tobytes() == y.tobytes(), f"step {k}: obs"
        assert abs(a[2] - b[2]) <= TOL_LOGP and abs(a[3] - b[3]) <= TOL_LOGP, (k, a[2:4], b[2:4])
        assert a[4:] == b[4:], f"step {k}: reward / done"
        compared += 1
    else:
        assert len(ts) == len(js)
    assert compared > 40


def test_5v5_selfplay_over_the_valve_dialect():
    """5v5 mirror self-play across the real wire dialect over gRPC:
    per-team act() routing, 10 hero trajectories, the horizon honoured."""
    server, port = VA.serve_valve(FakeDotaService(), max_workers=4)
    try:
        tmem.reset("valve5v5")
        cfg = ActorConfig(env_addr=f"127.0.0.1:{port}", env_dialect="valve", opponent="self", team_size=5,
                          rollout_len=8, max_dota_time=10.0, policy=PolicyConfig(**SMALL), platform="cpu", seed=13)
        actor = SelfPlayActor(cfg, tmem.MemoryBroker("valve5v5"), actor_id=2)
        asyncio.new_event_loop().run_until_complete(actor.run_episode())
        rollouts = [deserialize_rollout(f) for f in _frames(tmem, "valve5v5")]
        assert len(rollouts) >= 10 and len(rollouts) % 10 == 0
        teams = [float(r.obs.global_feats[0, 4]) for r in rollouts]
        assert teams.count(1.0) == teams.count(-1.0) == len(rollouts) // 2
        assert rollouts[-1].dones[-1] == 1.0
    finally:
        server.stop(0)


# ------------------------------------------------------------- plumbing


def test_without_grpc_the_network_paths_stop_naming_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "grpc", None)
    with pytest.raises(RuntimeError, match="grpc"):
        VA.connect_valve_async("127.0.0.1:1")
    with pytest.raises(RuntimeError, match="grpc"):
        VA.serve_valve(FakeDotaService())
    # the in-process path needs none
    stub = VA.ValveDotaServiceStub(VA.LocalValveChannel(VA.ValveFrontend(FakeDotaService()), "nogrpc"))
    obs = asyncio.run(stub.reset(ds.GameConfig(seed=1, max_dota_time=5.0)))
    assert obs.world_state.units and list(obs.world_state.player_ids)


def test_the_stub_turns_rpc_errors_into_env_rpc_errors():
    class _Err(Exception):
        def code(self):
            return "UNAVAILABLE"

        def details(self):
            return "connection refused"

    class _Channel:
        def __init__(self, exc):
            self.exc = exc

        def unary_unary(self, path, request_serializer, response_deserializer):
            async def call(request):
                raise self.exc
            return call

    stub = VA.ValveDotaServiceStub(_Channel(_Err()), rpc_error=_Err)
    with pytest.raises(EnvRpcError, match="observe") as info:
        asyncio.run(stub.observe(ds.ObserveRequest(team_id=2)))
    assert info.value.code() == "UNAVAILABLE"
    with pytest.raises(KeyError):  # not the channel's error class: passes through
        asyncio.run(VA.ValveDotaServiceStub(_Channel(KeyError("x")), rpc_error=_Err).act(ds.Actions()))


def test_every_public_name_of_the_reference_module_is_ported():
    names = [n for n in vars(JVA) if not n.startswith("_") and callable(getattr(JVA, n))
             and getattr(getattr(JVA, n), "__module__", "") == JVA.__name__]
    assert sorted(names) == sorted(["world_from_valve", "action_to_valve", "actions_to_valve", "game_config_to_valve",
                                    "observation_from_valve", "ValveDotaServiceStub", "connect_valve_async",
                                    "world_to_valve", "action_from_valve", "game_config_from_valve", "ValveFrontend",
                                    "add_valve_frontend_to_server", "serve_valve"])
    assert all(callable(getattr(VA, n)) for n in names)
    assert (VA.TEAM_RADIANT, VA.TEAM_DIRE, VA.VALVE_SERVICE) == (JVA.TEAM_RADIANT, JVA.TEAM_DIRE, JVA.VALVE_SERVICE)
    assert VA._XP_TO_REACH == JVA._XP_TO_REACH
    assert {int(k): int(v) for k, v in VA._UNIT_TYPE.items()} == {int(k): int(v) for k, v in JVA._UNIT_TYPE.items()}
    assert tws.Unit.FORT == vw.CMsgBotWorldState.FORT == 9
