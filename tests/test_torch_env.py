"""The port's env (dotaclient_tpu_torch/env: fake dotaservice, featurizer,
rewards, heroes) against the reference's: the same GameConfig and action
stream give byte-equal world states, bitwise-equal features and handles,
and equal rewards."""

from __future__ import annotations

import math

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dotaclient_tpu.env import fake_dotaservice as JFake
from dotaclient_tpu.env import featurizer as JF
from dotaclient_tpu.env import heroes as JH
from dotaclient_tpu.env import rewards as JR
from dotaclient_tpu.protos import dotaservice_pb2 as jds
from dotaclient_tpu.protos import worldstate_pb2 as jws
from dotaclient_tpu_torch.env import fake_dotaservice as TFake
from dotaclient_tpu_torch.env import featurizer as TF
from dotaclient_tpu_torch.env import heroes as TH
from dotaclient_tpu_torch.env import rewards as TR
from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
from dotaclient_tpu_torch.protos import dotaservice as tds
from dotaclient_tpu_torch.protos import worldstate as tws
from test_torch_protos import _build, _spec

POOL = sorted(TH.HEROES)


def _picks(mode: str, rng: np.random.RandomState):
    """(team_id, hero_name, control_mode) picks: 1v1 with the opponent in
    `mode` (scripted 0, policy 1, hard 2), or 5v5 with radiant policy and
    dire a mix of scripted bots."""
    if mode == "5v5":
        return [(2, POOL[rng.randint(len(POOL))], 1) for _ in range(5)] + \
            [(3, POOL[rng.randint(len(POOL))], int(rng.choice([0, 2]))) for _ in range(5)]
    return [(2, POOL[rng.randint(len(POOL))], 1), (3, POOL[rng.randint(len(POOL))], int(mode))]


def _actions(ds, world, players, rng: np.random.RandomState):
    """One step's Actions for `players`: MOVE, ATTACK, CAST or NOOP from
    the seeded stream, targets among the world's units (or a missing
    handle), moves around the hero (some far outside the map)."""
    handles = [u.handle for u in world.units] + [99999]
    out = []
    for pid in players:
        kind = int(rng.randint(4))
        target = int(handles[rng.randint(len(handles))])
        x, y = (float(v) for v in rng.uniform(-2500, 2500, 2))
        if rng.rand() < 0.05:
            x = float(rng.choice([1e40, -1e39, 3.3e38]))
        out.append(ds.Action(type=kind, player_id=pid, move_x=x, move_y=y, target_handle=target,
                             ability_slot=int(rng.choice([0, 0, 1]))))
    return ds.Actions(actions=out, team_id=2, dota_time=float(world.dota_time))


def _episode(Fake, ds, seed: int, picks, steps: int, act_seed: int, max_time: float = 45.0):
    """(worlds, statuses, telemetry) of one episode of `Fake` driven with
    the seeded action stream; team radiant observes."""
    svc = Fake.FakeDotaService()
    cfg = ds.GameConfig(seed=seed, ticks_per_observation=30, max_dota_time=max_time, host_timescale=10.0,
                        hero_picks=[ds.HeroPick(team_id=t, hero_name=h, control_mode=c) for t, h, c in picks])
    rng = np.random.RandomState(act_seed)
    obs = svc.reset(cfg, None)
    worlds, statuses = [obs.world_state], [obs.status]
    players = list(obs.world_state.player_ids)
    for _ in range(steps):
        svc.act(_actions(ds, worlds[-1], players, rng), None)
        obs = svc.observe(ds.ObserveRequest(team_id=2), None)
        worlds.append(obs.world_state)
        statuses.append(obs.status)
        if obs.status == ds.Observation.EPISODE_DONE:
            break
    return worlds, statuses, svc.action_telemetry()


def _assert_features_equal(jw, tw, pid):
    jo, jh = JF.featurize_with_handles(jw, pid)
    to, th = TF.featurize_with_handles(tw, pid)
    for name, a, b in zip(JF.Observation._fields, jo, to):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), name
    assert jh.dtype == th.dtype and np.array_equal(jh, th)


@pytest.mark.parametrize("mode", ["0", "1", "2", "5v5"])
@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_fake_env_worlds_features_and_rewards_equal_the_reference(mode, seed):
    rng = np.random.RandomState(seed)
    picks = _picks(mode, rng)
    jworlds, jst, jtel = _episode(JFake, jds, seed, picks, 60, seed + 1)
    tworlds, tst, ttel = _episode(TFake, tds, seed, picks, 60, seed + 1)
    assert len(jworlds) == len(tworlds) > 10 and jst == tst
    assert jtel == ttel
    players = list(jworlds[0].player_ids)
    assert players == list(tworlds[0].player_ids) == ([0, 1, 2, 3, 4] if mode == "5v5" else [0])
    jlast = {p: None for p in players}
    tlast = {p: None for p in players}
    for t, (jw, tw) in enumerate(zip(jworlds, tworlds)):
        assert jw.SerializeToString() == tw.SerializeToString(), f"world {t} differs"
        for pid in players:
            _assert_features_equal(jw, tw, pid)
            if t:
                jc = JR.component_rewards(jworlds[t - 1], jw, pid, jlast[pid])
                tc = TR.component_rewards(tworlds[t - 1], tw, pid, tlast[pid])
                assert jc == tc
                assert JR.total_reward(jc) == TR.total_reward(tc)
                assert JR.reward(jworlds[t - 1], jw, pid) == TR.reward(tworlds[t - 1], tw, pid)
            jlast[pid], tlast[pid] = JF.find_hero(jw, pid), TF.find_hero(tw, pid)
    # the stream exercised every action type and a finished game
    counts = ttel[0].get(0, {})
    assert set(counts) == {0, 1, 2, 3}


def test_fake_env_over_the_in_process_stub_keys_sessions_by_peer():
    import asyncio

    svc = TFake.FakeDotaService()
    a, b = LocalDotaServiceStub(svc), LocalDotaServiceStub(svc)

    async def go():
        cfg = tds.GameConfig(seed=5, max_dota_time=20, ticks_per_observation=30)
        wa = (await a.reset(cfg)).world_state
        await b.reset(tds.GameConfig(seed=6, max_dota_time=20, ticks_per_observation=30))
        for _ in range(3):
            await a.observe(tds.ObserveRequest(team_id=2))
        ob = await b.observe(tds.ObserveRequest(team_id=2))
        oa = await a.observe(tds.ObserveRequest(team_id=2))
        return wa, oa, ob

    wa, oa, ob = asyncio.run(go())
    assert oa.world_state.tick == 4 * 30 and ob.world_state.tick == 30 and wa.tick == 0
    assert isinstance(oa, tds.Observation)
    missing = svc.observe(tds.ObserveRequest(team_id=2), None)  # no session under "local"
    assert missing.status == tds.Observation.RESOURCE_EXHAUSTED


_WORLDS = _spec(tws.World)


@settings(max_examples=80, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_WORLDS, _spec(tws.Unit), _spec(tws.Unit), st.integers(0, 3))
def test_featurize_and_reward_of_arbitrary_worlds_equal_the_reference(world, hero, prev_hero, pid):
    """Corrupt or hostile worlds too: NaN/inf floats, dead or missing
    heroes, extreme stats, many units."""
    hero = dict(hero, unit_type=tws.Unit.HERO, player_id=pid)
    world = dict(world, units=list(world.get("units", [])) + [hero])
    prev = dict(world, units=[dict(prev_hero, unit_type=tws.Unit.HERO, player_id=pid)])
    tw, jw = _build(tws.World, world, False), _build(tws.World, world, True)
    tp, jp = _build(tws.World, prev, False), _build(tws.World, prev, True)
    _assert_features_equal(jw, tw, pid)
    jr, tr = JR.component_rewards(jp, jw, pid), TR.component_rewards(tp, tw, pid)
    assert jr == tr and all(math.isfinite(v) for v in tr.values())
    assert JF.castable(JF.find_hero(jw, pid)) == TF.castable(TF.find_hero(tw, pid))
    assert np.array_equal(JF.handles_for_slots(jw, pid), TF.handles_for_slots(tw, pid))
    assert TF.featurize(tw, pid).hero_feats.tobytes() == JF.featurize(jw, pid).hero_feats.tobytes()


def test_heroes_equal_the_reference():
    assert TH.HEROES == {k: tuple(v) for k, v in JH.HEROES.items()} and TH.DEFAULT_HERO == JH.DEFAULT_HERO
    for name in POOL + ["npc_dota_hero_unknown", ""]:
        assert tuple(TH.profile(name)) == tuple(JH.profile(name))
        assert TH.hero_id_features(name).tobytes() == JH.hero_id_features(name).tobytes()
    for spec in ("a, b,,c", "", " npc_dota_hero_axe "):
        assert TH.parse_pool(spec) == JH.parse_pool(spec)
    assert TF.norm_gold(1234) == JF.norm_gold(1234) and TF.norm_last_hits(17) == JF.norm_last_hits(17)
    for x in (math.nan, math.inf, -1.5):
        assert TF.finite_or_zero(x) == JF.finite_or_zero(x)
    assert TR.REWARD_WEIGHTS == JR.REWARD_WEIGHTS
    # the port's World feeds the reference's schema constants
    assert (TF.MAX_UNITS, TF.UNIT_FEATURES, TF.HERO_FEATURES, TF.GLOBAL_FEATURES, TF.FEATURE_SCHEMA_VERSION) == \
        (JF.MAX_UNITS, JF.UNIT_FEATURES, JF.HERO_FEATURES, JF.GLOBAL_FEATURES, JF.FEATURE_SCHEMA_VERSION)
    assert jws.Unit.HERO == tws.Unit.HERO
