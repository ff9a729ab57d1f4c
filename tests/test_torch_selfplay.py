"""The port's SelfPlayActor (dotaclient_tpu_torch/runtime/selfplay.py)
against the reference's on the CPU: mirror episodes step for step at
team sizes 1 and 2 (actions, rewards and obs equal; logp and value
within TOL), the local league's opponent draws and stats, the remote
league through the port's server and league service, and the group key
step's rows against their B=1 steps.

Small policy (16 wide, f32 compute), each package on its own fake env."""

from __future__ import annotations

import asyncio
import time

import jax
import numpy as np
import pytest
import torch

from dotaclient_tpu.config import ActorConfig as JActorConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.env.fake_dotaservice import FakeDotaService as JFakeDotaService
from dotaclient_tpu.env.service import LocalDotaServiceStub as JLocalStub
from dotaclient_tpu.models import policy as JP
from dotaclient_tpu.runtime.selfplay import SelfPlayActor as JSelfPlayActor
from dotaclient_tpu.transport import memory as jmem
from dotaclient_tpu.transport import serialize as jser
from dotaclient_tpu_torch.config import (
    ActorConfig,
    InferenceConfig,
    LeagueConfig,
    LeagueServiceConfig,
    PolicyConfig,
    ServeClientConfig,
    ServeConfig,
)
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
from dotaclient_tpu_torch.league.server import LeagueService
from dotaclient_tpu_torch.models import policy as P
from dotaclient_tpu_torch.ops import threefry
from dotaclient_tpu_torch.ops.batch import as_tensors
from dotaclient_tpu_torch.runtime import actor as tactor
from dotaclient_tpu_torch.runtime.selfplay import SelfPlayActor
from dotaclient_tpu_torch.serve.server import InferenceServer
from dotaclient_tpu_torch.transport import memory as tmem
from dotaclient_tpu_torch.transport import serialize as tser
from dotaclient_tpu_torch.transport.params import named_params

SMALL = dict(lstm_hidden=16, unit_embed_dim=16, mlp_hidden=16, dtype="float32")
POLICY = PolicyConfig(**SMALL)
# behavior logp / value, port vs JAX on the same f32 params: the reference
# steps the B heroes of a team in one batched call, the port row by row;
# the two frameworks' f32 matmuls sum in other orders (~1e-7 relative per
# op over a few dozen ops).
TOL = 1e-5


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _cfgs(**kw):
    t = ActorConfig(policy=POLICY, platform="cpu", rollout_len=8, max_weight_age_s=0.0, **kw)
    j = JActorConfig(policy=JPolicyConfig(**SMALL), rollout_len=8, max_weight_age_s=0.0, **kw)
    return t, j


def _jax_params(net, jcfg):
    return jser.unflatten_params(named_params(net), JP.init_params(jcfg.policy, jax.random.PRNGKey(0)))


def _rows(frames):
    out = []
    for f in frames:
        r = tser.deserialize_rollout(f)
        out.append((r.actor_id, r.version, [np.asarray(x) for x in r.obs], [np.asarray(a) for a in r.actions],
                    np.asarray(r.behavior_logp), np.asarray(r.behavior_value), np.asarray(r.rewards),
                    np.asarray(r.dones), [np.asarray(x) for x in r.initial_state]))
    return out


@pytest.mark.parametrize("team_size,seed", [(1, 0), (2, 3)])
def test_mirror_episodes_step_for_step_with_the_jax_actor(team_size, seed):
    """Mirror self-play, the same f32 params, seed and actor id, each on
    its package's fake env: every published chunk (both teams' heroes, in
    publish order) has the reference's obs, actions, rewards and dones,
    logp / value and initial carries within TOL, and the actor keys end
    equal."""
    tcfg, jcfg = _cfgs(opponent="self", team_size=team_size, seed=seed, max_dota_time=20.0)
    tmem.reset(f"spm_t{seed}")
    jmem.reset(f"spm_j{seed}")
    ours = SelfPlayActor(tcfg, tmem.MemoryBroker(f"spm_t{seed}"), actor_id=2,
                         stub=LocalDotaServiceStub(FakeDotaService()))
    theirs = JSelfPlayActor(jcfg, jmem.MemoryBroker(f"spm_j{seed}"), actor_id=2, stub=JLocalStub(JFakeDotaService()))
    theirs.params = _jax_params(ours.params, jcfg)
    run(ours.run(num_episodes=2))
    run(theirs.run(num_episodes=2))
    a = _rows(tmem.MemoryBroker(f"spm_t{seed}").consume_experience(100000, timeout=0.05))
    b = _rows(jmem.MemoryBroker(f"spm_j{seed}").consume_experience(100000, timeout=0.05))
    assert len(a) == len(b) >= 4 * team_size and ours.steps_done == theirs.steps_done > 0
    for k, (x, y) in enumerate(zip(a, b)):
        assert x[:2] == y[:2], f"chunk {k}: actor id / version"
        for u, v in zip(x[2], y[2]):
            assert u.tobytes() == v.tobytes(), f"chunk {k}: obs"
        for u, v in zip(x[3], y[3]):
            assert np.array_equal(u, v), f"chunk {k}: actions"
        for u, v in zip(x[4:6] + tuple(x[8]), y[4:6] + tuple(y[8])):
            assert np.max(np.abs(u - v), initial=0.0) <= TOL, f"chunk {k}: logp / value / carry"
        assert np.array_equal(x[6], y[6]) and np.array_equal(x[7], y[7]), f"chunk {k}: rewards / dones"
    assert ours.rng.tolist() == np.asarray(theirs.rng).tolist()
    assert (ours.rollouts_published, ours.episodes_done, ours.last_win) == \
        (theirs.rollouts_published, theirs.episodes_done, theirs.last_win)


def _weights(net, version):
    return tser.serialize_weights(named_params(net), version=version)


def test_local_league_draws_and_stats_equal_the_jax_actor():
    """League mode with the local pool: both actors snapshot the same
    weight frames (every 2 versions) and draw their opponents with the
    same seed; the opponent of each episode, the pool and the league_*
    stats are the reference's."""
    tcfg, jcfg = _cfgs(opponent="league", seed=1, max_dota_time=4.0, league_capacity=2, league_snapshot_every=2,
                       pfsp_mode="even")
    tmem.reset("spl_t")
    jmem.reset("spl_j")
    ours = SelfPlayActor(tcfg, tmem.MemoryBroker("spl_t"), actor_id=0, stub=LocalDotaServiceStub(FakeDotaService()))
    theirs = JSelfPlayActor(jcfg, jmem.MemoryBroker("spl_j"), actor_id=0, stub=JLocalStub(JFakeDotaService()))
    theirs.params = _jax_params(ours.params, jcfg)
    names = ([], [])
    for version in range(1, 8):
        net = P.init_params(POLICY, torch.Generator().manual_seed(100 + version), "cpu")
        frame = _weights(net, version)
        tmem.MemoryBroker("spl_t").publish_weights(frame)
        jmem.MemoryBroker("spl_j").publish_weights(frame)
        for actor, out in zip((ours, theirs), names):
            actor.maybe_update_weights()
            run(actor.run_episode())
            out.append(actor._opp_name)
    assert names[0] == names[1] and any(n is not None for n in names[0])
    assert ours.league.names == theirs.league.names and len(ours.league) == 2
    assert ours.league.stats() == theirs.league.stats()
    assert ours.version == theirs.version == 7


def _league_rig(slots=3):
    league = LeagueService(LeagueConfig(league=LeagueServiceConfig(port=0, slots=slots,
                                                                   policy="prioritized@0.7;exploiter@0.3"))).start()
    cfg = InferenceConfig(serve=ServeConfig(port=0, max_batch=4, models=slots + 1, gather_window_s=0.002,
                                            league_endpoint=f"127.0.0.1:{league.port}", league_sync_s=0.1),
                          policy=POLICY, seed=1, platform="cpu")
    server = InferenceServer(cfg).start()
    league.cfg.serve_endpoint = f"127.0.0.1:{server.port}"
    nets = {}
    for v in range(1, slots + 1):
        nets[f"v{v}"] = P.init_params(POLICY, torch.Generator().manual_seed(10 + v), "cpu")
        assert league.ingest_snapshot(f"v{v}", v, named_params(nets[f"v{v}"]))
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and any(server.stats()[f"serve_model_version_{m}"] != m
                                              for m in range(1, slots + 1)):
        time.sleep(0.05)
    assert all(server.stats()[f"serve_model_version_{m}"] == m for m in range(1, slots + 1))
    return league, server, nets


def test_remote_league_opponents_step_on_the_serve_slots_and_results_post():
    """--opponent league --serve.endpoint --serve.league: each episode asks
    GET /match, the dire hero steps on the matched slot of the port
    server, the live hero here, and the result moves /leaderboard; with
    the service down the episode falls back to a mirror."""
    league, server, _ = _league_rig()
    try:
        cfg = ActorConfig(policy=POLICY, platform="cpu", rollout_len=8, max_dota_time=10.0, opponent="league",
                          max_weight_age_s=0.0, serve=ServeClientConfig(endpoint=f"127.0.0.1:{server.port}",
                                                                        league=f"127.0.0.1:{league.port}"))
        actor = SelfPlayActor(cfg, tmem.MemoryBroker("spr"), actor_id=3,
                              stub=LocalDotaServiceStub(FakeDotaService()))
        assert actor.league is None
        run(actor.run(num_episodes=3))
        board = {r["name"]: r["games"] for r in league.leaderboard()["leaderboard"]}
        served = server.stats()["serve_requests_total"]
        league.stop()
        run(actor.run(num_episodes=4))
    finally:
        server.stop()
        league.stop()
    assert actor.remote_matches == 3 and actor.remote_results_posted == 3 and actor.remote_fallbacks == 0
    assert board["agent"] == 3 and sum(board.values()) == 6
    assert served >= actor.steps_done // 2 // 4 > 0
    assert actor.remote_match_errors == 1 and actor.episodes_done == 4
    frames = tmem.MemoryBroker("spr").consume_experience(100000, timeout=0.05)
    assert frames and all(tser.deserialize_rollout(f).actor_id == 3 for f in frames)


def test_group_key_step_rows_are_their_b1_steps_and_b1_is_the_key_step():
    """make_group_key_step: one key for the group (the reference's draw
    over a [B]-row dist); each row bitwise the B=1 group step on its own
    inputs with its row of the uniforms; at B=1 it is make_key_actor_step."""
    net = P.init_params(POLICY, torch.Generator().manual_seed(0), "cpu")
    rs = np.random.RandomState(0)
    group, single = tactor.make_group_key_step(POLICY), tactor.make_key_actor_step(POLICY)
    for B in (1, 2, 10):
        obs = as_tensors(F.stack([_rand_obs(rs) for _ in range(B)]), "cpu")
        state = (torch.from_numpy(rs.randn(B, 16).astype(np.float32)), torch.from_numpy(rs.randn(B, 16).astype(np.float32)))
        key = threefry.prng_key(B)
        new, action, logp, value, key2 = group(net, state, obs, key)
        assert np.array_equal(key2, threefry.split(key, 2)[0])
        if B == 1:
            want = single(net, state, obs, key)
            for x, y in zip((*new, *action, logp, value), (*want[0], *want[1], want[2], want[3])):
                assert torch.equal(x, y)
            assert np.array_equal(key2, want[4])
            continue
        from dotaclient_tpu_torch.ops import action_dist as ad

        sizes = (F.N_ACTION_TYPES, POLICY.n_move_bins, POLICY.n_move_bins, F.MAX_UNITS)
        u = torch.from_numpy(ad.key_uniforms(threefry.split(key, 2)[1], (B,), sizes))
        for i in range(B):
            row = tactor._row((state, obs), i)
            want = tactor._key_step_row(net, *row, u[i : i + 1].clone())
            for x, y in zip((*new, *action, logp, value), (*want[0], *want[1], want[2], want[3])):
                assert torch.equal(x[i : i + 1], y)


def _rand_obs(rs):
    o = F.zeros_observation()
    mask = rs.rand(F.N_ACTION_TYPES) > 0.3
    mask[0] = True
    return o._replace(unit_feats=rs.randn(*o.unit_feats.shape).astype(np.float32),
                      hero_feats=rs.randn(*o.hero_feats.shape).astype(np.float32),
                      global_feats=rs.randn(*o.global_feats.shape).astype(np.float32),
                      unit_mask=rs.rand(F.MAX_UNITS) > 0.3, target_mask=rs.rand(F.MAX_UNITS) > 0.3, action_mask=mask)


def test_5v5_mirror_is_one_b10_call_per_tick_and_publishes_per_hero():
    cfg = ActorConfig(policy=POLICY, platform="cpu", rollout_len=8, max_dota_time=6.0, opponent="self", team_size=5,
                      max_weight_age_s=0.0)
    tmem.reset("sp5")
    actor = SelfPlayActor(cfg, tmem.MemoryBroker("sp5"), actor_id=0, stub=LocalDotaServiceStub(FakeDotaService()))
    calls = []
    step = actor.step_fn

    def counting(net, state, obs, key):
        calls.append(obs.unit_feats.shape[0])
        return step(net, state, obs, key)

    actor.step_fn = counting
    run(actor.run(num_episodes=1))
    frames = tmem.MemoryBroker("sp5").consume_experience(100000, timeout=0.05)
    ticks = actor.steps_done // 10
    assert calls == [10] * ticks and ticks > 0
    assert len(frames) == actor.rollouts_published == 10 * -(-ticks // 8)
    assert actor.rollouts_shed == actor.rollouts_failed == 0


def test_selfplay_refuses_a_scripted_opponent_and_builds_the_valve_dialect():
    """A scripted opponent is refused, naming the flag; no mode is left
    unported, so the valve dialect builds."""
    cfg = ActorConfig(policy=POLICY, platform="cpu")
    with pytest.raises(ValueError, match="opponent"):
        SelfPlayActor(cfg, tmem.MemoryBroker("spx"))
    cfg.opponent, cfg.env_dialect = "self", "valve"  # the valve dialect is ported (A.11d): it builds
    assert SelfPlayActor(cfg, tmem.MemoryBroker("spx")).cfg.env_dialect == "valve"


def test_remote_opponent_lost_mid_episode_finishes_as_a_mirror():
    """The serve tier dies mid-episode: the opponent heroes finish the
    episode on the live net (the reference would step them with no net on
    the next tick), nothing posts, and the actor runs on."""
    league, server, _ = _league_rig()
    try:
        cfg = ActorConfig(policy=POLICY, platform="cpu", rollout_len=8, max_dota_time=12.0, opponent="league",
                          max_weight_age_s=0.0, serve=ServeClientConfig(endpoint=f"127.0.0.1:{server.port}",
                                                                        league=f"127.0.0.1:{league.port}",
                                                                        timeout_s=2.0, connect_timeout_s=0.5))
        actor = SelfPlayActor(cfg, tmem.MemoryBroker("spdeg"), actor_id=4,
                              stub=LocalDotaServiceStub(FakeDotaService()))
        step = actor._remote_opp_step

        async def dying(group, episode_start):
            if actor.steps_done >= 6 and server._thread is not None and server._thread.is_alive():
                server.stop()
            return await step(group, episode_start)

        actor._remote_opp_step = dying
        run(actor.run(num_episodes=2))
    finally:
        server.stop()
        league.stop()
    assert actor.remote_matches >= 1 and actor.remote_fallbacks >= 1 and actor.episodes_done == 2
    assert actor.remote_results_posted == 0 and actor.rollouts_published > 0
