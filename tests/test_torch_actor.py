"""The port's actor (dotaclient_tpu_torch/runtime/actor.py) against the
reference's: action messages and rollout frames byte for byte, an episode
step for step against the JAX Actor on the same params and seed, the
vector fleet bitwise its standalone actors, the publish throttle and the
kill switch, the refusals, the actor binary over loopback gRPC against
both packages' fake-env binaries, and a closed training loop of port
processes only."""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dotaclient_tpu.config import ActorConfig as JActorConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.config import parse_config as j_parse_config
from dotaclient_tpu.env.fake_dotaservice import FakeDotaService as JFakeDotaService
from dotaclient_tpu.env.service import LocalDotaServiceStub as JLocalStub
from dotaclient_tpu.models import policy as JP
from dotaclient_tpu.obs import ObsRuntime as JObsRuntime
from dotaclient_tpu.runtime import actor as jactor
from dotaclient_tpu.transport import base as jbase
from dotaclient_tpu.transport import memory as jmem
from dotaclient_tpu.transport import serialize as jser
from dotaclient_tpu_torch.config import (
    ActorConfig,
    LearnerConfig,
    ObsConfig,
    PolicyConfig,
    PPOConfig,
    parse_config,
    refuse_unported,
    unported_flags,
)
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
from dotaclient_tpu_torch.env.service import EnvRpcError, LocalDotaServiceStub
from dotaclient_tpu_torch.obs import ObsRuntime
from dotaclient_tpu_torch.ops import action_dist as ad
from dotaclient_tpu_torch.ops import threefry
from dotaclient_tpu_torch.ops.batch import as_tensors
from dotaclient_tpu_torch.protos import worldstate as tws
from dotaclient_tpu_torch.runtime import actor as tactor
from dotaclient_tpu_torch.runtime.harness import ActorPool
from dotaclient_tpu_torch.transport import base as tbase
from dotaclient_tpu_torch.transport import memory as tmem
from dotaclient_tpu_torch.transport import serialize as tser
from dotaclient_tpu_torch.transport.params import named_params
from test_torch_protos import _build, _spec

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(lstm_hidden=16, unit_embed_dim=16, mlp_hidden=16, dtype="float32")
SMALL_FLAGS = ["--policy.lstm_hidden", "16", "--policy.unit_embed_dim", "16", "--policy.mlp_hidden", "16",
               "--policy.dtype", "float32"]
# behavior_logp / behavior_value, port vs JAX on the same f32 params: the
# two frameworks' f32 matmuls and reductions sum in other orders (~1e-7
# relative per op over a few dozen ops).
TOL_LOGP = 1e-5
# A sampled index flips only where two Gumbel-perturbed logits of a head
# lie within this of each other (the same f32 reasons).
TOL_TIE = 1e-5


def _cfgs(**kw):
    """(port ActorConfig, reference ActorConfig) with the same fields."""
    t = ActorConfig(policy=PolicyConfig(**SMALL), platform="cpu", **kw)
    j = JActorConfig(policy=JPolicyConfig(**SMALL), **kw)
    return t, j


def _jax_params(net, jcfg):
    template = JP.init_params(jcfg.policy, jax.random.PRNGKey(0))
    return jser.unflatten_params(named_params(net), template)


def _frames(hub_mod, name):
    return hub_mod.MemoryBroker(name).consume_experience(100000, timeout=0.05)


# ------------------------------------------------------------ messages


def test_build_actions_proto_equals_the_reference_bytes():
    tcfg, jcfg = _cfgs()
    rng = np.random.RandomState(0)
    spec = _spec(tws.Unit)
    from hypothesis import HealthCheck, given, settings

    @settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
    @given(spec)
    def check(hero_spec):
        hero_spec = dict(hero_spec, unit_type=1, player_id=0)
        th, jh = _build(tws.Unit, hero_spec, False), _build(tws.Unit, hero_spec, True)
        for _ in range(6):
            act = ad.Action(*(np.array([rng.randint(n)], np.int32) for n in (4, 9, 9, F.MAX_UNITS)))
            handles = rng.randint(0, 2**32, F.MAX_UNITS).astype(np.uint32)
            dota_time = float(rng.uniform(-10, 700))
            for hero_t, hero_j in ((th, jh), (None, None)):
                ours = tactor.build_actions_proto(tcfg, act, handles, hero_t, 2, 0, dota_time)
                theirs = jactor.build_actions_proto(jcfg, act, handles, hero_j, 2, 0, dota_time)
                assert ours.SerializeToString() == theirs.SerializeToString()

    check()


def _chunk_pair(rng, L: int, H: int, aux: bool):
    """The same chunk content in the port's and the reference's _Chunk."""
    c, h = rng.randn(1, H).astype(np.float32), rng.randn(1, H).astype(np.float32)
    tc = tactor._Chunk((torch.from_numpy(c), torch.from_numpy(h)))
    jc = jactor._Chunk((c, h))
    for _ in range(L):
        o = F.zeros_observation()
        for leaf in o:
            leaf[...] = rng.randn(*leaf.shape) > 0 if leaf.dtype == bool else rng.randn(*leaf.shape)
        a = ad.Action(*(np.array([rng.randint(n)], np.int32) for n in (4, 9, 9, 16)))
        vals = (float(rng.randn()), float(rng.randn()), float(rng.randn()), float(rng.rand() < 0.2))
        for ch in (tc, jc):
            ch.obs.append(o)
            ch.actions.append(a)
            ch.logp.append(vals[0])
            ch.value.append(vals[1])
            ch.rewards.append(vals[2])
            ch.dones.append(vals[3])
            if aux:
                ch.aux_lh.append(0.25)
                ch.aux_nw.append(0.5)
    boot = F.zeros_observation()
    boot.global_feats[:] = rng.randn(F.GLOBAL_FEATURES)
    return tc, jc, boot


@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("aux", [False, True])
def test_chunk_to_rollout_serializes_to_the_reference_bytes(wire, traced, aux):
    rng = np.random.RandomState(3)
    tc, jc, boot = _chunk_pair(rng, 7, 16, aux)
    tr = tc.to_rollout(boot, 5, 17, 1.25, -1.0, aux)
    jr = jc.to_rollout(boot, 5, 17, 1.25, -1.0, aux)
    if traced:
        tr = tr._replace(trace_id=(17 << 32) | 3, birth_time=1.7e9)
        jr = jr._replace(trace_id=(17 << 32) | 3, birth_time=1.7e9)
    ours = tser.serialize_rollout(tser.wire_cast_fn(wire)(tr))
    theirs = jser.serialize_rollout(jser.wire_cast_fn(wire)(jr))
    assert ours == theirs
    assert ours[:4] == {("f32", False): b"DTR1", ("f32", True): b"DTR2"}.get((wire, traced), b"DTR3")
    with pytest.raises(ValueError, match="obs_dtype"):
        tser.wire_cast_fn("f16")


def test_obs_stamp_allocates_the_reference_trace_ids():
    rng = np.random.RandomState(4)
    tc, jc, boot = _chunk_pair(rng, 3, 16, False)
    ours = ObsRuntime.create(ObsConfig(enabled=True, install_handlers=False), "actor7")
    from dotaclient_tpu.config import ObsConfig as JObsConfig

    theirs = JObsRuntime.create(JObsConfig(enabled=True, install_handlers=False), "actor7")
    for _ in range(3):
        a = ours.stamp(tc.to_rollout(boot, 0, 7, 0.0, 0.0, False), 7)
        b = theirs.stamp(jc.to_rollout(boot, 0, 7, 0.0, 0.0, False), 7)
        assert a.trace_id == b.trace_id and abs(a.birth_time - b.birth_time) < 5.0
    assert [e["ev"] for e in ours.recorder.snapshot()["events"]][-3:] == ["publish"] * 3


def test_td_error_priority_equals_the_reference():
    from dotaclient_tpu.replay import td_error_priority as j_prio
    from dotaclient_tpu_torch.replay import td_error_priority as t_prio

    rng = np.random.RandomState(5)
    for n in (0, 1, 7, 16):
        r, v, d = rng.randn(n), rng.randn(n), (rng.rand(n) < 0.2).astype(np.float32)
        assert t_prio(r, v, d, 0.98) == j_prio(r, v, d, 0.98)
    assert t_prio([np.nan], [1.0], [0.0], 0.98) == j_prio([np.nan], [1.0], [0.0], 0.98) == 0.0


# -------------------------------------------------------- episode parity


class _TraceActor(tactor.Actor):
    """The port Actor with each step's (state, obs, key) recorded."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.trace = []

    async def _policy_step(self, state, obs, chunk_len=0, episode_start=False):
        self.trace.append((tuple(x.clone() for x in state), obs, self.rng.copy()))
        return await super()._policy_step(state, obs, chunk_len, episode_start)


class _JTraceActor(jactor.Actor):
    """The reference Actor with each step's key recorded."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.keys = []

    async def _policy_step(self, state, obs, chunk_len=0, episode_start=False):
        self.keys.append(np.asarray(self.rng).copy())
        return await super()._policy_step(state, obs, chunk_len, episode_start)


def _steps(frames):
    """Each step of a frame list: (obs row, action, logp, value, reward,
    done), in publish order."""
    out = []
    for f in frames:
        r = tser.deserialize_rollout(f)
        for t in range(r.length):
            out.append((tuple(np.asarray(x[t]) for x in r.obs), tuple(int(a[t]) for a in r.actions),
                        float(r.behavior_logp[t]), float(r.behavior_value[t]), float(r.rewards[t]),
                        float(r.dones[t])))
    return out


def _near_tie(net, cfg: PolicyConfig, state, obs, key, ours, theirs) -> None:
    """At a flipped sample: each head whose index differs had its two
    perturbed logits (the port's) within TOL_TIE of each other."""
    with torch.no_grad():
        _, out = net(state, as_tensors(F.stack([obs]), "cpu"))
    sizes = (F.N_ACTION_TYPES, cfg.n_move_bins, cfg.n_move_bins, F.MAX_UNITS)
    u = ad.key_uniforms(threefry.split(key, 2)[1], (1,), sizes)
    noise = -np.log(-np.log(u[0]))
    start = 0
    for h, n in enumerate(sizes):
        pert = out.dist[h][0].numpy() + noise[start : start + n]
        start += n
        if ours[h] != theirs[h]:
            assert abs(pert[ours[h]] - pert[theirs[h]]) <= TOL_TIE, (h, pert[ours[h]], pert[theirs[h]])


@pytest.mark.parametrize("seed,actor_id", [(0, 0), (3, 5)])
def test_episode_parity_with_the_jax_actor(seed, actor_id):
    """Two episodes of the port Actor and the JAX Actor, same f32 params,
    seed and actor_id, each on its package's fake env: equal actions,
    rewards, dones and obs and equal jax keys step by step; logp and value
    within TOL_LOGP. A sampled index that flips on a near-tie ends the
    comparison there (the tie is asserted)."""
    tcfg, jcfg = _cfgs(seed=seed, rollout_len=8, max_dota_time=40.0, opponent="scripted_hard")
    tname, jname = f"par_t{seed}", f"par_j{seed}"
    tmem.reset(tname)
    jmem.reset(jname)
    ours = _TraceActor(tcfg, tmem.MemoryBroker(tname), actor_id=actor_id, stub=LocalDotaServiceStub(FakeDotaService()))
    theirs = _JTraceActor(jcfg, jmem.MemoryBroker(jname), actor_id=actor_id, stub=JLocalStub(JFakeDotaService()),
                          params=_jax_params(ours.params, jcfg))
    asyncio.run(ours.run(num_episodes=2))
    asyncio.run(theirs.run(num_episodes=2))
    ts, js = _steps(_frames(tmem, tname)), _steps(_frames(jmem, jname))
    assert len(ts) == ours.steps_done and len(js) == theirs.steps_done and len(ts) > 40
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
    assert ours.rng.tolist() == np.asarray(theirs.rng).tolist() or compared < len(ts)


def test_prng_key_is_jax_prngkey():
    for s in (0, 7, 9973 * 3 + 2, 2**31 + 5, 2**33 + 1, -1):
        assert threefry.prng_key(s).tolist() == np.asarray(jax.random.PRNGKey(s)).tolist()


# --------------------------------------------------------------- fleet


def test_vector_actor_slots_are_bitwise_standalone_actors():
    tcfg, _ = _cfgs(seed=2, rollout_len=8, max_dota_time=30.0)
    M, svc = 3, FakeDotaService()
    tmem.reset("vec_fleet")
    tmem.reset("vec_single")
    vec = tactor.VectorActor(tcfg, tmem.MemoryBroker("vec_fleet"), actor_id=1, envs=M,
                             stubs=[LocalDotaServiceStub(svc) for _ in range(M)])
    asyncio.run(vec.run_episodes(2))
    for j in range(M):
        a = tactor.Actor(tcfg, tmem.MemoryBroker("vec_single"), actor_id=M + j, stub=LocalDotaServiceStub(svc))
        asyncio.run(a.run(num_episodes=2))

    def by_actor(name):
        out = {}
        for f in _frames(tmem, name):
            out.setdefault(tser.peek_rollout_actor_id(f), []).append(f)
        return out

    fleet, single = by_actor("vec_fleet"), by_actor("vec_single")
    assert sorted(fleet) == sorted(single) == [3, 4, 5]
    for aid in single:
        assert fleet[aid] == single[aid] and len(single[aid]) > 2
    st = vec.stats()
    assert st["actor_rollouts_published_total"] == st["actor_publish_attempted_total"] == sum(map(len, single.values()))
    assert vec.episodes_done == 2 * M and st["actor_jit_step_s"] > 0


def test_actor_pool_runs_actors_and_vector_actors():
    """ActorPool drives plain Actors and VectorActors (episode_stream)
    on their threads; an Actor whose cfg has envs_per_process 2 is wrapped
    into a VectorActor over it."""
    tcfg, _ = _cfgs(rollout_len=8, max_dota_time=10.0)
    vcfg, _ = _cfgs(envs_per_process=2, rollout_len=8, max_dota_time=10.0)
    tmem.reset("pool")
    svc, seen = FakeDotaService(), []

    def make(i):
        if i == 0:
            return tactor.Actor(tcfg, tmem.MemoryBroker("pool"), actor_id=0, stub=LocalDotaServiceStub(svc))
        return tactor.VectorActor(vcfg, tmem.MemoryBroker("pool"), actor_id=i,
                                  stubs=[LocalDotaServiceStub(svc) for _ in range(2)])

    pool = ActorPool(make, 2, on_episode=lambda i, a, r: seen.append(i), envs_per_actor=1).start()
    deadline = time.monotonic() + 60
    while (seen.count(0) < 2 or seen.count(1) < 2) and time.monotonic() < deadline:
        time.sleep(0.05)
    pool.stop(timeout=30, raise_on_dead=True)
    assert seen.count(0) >= 2 and seen.count(1) >= 2
    st = pool.publish_stats()
    assert st["published"] > 0 and st["dead_actors"] == 0 and st["shed"] == st["failed"] == 0
    wrapped = ActorPool(make, 1)._maybe_vectorize(tactor.Actor(vcfg, tmem.MemoryBroker("pool")))
    assert isinstance(wrapped, tactor.VectorActor) and len(wrapped.envs) == 2


# ------------------------------------------------- throttle, kill switch


class _ScriptedBroker:
    """Raises per a script: "ok", "shed" or "down" per publish."""

    def __init__(self, script, shed_error):
        self.script = list(script)
        self.shed_error = shed_error
        self.got = []

    def publish_experience(self, data):
        step = self.script.pop(0)
        if step == "shed":
            raise self.shed_error("queue full")
        if step == "down":
            raise ConnectionError("broker down")
        self.got.append(data)


def _throttle_run(throttle_cls, shed_error, script, monkeypatch):
    sleeps = []

    async def fake_sleep(s):
        sleeps.append(s)

    monkeypatch.setattr(asyncio, "sleep", fake_sleep)
    broker = _ScriptedBroker(script, shed_error)
    throttle = throttle_cls(tbase.RetryPolicy(jitter=0.5, rng=random.Random(11)) if throttle_cls is tactor.ShedThrottle
                            else jbase.RetryPolicy(jitter=0.5, rng=random.Random(11)))
    results = [asyncio.run(throttle.publish(broker, b"x")) for _ in script]
    return results, (throttle.published, throttle.shed, throttle.failed, throttle.throttle_s), sleeps, throttle.stats()


def test_shed_throttle_counts_and_backoff_equal_the_reference(monkeypatch):
    rng = np.random.RandomState(6)
    script = [str(x) for x in rng.choice(["ok", "shed", "down"], 40, p=[0.5, 0.3, 0.2])]
    ours = _throttle_run(tactor.ShedThrottle, tbase.BrokerShedError, script, monkeypatch)
    theirs = _throttle_run(jactor.ShedThrottle, jbase.BrokerShedError, script, monkeypatch)
    assert ours == theirs
    results, (published, shed, failed, _), sleeps, _ = ours
    assert published == script.count("ok") and shed == script.count("shed") and failed == script.count("down")
    assert published + shed + failed == len(script) and len(sleeps) == shed + failed


def test_stale_weights_kill_switch_fires_past_max_weight_age():
    tcfg, _ = _cfgs(max_weight_age_s=5.0)
    tmem.reset("stale")
    hub = tmem.MemoryBroker("stale")
    actor = tactor.Actor(tcfg, hub, stub=LocalDotaServiceStub(FakeDotaService()))
    actor.check_weight_freshness()
    actor.last_weight_time -= 6.0
    with pytest.raises(tactor.StaleWeightsError, match="no weight update"):
        asyncio.run(actor.run(num_episodes=1))
    hub.publish_weights(tser.serialize_weights(named_params(actor.params), version=3))
    assert actor.maybe_update_weights() and actor.version == 3
    actor.check_weight_freshness()  # a frame resets the clock
    off, _ = _cfgs(max_weight_age_s=0.0)
    idle = tactor.Actor(off, hub, stub=LocalDotaServiceStub(FakeDotaService()))
    idle.last_weight_time -= 1e6
    idle.check_weight_freshness()


class _Enough(Exception):
    pass


def test_env_rpc_errors_are_retried_with_the_capped_backoff(monkeypatch):
    """An env outage abandons the episode and retries 1, 2, 4 … 30 s,
    dropping the stub so the next episode dials afresh."""
    sleeps = []

    async def fake_sleep(s):
        sleeps.append(s)
        if len(sleeps) >= 7:
            raise _Enough

    class _Cause:
        def code(self):
            return "UNAVAILABLE"

        def details(self):
            return "connection refused"

    class _DownStub:
        class channel:
            @staticmethod
            async def close():
                pass

        async def reset(self, request):
            raise EnvRpcError("reset", _Cause())

    tcfg, _ = _cfgs()
    actor = tactor.Actor(tcfg, tmem.MemoryBroker("rpc_down"), stub=_DownStub())
    dials = []
    monkeypatch.setattr(tactor, "connect_env_async", lambda cfg: dials.append(cfg.env_addr) or _DownStub())
    monkeypatch.setattr(asyncio, "sleep", fake_sleep)
    with pytest.raises(_Enough):
        asyncio.run(actor.run(num_episodes=1))
    assert sleeps == [1.0, 2.0, 4.0, 8.0, 16.0, 30.0, 30.0]
    assert dials == [tcfg.env_addr] * 6 and actor.episodes_done == 0
    err = EnvRpcError("observe", _Cause())
    assert err.code() == "UNAVAILABLE" and err.details() == "connection refused" and "observe" in str(err)


# ------------------------------------------------------------ refusals


def test_valve_dialect_builds_and_dials(monkeypatch):
    """The valve dialect (once refused, A.11d): Actor, VectorActor and the
    binary take it, and the env stub an actor dials speaks the real
    dotaservice's service (tests/test_torch_valve_adapter.py plays
    episodes over it)."""
    from dotaclient_tpu_torch.env import service
    from dotaclient_tpu_torch.env.valve_adapter import VALVE_SERVICE, ValveDotaServiceStub

    cfg = ActorConfig(platform="cpu", policy=PolicyConfig(**SMALL), env_dialect="valve")
    actor = tactor.Actor(cfg, tmem.MemoryBroker("refuse"))
    vec = tactor.VectorActor(cfg, tmem.MemoryBroker("refuse"), envs=2)
    assert actor.cfg.env_dialect == vec.cfg.env_dialect == "valve"

    async def dial():
        internal = tactor.connect_env_async(dataclasses.replace(cfg, env_dialect="internal"))
        stub = tactor.connect_env_async(cfg)
        await internal.channel.close()
        await stub.channel.close()
        return internal, stub

    internal, stub = asyncio.run(dial())
    assert isinstance(stub, ValveDotaServiceStub) and not isinstance(internal, ValveDotaServiceStub)
    assert stub._calls["reset"]._method == f"/{VALVE_SERVICE}/reset".encode()
    seen = []
    monkeypatch.setattr(service, "require_grpc", lambda: None)
    monkeypatch.setattr(tactor, "build_actors", lambda c, broker: seen.append(c) or [])
    tactor.main(["--env_dialect", "valve", "--platform", "cpu", "--broker_url", "mem://refuse"])
    assert [c.env_dialect for c in seen] == ["valve"]


def test_main_chaos_enabled_wraps_the_broker(monkeypatch):
    """--chaos.enabled: the actor binary builds its actors on a ChaosBroker
    over the production broker; chaos off hands them the broker itself."""
    seen = []
    from dotaclient_tpu_torch.env import service

    monkeypatch.setattr(service, "require_grpc", lambda: None)
    monkeypatch.setattr(tactor, "build_actors", lambda cfg, broker: seen.append(broker) or [])
    argv = ["--platform", "cpu", "--broker_url", "mem://actor_chaos", "--chaos.enabled", "true", "--chaos.seed", "2",
            "--chaos.spec", "corrupt:0.5,latency:0.001"]
    tactor.main(argv)
    tactor.main(argv[:4])
    from dotaclient_tpu_torch.chaos import ChaosBroker

    wrapped, plain = seen
    assert type(wrapped) is ChaosBroker and type(wrapped.inner) is tmem.MemoryBroker
    assert wrapped.schedule.seed == 2 and wrapped.schedule.rates == {"corrupt": 0.5}
    assert wrapped.schedule.latency_mean_s == 0.001 and type(plain) is tmem.MemoryBroker


def test_every_unported_actor_mode_is_tested_and_the_serve_client_flags_do_not_parse():
    """The actor has no unported mode left: the valve dialect (the case
    above), the remote client and self-play parse to the reference's
    values and select no refusal (the name is this test's since the flags
    were unported)."""
    assert unported_flags(ActorConfig()) == []
    for argv in (["--serve.cooldown_s", "5"], ["--serve.resume", "true"], ["--team_size", "5"],
                 ["--pfsp_mode", "even"], ["--serve.route", "load"], ["--serve.endpoint", "a:1,b:2"],
                 ["--serve.league", "league:13410"], ["--opponent", "self"], ["--opponent", "league"],
                 ["--env_dialect", "valve"]):
        ours, theirs = parse_config(ActorConfig(), argv), j_parse_config(JActorConfig(), argv)
        assert vars(ours.serve) == vars(theirs.serve)
        assert (ours.team_size, ours.pfsp_mode, ours.opponent, ours.env_dialect) == (
            theirs.team_size, theirs.pfsp_mode, theirs.opponent, theirs.env_dialect)
        refuse_unported(ours)


def test_the_scripted_actor_manifest_parses_as_the_reference_does():
    """The actors-scripted container's args less --serve.* and --env_addr:
    every field equals the reference's parse, but for platform ("" is
    the card in the port, "cpu" in the reference)."""
    import chip_smoke

    args = chip_smoke.actor_args("tcp://a:1,tcp://b:2,tcp://c:3", "/tmp/x", 3)
    assert not any(a.startswith("--serve.") or a == "--env_addr" for a in args)
    ours, theirs = parse_config(ActorConfig(), args), j_parse_config(JActorConfig(), args)
    assert (ours.opponent, ours.envs_per_process, ours.wire.obs_dtype, ours.obs.enabled, ours.max_weight_age_s) == \
        ("scripted_hard", 2, "bf16", True, 300.0)
    assert (ours.platform, theirs.platform) == ("", "cpu")

    def same(a, b, path=""):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if dataclasses.is_dataclass(x):
                same(x, y, f"{path}{f.name}.")
            elif f.name != "platform":
                assert x == y, f"{path}{f.name}"

    same(ours, theirs)


def test_a_network_env_without_grpc_fails_at_boot_naming_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "grpc", None)
    with pytest.raises(RuntimeError, match="grpc"):
        tactor.main(["--platform", "cpu", "--broker_url", "mem://nogrpc"])
    tcfg, _ = _cfgs()
    with pytest.raises(RuntimeError, match="grpc"):
        tactor.connect_env_async(tcfg)


# --------------------------------------------------- binaries over gRPC


def _start(cmd, ready: str, env=None, timeout: float = 60.0):
    """A subprocess whose first stdout line starts with `ready` within
    `timeout` seconds; returns (process, that line)."""
    import select

    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, text=True, env=env)
    line = ""
    if select.select([proc.stdout], [], [], timeout)[0]:
        line = proc.stdout.readline().strip()
    if not line.startswith(ready):
        proc.kill()
        proc.wait(timeout=10)
        raise AssertionError(f"{cmd}: ready line {line!r}")
    return proc, line


def _stop(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


@pytest.mark.parametrize("env_pkg", ["dotaclient_tpu_torch", "dotaclient_tpu"])
def test_actor_binary_over_loopback_grpc_feeds_the_port_staging(env_pkg, tmp_path):
    """`python -m dotaclient_tpu_torch.runtime.actor --platform cpu`
    against the port's fake-env binary and the reference's (the
    cross-package wire), publishing bf16 trace-stamped frames over the
    port's tcp:// broker; the port learner trains a step on them."""
    from dotaclient_tpu_torch.runtime.learner import Learner
    from dotaclient_tpu_torch.transport.tcp import BrokerServer, TcpBroker

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    fake, line = _start([sys.executable, "-m", f"{env_pkg}.env.fake_dotaservice", "--port", "0"],
                        "fake dotaservice listening on 127.0.0.1:", env=env)
    server = BrokerServer("127.0.0.1", 0).start()
    actor = None
    try:
        port = int(line.rsplit(":", 1)[1])
        actor = subprocess.Popen([sys.executable, "-m", "dotaclient_tpu_torch.runtime.actor", "--platform", "cpu",
                                  "--env_addr", f"127.0.0.1:{port}", "--broker_url", f"tcp://127.0.0.1:{server.port}",
                                  "--envs_per_process", "2", "--rollout_len", "8", "--max_dota_time", "20",
                                  "--wire.obs_dtype", "bf16", "--obs.enabled", "true", "--obs.install_handlers",
                                  "false", "--seed", "4", *SMALL_FLAGS], cwd=REPO, env=env)
        client = TcpBroker("127.0.0.1", server.port)
        frames, deadline = [], time.monotonic() + 90
        while len(frames) < 8 and time.monotonic() < deadline and actor.poll() is None:
            frames += client.consume_experience(64, timeout=0.5)
        assert len(frames) >= 8, f"{len(frames)} frames, actor exit {actor.poll()}"
    finally:
        if actor is not None:
            _stop(actor)
        _stop(fake)
    rollouts = [tser.deserialize_rollout(f) for f in frames]
    assert all(f[:4] == b"DTR3" and r.traced for f, r in zip(frames, rollouts))
    assert {r.actor_id for r in rollouts} <= {0, 1} and all(r.length <= 8 for r in rollouts)
    cfg = LearnerConfig(batch_size=4, seq_len=8, policy=PolicyConfig(**SMALL), platform="cpu",
                        ppo=PPOConfig(max_staleness=1000))
    tmem.reset("grpc_feed")
    hub = tmem.MemoryBroker("grpc_feed")
    for f in frames:
        hub.publish_experience(f)
    learner = Learner(cfg, tmem.MemoryBroker("grpc_feed"), device="cpu")
    try:
        assert learner.run(num_steps=1, batch_timeout=30.0, max_idle=3) == 1
        stats = learner.staging.stats()
        assert stats["quarantined"] == 0 and stats["wire_frames_obs_bf16"] >= 4
    finally:
        learner.close()
        server.stop()


# --------------------------------------------------- the closed loop, CPU


def test_closed_loop_of_port_processes_on_the_cpu(tmp_path):
    """Port fake env → port actor processes (chip_smoke.py --actor-proc,
    the env in-process) → the port's tcp:// broker → the port learner →
    weight frames back: every actor applies v>=1 and publishes frames
    stamped with it, and no actor process holds jax, google.protobuf or
    grpc."""
    import chip_smoke
    from dotaclient_tpu_torch.runtime.learner import Learner
    from dotaclient_tpu_torch.transport.tcp import BrokerServer, TcpBroker

    server = BrokerServer("127.0.0.1", 0).start()
    url = f"tcp://127.0.0.1:{server.port}"
    d = tmp_path / "actors"
    d.mkdir()
    procs = [subprocess.Popen([sys.executable, "chip_smoke.py", "--actor-proc", str(d), str(i), "--broker_url", url,
                               "--actor_id", str(i), "--envs_per_process", "2", "--rollout_len", "8",
                               "--max_dota_time", "30", "--platform", "cpu", "--wire.obs_dtype", "bf16",
                               "--obs.enabled", "true", "--obs.dump_dir", str(tmp_path), *SMALL_FLAGS], cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"))
             for i in range(2)]
    status = lambda: [json.loads((d / f"actor{i}.json").read_text()) if (d / f"actor{i}.json").exists() else {}  # noqa: E731
                      for i in range(2)]
    cfg = LearnerConfig(batch_size=4, seq_len=8, policy=PolicyConfig(**SMALL), platform="cpu")
    learner = Learner(cfg, TcpBroker("127.0.0.1", server.port), device="cpu")
    try:
        assert learner.run(num_steps=4, batch_timeout=60.0, max_idle=5) == 4
        deadline = time.monotonic() + 60
        while not all(any(int(v) >= 1 for v in s.get("versions", {})) for s in status()):
            assert time.monotonic() < deadline and all(p.poll() is None for p in procs), status()
            time.sleep(0.1)
        (d / "stop").touch()
        for p in procs:
            assert p.wait(timeout=60) == 0
    finally:
        learner.close()
        for p in procs:
            _stop(p)
        server.stop()
    for s in status():
        assert s["done"] and s["forbidden"] == [] and max(s["applied"]) >= 1
        assert s["attempts"] == s["published"] + s["shed"] + s["failed"] and s["launches"] == 0
        assert s["dtr3_traced"] == s["published"] > 0 and s["device"] == "cpu"
    assert chip_smoke.forbidden_modules(["jax.numpy", "dotaclient_tpu", "dotaclient_tpu.env", "grpc",
                                         "google.protobuf.message", "dotaclient_tpu_torch.env", "google"]) == \
        ["dotaclient_tpu", "dotaclient_tpu.env", "google.protobuf.message", "grpc", "jax.numpy"]


def test_the_port_processes_import_no_jax_protobuf_grpc_or_tensorboard(tmp_path):
    """A process that imports the port's binaries (learner, actor, server,
    fabric shard, fake env) and writes a metrics window, TensorBoard file
    included, holds none of jax, dotaclient_tpu, google.protobuf, grpc or
    tensorboard."""
    code = (
        "import json, sys\n"
        "from dotaclient_tpu_torch.runtime import learner, actor, harness\n"
        "from dotaclient_tpu_torch.serve import server\n"
        "from dotaclient_tpu_torch.transport import fabric, tcp_server\n"
        "from dotaclient_tpu_torch.env import fake_dotaservice, service\n"
        "from dotaclient_tpu_torch.runtime.metrics import MetricsLogger\n"
        f"m = MetricsLogger({str(tmp_path)!r}); m.log(1, {{'loss': 0.5}}); m.close()\n"
        "import chip_smoke\n"
        "print(json.dumps(chip_smoke.forbidden_modules(sys.modules) +\n"
        "                 [n for n in sys.modules if n.split('.')[0] == 'tensorboard']))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(list(tmp_path.glob("events.out.tfevents.*"))) == 1
