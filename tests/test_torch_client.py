"""The port's remote-inference client (dotaclient_tpu_torch/serve/client.py)
against the reference (dotaclient_tpu/serve/client.py) on the CPU:
endpoint parsing, frames of a RemoteFleet byte for byte the reference
fleet's against one server (each package's client against the port's
server, and both against the reference's server), the failover,
cooldown, fallback and resume scenarios of the reference's own tests,
and the k8s/actors.yaml deployments through the port's actor binary.

Small policy (16 wide, f32 compute), the fake env in-process."""

from __future__ import annotations

import asyncio
import time

import numpy as np
import pytest
import torch

from dotaclient_tpu.config import ActorConfig as JActorConfig
from dotaclient_tpu.config import InferenceConfig as JInferenceConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.config import ServeClientConfig as JServeClientConfig
from dotaclient_tpu.config import ServeConfig as JServeConfig
from dotaclient_tpu.config import parse_config as j_parse_config
from dotaclient_tpu.env.fake_dotaservice import FakeDotaService as JFakeDotaService
from dotaclient_tpu.env.service import LocalDotaServiceStub as JLocalStub
from dotaclient_tpu.serve import client as jclient
from dotaclient_tpu.serve.server import InferenceServer as JInferenceServer
from dotaclient_tpu.transport import memory as jmem
from dotaclient_tpu_torch.config import (
    ActorConfig,
    InferenceConfig,
    PolicyConfig,
    RetryConfig,
    ServeClientConfig,
    ServeConfig,
    parse_config,
)
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
from dotaclient_tpu_torch.models import policy as P
from dotaclient_tpu_torch.ops import threefry
from dotaclient_tpu_torch.runtime import actor as tactor
from dotaclient_tpu_torch.runtime.harness import ActorPool
from dotaclient_tpu_torch.serve import client as tclient
from dotaclient_tpu_torch.serve.handoff import CarryStoreServer
from dotaclient_tpu_torch.serve.server import InferenceServer
from dotaclient_tpu_torch.transport import memory as tmem
from dotaclient_tpu_torch.transport.serialize import deserialize_rollout, serialize_weights
from dotaclient_tpu_torch.transport.params import named_params

SMALL = dict(lstm_hidden=16, unit_embed_dim=16, mlp_hidden=16, dtype="float32")
POLICY = PolicyConfig(**SMALL)


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def port_server(port=0, max_batch=4, seed=1, **serve_kw):
    cfg = InferenceConfig(serve=ServeConfig(port=port, max_batch=max_batch, gather_window_s=0.002,
                                            weight_poll_s=0.05, **serve_kw),
                          policy=POLICY, seed=seed, platform="cpu")
    return InferenceServer(cfg).start()


class Incarnations:
    """Sequential lives of a port InferenceServer on one port: kill()
    stops it (every connection aborted), restart() boots a fresh one (no
    carries) on the same port."""

    def __init__(self, **kw):
        self.kw = kw
        self.server = port_server(**kw)
        self.port = self.server.port

    def kill(self):
        self.server.stop()
        self.server = None

    def restart(self):
        self.server = port_server(port=self.port, **self.kw)

    def close(self):
        if self.server is not None:
            self.server.stop()


def _scfg(endpoint, **kw):
    return ServeClientConfig(endpoint=endpoint, timeout_s=kw.pop("timeout_s", 4.0),
                             connect_timeout_s=kw.pop("connect_timeout_s", 1.0),
                             cooldown_s=kw.pop("cooldown_s", 0.2), **kw)


def _acfg(endpoint, seed=3, **serve_kw):
    return ActorConfig(rollout_len=8, max_dota_time=3.0, policy=POLICY, seed=seed, max_weight_age_s=0.0,
                       serve=_scfg(endpoint, **serve_kw), platform="cpu",
                       retry=RetryConfig(window_s=3.0, backoff_base_s=0.02, backoff_cap_s=0.1))


def _rand_obs(rs):
    o = F.zeros_observation()
    return o._replace(
        unit_feats=np.asarray(rs.randn(*o.unit_feats.shape), np.float32),
        hero_feats=np.asarray(rs.randn(*o.hero_feats.shape), np.float32),
        global_feats=np.asarray(rs.randn(*o.global_feats.shape), np.float32),
        unit_mask=np.asarray(rs.rand(*o.unit_mask.shape) > 0.3),
        action_mask=np.ones_like(o.action_mask),
        target_mask=np.asarray(rs.rand(*o.target_mask.shape) > 0.3),
    )


# ------------------------------------------------------------- parsing

SPECS = ["127.0.0.1:13380", "a:1,b:2", " a:1 , b:2 ,c:3", ":5", "inference-0.inference:13380,inference-1.inference:13380",
         "control:ctl:13400", "control::7", "", "a", "a:", "a:x", "a:0", "a:70000", "a:1,,b:2", "a:1,", ",a:1",
         "a:1,b", "control:", "control:ctl", "control:ctl:x", "control:ctl:0"]


def _outcome(fn, spec):
    try:
        return ("ok", fn(spec))
    except ValueError:
        return ("ValueError", None)


@pytest.mark.parametrize("spec", SPECS)
def test_endpoint_parsing_equals_the_reference(spec):
    assert _outcome(tclient.parse_endpoints, spec) == _outcome(jclient.parse_endpoints, spec)
    assert _outcome(tclient.split_control_scheme, spec) == _outcome(jclient.split_control_scheme, spec)
    if _outcome(tclient.parse_endpoints, spec)[0] == "ValueError" and spec:
        with pytest.raises(ValueError):
            tclient.RemotePolicyClient(spec, POLICY)


def test_client_config_surface_equals_the_reference():
    argv = ["--serve.endpoint", "inf-0:13380,inf-1:13380", "--serve.timeout_s", "7", "--serve.connect_timeout_s", "2",
            "--serve.cooldown_s", "1.5", "--serve.fallback_local", "true", "--serve.fallback_after_s", "2.5",
            "--serve.resume", "true", "--serve.resume_window_s", "9", "--serve.route", "load", "--serve.model", "2",
            "--serve.league", "league:13410", "--team_size", "5", "--league_capacity", "4",
            "--league_snapshot_every", "3", "--pfsp_mode", "even", "--opponent", "league"]
    ours, theirs = parse_config(ActorConfig(), argv), j_parse_config(JActorConfig(), argv)
    assert vars(ours.serve) == vars(theirs.serve)
    for f in ("team_size", "league_capacity", "league_snapshot_every", "pfsp_mode", "opponent"):
        assert getattr(ours, f) == getattr(theirs, f)
    assert vars(ServeClientConfig()) == vars(JServeClientConfig())
    with pytest.raises(ValueError, match="route"):
        tclient.RemotePolicyClient("a:1", POLICY, route="random")
    with pytest.raises(ValueError, match="obs_dtype"):
        tclient.RemotePolicyClient("a:1", POLICY, wire_obs_dtype="f16")


# -------------------------------------------------- frames vs the reference


def _port_fleet(endpoint, hub, seed, envs, episodes):
    cfg = _acfg(endpoint, seed=seed, timeout_s=30.0)
    tmem.reset(hub)
    fleet = tclient.RemoteFleet(cfg, tmem.MemoryBroker(hub), actor_id=1, envs=envs)
    svc = FakeDotaService()
    for e in fleet.envs:
        e._stub = LocalDotaServiceStub(svc)
    run(_per_env(fleet, episodes))
    return tmem.MemoryBroker(hub).consume_experience(100000, timeout=0.05), fleet


def _jax_fleet(endpoint, hub, seed, envs, episodes):
    jcfg = JActorConfig(rollout_len=8, max_dota_time=3.0, policy=JPolicyConfig(**SMALL), seed=seed,
                        max_weight_age_s=0.0, serve=JServeClientConfig(endpoint=endpoint, timeout_s=30.0))
    jmem.reset(hub)
    fleet = jclient.RemoteFleet(jcfg, jmem.MemoryBroker(hub), actor_id=1, envs=envs)
    svc = JFakeDotaService()
    for e in fleet.envs:
        e._stub = JLocalStub(svc)
    run(_per_env(fleet, episodes))
    return jmem.MemoryBroker(hub).consume_experience(100000, timeout=0.05), fleet


async def _per_env(fleet, episodes):
    """`episodes` episodes on every env slot, the slots concurrent on one
    connection (each slot's frames depend only on its own stream)."""

    async def one(env):
        for _ in range(episodes):
            await env.run_episode()

    try:
        await asyncio.gather(*(one(e) for e in fleet.envs))
    finally:
        await fleet.client.close()


def _by_actor(frames):
    out = {}
    for f in frames:
        out.setdefault(deserialize_rollout(f).actor_id, []).append(f)
    return out


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_remote_fleet_frames_byte_equal_the_reference_fleet(server_pkg):
    """A port RemoteFleet and a JAX RemoteFleet, same seed and actor ids,
    stepping one server (the port's, then the reference's): every slot
    publishes the same DTR frames, byte for byte."""
    if server_pkg == "port":
        server = port_server()
    else:
        server = JInferenceServer(JInferenceConfig(serve=JServeConfig(port=0, max_batch=4, gather_window_s=0.002),
                                                   policy=JPolicyConfig(**SMALL), seed=1)).start()
    endpoint = f"127.0.0.1:{server.port}"
    try:
        ours, tfleet = _port_fleet(endpoint, f"rf_t_{server_pkg}", 5, 3, 2)
        theirs, jfleet = _jax_fleet(endpoint, f"rf_j_{server_pkg}", 5, 3, 2)
    finally:
        server.stop()
    a, b = _by_actor(ours), _by_actor(theirs)
    assert sorted(a) == sorted(b) == [3, 4, 5]
    for aid in a:
        assert len(a[aid]) == len(b[aid]) and len(a[aid]) >= 2
        for x, y in zip(a[aid], b[aid]):
            assert x == y, f"actor {aid}: frame bytes differ"
    assert tfleet.steps_done == jfleet.steps_done > 0
    assert tfleet.client.steps == jfleet.client.steps and tfleet.client.errors == 0
    # the port's fleet also exports the producer ledger's two counters
    # (obs/fleet.py LEDGERS), which the reference exports from VectorActor only
    producer = {"actor_publish_attempted_total", "actor_rollouts_published_total"}
    assert set(tfleet.stats()) == set(jfleet.stats()) | producer and not producer & set(jfleet.stats())
    st = tfleet.stats()
    assert st["actor_publish_attempted_total"] == st["actor_rollouts_published_total"] == tfleet.rollouts_published > 0


def test_latency_percentiles_and_fleet_run_export_the_meters():
    server = port_server()
    try:
        cfg = _acfg(f"127.0.0.1:{server.port}")
        cfg.envs_per_process = 2
        fleet = tclient.RemoteFleet(cfg, tmem.MemoryBroker("rf_meters"), actor_id=0)
        svc = FakeDotaService()
        for e in fleet.envs:
            e._stub = LocalDotaServiceStub(svc)
        run(fleet.run(num_episodes=3))
    finally:
        server.stop()
    lat = fleet.client.latency_percentiles()
    assert lat["samples"] == fleet.steps_done > 0 and 0 < lat["p50_ms"] <= lat["p99_ms"]
    st = fleet.stats()
    assert st["serve_failover_endpoints"] == 1 and st["serve_failover_total"] == 0
    assert st["serve_endpoint_up_0"] == 1.0 and st["serve_fallback_engaged"] == 0.0
    assert fleet.rollouts_published > 0


# ------------------------------------------------------------- failover


def test_client_fails_over_to_next_healthy_endpoint():
    """Two replicas: the client sticks to the first until it dies, then
    fails over (counted); the dead replica's carry is gone, so the old
    episode's next step fails, while a fresh episode serves on the
    survivor and stays there."""
    a, b = Incarnations(), Incarnations()
    client = tclient.RemotePolicyClient(f"127.0.0.1:{a.port},127.0.0.1:{b.port}", POLICY, timeout_s=4.0,
                                        connect_timeout_s=1.0, cooldown_s=0.2)
    obs = _rand_obs(np.random.RandomState(0))
    rng = threefry.prng_key(7)

    async def go():
        r1 = await client.step(1, obs, rng, episode_start=True)
        assert r1.status == 0 and client._ep == 0
        a.kill()
        with pytest.raises(tclient.RemoteInferenceError):
            await client.step(1, obs, r1.rng)
        deadline = time.monotonic() + 10
        while True:
            try:
                r2 = await client.step(1, obs, r1.rng, episode_start=True)
                break
            except tclient.RemoteInferenceError:
                if time.monotonic() > deadline:
                    raise
                await asyncio.sleep(0.05)
        assert r2.status == 0 and client._ep == 1 and client.failovers == 1
        r3 = await client.step(1, obs, r2.rng)
        assert r3.status == 0 and client._ep == 1 and client.failovers == 1
        await client.close()

    try:
        run(go())
    finally:
        a.close()
        b.close()


def test_all_endpoints_down_fails_fast_and_cooldown_recovers():
    inc = Incarnations(max_batch=2)
    client = tclient.RemotePolicyClient(f"127.0.0.1:{inc.port}", POLICY, timeout_s=3.0, connect_timeout_s=0.8,
                                        cooldown_s=0.4)
    obs = _rand_obs(np.random.RandomState(1))
    rng = threefry.prng_key(9)

    async def go():
        r = await client.step(5, obs, rng, episode_start=True)
        assert r.status == 0
        inc.kill()
        with pytest.raises(tclient.RemoteInferenceError):
            await client.step(5, obs, r.rng)
        assert client.all_down_since is not None
        assert client.endpoints_down() == 1 and not client.has_healthy_endpoint()
        t0 = time.monotonic()
        with pytest.raises(tclient.RemoteInferenceError):
            await client.step(5, obs, r.rng, episode_start=True)
        assert time.monotonic() - t0 < 0.3, "all-down must fail fast, not dial"
        inc.restart()
        deadline = time.monotonic() + 10
        while True:
            try:
                r2 = await client.step(5, obs, r.rng, episode_start=True)
                break
            except tclient.RemoteInferenceError:
                if time.monotonic() > deadline:
                    raise
                await asyncio.sleep(0.05)
        assert r2.status == 0 and client.all_down_since is None
        await client.close()

    try:
        run(go())
    finally:
        inc.close()


def test_all_down_latches_despite_staggered_cooldowns():
    """cooldown 0: every endpoint is always eligible, so only a failed
    failover pass can latch the all-down clock; the episode-mode decision
    then engages the fallback although an endpoint is nominally healthy."""
    client = tclient.RemotePolicyClient("127.0.0.1:9,127.0.0.1:19", POLICY, connect_timeout_s=0.5, cooldown_s=0.0)

    async def go():
        with pytest.raises(tclient.RemoteInferenceError):
            await client.step(1, F.zeros_observation(), threefry.prng_key(0), episode_start=True)

    run(go())
    assert client.all_down_since is not None and client.has_healthy_endpoint()
    cfg = _acfg("127.0.0.1:9,127.0.0.1:19", seed=41, cooldown_s=0.0, connect_timeout_s=0.5, fallback_local=True,
                fallback_after_s=0.0)
    actor = tclient.RemoteActor(cfg, tmem.MemoryBroker("svlatch"), actor_id=0,
                                stub=LocalDotaServiceStub(FakeDotaService()), client=client)
    assert actor._decide_local_episode() is True
    assert actor._fallback.engaged and actor._fallback.engagements == 1


def test_route_load_probes_and_picks_the_least_loaded():
    a, b = Incarnations(), Incarnations()
    busy = tclient.RemotePolicyClient(f"127.0.0.1:{a.port}", POLICY)
    client = tclient.RemotePolicyClient(f"127.0.0.1:{a.port},127.0.0.1:{b.port}", POLICY, route="load")
    obs = _rand_obs(np.random.RandomState(2))

    async def go():
        await busy.step(1, obs, threefry.prng_key(1), episode_start=True)
        r = await client.step(2, obs, threefry.prng_key(2), episode_start=True)
        assert r.status == 0
        await busy.close()
        await client.close()

    try:
        run(go())
    finally:
        a.close()
        b.close()
    assert client.route_probes == 2 and client.route_picks == 1 and client._ep == 1


# ------------------------------------------------------------- fallback


def test_fallback_engages_after_budget_and_disengages_on_recovery():
    """The actor loop on the fake env: remote while the replica lives;
    after a kill, episodes abandon until the budget passes, then step on
    the fallback net warmed from the weight fanout (chunks stamped with
    its version); after a restart the actor returns to the server."""
    inc = Incarnations(max_batch=2)
    tmem.reset("svfb")
    broker, wbroker = tmem.MemoryBroker("svfb"), tmem.MemoryBroker("svfb")
    cfg = _acfg(f"127.0.0.1:{inc.port}", seed=11, connect_timeout_s=0.5, cooldown_s=0.4, fallback_local=True,
                fallback_after_s=0.3)
    actor = tclient.RemoteActor(cfg, broker, actor_id=0, stub=LocalDotaServiceStub(FakeDotaService()))
    fb = actor._fallback
    assert fb is not None and not fb.engaged and fb.device == torch.device("cpu")

    async def episode_with_retries(deadline_s=15.0):
        deadline = time.monotonic() + deadline_s
        while True:
            try:
                return await actor.run_episode()
            except tclient.RemoteInferenceError:
                if time.monotonic() > deadline:
                    raise
                await asyncio.sleep(0.05)

    async def go():
        net = P.init_params(POLICY, torch.Generator().manual_seed(4), "cpu")
        wbroker.publish_weights(serialize_weights(named_params(net), version=7))
        await actor.run_episode()
        assert actor.remote_policy.steps > 0 and fb.steps_total == 0 and fb.version == 7
        inc.kill()
        before = actor.rollouts_published
        await episode_with_retries()
        assert fb.engaged and fb.engagements == 1 and fb.steps_total > 0 and actor.episodes_abandoned >= 1
        for _ in range(2):
            await episode_with_retries()
        assert fb.engagements == 1 and actor.rollouts_published > before
        local = broker.consume_experience(10000, timeout=0.2)[before:]
        assert local and all(deserialize_rollout(f).version == 7 for f in local)
        inc.restart()
        steps_before = actor.remote_policy.steps
        deadline = time.monotonic() + 15
        while fb.engaged and time.monotonic() < deadline:
            await episode_with_retries()
        assert not fb.engaged and actor.remote_policy.steps > steps_before
        await actor.remote_policy.close()

    try:
        run(go())
    finally:
        inc.close()


def test_fallback_frames_bitwise_equal_the_local_actor():
    """An engaged fallback is the local Actor: with the tier unreachable
    from the start, every frame equals a standalone Actor's, byte for
    byte (same boot net from the seed, same keys and env seeds)."""
    tmem.reset("svfb_r")
    cfg = _acfg("127.0.0.1:9", seed=21, fallback_local=True, fallback_after_s=0.0, cooldown_s=3600.0)
    actor = tclient.RemoteActor(cfg, tmem.MemoryBroker("svfb_r"), actor_id=0,
                                stub=LocalDotaServiceStub(FakeDotaService()))
    actor.remote_policy._down_until = [time.monotonic() + 3600.0]
    actor.remote_policy.all_down_since = time.monotonic() - 10.0
    run(actor.run(num_episodes=2))
    remote = tmem.MemoryBroker("svfb_r").consume_experience(10000, timeout=0.1)
    assert actor._fallback.steps_total > 0 and actor.remote_policy.steps == 0
    tmem.reset("svfb_l")
    lcfg = ActorConfig(rollout_len=8, max_dota_time=3.0, policy=POLICY, seed=21, max_weight_age_s=0.0, platform="cpu")
    local = tactor.Actor(lcfg, tmem.MemoryBroker("svfb_l"), actor_id=0, stub=LocalDotaServiceStub(FakeDotaService()))
    run(local.run(num_episodes=2))
    frames = tmem.MemoryBroker("svfb_l").consume_experience(10000, timeout=0.1)
    assert remote and remote == frames


# --------------------------------------------------------------- resume


def _resume_rig(store: bool):
    st = CarryStoreServer(port=0).start() if store else None
    kw = dict(handoff_endpoint=f"127.0.0.1:{st.port}") if store else {}
    a, b = Incarnations(**kw), Incarnations(**kw)
    return st, a, b


@pytest.mark.parametrize("store", [True, False])
def test_resume_restores_the_episode_or_abandons_when_refused(store):
    """--serve.resume: a replica killed mid-episode; with the carry store
    the client resumes the episode on the survivor (S_RESUME + replay of
    the partial chunk) and its frames are byte for byte an uninterrupted
    run's; without a store the server refuses (SessionResumeRefused) and
    the episode is abandoned."""
    st, a, b = _resume_rig(store)
    endpoint = f"127.0.0.1:{a.port},127.0.0.1:{b.port}"
    cfg = _acfg(endpoint, seed=13, resume=True, resume_window_s=5.0, timeout_s=5.0)
    cfg.max_dota_time = 20.0
    tmem.reset("svres")
    actor = tclient.RemoteActor(cfg, tmem.MemoryBroker("svres"), actor_id=0,
                                stub=LocalDotaServiceStub(FakeDotaService()))
    killed = []
    step = actor._policy_step

    async def killing_step(state, obs, chunk_len=0, episode_start=False):
        if actor.steps_done == 11 and not killed:  # mid-chunk, after one boundary
            killed.append(1)
            a.kill()
        return await step(state, obs, chunk_len, episode_start)

    actor._policy_step = killing_step

    async def episode(agent):
        try:
            await agent.run_episode()
        finally:
            await agent.remote_policy.close()

    try:
        if store:
            run(episode(actor))
        else:
            with pytest.raises(tclient.SessionResumeRefused):
                run(episode(actor))
        ours = tmem.MemoryBroker("svres").consume_experience(10000, timeout=0.1)
        if store:
            tmem.reset("svres_ref")
            ref_cfg = _acfg(f"127.0.0.1:{b.port}", seed=13, timeout_s=5.0)
            ref_cfg.max_dota_time = 20.0
            ref = tclient.RemoteActor(ref_cfg, tmem.MemoryBroker("svres_ref"), actor_id=0,
                                      stub=LocalDotaServiceStub(FakeDotaService()))
            run(episode(ref))
            assert ours == tmem.MemoryBroker("svres_ref").consume_experience(10000, timeout=0.1)
    finally:
        a.close()
        b.close()
        if st is not None:
            st.stop()
    assert killed
    if store:
        assert actor.episodes_resumed == 1 and actor.episodes_abandoned == 0 and actor.resume_replay_steps == 3
    else:
        assert actor.episodes_resumed == 0 and actor.episodes_abandoned == 1


# ------------------------------------------------ fleet, pool and binary


def test_fleet_close_converges_after_a_server_death_mid_stream():
    inc = Incarnations(max_batch=4)
    cfg = _acfg(f"127.0.0.1:{inc.port}", seed=31, timeout_s=2.0, connect_timeout_s=0.5, cooldown_s=0.5)
    fleet = tclient.RemoteFleet(cfg, tmem.MemoryBroker("svtear"), actor_id=0, envs=3)
    svc = FakeDotaService()
    for e in fleet.envs:
        e._stub = LocalDotaServiceStub(svc)

    async def go():
        agen = fleet.episode_stream()
        done = 0
        async for _ in agen:
            done += 1
            if done >= 2:
                break
        inc.kill()
        await asyncio.sleep(0.05)
        t0 = time.monotonic()
        await asyncio.wait_for(agen.aclose(), timeout=20.0)
        return time.monotonic() - t0

    try:
        close_s = run(go())
    finally:
        inc.close()
    assert close_s < 15.0 and fleet.client._closed and fleet.client._writer is None

    async def after_close():
        with pytest.raises(tclient.RemoteInferenceError):
            await fleet.client.step(0, F.zeros_observation(), threefry.prng_key(0))

    run(after_close())


def test_actor_pool_wraps_remote_actors_in_a_fleet(monkeypatch):
    """ActorPool runs a RemoteActor as a RemoteFleet of its envs per actor
    (the server batches; the fleet's loop retries failed steps)."""
    monkeypatch.setattr(tactor, "connect_env_async", lambda cfg: LocalDotaServiceStub(FakeDotaService()))
    server = port_server()
    tmem.reset("svpool")
    episodes = []
    try:
        cfg = _acfg(f"127.0.0.1:{server.port}", seed=2)
        pool = ActorPool(lambda i: tclient.RemoteActor(cfg, tmem.MemoryBroker("svpool"), actor_id=i), 2,
                         on_episode=lambda i, a, r: episodes.append(i), envs_per_actor=2).start()
        deadline = time.monotonic() + 60
        while len(episodes) < 4 and time.monotonic() < deadline:
            time.sleep(0.05)
        pool.stop(timeout=30, raise_on_dead=True)
    finally:
        server.stop()
    assert len(episodes) >= 4 and len(pool.actors) == 2
    assert all(isinstance(a, tclient.RemoteFleet) and len(a.envs) == 2 for a in pool.actors)
    led = pool.publish_stats()
    assert led["published"] > 0 and led["dead_actors"] == 0


def _manifest_actor_args(deployment: int, endpoints: str, league: str = ""):
    import chip_smoke

    args = chip_smoke.manifest_args(chip_smoke.ACTORS_MANIFEST, container=deployment)
    out, i = [], 0
    while i < len(args):
        if args[i] == "--env_addr":
            i += 2
            continue
        out.append(args[i])
        i += 1
    out[out.index("--broker_url") + 1] = "mem://manifest"
    out[out.index("--serve.endpoint") + 1] = endpoints
    if "--serve.league" in out:
        out[out.index("--serve.league") + 1] = league
    return out + ["--platform", "cpu", "--policy.lstm_hidden", "16", "--policy.unit_embed_dim", "16",
                  "--policy.mlp_hidden", "16", "--policy.dtype", "float32"]


def test_the_actors_manifest_deployments_build_with_no_refusal(monkeypatch):
    """Both deployments of k8s/actors.yaml through the port binary's
    dispatch: `actors` (--opponent league --serve.league) builds
    SelfPlayActors in remote-league mode, `actors-scripted` (every
    --serve.* flag) a RemoteFleet of two slots with fallback, resume and
    load routing armed; each parses as the reference parses it."""
    from dotaclient_tpu_torch.obs.flight_recorder import FlightRecorder
    from dotaclient_tpu_torch.runtime.selfplay import SelfPlayActor

    # --obs.enabled true: the flight recorder's process-wide handlers stay out of pytest
    monkeypatch.setattr(FlightRecorder, "install_handlers", lambda self: None)
    for deployment, want in ((0, SelfPlayActor), (1, tclient.RemoteFleet)):
        args = _manifest_actor_args(deployment, "127.0.0.1:9,127.0.0.1:19", "127.0.0.1:29")
        cfg = parse_config(ActorConfig(), args)
        jcfg = j_parse_config(JActorConfig(), args)
        assert vars(cfg.serve) == vars(jcfg.serve) and cfg.opponent == jcfg.opponent
        built = tactor.build_actors(cfg, tmem.MemoryBroker("manifest"),
                                    make_stub=lambda: LocalDotaServiceStub(FakeDotaService()))
        assert len(built) == 1 and type(built[0]) is want
    fleet = built[0]
    assert len(fleet.envs) == 2 and fleet.fallback is not None and fleet.client._route == "load"
    assert all(e._resume_armed and e._stub is not None for e in fleet.envs)
    sp = tactor.build_actors(parse_config(ActorConfig(), _manifest_actor_args(0, "a:1", "l:2")),
                             tmem.MemoryBroker("manifest"))[0]
    assert sp._league_endpoint == "l:2" and sp.league is None


def test_serve_endpoint_with_a_mirror_opponent_is_refused_as_the_reference_does():
    for opp, league in (("self", ""), ("league", "")):
        cfg = _acfg("127.0.0.1:9")
        cfg.opponent = opp
        cfg.serve.league = league
        with pytest.raises(ValueError, match="does not serve mirror/league sessions"):
            tactor.build_actors(cfg, tmem.MemoryBroker("refuse"))
