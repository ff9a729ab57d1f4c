"""The port's inference server with k8s/inference.yaml's modes, against
the reference: the carry-store write-ahead lands before the reply; a
session resumed on another server after a kill replays bitwise the
uninterrupted arm; refusals and store outages are counted; frozen slots
synced from the JAX package's league service answer as the JAX server
does on the same snapshot; the obs surface's names are the reference
registry's; the manifest's args parse and refuse nothing, and the binary
runs with them (local endpoints, --platform cpu)."""

import asyncio
import json
import os
import select
import socket
import struct
import subprocess
import sys
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

from dotaclient_tpu.config import InferenceConfig as JInferenceConfig
from dotaclient_tpu.config import LeagueConfig, LeagueServiceConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.config import ServeConfig as JServeConfig
from dotaclient_tpu.config import parse_config as j_parse_config
from dotaclient_tpu.env import featurizer as JF
from dotaclient_tpu.league.server import LeagueService
from dotaclient_tpu.models import policy as JP
from dotaclient_tpu.obs import registry as jreg
from dotaclient_tpu.serve.client import RemotePolicyClient
from dotaclient_tpu.serve.server import InferenceServer as JInferenceServer
from dotaclient_tpu.transport import serialize as jser
from dotaclient_tpu_torch.config import InferenceConfig, ObsConfig, PolicyConfig, ServeConfig, parse_config, refuse_unported
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.models import policy as P
from dotaclient_tpu_torch.serve import handoff as th
from dotaclient_tpu_torch.serve import server as tserver
from dotaclient_tpu_torch.serve import wire as W
from dotaclient_tpu_torch.transport import tcp as ttcp
from dotaclient_tpu_torch.transport.params import named_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16)
H = SMALL["lstm_hidden"]
# logp and value, port vs reference server on the same params (the
# tolerance tests/test_torch_serve.py states and explains)
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
EP_LEN, CARRY_EVERY = 12, 4


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _obs(session: int, t: int) -> F.Observation:
    rs = np.random.RandomState([session, t])
    mask = rs.rand(F.N_ACTION_TYPES) > 0.3
    mask[F.ACT_NOOP] = True
    return F.Observation(
        global_feats=rs.randn(F.GLOBAL_FEATURES).astype(np.float32),
        hero_feats=rs.randn(F.HERO_FEATURES).astype(np.float32),
        unit_feats=rs.randn(F.MAX_UNITS, F.UNIT_FEATURES).astype(np.float32),
        unit_mask=rs.rand(F.MAX_UNITS) > 0.3, target_mask=rs.rand(F.MAX_UNITS) > 0.3, action_mask=mask)


def _server(store=None, models=1, dtype="float32", **serve_kw):
    cfg = InferenceConfig(serve=ServeConfig(port=0, max_batch=4, gather_window_s=0.002, models=models, **serve_kw),
                          policy=PolicyConfig(**SMALL, dtype=dtype), seed=1, platform="cpu")
    return tserver.InferenceServer(cfg, carry_store=store).start()


class Raw:
    """A blocking serve-wire client on one connection, bound to a slot."""

    def __init__(self, port: int, model: int = 0):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=20)
        self.buf = self.sock.makefile("rb")
        rtype, body = self.call(W.S_INFO, W.encode_info_request(model))
        assert rtype == W.R_INFO and json.loads(body)["model"] == model

    def send(self, mtype, payload):
        self.sock.sendall(W.frame(mtype, payload))

    def read(self):
        n, rtype = struct.unpack("<IB", self.buf.read(5))
        return rtype, self.buf.read(n)

    def call(self, mtype, payload):
        self.send(mtype, payload)
        return self.read()

    def step(self, key, obs, rng, start=False, carry=False, replay=False) -> W.StepResponse:
        rtype, body = self.call(W.S_STEP, W.encode_step_request(key, obs, rng, episode_start=start,
                                                                want_carry=carry, replay=replay))
        assert rtype == W.R_STEP
        return W.decode_step_response(body, H)

    def resume(self, key, boundary, carry_hash) -> W.ResumeResponse:
        rtype, body = self.call(W.S_RESUME, W.encode_resume_request(key, boundary, carry_hash))
        assert rtype == W.R_RESUME
        return W.decode_resume_response(body)

    def close(self):
        self.sock.close()


def _bits(r: W.StepResponse):
    return (r.status, r.version, r.rng.tobytes(), r.action.tobytes(), np.float32(r.logp).tobytes(),
            np.float32(r.value).tobytes(), None if r.carry is None else (r.carry[0].tobytes(), r.carry[1].tobytes()))


def _frozen(server, seed=12):
    return named_params(P.init_params(server.cfg.policy, torch.Generator().manual_seed(seed), "cpu"))


# ------------------------------------------------------------ write-ahead


class _GatedStore(th.LocalCarryStore):
    """A store whose puts wait for a gate, recording when they start."""

    def __init__(self):
        super().__init__()
        self.started = []
        self.open = False

    async def put(self, key, episode_step, version, c, h):
        self.started.append((key, episode_step))
        while not self.open:
            await asyncio.sleep(0.01)
        await super().put(key, episode_step, version, c, h)


def test_the_store_write_lands_before_the_reply():
    store = _GatedStore()
    server = _server(store)
    try:
        c = Raw(server.port)
        rng = np.array([0, 5], np.uint32)
        r = c.step(5, _obs(5, 0), rng, start=True)  # no carry asked: no put
        assert r.status == W.OK and not store.started
        c.send(W.S_STEP, W.encode_step_request(5, _obs(5, 1), r.rng, want_carry=True))
        deadline = time.monotonic() + 10
        while not store.started and time.monotonic() < deadline:
            time.sleep(0.01)
        assert store.started == [(5, 2)]
        readable, _, _ = select.select([c.sock], [], [], 0.5)
        assert not readable  # the reply waits for the put
        store.open = True
        rtype, body = c.read()
        reply = W.decode_step_response(body, H)
        status, entry = store.store.get(5, 2)
        assert status == th.ST_OK and entry.c.tobytes() == reply.carry[0].tobytes()
        assert entry.h.tobytes() == reply.carry[1].tobytes() and entry.version == reply.version
        assert server.stats()["serve_handoff_store_writes_total"] == 1.0
        c.close()
    finally:
        server.stop()


# ----------------------------------------------------------------- resume


def _episode(port, key, model, ts, rng):
    """Steps ts of one episode over a fresh connection; a carry every
    CARRY_EVERY steps. Returns the replies and the next rng."""
    c = Raw(port, model)
    out = []
    for t in ts:
        r = c.step(key, _obs(key, t), rng, start=t == 0, carry=(t + 1) % CARRY_EVERY == 0)
        assert r.status == W.OK, (t, r.status)
        out.append(r)
        rng = r.rng
    c.close()
    return out, rng


@pytest.mark.parametrize("model", [0, 1])
def test_a_resumed_session_replays_bitwise_the_uninterrupted_arm(model):
    """Server A serves steps 0-6 of an episode with a store, then dies;
    server B, on the same store, takes S_RESUME at the last boundary
    (episode step 4, with the carry's fingerprint), the replay of steps
    4-6 and steps 7-11. Every reply is bitwise that of an uninterrupted
    server's, and the store holds one write per boundary served."""
    store = th.CarryStore()
    arms = {}
    try:
        for name in ("A", "B", "C"):
            arms[name] = _server(th.LocalCarryStore(store) if name != "C" else None, models=2)
            arms[name].swap_model(1, _frozen(arms[name]), 7)
        key = 41
        want, _ = _episode(arms["C"].port, key, model, range(EP_LEN), np.array([0, key], np.uint32))
        first, _ = _episode(arms["A"].port, key, model, range(7), np.array([0, key], np.uint32))
        arms["A"].stop()
        boundary = first[CARRY_EVERY - 1]  # the reply of step 3 carried the episode-step-4 carry
        c = Raw(arms["B"].port, model)
        bad = c.resume(key, CARRY_EVERY, th.carry_fingerprint(boundary.carry[0], boundary.carry[1]) ^ 1)
        assert bad.status == W.UNKNOWN_CLIENT  # the fingerprint must match
        ok = c.resume(key, CARRY_EVERY, th.carry_fingerprint(*boundary.carry))
        assert (ok.status, ok.episode_step, ok.version) == (W.OK, CARRY_EVERY, 7 if model else 0)
        rest, rng = [], boundary.rng
        for t in range(CARRY_EVERY, EP_LEN):
            r = c.step(key, _obs(key, t), rng, carry=(t + 1) % CARRY_EVERY == 0, replay=t < 7)
            rest.append(r)
            rng = r.rng
        c.close()
        assert [_bits(r) for r in first] == [_bits(r) for r in want[:7]]
        assert [_bits(r) for r in rest] == [_bits(r) for r in want[CARRY_EVERY:]]
        stats_b = arms["B"].stats()
        assert stats_b["serve_handoff_resumes_total"] == 1.0 and stats_b["serve_handoff_resume_misses_total"] == 1.0
        assert stats_b["serve_handoff_replayed_steps_total"] == 3.0
        assert stats_b["serve_handoff_store_writes_total"] == 2.0  # boundaries 8 and 12
        skey = W.compose_store_key(key, model)
        assert store.get(skey, 12)[0] == th.ST_OK and store.get(skey, 8)[0] == th.ST_OK
        assert store.get(skey, 4)[0] == th.ST_STALE  # keep two
    finally:
        for s in arms.values():
            s.stop()


def test_resume_refusals_answer_unknown_client_and_are_counted():
    store = th.CarryStore()
    c0, h0 = np.ones(H, np.float32), np.full(H, 2.0, np.float32)
    store.put(9, 16, 3, c0, h0)
    store.put(10, 16, 3, np.ones(H + 1, np.float32), np.ones(H + 1, np.float32))  # another policy's width
    no_store, with_store = _server(), _server(th.LocalCarryStore(store))
    try:
        for srv, key, boundary, fp in ((no_store, 9, 16, th.carry_fingerprint(c0, h0)),  # no store
                                       (with_store, 99, 16, 0),  # miss
                                       (with_store, 9, 32, th.carry_fingerprint(c0, h0)),  # stale boundary
                                       (with_store, 9, 16, th.carry_fingerprint(c0, h0 + 1)),  # fingerprint
                                       (with_store, 10, 16, 0)):  # width
            c = Raw(srv.port)
            assert c.resume(key, boundary, fp) == W.ResumeResponse(key, W.UNKNOWN_CLIENT)
            # the refused key has no resident carry
            r = c.step(key, _obs(key, 1), np.array([0, key], np.uint32))
            assert r.status == W.UNKNOWN_CLIENT
            c.close()
        assert no_store.stats()["serve_handoff_resume_misses_total"] == 1.0
        assert with_store.stats()["serve_handoff_resume_misses_total"] == 4.0
        c = Raw(with_store.port)
        ok = c.resume(9, 16, th.carry_fingerprint(c0, h0))
        assert ok == W.ResumeResponse(9, W.OK, 3, 16)
        assert c.step(9, _obs(9, 16), np.array([0, 9], np.uint32)).status == W.OK
        c.close()
    finally:
        no_store.stop()
        with_store.stop()


class _DeadStore:
    async def put(self, *a):
        raise th.StoreUnavailableError("down")

    async def get(self, *a):
        raise th.StoreUnavailableError("down")

    async def close(self):
        pass


def test_a_store_outage_degrades_serving_and_is_counted():
    server = _server(_DeadStore())
    try:
        out, _ = _episode(server.port, 3, 0, range(8), np.array([0, 3], np.uint32))
        assert all(r.status == W.OK for r in out) and out[3].carry is not None
        c = Raw(server.port)
        assert c.resume(3, 4, th.carry_fingerprint(*out[3].carry)).status == W.UNKNOWN_CLIENT
        c.close()
        stats = server.stats()
        assert stats["serve_handoff_store_errors_total"] == 3.0  # two writes, one read
        assert stats["serve_handoff_store_writes_total"] == 0.0
    finally:
        server.stop()


def test_the_handoff_endpoint_builds_the_store_client():
    assert isinstance(tserver._store_client("127.0.0.1:13390", 2.0), th.CarryStoreClient)
    sharded = tserver._store_client("a:1,b:2", 2.0)
    assert isinstance(sharded, th.ShardedCarryStore) and sharded.endpoints == ["a:1", "b:2"]
    with pytest.raises(ValueError, match="host:port"):
        tserver._store_client("carry-store", 2.0)
    cfg = InferenceConfig(serve=ServeConfig(port=0, handoff_endpoint="127.0.0.1:1", handoff_timeout_s=0.25),
                          policy=PolicyConfig(**SMALL), platform="cpu")
    server = tserver.InferenceServer(cfg)  # built, not started: no dial
    assert isinstance(server._store, th.CarryStoreClient) and server._store.timeout_s == 0.25


# ----------------------------------------------------------------- league


def _league(tmp_path, pol, seeds):
    svc = LeagueService(LeagueConfig(league=LeagueServiceConfig(port=0, dir=str(tmp_path), capacity=4,
                                                                 slots=len(seeds)))).start()
    named = {}
    for s in seeds:
        named[s] = [(n, np.asarray(a)) for n, a in jser.flatten_params(JP.init_params(pol, jax.random.PRNGKey(s)))]
        svc.ingest_snapshot(f"v{s}", s, named[s])
    return svc, named


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slots_synced_from_the_jax_league_service_answer_as_the_jax_server(tmp_path, dtype):
    """A models=3 port server and a models=3 JAX server sync from one JAX
    league service: the port installs each assigned slot's tree bitwise
    (by flax name) and stamps its version, a repeat sync installs nothing,
    and a reference client on slot 1 gets the same actions and keys from
    both servers, logp and value within the bf16 tolerance."""
    jpol = JPolicyConfig(**SMALL, dtype=dtype)
    svc, named = _league(tmp_path, jpol, (11, 22))
    ep = f"127.0.0.1:{svc.port}"
    port = _server(models=3, dtype=dtype, league_endpoint=ep, league_sync_s=30.0)
    ref = JInferenceServer(JInferenceConfig(serve=JServeConfig(port=0, max_batch=4, models=3, league_endpoint=ep,
                                                                league_sync_s=30.0), policy=jpol, seed=1)).start()
    try:
        port._league_sync_once()
        ref._league_sync_once()
        assert port.league_syncs_total == ref.league_syncs_total == 2
        for slot, seed in ((1, 11), (2, 22)):
            assert port._bundles[slot][1] == seed
            got = dict(named_params(port._bundles[slot][0]))
            assert all(got[n].tobytes() == a.tobytes() for n, a in named[seed])
        port._league_sync_once()
        assert port.league_syncs_total == 2 and port.model_swaps[1] == port.model_swaps[2] == 1

        async def drive(server):
            c = RemotePolicyClient(f"127.0.0.1:{server.port}", jpol, model=1)
            out, rng = [], np.array([0, 5], np.uint32)
            try:
                for t in range(8):
                    r = await c.step(5, JF.Observation(*_obs(5, t)), rng, episode_start=t == 0, want_carry=True)
                    out.append(r)
                    rng = r.rng
            finally:
                await c.close()
            return out

        for w, g in zip(run(drive(ref)), run(drive(port))):
            assert (g.status, g.version) == (w.status, w.version) == (W.OK, 11)
            assert np.array_equal(g.rng, w.rng) and np.array_equal(g.action, w.action)
            np.testing.assert_allclose(g.logp, w.logp, rtol=1e-6, atol=ATOL[dtype])
            np.testing.assert_allclose(g.value, w.value, rtol=1e-6, atol=ATOL[dtype])
    finally:
        port.stop()
        ref.stop()
        svc.stop()


def test_a_league_outage_keeps_the_slots_and_is_counted():
    server = _server(models=2, league_endpoint=f"127.0.0.1:{_free_port()}", league_sync_s=0.05)
    try:
        before = server._bundles[1]
        deadline = time.monotonic() + 10
        while server.league_sync_errors_total < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert server.league_sync_errors_total >= 2 and server._bundles[1] is before
        assert server._sync_thread.name == "serve-league-sync"
    finally:
        server.stop()
    single = _server(models=1, league_endpoint="127.0.0.1:1", league_sync_s=0.05)
    assert single._sync_thread is None  # one slot: nothing to sync
    single.stop()


# -------------------------------------------------------------------- obs


def test_the_obs_surface_names_are_the_reference_registry_s():
    from dotaclient_tpu_torch.obs import ObsRuntime

    mport = _free_port()
    obs = ObsRuntime.create(ObsConfig(enabled=True, metrics_port=mport, install_handlers=False), role="serve")
    cfg = InferenceConfig(serve=ServeConfig(port=0, max_batch=4, models=2), policy=PolicyConfig(**SMALL),
                          platform="cpu", obs=obs.cfg)
    server = tserver.InferenceServer(cfg, carry_store=th.LocalCarryStore(), obs_runtime=obs).start()
    try:
        _episode(server.port, 1, 0, range(8), np.array([0, 1], np.uint32))
        metrics = urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics", timeout=10).read().decode()
        names = [ln.split()[0][len("dotaclient_"):] for ln in metrics.splitlines() if ln and ln[0] != "#"]
        assert "serve_handoff_store_writes_total" in names and "actor_tick_rows_1" in names
        assert "serve_league_syncs_total" in names and "serve_model_version_1" in names
        assert not jreg.unregistered(names), jreg.unregistered(names)
        health = urllib.request.urlopen(f"http://127.0.0.1:{mport}/healthz", timeout=10)
        assert health.status == 200 and json.loads(health.read())["role"] == "serve"
        flight = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{mport}/debug/flight", timeout=10).read())
        assert flight["role"] == "serve" and "events" in flight
        assert obs.watchdog is None and obs.compute is None  # the learner's parts stay off
    finally:
        server.stop()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{mport}/healthz", timeout=2)  # stop() closed the surface


# -------------------------------------------------------------- manifest


def _inference_args():
    import chip_smoke

    return chip_smoke.manifest_args(chip_smoke.INFERENCE_MANIFEST)


def _swap(args, flag, value):
    out = list(args)
    out[out.index(flag) + 1] = value
    return out


def test_the_inference_manifest_parses_as_the_reference_and_refuses_nothing():
    """k8s/inference.yaml's args: every flag parses in both packages to the
    same values but `--platform` (the port's "" is the card, ROADMAP §C),
    and with `--platform ""` nothing is refused."""
    args = _inference_args()
    assert "--serve.handoff_endpoint" in args and "--serve.league_endpoint" in args and "--obs.enabled" in args
    tcfg, jcfg = parse_config(InferenceConfig(), args), j_parse_config(JInferenceConfig(), args)

    def flat(c, prefix=""):
        import dataclasses

        out = {}
        for f in dataclasses.fields(c):
            v = getattr(c, f.name)
            out.update(flat(v, f"{prefix}{f.name}.") if dataclasses.is_dataclass(v) else {f"{prefix}{f.name}": v})
        return out

    t, j = flat(tcfg), flat(jcfg)
    shared = set(t) & set(j)
    assert {k for k in shared if t[k] != j[k]} == set()
    assert tcfg.serve.handoff_timeout_s == 2.0 and tcfg.serve.league_sync_s == 5.0 and tcfg.obs.metrics_port == 9100
    card = parse_config(InferenceConfig(), _swap(args, "--platform", ""))
    refuse_unported(card)
    assert card.platform == "" and len(card.broker_url.split(",")) == 3


def test_the_server_binary_runs_with_the_manifest_s_args(tmp_path):
    """The port server binary with k8s/inference.yaml's args, endpoints
    made local (two port fabric shards, a port carry store, the JAX league
    service, ephemeral ports, a 0.2 s league poll) and `--platform cpu`
    with a small policy: it prints its ready line, syncs the league slots,
    serves slot 2, writes the boundary carries ahead, and answers /healthz
    and /metrics."""
    jpol = JPolicyConfig(**SMALL, dtype="float32")
    svc, _ = _league(tmp_path, jpol, (11, 22))
    shards = [ttcp.BrokerServer("127.0.0.1", 0, priority_shed=True).start() for _ in range(2)]
    store = th.CarryStoreServer(port=0).start()
    mport = _free_port()
    args = _inference_args()
    for flag, value in (("--serve.port", "0"), ("--broker_url", ",".join(f"tcp://127.0.0.1:{s.port}" for s in shards)),
                        ("--platform", "cpu"), ("--serve.handoff_endpoint", f"127.0.0.1:{store.port}"),
                        ("--serve.league_endpoint", f"127.0.0.1:{svc.port}"), ("--serve.league_sync_s", "0.2"),
                        ("--obs.metrics_port", str(mport))):
        args = _swap(args, flag, value)
    args += ["--policy.lstm_hidden", "16", "--policy.unit_embed_dim", "16", "--policy.mlp_hidden", "16",
             "--policy.dtype", "float32", "--obs.dump_dir", str(tmp_path)]
    proc = subprocess.Popen([sys.executable, "-m", "dotaclient_tpu_torch.serve.server", *args], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready == {"serving": True, "port": ready["port"]}
        scraped = {}
        deadline = time.monotonic() + 30
        while scraped.get("dotaclient_serve_league_syncs_total", 0) < 2 and time.monotonic() < deadline:
            metrics = urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics", timeout=10).read().decode()
            scraped = {ln.split()[0]: float(ln.split()[1]) for ln in metrics.splitlines() if ln and ln[0] != "#"}
            time.sleep(0.1)
        assert scraped["dotaclient_serve_league_syncs_total"] == 2.0
        assert scraped["dotaclient_serve_model_version_2"] == 22.0 and scraped["dotaclient_serve_models_resident"] == 4
        out, _ = _episode(ready["port"], 8, 2, range(8), np.array([0, 8], np.uint32))
        assert all(r.version == 22 for r in out)
        assert store.stats()["serve_handoff_store_puts_total"] == 2.0
        assert urllib.request.urlopen(f"http://127.0.0.1:{mport}/healthz", timeout=10).status == 200
    finally:
        proc.kill()
        proc.wait(timeout=20)
        store.stop()
        for s in shards:
            s.stop()
        svc.stop()
