"""The port's carry store (dotaclient_tpu_torch/serve/handoff.py) against
the reference's: the fingerprint bits, the keep-two store's answers on one
op sequence, the wire both ways (the JAX client against the port server
and the port client against the JAX server, raw reply bytes equal),
sharded placement, and the store binary with k8s/inference.yaml's
carry-store args."""

import asyncio
import json
import os
import socket
import struct
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from dotaclient_tpu.config import HandoffConfig as JHandoffConfig
from dotaclient_tpu.config import parse_config as j_parse_config
from dotaclient_tpu.serve import handoff as jh
from dotaclient_tpu_torch.config import HandoffConfig, parse_config
from dotaclient_tpu_torch.obs import registry as treg
from dotaclient_tpu_torch.serve import handoff as th

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def _carry(seed: int, hidden: int = 16):
    rs = np.random.RandomState(seed)
    return rs.randn(hidden).astype(np.float32), rs.randn(hidden).astype(np.float32)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("hidden", [1, 16, 128])
def test_carry_fingerprint_bits_equal_the_reference(hidden):
    for seed in range(20):
        c, h = _carry(seed, hidden)
        assert th.carry_fingerprint(c, h) == jh.carry_fingerprint(c, h)
        # other layouts of the same f32 values hash the same
        assert th.carry_fingerprint(c[None], h[None]) == jh.carry_fingerprint(c, h)
        assert th.carry_fingerprint(c.astype(np.float64), h) == jh.carry_fingerprint(c.astype(np.float64), h)
    c, h = _carry(0, hidden)
    h2 = h.copy()
    h2.view(np.uint32)[0] ^= 1  # one bit of h
    assert th.carry_fingerprint(c, h2) != th.carry_fingerprint(c, h)


def test_the_store_answers_one_op_sequence_as_the_reference():
    rs = np.random.RandomState(3)
    t, j = th.CarryStore(keep=2), jh.CarryStore(keep=2)
    for i in range(400):
        key = int(rs.randint(0, 5))
        step = 16 * int(rs.randint(0, 6))
        if rs.rand() < 0.5:
            c, h = _carry(i)
            t.put(key, step, i, c, h)
            j.put(key, step, i, c, h)
        else:
            (ts, te), (js, je) = t.get(key, step), j.get(key, step)
            assert ts == js
            assert (te is None) == (je is None)
            if te is not None:
                assert (te.episode_step, te.version, te.c.tobytes(), te.h.tobytes()) == (
                    je.episode_step, je.version, je.c.tobytes(), je.h.tobytes())
        if rs.rand() < 0.02:
            t.evict(key), j.evict(key)
    assert t.stats() == j.stats() and len(t) == len(j)
    with pytest.raises(ValueError, match="keep"):
        th.CarryStore(keep=1)


def test_same_boundary_put_replaces_and_keeps_the_previous_entry():
    s = th.CarryStore()
    for step in (16, 32, 32):
        s.put(7, step, step, *_carry(step))
    assert s.get(7, 16)[0] == th.ST_OK and s.get(7, 32)[1].version == 32
    s.put(7, 48, 48, *_carry(48))
    assert s.get(7, 16)[0] == th.ST_STALE and s.get(8, 16)[0] == th.ST_MISS


@pytest.mark.parametrize("direction", ["jax_client_port_server", "port_client_jax_server"])
def test_the_store_wire_both_ways(direction):
    """Puts and gets across packages: OK entries come back bit for bit,
    MISS and STALE as statuses, the stats as the same JSON."""
    server = (th.CarryStoreServer if direction.endswith("port_server") else jh.CarryStoreServer)(port=0).start()
    client = (jh.CarryStoreClient if direction.startswith("jax") else th.CarryStoreClient)("127.0.0.1", server.port)
    try:
        async def go():
            out = []
            for k in range(4):
                for step in (16, 32, 48):
                    await client.put(k, step, 100 + step, *_carry(k * 100 + step))
            for k, step in ((0, 48), (1, 32), (2, 16), (9, 16), (3, 64)):
                out.append(await client.get(k, step))
            await client.close()
            return out

        got = run(go())
        statuses = [g[0] for g in got]
        assert statuses == [th.ST_OK, th.ST_OK, th.ST_STALE, th.ST_MISS, th.ST_STALE]
        for (k, step), (status, entry) in zip(((0, 48), (1, 32)), got):
            c, h = _carry(k * 100 + step)
            assert entry.episode_step == step and entry.version == 100 + step
            assert entry.c.tobytes() == c.tobytes() and entry.h.tobytes() == h.tobytes()
        stats = server.stats()
        assert stats["serve_handoff_store_puts_total"] == 12 and stats["serve_handoff_store_gets_total"] == 5
        assert not treg.unregistered(stats)
    finally:
        server.stop()


def _raw(port: int, frames):
    replies = []
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        buf = s.makefile("rb")
        for mtype, payload in frames:
            s.sendall(struct.pack("<IB", len(payload), mtype) + payload)
            n, rtype = struct.unpack("<IB", buf.read(5))
            replies.append((rtype, buf.read(n)))
    return replies


def test_raw_reply_bytes_equal_the_reference_server_s():
    c, h = _carry(5)
    put = struct.pack("<QIII", 0xDEADBEEF01, 32, 7, c.size) + c.tobytes() + h.tobytes()
    frames = [(th.H_PUT, put), (th.H_GET, struct.pack("<QI", 0xDEADBEEF01, 32)),
              (th.H_GET, struct.pack("<QI", 0xDEADBEEF01, 16)), (th.H_GET, struct.pack("<QI", 5, 16))]
    assert (th.H_PUT, th.H_GET, th.H_STATS, th.H_PUT_ACK, th.H_GET_RES, th.H_STATS_RES) == (
        jh.H_PUT, jh.H_GET, jh.H_STATS, jh.H_PUT_ACK, jh.H_GET_RES, jh.H_STATS_RES)
    assert th._frame(th.H_PUT, put) == jh._frame(jh.H_PUT, put)
    answers = []
    for make in (th.CarryStoreServer, jh.CarryStoreServer):
        server = make(port=0).start()
        try:
            answers.append(_raw(server.port, frames))
            # a malformed put closes the connection and is counted
            with socket.create_connection(("127.0.0.1", server.port), timeout=10) as s:
                s.sendall(struct.pack("<IB", 3, th.H_PUT) + b"abc")
                assert s.recv(8) == b""
            assert server.stats()["serve_handoff_store_bad_requests_total"] == 1
        finally:
            server.stop()
    assert answers[0] == answers[1]
    assert answers[0][1][1][-2 * 4 * c.size:] == c.tobytes() + h.tobytes()


def test_sharded_placement_equals_the_reference():
    eps = ["s0:13390", "s1:13390", "s2:13391"]
    for key in range(1000):
        assert th.rendezvous_store_order(key, eps) == jh.rendezvous_store_order(key, eps)
    spec = "127.0.0.1:1, s1:2,:3"
    assert th.parse_store_endpoints(spec) == jh.parse_store_endpoints(spec)
    for bad in ("a", "a:b", "a:1,,b:2", ""):
        with pytest.raises(ValueError):
            th.parse_store_endpoints(bad)
    stores = [th.CarryStore() for _ in eps]
    sharded = th.ShardedCarryStore(eps, clients=[th.LocalCarryStore(s) for s in stores])

    async def go():
        for key in range(30):
            await sharded.put(key, 16, 1, *_carry(key))
        return [await sharded.get(key, 16) for key in range(30)]

    got = run(go())
    assert all(status == th.ST_OK for status, _ in got)
    for key in range(30):
        primary = th.rendezvous_store_order(key, eps)[0]
        assert stores[primary].get(key, 16)[0] == th.ST_OK
        assert all(len(s._entries.get(key, ())) == 0 for i, s in enumerate(stores) if i != primary)


def test_a_dead_store_raises_store_unavailable_and_the_next_op_redials():
    port = _free_port()
    client = th.CarryStoreClient("127.0.0.1", port, timeout_s=0.5)
    with pytest.raises(th.StoreUnavailableError):
        run(client.put(1, 16, 1, *_carry(1)))
    server = th.CarryStoreServer(port=port).start()
    try:
        async def go():
            await client.put(1, 16, 1, *_carry(1))
            return await client.get(1, 16)

        assert run(go())[0] == th.ST_OK
    finally:
        server.stop()


def test_the_store_binary_takes_the_inference_manifest_s_args():
    """`python -m dotaclient_tpu_torch.serve.handoff` with the carry-store
    args of k8s/inference.yaml (`--keep 2 --obs.enabled true`, local ports):
    its one ready line, the reference's flags parsed the same, /metrics with
    the store gauges, /healthz and /debug/flight."""
    args = ["--keep", "2", "--obs.enabled", "true"]
    assert parse_config(HandoffConfig(), args).keep == j_parse_config(JHandoffConfig(), args).keep == 2
    mport = _free_port()
    proc = subprocess.Popen([sys.executable, "-m", "dotaclient_tpu_torch.serve.handoff", "--port", "0", *args,
                             "--obs.metrics_port", str(mport), "--obs.install_handlers", "false"],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["serving"] is True and ready["port"] > 0
        client = jh.CarryStoreClient("127.0.0.1", ready["port"])

        async def go():
            await client.put(3, 16, 1, *_carry(3))
            got = await client.get(3, 16)
            await client.close()
            return got

        assert run(go())[0] == jh.ST_OK
        metrics = urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics", timeout=10).read().decode()
        scraped = {ln.split()[0]: float(ln.split()[1]) for ln in metrics.splitlines() if ln and ln[0] != "#"}
        assert scraped["dotaclient_serve_handoff_store_puts_total"] == 1.0
        assert scraped["dotaclient_serve_handoff_store_hits_total"] == 1.0
        assert urllib.request.urlopen(f"http://127.0.0.1:{mport}/healthz", timeout=10).status == 200
        flight = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{mport}/debug/flight", timeout=10).read())
        assert flight["role"] == "carry-store"
    finally:
        proc.kill()
        proc.wait(timeout=10)
