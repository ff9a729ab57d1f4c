"""The port's tcp:// broker against the reference's, in both directions:
the port's TcpBroker against the reference's BrokerServer and the
reference's TcpBroker against the port's BrokerServer (publish, consume,
weights, shed hysteresis, priority eviction, STATS/STATS2), equal
conservation ledgers for one op sequence, reconnect after a server
restart under a seeded RetryPolicy, the refusals, the server binary's
ready line, and the port learner's binary over tcp://."""

import random
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from dotaclient_tpu.transport import base as jbase
from dotaclient_tpu.transport import tcp as jtcp
from dotaclient_tpu_torch.config import LearnerConfig, RetryConfig
from dotaclient_tpu_torch.runtime import learner as tlearner
from dotaclient_tpu_torch.transport import base as tbase
from dotaclient_tpu_torch.transport import serialize as tser
from dotaclient_tpu_torch.transport import tcp as ttcp
from test_torch_learner import frames_for

REPO = Path(__file__).resolve().parents[1]

# (client class, server class): the port's client on the reference's
# server, and the reference's client on the port's server
DIRECTIONS = {
    "port_client_ref_server": (ttcp.TcpBroker, jtcp.BrokerServer),
    "ref_client_port_server": (jtcp.TcpBroker, ttcp.BrokerServer),
}


@pytest.fixture(params=list(DIRECTIONS))
def direction(request):
    servers = []

    def make(**kw):
        client_cls, server_cls = DIRECTIONS[request.param]
        server = server_cls("127.0.0.1", 0, **kw).start()
        servers.append(server)
        return server, (lambda: client_cls("127.0.0.1", server.port))

    yield make
    for s in servers:
        s.stop()


def test_publish_consume_and_weights(direction):
    server, client = direction(maxlen=4)
    a, b = client(), client()
    for i in range(6):
        a.publish_experience(b"f%d" % i)
    assert b.experience_depth() == 4  # drop-oldest at maxlen
    assert b.consume_experience(3, timeout=1.0) == [b"f2", b"f3", b"f4"]
    assert b.consume_experience(10, timeout=1.0) == [b"f5"]
    t0 = time.monotonic()
    assert b.consume_experience(10, timeout=0.2) == []
    assert time.monotonic() - t0 >= 0.15
    assert a.poll_weights() is None
    a.publish_weights(b"w1")
    a.publish_weights(b"w2")
    assert b.poll_weights() == b"w2" and b.poll_weights() is None
    assert client().poll_weights() == b"w2"
    assert a.stats() == {"depth": 0, "dropped_oldest": 2, "shed": 0, "enqueued": 6, "popped": 4, "reply_lost": 0}
    a.close()
    b.close()


def test_blocking_consume_wakes_on_publish(direction):
    server, client = direction()
    a, b = client(), client()
    got = []
    t = threading.Thread(target=lambda: got.append(b.consume_experience(5, timeout=10.0)))
    t.start()
    deadline = time.monotonic() + 5
    while server.consume_waiters == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    a.publish_experience(b"late")
    t.join(timeout=5)
    assert got == [[b"late"]]


def test_shed_with_hysteresis(direction):
    server, client = direction(shed_high=3, shed_low=1)
    a = client()
    for i in range(3):
        a.publish_experience(b"%d" % i)
    with pytest.raises(Exception) as e:
        a.publish_experience(b"x")
    assert type(e.value).__name__ == "BrokerShedError"
    a.consume_experience(1, timeout=1.0)  # depth 2: still above shed_low
    with pytest.raises(Exception, match="shed"):
        a.publish_experience(b"y")
    a.consume_experience(1, timeout=1.0)  # depth 1: admitting again
    a.publish_experience(b"z")
    assert a.shed_observed == 2
    assert a.stats()["shed"] == 2 and a.stats()["enqueued"] == 4
    assert server.ledger()["shed"] == 2


def test_priority_eviction_and_stats2(direction):
    server, client = direction(shed_high=2, shed_low=0, priority_shed=True)
    a = client()
    a.publish_experience_prioritized(b"p1", 1.0)
    a.publish_experience_prioritized(b"p5", 5.0)
    a.publish_experience_prioritized(b"p3", 3.0)  # shedding: evicts p1, the lowest
    with pytest.raises(Exception, match="shed"):
        a.publish_experience_prioritized(b"p0", 0.5)  # cannot beat the resident minimum
    s2 = a.stats2()
    assert s2 == {"depth": 2, "dropped_oldest": 0, "shed": 1, "enqueued": 3, "popped": 0, "reply_lost": 0,
                  "evicted_low": 1, "priority_mode": 1}
    assert a.consume_experience(5, timeout=1.0) == [b"p5", b"p3"]


def _ledger_ops(server, client):
    a, b = client(), client()

    def pub(data, priority=None):
        try:
            a.publish_experience(data) if priority is None else a.publish_experience_prioritized(data, priority)
        except Exception as e:
            assert type(e).__name__ == "BrokerShedError"

    for i in range(6):
        pub(b"e%d" % i)  # sheds from depth 4
    b.consume_experience(2, timeout=1.0)  # depth 2: still shedding
    for i in range(4):  # a resident of priority 0 goes first, then ones that cannot win
        pub(b"q%d" % i, float(i) - 1.0)
    b.consume_experience(3, timeout=1.0)  # depth 0: admitting again
    for i in range(3):
        pub(b"r%d" % i)
    a.publish_weights(b"w")
    b.poll_weights()
    a.close()
    b.close()
    server.stop()
    return server.ledger()


def test_same_op_sequence_same_ledger():
    kw = dict(maxlen=8, shed_high=4, shed_low=1, priority_shed=True)
    ledgers = []
    for client_cls, server_cls in ((jtcp.TcpBroker, jtcp.BrokerServer), (ttcp.TcpBroker, ttcp.BrokerServer)):
        server = server_cls("127.0.0.1", 0, **kw).start()
        ledgers.append(_ledger_ops(server, lambda: client_cls("127.0.0.1", server.port)))
    assert ledgers[0] == ledgers[1]
    led = ledgers[1]
    assert led["enqueued"] == led["popped"] + led["dropped_oldest"] + led["evicted_low"] + led["resident"]
    assert led["shed"] and led["evicted_low"] and led["popped"] and led["resident"]


def test_retry_policy_matches_the_reference_draw_for_draw():
    cfg = RetryConfig(window_s=3.0, backoff_base_s=0.05, backoff_cap_s=0.4, jitter=0.5)
    port = tbase.RetryPolicy.from_config(cfg, rng=random.Random(7))
    ref = jbase.RetryPolicy.from_config(cfg)
    ref.rng = random.Random(7)
    b_port = b_ref = cfg.backoff_base_s
    for _ in range(8):
        assert port.sleep_for(b_port) == ref.sleep_for(b_ref)
        b_port, b_ref = port.next_backoff(b_port), ref.next_backoff(b_ref)
        assert b_port == b_ref <= cfg.backoff_cap_s
    assert tbase.RetryPolicy(jitter=0.0).sleep_for(0.3) == 0.3


def test_reconnect_after_server_restart():
    """The client outlives its broker: a publish issued while the broker is
    down retries under the seeded policy until the broker is back on its
    port, and the weight high-water mark resets on the new connection."""
    first = ttcp.BrokerServer("127.0.0.1", 0).start()
    port = first.port
    policy = tbase.RetryPolicy(window_s=20.0, backoff_base_s=0.02, backoff_cap_s=0.1, rng=random.Random(3))
    client = tbase.connect(f"tcp://127.0.0.1:{port}", retry=policy)
    assert client._exp.retry is policy
    client.publish_weights(b"old")
    assert client.poll_weights() == b"old"
    client.publish_experience(b"before")
    first.stop()
    second = []

    def restart():
        time.sleep(0.3)
        second.append(ttcp.BrokerServer("127.0.0.1", port).start())

    t = threading.Thread(target=restart)
    t.start()
    try:
        client.publish_experience(b"after")  # retries until the new broker listens
        t.join(timeout=10)
        assert second and second[0].ledger()["enqueued"] == 1
        assert client._exp.generation >= 1
        jclient = jtcp.TcpBroker("127.0.0.1", port)
        jclient.publish_weights(b"new")  # seq 1 again on the new broker
        # the first poll finds its connection dead and reconnects (seq 1 is
        # "seen" still); the next resets the high-water mark, as the
        # reference's client does
        assert [client.poll_weights(), client.poll_weights()] == [None, b"new"]
        assert client.consume_experience(5, timeout=1.0) == [b"after"]
    finally:
        t.join(timeout=10)
        client.close()
        for s in second:
            s.stop()


def test_connect_schemes_and_refusals(monkeypatch):
    server = ttcp.BrokerServer("127.0.0.1", 0).start()
    try:
        b = tbase.connect(f"tcp://127.0.0.1:{server.port}")
        assert isinstance(b, ttcp.TcpBroker)
        b.publish_experience(b"x")
        assert b.experience_depth() == 1
        # an unarmed server closes a GET_BLOCK connection, as the reference does
        with socket.create_connection(("127.0.0.1", server.port), timeout=5) as s:
            s.sendall(struct.pack("<IB", 0, ttcp.GET_BLOCK))
            assert s.recv(16) == b""
        assert server.ledger()["enqueued"] == 1
    finally:
        server.stop()
    armed = ttcp.BrokerServer(assemble=True)  # assembly is ported: an armed server builds, with its ledger at 0
    assert armed.assemble and set(armed.assemble_ledger().values()) == {0}
    from tests import fake_pika
    from dotaclient_tpu_torch.transport.rmq import RmqBroker

    monkeypatch.setitem(sys.modules, "pika", fake_pika)  # amqp:// is ported (A.10d3), on pika
    fake_pika.reset()
    assert isinstance(tbase.connect("amqp://guest@localhost/"), RmqBroker)
    fake_pika.reset()
    with pytest.raises(ConnectionError):
        tbase.connect("tcp://127.0.0.1:1")  # dials at construction: a wrong URL fails fast


def test_server_binary_prints_its_bound_port():
    proc = subprocess.Popen([sys.executable, "-m", "dotaclient_tpu_torch.transport.tcp_server", "--port", "0",
                             "--host", "127.0.0.1", "--shed_high", "8", "--shed_low", "2"],
                            cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().strip()
        assert line.startswith("broker listening on 127.0.0.1:") and line.endswith("(queue bound 4096, shed 8/2)")
        port = int(line.split(":")[1].split()[0])
        ref = jtcp.TcpBroker("127.0.0.1", port)
        ref.publish_experience(b"hello")
        assert ref.consume_experience(1, timeout=1.0) == [b"hello"]
        ref.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def test_learner_binary_trains_over_tcp(tmp_path):
    """`python -m dotaclient_tpu_torch.runtime.learner --broker_url tcp://…`
    (in-process main): frames published by the reference's client into the
    port's broker, DTW2 frames back out through it."""
    server = ttcp.BrokerServer("127.0.0.1", 0).start()
    try:
        argv = ["--broker_url", f"tcp://127.0.0.1:{server.port}", "--platform", "cpu", "--train_steps", "2",
                "--batch_size", "4", "--seq_len", "4", "--policy.lstm_hidden", "16", "--policy.unit_embed_dim", "16",
                "--policy.mlp_hidden", "16", "--policy.dtype", "float32", "--ppo.max_staleness", "1000",
                "--log_dir", str(tmp_path), "--retry.window_s", "5", "--retry.jitter", "0.25"]
        from dotaclient_tpu_torch.config import parse_config

        cfg = parse_config(LearnerConfig(), argv)
        assert (cfg.retry.window_s, cfg.retry.jitter) == (5.0, 0.25)
        producer = jtcp.TcpBroker("127.0.0.1", server.port)
        for fr in frames_for(cfg, 2):
            producer.publish_experience(fr)
        tlearner.main(argv)
        named, version, _ = tser.deserialize_weights(producer.poll_weights())
        assert version == 2 and all(np.isfinite(a).all() for _, a in named)
        assert server.ledger()["popped"] == 8
    finally:
        server.stop()
