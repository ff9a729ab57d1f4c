"""The port's broker fabric (dotaclient_tpu_torch/transport/fabric.py)
against the reference's: the FAB1 envelope bytes, the rendezvous order of
1,000 keys and the fence's decisions on a seeded event stream are equal;
a JAX FabricBroker publishes into port shards that a port fan-in drains,
and the other way round; a failover with a stale-epoch resurrection keeps
the conservation ledger exact; the single-endpoint path never imports the
fabric; the shard binary boots with k8s/broker.yaml's flags."""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from dotaclient_tpu.transport import fabric as jfab
from dotaclient_tpu.transport import tcp as jtcp
from dotaclient_tpu.transport.base import RetryPolicy as JRetryPolicy
from dotaclient_tpu.transport.serialize import serialize_rollout
from dotaclient_tpu_torch.obs import registry as treg
from dotaclient_tpu_torch.transport import base as tbase
from dotaclient_tpu_torch.transport import fabric as tfab
from dotaclient_tpu_torch.transport import memory as tmem
from dotaclient_tpu_torch.transport import tcp as ttcp
from test_transport import make_rollout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAST = tbase.RetryPolicy(window_s=0.4, backoff_base_s=0.01, backoff_cap_s=0.05, jitter=0.0)
JFAST = JRetryPolicy(window_s=0.4, backoff_base_s=0.01, backoff_cap_s=0.05, jitter=0.0)


def _fabric(urls, **kw):
    kw.setdefault("retry", FAST)
    kw.setdefault("failover_window_s", 0.4)
    kw.setdefault("cooldown_s", 0.5)
    return tfab.FabricBroker(urls, **kw)


def _jfabric(urls, **kw):
    kw.setdefault("retry", JFAST)
    kw.setdefault("failover_window_s", 0.4)
    kw.setdefault("cooldown_s", 0.5)
    return jfab.FabricBroker(urls, **kw)


def _frame(aid: int, seed: int = 0) -> bytes:
    return serialize_rollout(make_rollout(L=4, H=8, version=0, seed=seed)._replace(actor_id=aid))


def _drain(fb, n: int, timeout: float = 10.0) -> list:
    got = []
    deadline = time.monotonic() + timeout
    while len(got) < n and time.monotonic() < deadline:
        got.extend(fb.consume_experience(64, timeout=0.2))
    return got


# ---------------------------------------------------------------- bytes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_envelope_bytes_peek_and_strip_equal_the_reference(seed):
    rng = np.random.RandomState(seed)
    payload = rng.bytes(int(rng.randint(0, 200)))
    key, boot, epoch, seq = (int(rng.randint(0, 2**32)), int(rng.randint(0, 2**62)), int(rng.randint(0, 2**31)),
                             int(rng.randint(0, 2**31)))
    wrapped = tfab.wrap_fabric(payload, key, boot, epoch, seq)
    assert wrapped == jfab.wrap_fabric(payload, key, boot, epoch, seq)
    assert len(wrapped) == len(payload) + 24 and wrapped[:4] == b"FAB1"
    assert tfab.peek_fabric(wrapped) == jfab.peek_fabric(wrapped) == (key, boot, epoch, seq)
    assert tfab.strip_fabric(wrapped) == jfab.strip_fabric(wrapped) == payload
    # a key or boot past the field width is masked as the reference masks it
    assert tfab.wrap_fabric(b"x", key + 2**32, boot + 2**64, epoch, seq) == jfab.wrap_fabric(b"x", key + 2**32,
                                                                                            boot + 2**64, epoch, seq)
    for foreign in (payload[:23], b"DTR1" + bytes(40), b"FAB" + bytes(30)):
        assert tfab.peek_fabric(foreign) is None and jfab.peek_fabric(foreign) is None


@pytest.mark.parametrize("n_shards", [2, 3, 5])
def test_rendezvous_order_for_1000_keys_equals_the_reference(n_shards):
    urls = [f"tcp://broker-{i}.broker:13370" for i in range(n_shards)]
    for key in range(1000):
        assert tfab.rendezvous_order(key, urls) == jfab.rendezvous_order(key, urls)
    # removing one endpoint never moves a key between the survivors
    for key in range(200):
        full = [urls[i] for i in tfab.rendezvous_order(key, urls)]
        fewer = [urls[1:][i] for i in tfab.rendezvous_order(key, urls[1:])]
        assert [u for u in full if u != urls[0]] == fewer


@pytest.mark.parametrize("window", [8, tfab.FENCE_WINDOW])
def test_fence_decisions_on_a_seeded_stream_equal_the_reference(window):
    rng = np.random.RandomState(window)
    t, j = tfab.ShardFence(window=window), jfab.ShardFence(window=window)
    seqs = {}
    for _ in range(5000):
        key = int(rng.randint(0, 6))
        boot = 1000 + int(rng.randint(0, 3))
        epoch = int(rng.randint(0, 4))
        # mostly fresh seqs per key, some repeats and some far behind
        seqs[key] = seqs.get(key, 0) + int(rng.randint(0, 3))
        seq = max(0, seqs[key] - int(rng.choice([0, 0, 0, 1, 2, 20])))
        assert t.admit(key, boot, epoch, seq) == j.admit(key, boot, epoch, seq)
    assert (t.delivered, t.fence_dropped, t.dup_dropped) == (j.delivered, j.fence_dropped, j.dup_dropped)
    assert t.keys_tracked() == j.keys_tracked()
    assert t.delivered and t.fence_dropped and t.dup_dropped


def test_fence_rules_and_window():
    f = tfab.ShardFence()
    assert f.admit(1, 100, 0, 0) is True
    assert f.admit(1, 100, 0, 0) is False  # duplicate seq
    assert f.admit(1, 100, 1, 1) is True  # failover republish
    assert f.admit(1, 100, 0, 2) is False  # stale epoch
    assert f.admit(1, 100, 1, 1) is False  # duplicate of the republish
    assert f.admit(1, 200, 0, 0) is True  # restarted producer
    assert f.admit(1, 100, 9, 9) is False  # stale boot
    assert (f.fence_dropped, f.dup_dropped, f.delivered) == (2, 2, 3)
    w = tfab.ShardFence(window=8)
    for s in range(40):
        assert w.admit(5, 1, 0, s)
    assert len(w._keys[5]["seen"]) <= 9 and w.admit(5, 1, 0, 2) is False and w.fence_dropped == 1


def test_parse_fabric_endpoints_as_the_reference():
    assert tfab.parse_fabric_endpoints("tcp://a:1, tcp://b:2") == ["tcp://a:1", "tcp://b:2"]
    for bad in ("tcp://a:1", "tcp://a:1,", "tcp://a:1,b:2", "tcp://a:1,tcp://a:1", ","):
        with pytest.raises(ValueError):
            tfab.parse_fabric_endpoints(bad)
        with pytest.raises(ValueError):
            jfab.parse_fabric_endpoints(bad)


def test_boot_is_u64_milliseconds_and_routing_pins_a_trajectory():
    tmem.reset("tf_pa"), tmem.reset("tf_pb"), tmem.reset("tf_pc")
    urls = ["mem://tf_pa", "mem://tf_pb", "mem://tf_pc"]
    before = int(time.time() * 1000)
    fb = _fabric(urls)
    assert before <= fb._boot <= int(time.time() * 1000) and fb._boot > 2**32
    shards = {}
    for aid in range(12):
        for chunk in range(3):
            fb.publish_experience(_frame(aid, seed=chunk))
            shards.setdefault(aid, set()).add(fb.last_publish_endpoint)
    assert all(len(s) == 1 for s in shards.values())
    assert {s.pop() for s in shards.values()} == set(urls)
    for aid in range(12):
        assert fb.route_endpoint(_frame(aid)) == urls[tfab.rendezvous_order(aid, urls)[0]]
    with pytest.raises(ValueError, match="needs tcp:// shards"):  # mem:// has no assembly tier
        fb.enable_assembled_consume(None)
    fb.close()


# ------------------------------------------------------- cross-package


def _servers(make, n):
    return [make() for _ in range(n)]


@pytest.mark.parametrize("direction", ["jax_into_port", "port_into_jax"])
def test_one_package_publishes_and_the_other_drains(direction):
    """A JAX FabricBroker publishes into port shards and a port fan-in
    drains them, or the other way round: every frame arrives once, its
    bytes intact, and the consumer's ledger balances."""
    if direction == "jax_into_port":
        servers = _servers(lambda: ttcp.BrokerServer("127.0.0.1", 0, priority_shed=True).start(), 3)
        make_pub, make_cons = _jfabric, _fabric
    else:
        servers = _servers(lambda: jtcp.BrokerServer("127.0.0.1", 0, priority_shed=True).start(), 3)
        make_pub, make_cons = _fabric, _jfabric
    urls = [f"tcp://127.0.0.1:{s.port}" for s in servers]
    pub, cons = make_pub(urls), make_cons(urls)
    try:
        frames = [_frame(aid, seed=k) for aid in range(16) for k in range(2)]
        for i, f in enumerate(frames):
            pub.publish_experience(f, priority=float(i % 5))
        assert sorted(s.ledger()["enqueued"] for s in servers) != [0, 0, len(frames)]  # spread over shards
        got = _drain(cons, len(frames))
        assert sorted(got) == sorted(frames)
        stats = cons.fabric_stats()
        popped = sum(stats[f"broker_shard_{i}_popped_total"] for i in range(3))
        assert popped == stats["fanin_delivered_total"] == len(frames)
        assert stats["fanin_fence_dropped_total"] == stats["fanin_dup_dropped_total"] == 0
        # weights: fanned out to every shard, polled from the first
        pub.publish_weights(b"DTW2-frame")
        assert cons.poll_weights() == b"DTW2-frame" and cons.poll_weights() is None
        assert all(s.weights == b"DTW2-frame" for s in servers)
    finally:
        pub.close(), cons.close()
        for s in servers:
            s.stop()


def _until(cond, what: str, consume=None, cap: float = 120.0) -> None:
    """Wait for the fabric's own progress (`cond()`), consuming meanwhile
    through `consume` if given. The cap only turns a hang into a failure:
    the test waits on the event, never on a wall-clock window."""
    deadline = time.monotonic() + cap
    while not cond():
        if time.monotonic() >= deadline:
            raise AssertionError(f"no progress in {cap} s: {what}")
        if consume is not None:
            consume()
        else:
            time.sleep(0.02)


def test_failover_and_stale_resurrection_keep_the_ledger_exact():
    """Port shards, port fabric: the primary dies, the publish fails over
    with an epoch bump, the primary resurrects holding a stale-epoch copy;
    the fence drops it, the chunk is delivered once, and popped =
    delivered + fence_dropped + dup_dropped exactly."""
    s0, s1 = ttcp.BrokerServer("127.0.0.1", 0).start(), ttcp.BrokerServer("127.0.0.1", 0).start()
    urls = [f"tcp://127.0.0.1:{s0.port}", f"tcp://127.0.0.1:{s1.port}"]
    fb = _fabric(urls)
    data = _frame(5)
    order = tfab.rendezvous_order(5, urls)
    primary, successor = [s0, s1][order[0]], [s0, s1][order[1]]
    fb.publish_experience(data)  # seq 0, epoch 0 → primary
    assert primary.enqueued_total == 1 and successor.enqueued_total == 0
    primary.stop()
    fb.publish_experience(data)  # seq 1 fails over: epoch 1 → successor
    assert successor.enqueued_total == 1
    env = tfab.peek_fabric(bytes(successor.experience[0]))
    assert env[2] == 1 and env[3] == 1
    got = []

    def consume():
        got.extend(fb.consume_experience(8, timeout=0.2))

    # the republish is delivered first, so the key's fence stands at epoch 1
    _until(lambda: got, "the failover republish delivered", consume)
    assert got == [data] and fb._fence.delivered == 1
    reborn = None
    deadline = time.monotonic() + 120
    while reborn is None:
        try:
            reborn = ttcp.BrokerServer("127.0.0.1", primary.port).start()
        except (RuntimeError, OSError):
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.05)
    direct = ttcp.TcpBroker("127.0.0.1", reborn.port)
    direct.publish_experience(tfab.wrap_fabric(data, key=5, boot=fb._boot, epoch=0, seq=1))  # the stale copy
    # the fan-in polls the reborn primary again once its cooldown passed:
    # its popped count moves, and the fence drops the stale copy
    _until(lambda: fb.fabric_stats()[f"broker_shard_{order[0]}_popped_total"] >= 1, "the reborn primary polled",
           consume)
    _until(lambda: fb._fence.fence_dropped >= 1, "the stale copy fence-dropped", consume)
    fb.quiesce()
    _until(lambda: not any(fb._mid_pop), "the pop threads idle")
    got.extend(fb.consume_residual(100))
    assert got.count(data) == 1 and fb.fanin_residual() == 0
    stats = fb.fabric_stats()
    popped = sum(stats[f"broker_shard_{i}_popped_total"] for i in range(2))
    assert stats["fanin_fence_dropped_total"] == 1 and stats["fanin_publish_failovers_total"] >= 1
    assert popped == stats["fanin_delivered_total"] + stats["fanin_fence_dropped_total"] + stats["fanin_dup_dropped_total"]
    assert reborn.ledger()["popped"] == 1
    for s in (reborn, successor):
        led = s.ledger()
        assert led["enqueued"] == led["popped"] + led["dropped_oldest"] + led["evicted_low"] + led["resident"]
    direct.close(), fb.close()
    reborn.stop(), successor.stop()


def test_all_shards_down_raises_and_counts():
    s0, s1 = ttcp.BrokerServer("127.0.0.1", 0).start(), ttcp.BrokerServer("127.0.0.1", 0).start()
    fb = _fabric([f"tcp://127.0.0.1:{s0.port}", f"tcp://127.0.0.1:{s1.port}"])
    fb.publish_experience(b"DTR1" + bytes(40))
    s0.stop(), s1.stop()
    with pytest.raises((ConnectionError, OSError)):
        fb.publish_experience(b"DTR1" + bytes(40))
    assert fb.publish_failed_total == 1
    with pytest.raises(ConnectionError):
        fb.publish_weights(b"w")
    fb.close()


def test_disjoint_consume_shards_split_the_stream_and_restrict_locks():
    tmem.reset("tf_dja"), tmem.reset("tf_djb")
    urls = ["mem://tf_dja", "mem://tf_djb"]
    pub = _fabric(urls)
    for aid in range(24):
        pub.publish_experience(_frame(aid, seed=aid))
    c0, c1 = _fabric(urls, consume_shards=[0]), _fabric(urls)
    with pytest.raises(ValueError):
        c1.restrict_consume_shards([2])
    c1.restrict_consume_shards([1])
    got0, got1 = [], []
    deadline = time.monotonic() + 5
    while len(got0) + len(got1) < 24 and time.monotonic() < deadline:
        got0.extend(c0.consume_experience(32, timeout=0.2))
        got1.extend(c1.consume_experience(32, timeout=0.2))
    assert len(got0) + len(got1) == 24 and got0 and got1 and set(got0).isdisjoint(got1)
    with pytest.raises(RuntimeError):
        c1.restrict_consume_shards([0])
    assert set(c1.fabric_stats()) >= {"broker_shard_1_up", "fanin_delivered_total"}
    assert "broker_shard_0_up" not in c1.fabric_stats()
    for b in (pub, c0, c1):
        b.close()


def test_fabric_stats_names_are_the_reference_registry_s():
    from dotaclient_tpu.obs import registry as jreg

    tmem.reset("tf_ra"), tmem.reset("tf_rb")
    fb = _fabric(["mem://tf_ra", "mem://tf_rb"])
    names = list(fb.fabric_stats())
    src = tfab.shard_metrics_source(ttcp.BrokerServer("127.0.0.1", 0))
    names += list(src())
    assert not jreg.unregistered(names) and not treg.unregistered(names)
    fb.close()


# ------------------------------------------------------------ inertness


def test_a_single_endpoint_never_imports_the_fabric():
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
from dotaclient_tpu_torch.config import LearnerConfig, InferenceConfig, parse_config
from dotaclient_tpu_torch.transport.base import connect
assert parse_config(LearnerConfig(), []).broker_shards == ""
parse_config(InferenceConfig(), [])
b = connect("mem://inert")
b.publish_experience(b"x")
assert b.consume_experience(1, timeout=0.5) == [b"x"]
assert "dotaclient_tpu_torch.transport.fabric" not in sys.modules, "fabric imported on the classic path"
connect("mem://a,mem://b")
assert "dotaclient_tpu_torch.transport.fabric" in sys.modules
print("INERT_OK")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "INERT_OK" in proc.stdout


# ------------------------------------------------------------- binary


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_the_shard_binary_takes_the_broker_manifest_s_flags():
    """`python -m dotaclient_tpu_torch.transport.fabric` with
    k8s/broker.yaml's args (and an ephemeral port): priority admission
    on, /metrics carries the shard ledger, /healthz 200, /debug/flight a
    snapshot with the ledger section and the broker_assemble_* ledger at
    zero; `--broker.assemble true` arms the shard (its ready line says
    so)."""
    mport = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "dotaclient_tpu_torch.transport.fabric", "--host", "127.0.0.1", "--port", "0",
         "--maxlen", "8192", "--shed_high", "768", "--shed_low", "256", "--priority", "true",
         "--prio_half_life_s", "8.0", "--broker.assemble", "false", "--metrics_port", str(mport)],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "fabric shard listening" in line and "priority admission" in line and "shed 768/256" in line, line
        port = int(line.split(":")[1].split(" ")[0])
        c = jtcp.TcpBroker(port=port)  # the reference's client against the port's shard
        c.publish_experience_prioritized(b"x", 1.0)
        assert c.stats2()["priority_mode"] == 1 and c.consume_experience(4, timeout=1.0) == [b"x"]
        c.close()
        metrics = urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics", timeout=10).read().decode()
        scraped = {ln.split()[0]: float(ln.split()[1]) for ln in metrics.splitlines() if ln and ln[0] != "#"}
        assert scraped["dotaclient_broker_shard_enqueued_total"] == 1.0
        assert scraped["dotaclient_broker_shard_popped_total"] == 1.0
        assert scraped["dotaclient_broker_shard_resident"] == 0.0
        assert scraped["dotaclient_broker_assemble_rows_admitted_total"] == 0.0
        assert urllib.request.urlopen(f"http://127.0.0.1:{mport}/healthz", timeout=10).status == 200
        flight = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{mport}/debug/flight", timeout=10).read())
        assert flight["role"] == "fabric_shard" and flight["sections"]["ledger"]["enqueued"] == 1
    finally:
        proc.kill()
        proc.wait(timeout=10)
    proc = subprocess.Popen([sys.executable, "-m", "dotaclient_tpu_torch.transport.fabric", "--host", "127.0.0.1",
                             "--port", "0", "--broker.assemble", "true"], cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "fabric shard listening" in line and ", assemble" in line, line
    finally:
        proc.kill()
        proc.wait(timeout=10)
