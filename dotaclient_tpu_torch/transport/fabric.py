"""Broker fabric (own copy of dotaclient_tpu/transport/fabric.py): N
experience-broker shards behind a rendezvous-hash router, with
epoch-fenced failover, in-shard priority admission and a multi-shard
fan-in consumer. The bytes on the wire are the reference's, so a mixed
fleet of both packages' producers, shards and learners interoperates.

- Routing: `--broker_url` is a comma-separated shard list
  ("tcp://h1:p1,tcp://h2:p2,..."). Every chunk of one trajectory goes to
  one shard, chosen by rendezvous (highest-random-weight) hashing of the
  actor_id in the frame header (transport/serialize.py
  peek_rollout_actor_id), so any process computes the same route.
- Epoch-fenced failover: each frame travels in a 24-byte envelope
  (FAB1, route key, u64 boot in milliseconds, epoch, seq). When a shard
  publish fails past the short failover window, the client bumps the
  key's epoch, re-routes to the next shard in that key's order and
  republishes the same seq under the new epoch. The consumer's fence
  applies each chunk at most once:
    * boot newer  → a new producer incarnation: reset the key, deliver;
    * boot older  → a stale incarnation: fence-drop;
    * epoch older → a late copy from a shard the key failed away from:
      fence-drop;
    * seq already applied (epoch >= current) → dup-drop.
  Every drop is counted: per consumer, popped = delivered +
  fence_dropped + dup_dropped.
- Priority admission: publishes go over the tcp PUB_EXPP op with the
  producer's priority; a shard running `--priority` evicts its
  lowest-effective-priority resident instead of refusing the newcomer.
- Fan-in: the learner runs one pop thread per consumed shard into one
  bounded queue that staging drains; `restrict_consume_shards` pins a
  learner to a disjoint shard subset (LearnerConfig.broker_shards).

A single-endpoint `--broker_url` never imports this module
(transport/base.py connect imports it only for comma lists).

Shard binary: `python -m dotaclient_tpu_torch.transport.fabric` runs one
shard (a BrokerServer with the priority-admission flags), the process
k8s/broker.yaml's StatefulSet runs per pod. Its one stdout line names
the bound port: `fabric shard listening on HOST:PORT (...)`.
- In-network batch assembly: a shard run with `--broker.assemble true`
  packs every admitted frame into the learner's row layout and serves
  DTB1 blocks (transport/tcp.py GET_BLOCK); a learner with
  `--staging.assemble true` calls `enable_assembled_consume`, and its pop
  threads then take blocks, fence each row by the stamp in its sidecar
  and hand AssembledRows to staging. k8s/broker.yaml pins it off.
"""

from __future__ import annotations

import argparse
import logging
import queue
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

from dotaclient_tpu_torch.transport.base import Broker, BrokerShedError, RetryPolicy
from dotaclient_tpu_torch.transport.base import connect as _connect
from dotaclient_tpu_torch.transport.serialize import deserialize_block, peek_rollout_actor_id

_log = logging.getLogger(__name__)

FABRIC_MAGIC = b"FAB1"
# magic | u32 route key | u64 boot | u32 epoch | u32 seq, then the payload
# (a DTR1/2/3 frame, untouched); the fan-in strips it before staging.
# boot is milliseconds since the epoch: the fence orders producer
# incarnations by it, so a restart within the same second must still
# stamp a larger boot, and a u64 never wraps.
_ENV = struct.Struct("<4sIQII")

# Seq-dedup window per key: a republish only duplicates the newest unacked
# chunks; older frames are fence-dropped (counted), never applied twice.
FENCE_WINDOW = 512

# The fan-in queue's bound, and the most frames one pop takes from a shard.
FANIN_DEPTH = 4096
POP_BATCH = 64


def wrap_fabric(payload: bytes, key: int, boot: int, epoch: int, seq: int) -> bytes:
    return _ENV.pack(FABRIC_MAGIC, key & 0xFFFFFFFF, boot & 0xFFFFFFFFFFFFFFFF, epoch, seq) + payload


def peek_fabric(data: bytes) -> Optional[Tuple[int, int, int, int]]:
    """(key, boot, epoch, seq) of an enveloped frame, None otherwise: a
    frame published straight at one shard passes the fan-in unfenced."""
    if len(data) < _ENV.size or data[:4] != FABRIC_MAGIC:
        return None
    _, key, boot, epoch, seq = _ENV.unpack_from(data)
    return key, boot, epoch, seq


def strip_fabric(data: bytes) -> bytes:
    return data[_ENV.size :]


def parse_fabric_endpoints(url: str) -> List[str]:
    """Split a comma-separated shard list; a malformed list raises at boot
    instead of quietly shrinking the fabric."""
    parts = [p.strip() for p in url.split(",")]
    if any(not p for p in parts) or len(parts) < 2:
        raise ValueError(f"malformed broker shard list {url!r}")
    for p in parts:
        if not (p.startswith("tcp://") or p.startswith("mem://") or p.startswith("amqp://")):
            raise ValueError(f"shard {p!r} has no broker url scheme in {url!r}")
    if len(set(parts)) != len(parts):
        raise ValueError(f"duplicate shard endpoint in {url!r}")
    return parts


def rendezvous_order(key: int, endpoints: List[str]) -> List[int]:
    """Shard preference order of a route key: shard i scores
    crc32(f"{key}|{endpoint_i}"), highest first. Every process computes
    the same order, removing an endpoint never moves keys between the
    survivors, and the failover successor is the next index."""
    return sorted(range(len(endpoints)), key=lambda i: zlib.crc32(f"{key}|{endpoints[i]}".encode()), reverse=True)


class ShardFence:
    """Consumer-side epoch fence and seq dedup (the rules in the module
    docstring), one lock over the per-key table: pop threads of two shards
    race on one key exactly while a failover is in flight."""

    def __init__(self, window: int = FENCE_WINDOW):
        self.window = window
        self._lock = threading.Lock()
        self._keys: Dict[int, dict] = {}
        self.fence_dropped = 0  # stale boot or epoch, or older than the window
        self.dup_dropped = 0  # a seq already applied
        self.delivered = 0

    def admit(self, key: int, boot: int, epoch: int, seq: int) -> bool:
        with self._lock:
            st = self._keys.get(key)
            if st is None or boot > st["boot"]:
                # first sight, or a restarted producer: a new seq space
                st = {"boot": boot, "epoch": epoch, "max_seq": -1, "seen": set()}
                self._keys[key] = st
            elif boot < st["boot"]:
                self.fence_dropped += 1
                return False
            if epoch < st["epoch"]:
                self.fence_dropped += 1  # a late copy from a shard the key failed away from
                return False
            st["epoch"] = epoch
            if seq in st["seen"]:
                self.dup_dropped += 1
                return False
            if seq <= st["max_seq"] - self.window:
                # older than the dedup window: it cannot be proven new
                self.fence_dropped += 1
                return False
            st["seen"].add(seq)
            if seq > st["max_seq"]:
                st["max_seq"] = seq
            floor = st["max_seq"] - self.window
            if len(st["seen"]) > self.window:
                st["seen"] = {s for s in st["seen"] if s > floor}
            self.delivered += 1
            return True

    def keys_tracked(self) -> int:
        with self._lock:
            return len(self._keys)


class FabricBroker(Broker):
    """The sharded transport's client: a router on the publish side and a
    fenced fan-in on the consume side, in one object (actors only publish,
    learners only consume experience)."""

    def __init__(self, endpoints: List[str], retry: Optional[RetryPolicy] = None,
                 consume_shards: Optional[List[int]] = None, failover_window_s: float = 2.0,
                 cooldown_s: float = 5.0, **shard_kw):
        if len(endpoints) < 2:
            raise ValueError("FabricBroker needs >= 2 shard endpoints")
        self.endpoints = list(endpoints)
        base = retry if retry is not None else RetryPolicy()
        # A shard client reconnect-retries only within the failover window:
        # a shard down longer than that is the router's to route around.
        self._shard_retry = RetryPolicy(window_s=min(base.window_s, failover_window_s),
                                        backoff_base_s=base.backoff_base_s, backoff_cap_s=base.backoff_cap_s,
                                        jitter=base.jitter)
        self._shard_kw = shard_kw
        self.cooldown_s = cooldown_s
        self._shards: List[Optional[Broker]] = [None] * len(endpoints)
        self._down_until = [0.0] * len(endpoints)
        self._shard_lock = threading.Lock()
        # The producer's incarnation, in wall-clock milliseconds; epoch and
        # seq are per route key.
        self._boot = int(time.time() * 1000)
        self._pub_lock = threading.Lock()
        self._key_state: Dict[int, dict] = {}  # key -> {"epoch", "seq"}
        self.published_total = 0
        self.failovers_total = 0
        self.publish_failed_total = 0
        self.shed_observed = 0
        self.last_publish_endpoint: Optional[str] = None
        # the fan-in, started by the first consume
        self.consume_shards = sorted(set(consume_shards)) if consume_shards is not None else None
        self._fence = ShardFence()
        self._fanin: "queue.Queue" = queue.Queue(maxsize=FANIN_DEPTH)
        self._stop = threading.Event()
        self._quiesce = threading.Event()
        self._pop_threads: List[threading.Thread] = []
        self._fanin_started = False
        self._fanin_lock = threading.Lock()
        # a BlockSpec once enable_assembled_consume has run: the pop threads
        # then take DTB1 blocks, and the fan-in carries AssembledRows
        self._block_spec = None
        self._shard_popped = [0] * len(endpoints)
        self._shard_starved_s = [0.0] * len(endpoints)
        self._mid_pop = [False] * len(endpoints)
        self._meters_lock = threading.Lock()

    # ------------------------------------------------------------ shards

    def _my_shards(self) -> List[int]:
        return self.consume_shards if self.consume_shards is not None else list(range(len(self.endpoints)))

    def restrict_consume_shards(self, shards: List[int]) -> None:
        """Pin this consumer to a shard subset (LearnerConfig.broker_shards).
        Before the first consume only: the pop threads are built from it."""
        with self._fanin_lock:
            if self._fanin_started:
                raise RuntimeError("restrict_consume_shards after fan-in started")
            bad = [s for s in shards if not 0 <= s < len(self.endpoints)]
            if bad or not shards:
                raise ValueError(f"broker_shards {shards} out of range for {len(self.endpoints)} endpoints")
            self.consume_shards = sorted(set(shards))

    def _shard(self, i: int) -> Broker:
        """The live client of shard i, rebuilt after its cooldown; raises
        ConnectionError while the shard sits the cooldown out."""
        with self._shard_lock:
            b = self._shards[i]
            if b is not None:
                return b
            if time.monotonic() < self._down_until[i]:
                raise ConnectionError(f"shard {self.endpoints[i]} cooling down")
        # dial outside the lock: a slow connect must not hold up other shards
        nb = _connect(self.endpoints[i], retry=self._shard_retry, **self._shard_kw)
        with self._shard_lock:
            if self._shards[i] is None:
                self._shards[i] = nb
            else:  # another thread rebuilt it first; keep that one
                try:
                    nb.close()
                except Exception:
                    pass
            return self._shards[i]

    def _mark_down(self, i: int) -> None:
        with self._shard_lock:
            b, self._shards[i] = self._shards[i], None
            self._down_until[i] = time.monotonic() + self.cooldown_s
        if b is not None:
            try:
                b.close()
            except Exception:
                pass

    def _shard_up(self, i: int) -> bool:
        with self._shard_lock:
            return self._shards[i] is not None or time.monotonic() >= self._down_until[i]

    # ----------------------------------------------------------- publish

    @property
    def wants_priority(self) -> bool:
        """Producers that hold the rollout's priority should pass it: it
        drives the shards' priority admission."""
        return True

    def _route_key(self, data: bytes) -> int:
        key = peek_rollout_actor_id(data)
        if key is None:
            key = zlib.crc32(data[:64])  # a non-rollout payload still routes deterministically
        return key

    def route_endpoint(self, data: bytes) -> str:
        """The endpoint this frame would be published to now (a producer's
        per-endpoint shed throttle keys on it)."""
        key = self._route_key(data)
        for i in rendezvous_order(key, self.endpoints):
            if self._shard_up(i):
                return self.endpoints[i]
        return self.endpoints[rendezvous_order(key, self.endpoints)[0]]

    def publish_experience(self, data: bytes, priority: float = 0.0) -> None:
        """Route, envelope, publish; fail over with an epoch bump. A shed
        is not a failover (the shard is alive and asked for less): it
        raises BrokerShedError with `.endpoint` set. `_pub_lock` guards only
        the per-key epoch/seq, never the network I/O, so one thread's
        failover dials never hold up another thread's healthy publishes."""
        key = self._route_key(data)
        with self._pub_lock:
            st = self._key_state.setdefault(key, {"epoch": 0, "seq": 0})
            seq = st["seq"]
            st["seq"] += 1
            epoch = st["epoch"]
        last_error: Optional[Exception] = None
        hops = 0
        for i in rendezvous_order(key, self.endpoints):
            if not self._shard_up(i):
                continue
            frame = wrap_fabric(data, key, self._boot, epoch, seq)
            try:
                shard = self._shard(i)
                pub = getattr(shard, "publish_experience_prioritized", None)
                if pub is not None:
                    pub(frame, priority)
                else:
                    shard.publish_experience(frame)
                self.published_total += 1
                self.failovers_total += hops
                self.last_publish_endpoint = self.endpoints[i]
                return
            except BrokerShedError as e:
                self.shed_observed += 1
                e.endpoint = self.endpoints[i]
                raise
            except (ConnectionError, OSError) as e:
                # This shard is unreachable past the failover window: bump
                # the key's epoch before the next hop, so a copy the dead
                # shard still holds is fenced at the consumer. Advance only:
                # a concurrent failover of the same key never rolls it back.
                last_error = e
                self._mark_down(i)
                with self._pub_lock:
                    st["epoch"] = max(st["epoch"], epoch + 1)
                    epoch = st["epoch"]
                hops += 1
        self.publish_failed_total += 1
        raise ConnectionError(f"all {len(self.endpoints)} broker shards unreachable") from last_error

    def publish_experience_prioritized(self, data: bytes, priority: float) -> None:
        self.publish_experience(data, priority=priority)

    # ----------------------------------------------------------- consume

    def enable_assembled_consume(self, spec) -> None:
        """Switch this consumer's fan-in to shard-assembled DTB1 blocks of
        `spec`'s row layout (serialize.BlockSpec); consumed items become
        AssembledRows. Before the first consume only, and every consumed
        shard must be tcp:// (GET_BLOCK is a tcp broker op)."""
        with self._fanin_lock:
            if self._fanin_started:
                raise RuntimeError("enable_assembled_consume after fan-in started")
            bad = [self.endpoints[i] for i in self._my_shards() if not self.endpoints[i].startswith("tcp://")]
            if bad:
                raise ValueError(f"assembled consume needs tcp:// shards, got {bad}")
            self._block_spec = spec

    def _ensure_fanin(self) -> None:
        with self._fanin_lock:
            if self._fanin_started:
                return
            self._fanin_started = True
            for i in self._my_shards():
                t = threading.Thread(target=self._pop_loop, args=(i,), daemon=True, name=f"fabric-pop-{i}")
                self._pop_threads.append(t)
                t.start()

    def _pop_loop(self, i: int) -> None:
        """Shard i's pop thread: drain it through the fence into the shared
        queue. A dead shard costs this thread backoff time (metered as
        starvation) while the others keep the learner fed. Each consume
        is bounded by the shard client's read timeout and retry window, so
        a stopped shard holds this thread (and `_mid_pop[i]`) for that
        long at most before it is marked down."""
        backoff = self._shard_retry.backoff_base_s
        while not self._stop.is_set():
            if self._quiesce.is_set():
                time.sleep(0.05)
                continue
            if not self._shard_up(i):
                # sit the cooldown out without dialing: a dial here would
                # raise and re-arm the cooldown, and a reborn shard could
                # never rejoin
                with self._meters_lock:
                    self._shard_starved_s[i] += 0.1
                self._stop.wait(0.1)
                continue
            t0 = time.monotonic()
            with self._meters_lock:
                self._mid_pop[i] = True
            try:
                try:
                    shard = self._shard(i)
                    if self._block_spec is not None:
                        _, frames = deserialize_block(shard.consume_block(self._block_spec, max_rows=POP_BATCH,
                                                                          timeout=0.2))
                    else:
                        frames = shard.consume_experience(max_items=POP_BATCH, timeout=0.2)
                except (ConnectionError, OSError, ValueError):
                    self._mark_down(i)
                    with self._meters_lock:
                        self._shard_starved_s[i] += time.monotonic() - t0
                    self._stop.wait(self._shard_retry.sleep_for(backoff))
                    backoff = self._shard_retry.next_backoff(backoff)
                    continue
                backoff = self._shard_retry.backoff_base_s
                if not frames:
                    with self._meters_lock:
                        self._shard_starved_s[i] += time.monotonic() - t0
                    continue
                with self._meters_lock:
                    self._shard_popped[i] += len(frames)
                for f in frames:
                    if self._block_spec is not None:
                        # an assembled row's fence stamp rides its sidecar
                        # (boot 0: un-enveloped, always admitted); the route
                        # key is its actor_id, as publish derives it
                        if f.boot and not self._fence.admit(f.actor_id, f.boot, f.epoch, f.seq):
                            continue
                    else:
                        env = peek_fabric(f)
                        if env is not None:
                            if not self._fence.admit(*env):
                                continue
                            f = f[_ENV.size :]
                    while not self._stop.is_set():
                        try:
                            self._fanin.put(f, timeout=0.2)
                            break
                        except queue.Full:
                            continue
            finally:
                with self._meters_lock:
                    self._mid_pop[i] = False

    def consume_experience(self, max_items: int, timeout: Optional[float] = None) -> List[bytes]:
        self._ensure_fanin()
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[bytes] = []
        while len(out) < max_items:
            if out:
                wait = 0.0  # the first frame landed: drain without waiting
            elif deadline is None:
                wait = 0.2
            else:
                wait = max(0.0, deadline - time.monotonic())
            try:
                out.append(self._fanin.get(timeout=min(wait, 0.2) if wait else 0.0))
            except queue.Empty:
                if out or (deadline is not None and time.monotonic() >= deadline):
                    break
        return out

    def consume_residual(self, max_items: int) -> List[bytes]:
        """Non-blocking drain of frames already popped off the shards (the
        fan-in queue): the SIGTERM drain quiesces the fabric, then drains
        this, so no popped frame strands between the shards and staging."""
        out: List[bytes] = []
        while len(out) < max_items:
            try:
                out.append(self._fanin.get_nowait())
            except queue.Empty:
                break
        return out

    def quiesce(self) -> None:
        """Stop popping the shards; popped frames stay readable through
        consume_residual. Idempotent."""
        self._quiesce.set()

    def fanin_residual(self) -> int:
        """Frames popped off the shards but not yet handed to staging: the
        fan-in queue plus one for each pop thread between its shard read
        and its queue put. staging.drained() reads nonzero as not drained."""
        with self._meters_lock:
            mid = sum(1 for m in self._mid_pop if m)
        return self._fanin.qsize() + mid

    # ----------------------------------------------------------- weights

    def publish_weights(self, data: bytes) -> None:
        """Fan out to every shard (producers poll whichever answers first);
        best effort per shard, raises only when no shard took it."""
        ok = 0
        last_error: Optional[Exception] = None
        for i in range(len(self.endpoints)):
            if not self._shard_up(i):
                continue
            try:
                self._shard(i).publish_weights(data)
                ok += 1
            except (ConnectionError, OSError) as e:
                last_error = e
                self._mark_down(i)
        if ok == 0:
            raise ConnectionError("weight publish reached no broker shard") from last_error

    def poll_weights(self) -> Optional[bytes]:
        """Poll the first healthy shard, in list order. After a failover the
        new shard may deliver a version already applied; apply_weight_frame
        makes that a no-op."""
        last_error: Optional[Exception] = None
        for i in range(len(self.endpoints)):
            if not self._shard_up(i):
                continue
            try:
                return self._shard(i).poll_weights()
            except (ConnectionError, OSError) as e:
                last_error = e
                self._mark_down(i)
        if last_error is not None:
            raise ConnectionError("no broker shard reachable for weights") from last_error
        return None

    # ------------------------------------------------------------- misc

    def experience_depth(self) -> int:
        """Sum of the reachable consumed shards' depths (an RPC per shard)."""
        total = 0
        for i in self._my_shards():
            if not self._shard_up(i):
                continue
            try:
                d = self._shard(i).experience_depth()
                if d >= 0:
                    total += d
            except (ConnectionError, OSError):
                self._mark_down(i)
        return total

    def shard_stats(self, i: int) -> dict:
        """Shard i's server-side counters (STATS2 when its client has it)."""
        shard = self._shard(i)
        fn = getattr(shard, "stats2", None) or getattr(shard, "stats", None)
        return {} if fn is None else fn()

    def fabric_stats(self) -> Dict[str, float]:
        """The fanin_* and broker_shard_<i>_* scalars (obs/registry.py):
        local counters only, no RPC."""
        with self._meters_lock:
            popped = list(self._shard_popped)
            starved = list(self._shard_starved_s)
        out: Dict[str, float] = {
            "fanin_queue_depth": float(self._fanin.qsize()),
            "fanin_delivered_total": float(self._fence.delivered),
            "fanin_fence_dropped_total": float(self._fence.fence_dropped),
            "fanin_dup_dropped_total": float(self._fence.dup_dropped),
            "fanin_pop_threads": float(len(self._pop_threads)),
            "fanin_keys_tracked": float(self._fence.keys_tracked()),
            "fanin_publish_failovers_total": float(self.failovers_total),
            "fanin_publish_failed_total": float(self.publish_failed_total),
        }
        for i in self._my_shards():
            out[f"broker_shard_{i}_popped_total"] = float(popped[i])
            out[f"broker_shard_{i}_starved_s"] = round(starved[i], 3)
            out[f"broker_shard_{i}_up"] = 1.0 if self._shard_up(i) else 0.0
        return out

    def close(self) -> None:
        self._stop.set()
        for t in self._pop_threads:
            t.join(timeout=5)
        with self._shard_lock:
            shards, self._shards = list(self._shards), [None] * len(self.endpoints)
        for b in shards:
            if b is not None:
                try:
                    b.close()
                except Exception:
                    pass


# ------------------------------------------------------------------ binary


def shard_metrics_source(server):
    """The shard binary's scrape source: its BrokerServer ledger as the
    un-indexed broker_shard_* gauges (enqueued = popped + dropped +
    evicted_low + resident at any quiescent point), and the assembly
    station's broker_assemble_* ledger (all zero unless armed; admitted =
    packed + reject + bypassed + dropped + resident)."""

    def source():
        led = server.ledger()
        asm = server.assemble_ledger()
        out = {
            "broker_shard_enqueued_total": float(led["enqueued"]),
            "broker_shard_popped_total": float(led["popped"]),
            "broker_shard_dropped_total": float(led["dropped_oldest"]),
            "broker_shard_shed_total": float(led["shed"]),
            "broker_shard_reply_lost_total": float(led["reply_lost"]),
            "broker_shard_evicted_low_total": float(led["evicted_low"]),
            "broker_shard_resident": float(led["resident"]),
            "broker_shard_depth": float(led["resident"]),
        }
        for k in ("rows_admitted", "rows_packed", "rows_reject", "rows_bypassed", "rows_dropped", "blocks_built",
                  "blocks_served", "block_bytes"):
            out[f"broker_assemble_{k}_total"] = float(asm[k])
        out["broker_assemble_rows_resident"] = float(asm["rows_resident"])
        out["broker_assemble_cpu_s_total"] = round(float(asm["cpu_s"]), 6)
        return out

    return source


def main(argv=None):
    """One fabric shard: a BrokerServer with the priority-admission flags
    (the reference binary's flags)."""
    from dotaclient_tpu_torch.config import _parse_bool
    from dotaclient_tpu_torch.transport.tcp import BrokerServer

    p = argparse.ArgumentParser(description="dotaclient broker fabric shard")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=13370)
    p.add_argument("--maxlen", type=int, default=8192, help="experience queue bound (drop-oldest)")
    p.add_argument("--shed_high", type=int, default=0,
                   help="admission-control high watermark (0 = admission control off)")
    p.add_argument("--shed_low", type=int, default=0, help="low watermark: admit again at this depth")
    p.add_argument("--priority", type=_parse_bool, default=False,
                   help="priority admission: a prioritized publish while shedding evicts the "
                   "lowest-effective-priority resident instead of being refused")
    p.add_argument("--prio_half_life_s", type=float, default=8.0,
                   help="age half-life of the eviction priority decay, seconds")
    p.add_argument("--broker.assemble", dest="broker_assemble", type=_parse_bool, default=False,
                   help="in-network batch assembly: pack admitted frames into the learner's row layout and "
                   "serve DTB1 blocks to GET_BLOCK consumers (flip the learners' --staging.assemble first)")
    p.add_argument("--metrics_port", type=int, default=0,
                   help="/metrics (broker_shard_* ledger gauges), /healthz, /debug/flight (0 = none)")
    args = p.parse_args(argv)
    server = BrokerServer(args.host, args.port, args.maxlen, shed_high=args.shed_high, shed_low=args.shed_low,
                          priority_shed=args.priority, prio_half_life_s=args.prio_half_life_s,
                          assemble=args.broker_assemble).start()
    obs_http = None
    if args.metrics_port != 0:
        # a shard without --metrics_port never imports the obs package
        from dotaclient_tpu_torch.obs.flight_recorder import FlightRecorder
        from dotaclient_tpu_torch.obs.http import MetricsHTTPServer

        recorder = FlightRecorder("fabric_shard")
        recorder.add_section("ledger", server.ledger)
        recorder.record("boot", port=server.port, maxlen=args.maxlen)
        obs_http = MetricsHTTPServer(args.metrics_port, sources=[shard_metrics_source(server)],
                                     flight_provider=recorder.snapshot).start()
    shed = f", shed {args.shed_high}/{args.shed_low}" if args.shed_high else ""
    prio = ", priority admission" if args.priority else ""
    asm = ", assemble" if args.broker_assemble else ""
    obs_note = f", obs :{obs_http.port}" if obs_http is not None else ""
    print(f"fabric shard listening on {args.host}:{server.port} (queue bound {args.maxlen}{shed}{prio}{asm}{obs_note})",
          flush=True)
    try:
        while True:
            time.sleep(60)
    except KeyboardInterrupt:
        server.stop()
        if obs_http is not None:
            obs_http.stop()


if __name__ == "__main__":
    main()
