"""ChaosBroker (twin of dotaclient_tpu/chaos/broker.py): any
transport.base.Broker wrapped in a seeded fault schedule.

It sits above the transport client, so its faults model what the wire
and a misbehaving peer can do to the pipeline: corrupted and truncated
frames (the staging quarantine must catch them), duplicate delivery (the
conservation ledger must account them), connection resets (the
producer's retry and degradation paths), admission sheds (the actor
throttle), added latency and scheduled stalls (staleness filtering and
the watchdog). Broker kills are the one fault a client-side wrapper
cannot execute: chaos/controller.py owns those against the real server.

Fault decisions are a pure function of (seed, spec, op index)
(chaos/schedule.py), so a failing soak replays bit for bit. The binaries
import this package only under --chaos.enabled.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from dotaclient_tpu_torch.chaos.schedule import FaultSchedule, corrupt_bytes, truncate_bytes
from dotaclient_tpu_torch.transport.base import Broker, BrokerShedError


class ChaosBroker(Broker):
    """Fault-injecting Broker decorator.

    Experience ops get the full fault set; weight ops get latency and
    stall only (a poll_weights reset would kill an actor outright rather
    than degrade it; weight-path outages are the kill events' job).

    `t0` anchors the timed events; pass one shared epoch when several
    wrapped brokers must see the same schedule (a soak's actor fleet).
    Thread-safe: the op counter is lock-guarded (actors publish from many
    threads in ActorPool drivers)."""

    def __init__(self, inner: Broker, schedule: FaultSchedule, t0: Optional[float] = None, clock=time.monotonic,
                 sleep=time.sleep):
        self.inner = inner
        self.schedule = schedule
        self._clock = clock
        self._sleep = sleep
        self.t0 = clock() if t0 is None else t0
        self._lock = threading.Lock()
        self._ops = 0
        # chaos_* meters (obs/registry.py family): what the layer did, the
        # soak's injected-fault inventory
        self.meters = {
            "chaos_ops": 0,
            "chaos_corrupted": 0,
            "chaos_truncated": 0,
            "chaos_duplicated": 0,
            "chaos_resets": 0,
            "chaos_sheds": 0,
            "chaos_stall_s": 0.0,
            "chaos_latency_s": 0.0,
        }

    # ------------------------------------------------------------ common

    def _next_op(self):
        with self._lock:
            i = self._ops
            self._ops += 1
            self.meters["chaos_ops"] += 1
        return self.schedule.decide(i)

    def _pay_delays(self, faults) -> None:
        stall = self.schedule.stall_remaining(self._clock() - self.t0)
        if stall > 0:
            with self._lock:
                self.meters["chaos_stall_s"] += stall
            self._sleep(stall)
        if faults.latency_s > 0:
            with self._lock:
                self.meters["chaos_latency_s"] += faults.latency_s
            self._sleep(faults.latency_s)

    def _count(self, key: str) -> None:
        with self._lock:
            self.meters[key] += 1

    # -------------------------------------------------------- experience

    def publish_experience(self, data: bytes) -> None:
        f = self._next_op()
        self._pay_delays(f)
        if f.reset:
            self._count("chaos_resets")
            raise ConnectionResetError("chaos: injected connection reset on publish")
        if f.shed:
            self._count("chaos_sheds")
            raise BrokerShedError("chaos: injected shed on publish")
        poison_meter = None
        if f.truncate:
            data = truncate_bytes(data, f.rng)
            poison_meter = "chaos_truncated"
        elif f.corrupt:
            data = corrupt_bytes(data, f.rng)
            poison_meter = "chaos_corrupted"
        self.inner.publish_experience(data)
        # Poison and duplicates count only once the inner publish took
        # them: the meters feed conservation cross-checks (quarantined vs
        # injected poison, the dup-extras term), so a frame a dead broker
        # never accepted must not be claimed as delivered.
        if poison_meter is not None:
            self._count(poison_meter)
        if f.dup:
            try:
                self.inner.publish_experience(data)
            except Exception:
                pass
            else:
                self._count("chaos_duplicated")

    def consume_experience(self, max_items: int, timeout: Optional[float] = None) -> List[bytes]:
        f = self._next_op()
        self._pay_delays(f)
        if f.reset:
            self._count("chaos_resets")
            raise ConnectionResetError("chaos: injected connection reset on consume")
        return self.inner.consume_experience(max_items, timeout=timeout)

    # ----------------------------------------------------------- weights

    def publish_weights(self, data: bytes) -> None:
        f = self._next_op()
        self._pay_delays(f)
        self.inner.publish_weights(data)

    def poll_weights(self) -> Optional[bytes]:
        f = self._next_op()
        self._pay_delays(f)
        return self.inner.poll_weights()

    # ------------------------------------------------------------- misc

    def experience_depth(self) -> int:
        return self.inner.experience_depth()

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.meters)
        inner_stats = getattr(self.inner, "stats", None)
        if callable(inner_stats):
            try:
                out.update(inner_stats())
            except Exception:
                pass  # a dead inner broker must not kill a meters read
        return out

    def close(self) -> None:
        self.inner.close()
