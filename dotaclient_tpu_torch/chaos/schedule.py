"""Seeded, deterministic fault schedules (own copy of
dotaclient_tpu/chaos/schedule.py) — the grammar behind
`--chaos.spec` / `--chaos.seed`.

A spec is a comma-separated list of clauses:

Rate faults (fire probabilistically, decided PER OPERATION INDEX from
the seed — same seed + spec replays the same faults at the same
operation indices, which is what makes a chaos failure a bug report
instead of an anecdote):

    corrupt:P       flip bytes of a published frame with prob P
    truncate:P      cut a published frame's tail with prob P
    dup:P           deliver a published frame twice with prob P
    reset:P         fail the op with ConnectionResetError with prob P
    shed:P          refuse a publish with BrokerShedError with prob P
    latency:M~J     add M±J seconds of sleep to every op (J optional)

Timed one-shots (wall-clock offsets from the schedule epoch `t0`):

    stall@T:D       every broker op blocks for the window [T, T+D)
    rolling@T:P@server
    rolling@T:P@broker
                    staggered sequential restarts across a replicated
                    tier, starting at T: kill replica 0, keep it down
                    P seconds, restart it, wait for its recovery probe,
                    then replica 1, and so on — at most ONE replica is
                    ever down, the rolling-deploy shape. `server` rolls
                    the serve tier; `broker` rolls the broker
                    fabric's shard fleet (transport/fabric.py — the
                    shard-kill soak's at-most-one-shard-down arm).
                    Executed by a ScheduleRunner whose matching
                    controller fans kills across replicas (a
                    replica_count()-bearing router, or a bare
                    ServeIncarnations/BrokerIncarnations = 1 replica).
                    The selector rides the ARG side like the kill
                    targets, so existing specs parse byte-identically
                    and no rate draw ever moves (the golden
                    decision-sequence pin covers it).
    scale@T:N@TIER  set TIER's replica count to N at T. TIER is
                    `broker` (fabric shards), `server` (serve
                    replicas), or `actor` (the actor fleet). Executed
                    by the control tier (control/) or a
                    soak harness against a driver that owns the tier's
                    replica routers — a client-side wrapper cannot add
                    or remove processes, the kill@ argument again. The
                    replica count rides the duration slot and the tier
                    selector rides the ARG side, so existing specs
                    parse byte-identically and scale clauses consume
                    ZERO per-op rate draws (the golden
                    decision-sequence pin covers it).
    kill@T:D        kill the broker at T, restart it at T+D — executed
                    by a ScheduleRunner against a controller that owns
                    the broker process (chaos/controller.py), because a
                    client-side wrapper cannot kill a server
    kill@T:D@TGT    kill-target selector: TGT is `broker` (the default,
                    identical to the bare form), `learner[:SIG]`
                    where SIG is `kill` (SIGKILL semantics: nothing
                    saved, recovery from the last periodic checkpoint)
                    or `term` (SIGTERM drain: train out staged batches,
                    full-state save, clean exit) — executed against a
                    LearnerIncarnations controller — or `server` (the
                    inference service, serve/), executed
                    against a ServeIncarnations controller (sequential
                    in-process InferenceServer lives on one port,
                    per-life ledgers, first-served-step recovery probe;
                    the reference's soak_serve_chaos is its
                    closed-loop proof). Timed events never consume per-op rate
                    draws, so the selector leaves the canonical draw
                    order of every existing spec untouched (pinned by
                    the golden decision-sequence test — including the
                    server target).

Determinism contract: the decision for operation index i draws from
`random.Random(seed * 1_000_003 + i)` in a FIXED canonical order, for
every fault type whether configured or not — so decisions at index i
are identical across runs AND stable when unrelated clauses are added
to the spec.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import List, Optional

# Canonical per-op draw order (schedule determinism contract above).
_RATE_FAULTS = ("corrupt", "truncate", "dup", "reset", "shed")


@dataclass
class TimedEvent:
    kind: str  # "stall" | "kill" | "rolling" | "scale"
    at_s: float  # offset from the schedule epoch
    duration_s: float  # down window (per replica, for rolling); replica count for scale
    target: str = "broker"  # "broker" | "learner" | "server" | "actor" (scale only)
    signal: str = "kill"  # "kill" (SIGKILL) | "term" (SIGTERM drain); learner only


@dataclass
class OpFaults:
    """The decided faults for ONE operation index."""

    corrupt: bool = False
    truncate: bool = False
    dup: bool = False
    reset: bool = False
    shed: bool = False
    latency_s: float = 0.0
    # seeded sub-rng for data-dependent choices (which bytes to flip,
    # where to cut) so those are reproducible too
    rng: Optional[random.Random] = None


@dataclass
class FaultSchedule:
    seed: int = 0
    rates: dict = field(default_factory=dict)  # fault name -> probability
    latency_mean_s: float = 0.0
    latency_jitter_s: float = 0.0
    events: List[TimedEvent] = field(default_factory=list)

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultSchedule":
        sched = cls(seed=seed)
        for clause in filter(None, (c.strip() for c in spec.split(","))):
            name, _, arg = clause.partition(":")
            if "@" in name:
                kind, _, at = name.partition("@")
                if kind not in ("stall", "kill", "rolling", "scale"):
                    raise ValueError(f"unknown timed fault {kind!r} in {clause!r}")
                if kind == "scale":
                    # scale@T:N@TIER — a topology set-point, not a
                    # fault: the tier selector is MANDATORY (there is
                    # no default tier to scale) and N must be a whole
                    # replica count >= 1 (scale-to-zero is a kill, and
                    # kills already exist).
                    n_s, _, tier = arg.partition("@")
                    if not tier or ":" in tier:
                        raise ValueError(
                            f"scale needs scale@T:N@broker|server|actor, got {clause!r}"
                        )
                    if tier not in ("broker", "server", "actor"):
                        raise ValueError(f"unknown scale tier {tier!r} in {clause!r}")
                    n = float(n_s)
                    if n != int(n) or int(n) < 1:
                        raise ValueError(
                            f"scale replica count must be an integer >= 1 in {clause!r}"
                        )
                    sched.events.append(TimedEvent("scale", float(at), n, target=tier))
                    continue
                # kill@T:D@TGT[:SIG] / rolling@T:P@server — the target
                # selector rides the ARG side of the clause, so existing
                # bare specs parse byte-identically (target defaults to
                # broker) and the canonical rate-draw order never moves.
                dur, _, tail = arg.partition("@")
                target, sig = ("server" if kind == "rolling" else "broker"), "kill"
                if tail:
                    if kind == "stall":
                        raise ValueError(
                            f"target selector only applies to kill/rolling, not "
                            f"{kind!r} in {clause!r}"
                        )
                    target, _, sig_s = tail.partition(":")
                    if kind == "rolling":
                        # rolling targets the two N-replica tiers: the
                        # serve tier and the broker fabric's
                        # shard fleet (transport/fabric.py — a shard
                        # router with replica_count() fans the kills).
                        # The learner stays a singleton where rolling
                        # degenerates to kill.
                        if target not in ("server", "broker") or sig_s:
                            raise ValueError(
                                f"rolling restarts target the serve tier or the "
                                f"broker fabric (rolling@T:P@server|broker) in "
                                f"{clause!r}"
                            )
                    elif target not in ("broker", "learner", "server"):
                        raise ValueError(f"unknown kill target {target!r} in {clause!r}")
                    if sig_s:
                        if target != "learner":
                            raise ValueError(
                                f"signal selector needs target learner in {clause!r}"
                            )
                        if sig_s not in ("kill", "term"):
                            raise ValueError(f"unknown kill signal {sig_s!r} in {clause!r}")
                        sig = sig_s
                sched.events.append(
                    TimedEvent(kind, float(at), float(dur), target=target, signal=sig)
                )
            elif name == "latency":
                mean, _, jit = arg.partition("~")
                sched.latency_mean_s = float(mean)
                sched.latency_jitter_s = float(jit) if jit else 0.0
            elif name in _RATE_FAULTS:
                p = float(arg)
                if not 0.0 <= p <= 1.0:
                    raise ValueError(f"fault probability out of range in {clause!r}")
                sched.rates[name] = p
            else:
                raise ValueError(f"unknown fault {name!r} in {clause!r}")
        sched.events.sort(key=lambda e: e.at_s)
        return sched

    # ----------------------------------------------------- per-op decide

    def decide(self, op_index: int) -> OpFaults:
        """The faults for operation `op_index` — pure function of
        (seed, spec, op_index)."""
        rng = random.Random(self.seed * 1_000_003 + op_index)
        out = OpFaults()
        # fixed canonical draw order, configured or not (determinism
        # contract: adding a clause must not shift other draws)
        for name in _RATE_FAULTS:
            draw = rng.random()
            if draw < self.rates.get(name, 0.0):
                setattr(out, name, True)
        jitter_draw = rng.random()
        if self.latency_mean_s > 0.0:
            out.latency_s = max(
                0.0,
                self.latency_mean_s + (2.0 * jitter_draw - 1.0) * self.latency_jitter_s,
            )
        out.rng = rng
        return out

    # ------------------------------------------------------ timed events

    def stalls(self) -> List[TimedEvent]:
        return [e for e in self.events if e.kind == "stall"]

    def kills(self) -> List[TimedEvent]:
        """Kill-class timed events a ScheduleRunner executes — bare
        kills AND rolling restarts (a rolling event is a kill sequence
        fanned across replicas)."""
        return [e for e in self.events if e.kind in ("kill", "rolling")]

    def scales(self) -> List[TimedEvent]:
        """Scale set-points (scale@T:N@tier) in schedule order — the
        control tier's deterministic topology script. `duration_s`
        carries the target replica count; kept OUT of kills() so every
        existing ScheduleRunner routes exactly what it did before."""
        return [e for e in self.events if e.kind == "scale"]

    def stall_remaining(self, elapsed_s: float) -> float:
        """Seconds an op starting at `elapsed_s` (since epoch) must block
        to honor any active stall window."""
        for e in self.stalls():
            if e.at_s <= elapsed_s < e.at_s + e.duration_s:
                return e.at_s + e.duration_s - elapsed_s
        return 0.0


def corrupt_bytes(data: bytes, rng: random.Random, n_flips: int = 4) -> bytes:
    """Flip up to `n_flips` bytes at seeded positions, never changing the
    length (truncation is its own fault). The FIRST flip always lands in
    the magic (bytes 0..3): payload-only corruption is undetectable
    without wire checksums (a known limitation — the frame parses and
    the garbage trains), and this fault exists to exercise the DETECTED
    path: parse rejection → staging quarantine, with the conservation
    ledger able to cross-check quarantined ≈ corrupted + truncated."""
    if not data:
        return data
    buf = bytearray(data)
    buf[rng.randrange(min(4, len(buf)))] ^= 0xFF
    for _ in range(min(n_flips - 1, len(buf))):
        i = rng.randrange(len(buf))
        buf[i] ^= 0xFF
    return bytes(buf)


def truncate_bytes(data: bytes, rng: random.Random) -> bytes:
    """Cut the frame at a seeded point in its back half (an empty or
    header-only stub is the corrupt fault's job)."""
    if len(data) < 2:
        return data
    cut = rng.randrange(len(data) // 2, len(data))
    return data[:cut]
