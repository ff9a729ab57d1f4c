"""Kill/restart execution + post-mortem ledger harvesting, for the
stateful processes a client-side fault wrapper cannot kill (twin of
dotaclient_tpu/chaos/controller.py).

`BrokerIncarnations` owns a sequence of in-process tcp BrokerServer
incarnations on ONE port and harvests each incarnation's conservation
ledger at kill time — exact, because the counters are read AFTER stop()
joined the server loop. `LearnerIncarnations` is its learner-side
sibling: sequential in-process Learner lives against one broker and one
checkpoint directory, with SIGTERM (drain: the same request_drain →
train-out → drain_save path the real signal handler invokes) and
SIGKILL (abort mid-flight, discard queued saves, nothing persisted
beyond what already hit disk) variants — in-process for the same reason
the broker is: a real kill -9 vaporizes the very counters the
conservation proof needs, while the abandoned object still holds them.
`ServeIncarnations` is the serving-tier third: sequential in-process
InferenceServer lives on one port, with per-life ledgers (requests
served, carries stranded at kill = episodes the kill abandoned,
evictions, weight swaps). `ScheduleRunner` executes a FaultSchedule's
kill events against any of the three on a side thread, routed by the
spec's kill-target selector
(`kill@T:D@broker|learner[:sig]|server`, chaos/schedule.py).

Recovery-time probes: a broker incarnation records the monotonic time
of its first post-boot enqueue (transport/tcp.py `first_enqueue_t`);
recovery after a broker kill = that minus the restart completion time —
how long the fleet's jittered reconnect/backoff took to actually land a
frame in the reborn broker. A learner incarnation's recovery = restart
completion to its first post-restore trained step (the version counter
advancing past the resumed high-water mark). A serve incarnation's
recovery = restart completion to its first post-restart SERVED step
(`first_request_t`, serve/server.py).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, List, Optional

from dotaclient_tpu_torch.chaos.schedule import FaultSchedule
from dotaclient_tpu_torch.transport.tcp import BrokerServer

_log = logging.getLogger(__name__)


class BrokerIncarnations:
    """N sequential BrokerServer lives on one port, ledgers kept."""

    def __init__(
        self,
        port: int = 0,
        maxlen: int = 4096,
        shed_high: int = 0,
        shed_low: int = 0,
        priority_shed: bool = False,
    ):
        self.maxlen, self.shed_high, self.shed_low = maxlen, shed_high, shed_low
        self.priority_shed = priority_shed
        self.server = BrokerServer(
            port=port, maxlen=maxlen, shed_high=shed_high, shed_low=shed_low,
            priority_shed=priority_shed,
        ).start()
        self.port = self.server.port
        self.ledgers: List[dict] = []  # one per DEAD incarnation
        self.kill_times: List[float] = []
        self.restart_times: List[float] = []
        self._lock = threading.Lock()

    def kill(self) -> dict:
        """Stop the live server and harvest its exact ledger. The dead
        incarnation is unbound immediately so a final_ledger() landing
        before any restart (runner stopped mid-down-window, restart
        raised) can never harvest — and double-count — the same life."""
        with self._lock:
            if self.server is None:
                raise RuntimeError("kill() with no live incarnation")
            self.server.stop()
            led = self.server.ledger()
            self.server = None
            led["killed_at"] = time.monotonic()
            self.ledgers.append(led)
            self.kill_times.append(led["killed_at"])
            return led

    def restart(self) -> None:
        """Bring a fresh incarnation up on the SAME port. Bounded retry:
        the dead server's socket can linger briefly."""
        with self._lock:
            deadline = time.monotonic() + 30.0
            while True:
                try:
                    self.server = BrokerServer(
                        port=self.port,
                        maxlen=self.maxlen,
                        shed_high=self.shed_high,
                        shed_low=self.shed_low,
                        priority_shed=self.priority_shed,
                    ).start()
                    break
                except (RuntimeError, OSError):
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(0.1)
            self.restart_times.append(time.monotonic())

    def wait_first_enqueue(self, timeout: float = 30.0, stop: Optional[threading.Event] = None):
        """Monotonic time of the reborn incarnation's first post-boot
        enqueue (None if none landed in time) — the broker recovery
        probe: how long the fleet's jittered reconnect/backoff took to
        actually land a frame in the reborn broker. Shared by the bare
        kill path and the rolling executor."""
        with self._lock:
            server = self.server
        if server is None:
            return None
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and (stop is None or not stop.is_set()):
            t = server.first_enqueue_t
            if t is not None:
                return t
            time.sleep(0.05)
        return None

    def replica_count(self) -> int:
        """One controller = one broker replica; a shard ROUTER (e.g. the
        fabric soak's round-robin over N BrokerIncarnations) reports N —
        the rolling@T:P@broker execution contract, same shape as the
        serve tier's."""
        return 1

    def final_ledger(self) -> dict:
        """Stop the last incarnation (if live) and sum every life's
        counters into one run ledger."""
        with self._lock:
            if self.server is not None:
                self.server.stop()
                led = self.server.ledger()
                led["killed_at"] = None  # run end, not a chaos kill
                self.ledgers.append(led)
                self.server = None
            total = {
                k: sum(l[k] for l in self.ledgers)
                for k in (
                    "enqueued", "popped", "dropped_oldest", "shed",
                    "shed_closes", "reply_lost", "evicted_low", "resident",
                )
            }
            total["incarnations"] = len(self.ledgers)
            return total

class ServeIncarnations:
    """Sequential in-process InferenceServer lives on ONE port — the
    serving-tier sibling of BrokerIncarnations, and the controller of
    the `kill@T:D@server` routing.

    `make_server(port)` builds AND starts a fresh InferenceServer bound
    to `port` (0 on the first boot picks a free one; every restart
    reuses that port, so client endpoint lists stay valid across
    lives). In-process for the same reason the broker/learner
    controllers are: a real kill -9 vaporizes the counters the
    conservation proof needs, while the abandoned object still holds
    them — and stop() joins the serve loop, so each harvested ledger is
    exact. A kill abandons every in-flight episode on that replica:
    their resident carries die with the life. `carries_resident_at_kill`
    is the server-side UPPER BOUND on those abandons (a carry also
    stays resident between a client's episodes until reset/disconnect),
    which the soak reconciles against the clients' exact
    episodes_abandoned counters.

    Recovery probe: `wait_first_request()` polls the reborn server's
    `first_request_t` (the first SERVED post-restart step — the
    first_enqueue_t analog); ScheduleRunner reports it as recovery_s.
    """

    def __init__(self, make_server: Callable[[int], object], port: int = 0):
        self.make_server = make_server
        self.server = make_server(port)
        self.port = self.server.port
        self.ledgers: List[dict] = []  # one per DEAD incarnation
        self.kill_times: List[float] = []
        self.restart_times: List[float] = []
        self._lock = threading.Lock()

    @staticmethod
    def _harvest(server, chaos_kill: bool) -> dict:
        """Stop `server` and read its exact counters. The resident-carry
        count is snapshotted BEFORE stop(): the shutdown path runs the
        handlers' eviction code, which would fold the carries this kill
        stranded into the ordinary eviction counter."""
        resident = sum(len(c.carries) for c in list(server._conns))
        server.stop()
        # The controller owns the life end-to-end: make_server built a
        # fresh weights-broker client for it, so the kill closes it
        # (stop() only joins the poll thread).
        broker = getattr(server, "broker", None)
        if broker is not None:
            try:
                broker.close()
            except Exception:
                pass
        return {
            "requests": int(server.requests_total),
            "bad_requests": int(server.bad_requests_total),
            "episode_resets": int(server.episode_resets_total),
            "unknown_client": int(server.unknown_client_total),
            "evictions": int(server.evictions_total),
            "weight_swaps": int(server.weight_swaps_total),
            "version": int(server.version),
            "carries_resident_at_kill": int(resident),
            # Session-continuity counters (serve/handoff.py; zero when
            # the life ran without a carry store): the handoff soak
            # reconciles resumes against kills the same way the abandon
            # ledger reconciles them in the serve chaos soak.
            "handoff_writes": int(getattr(server, "handoff_writes_total", 0)),
            "handoff_write_errors": int(getattr(server, "handoff_write_errors_total", 0)),
            "resumes": int(getattr(server, "resumes_total", 0)),
            "resume_misses": int(getattr(server, "resume_misses_total", 0)),
            "replayed_steps": int(getattr(server, "replayed_steps_total", 0)),
            "killed_at": time.monotonic() if chaos_kill else None,
            # Per-model-slot ledgers (multi-model tier; {} on a
            # single-model server): FLAT int keys "model<m>_<what>" —
            # final_ledger's sum() folds them like any other counter.
            **ServeIncarnations._model_ledgers(server),
        }

    @staticmethod
    def _model_ledgers(server) -> dict:
        models = int(getattr(server, "models", 1))
        if models <= 1:
            return {}
        out = {}
        for m in range(models):
            out[f"model{m}_requests"] = int(server.model_requests[m])
            out[f"model{m}_evictions"] = int(server.model_evictions[m])
            out[f"model{m}_swaps"] = int(server.model_swaps[m])
        return out

    def kill(self) -> dict:
        """Stop the live incarnation and harvest its exact ledger."""
        with self._lock:
            if self.server is None:
                raise RuntimeError("kill() with no live incarnation")
            led = self._harvest(self.server, chaos_kill=True)
            self.server = None
            self.ledgers.append(led)
            self.kill_times.append(led["killed_at"])
            return led

    def restart(self) -> None:
        """Bring a fresh incarnation up on the SAME port. Bounded retry:
        the dead server's socket can linger briefly, and start() raises
        through the boot-error path when the bind fails."""
        with self._lock:
            deadline = time.monotonic() + 60.0
            while True:
                try:
                    self.server = self.make_server(self.port)
                    break
                except (RuntimeError, OSError):
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(0.2)
            self.restart_times.append(time.monotonic())

    def wait_first_request(self, timeout: float = 30.0, stop: Optional[threading.Event] = None):
        """Monotonic time of the reborn incarnation's first served step
        (None if none arrived in time) — the serve recovery probe."""
        server = self.server
        if server is None:
            return None
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and (stop is None or not stop.is_set()):
            t = server.first_request_t
            if t is not None:
                return t
            time.sleep(0.02)
        return None

    def final_ledger(self) -> dict:
        """Stop the last incarnation (if live) and sum every life."""
        with self._lock:
            if self.server is not None:
                self.ledgers.append(self._harvest(self.server, chaos_kill=False))
                self.server = None
            keys = [
                "requests", "bad_requests", "episode_resets", "unknown_client",
                "evictions", "weight_swaps", "carries_resident_at_kill",
                "handoff_writes", "handoff_write_errors", "resumes",
                "resume_misses", "replayed_steps",
            ]
            # per-model keys appear only on multi-model lives; sum each
            # across the lives that carried it (a rolling schedule can
            # mix single- and multi-model incarnations mid-migration).
            keys += sorted(
                {k for l in self.ledgers for k in l if k.startswith("model")}
            )
            total = {k: sum(l.get(k, 0) for l in self.ledgers) for k in keys}
            total["incarnations"] = len(self.ledgers)
            return total

    def replica_count(self) -> int:
        """One controller = one replica; multi-replica topologies route
        through a replica router (e.g. the soaks' round-robin router)
        that fans kill()/restart() across N of these and reports N here
        — the rolling@T:P@server execution contract."""
        return 1


class LearnerIncarnations:
    """Sequential in-process Learner lives sharing one checkpoint dir.

    `make_learner` builds (and thereby restores) a fresh Learner; the
    controller runs each life's `run()` on a daemon thread and executes
    the two death variants against it:

    - kill(sig="term"): the SIGTERM drain — request_drain(), join the
      loop (which trains out already-staged batches), drain_save() with
      wait=True. A clean exit is part of the harvested ledger.
    - kill(sig="kill"): SIGKILL emulation — abort() the loop mid-flight
      and DISCARD queued async-checkpoint/aux/mirror work; the next
      incarnation restores from whatever the periodic cadence already
      made durable (plus the publisher's version high-water file).
      Known emulation gap: a save already INSIDE its commit at
      kill time completes (an in-process emulation cannot abort a
      mid-write commit, and half-killing it would corrupt the very
      directory under test) — so the restored step can be at most one
      save newer than a true kill -9 would allow. The resume soak's
      SIGKILL claims (bounded divergence, conservation, monotonic hwm)
      are restore-point-agnostic, and its part-A kill offsets are
      chosen off the checkpoint cadence so the worker is provably idle.

    Every death harvests the dead life's staging/replay counters EXACTLY
    (the in-process advantage — see module docstring), so the resume
    soak's conservation ledger can account each popped frame even for a
    life that "lost" its in-flight work.
    """

    def __init__(self, make_learner: Callable[[], object], run_kwargs: Optional[dict] = None):
        self.make_learner = make_learner
        self.run_kwargs = dict(run_kwargs or {})
        self.learner = None
        self._thread: Optional[threading.Thread] = None
        self._run_error: Optional[str] = None
        self.lives: List[dict] = []  # one ledger per DEAD incarnation
        self.boots: List[dict] = []  # one record per boot (construct/restore)
        self.kill_times: List[float] = []
        self.restart_times: List[float] = []
        self._lock = threading.Lock()

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "LearnerIncarnations":
        with self._lock:
            if self.learner is not None:
                raise RuntimeError("start() with a live incarnation")
            t0 = time.monotonic()
            learner = self.make_learner()
            boot = {
                "construct_s": round(time.monotonic() - t0, 3),
                "resume_version": int(learner.version),
                "resume": learner.resume_info,
            }
            self.boots.append(boot)
            self.learner = learner
            self._run_error = None

            def _loop():
                try:
                    learner.run(**self.run_kwargs)
                except Exception as e:  # harvested into the life ledger
                    self._run_error = f"{type(e).__name__}: {e}"
                    _log.exception("learner incarnation loop died")

            self._thread = threading.Thread(target=_loop, daemon=True, name="learner-life")
            self._thread.start()
            self.restart_times.append(time.monotonic())
        return self

    def kill(self, sig: str = "kill") -> dict:
        """Execute one death; returns the harvested life ledger."""
        if sig not in ("kill", "term"):
            raise ValueError(f"unknown learner kill signal {sig!r}")
        with self._lock:
            learner = self.learner
            if learner is None:
                raise RuntimeError("kill() with no live incarnation")
            t0 = time.monotonic()
            if sig == "term":
                learner.request_drain()
            else:
                learner.abort()
            self._thread.join(timeout=120)
            joined = not self._thread.is_alive()
            if sig == "term" and joined:
                learner.drain_save()
            else:
                learner.discard_unsaved()
            s = learner.staging.stats()
            # Single atomic read: the loop thread rebinds _run_error once
            # on death; a local keeps exit_clean and loop_error coherent.
            run_error = self._run_error
            led = {
                "sig": sig,
                "exit_clean": bool(joined and run_error is None and sig == "term"),
                "loop_error": run_error,
                "death_wall_s": round(time.monotonic() - t0, 3),
                "version": int(learner.version),
                "consumed": int(s["consumed"]),
                "dropped_stale": int(s["dropped_stale"]),
                "dropped_bad": int(s["dropped_bad"]),
                "quarantined": int(s["quarantined"]),
                "rows_packed": int(s["rows_packed"]),
                "rows_replayed": int(s.get("rows_replayed", 0)),
                "replay_admitted": int(s.get("replay_admitted", 0)),
                "pending_at_death": int(s["pending_rollouts"]),
                "ready_batches_at_death": int(s["ready_batches"]),
                "reservoir_at_death": int(s.get("replay_occupancy", 0)),
                "resume_version": self.boots[-1]["resume_version"],
                "resume_pending": int(self.boots[-1]["resume"].get("resume_pending_frames", 0)),
                "resume_reservoir": int(
                    self.boots[-1]["resume"].get("resume_reservoir_entries", 0)
                ),
                "killed_at": time.monotonic(),
            }
            obs = getattr(learner, "obs", None)
            if obs is not None and obs.watchdog is not None:
                led["watchdog"] = obs.watchdog.verdict()
            learner.close()
            self.learner = None
            self._thread = None
            self.lives.append(led)
            self.kill_times.append(led["killed_at"])
            return led

    def restart(self) -> None:
        """Boot the next incarnation (restores from the shared dir)."""
        self.start()

    def wait_first_step(self, timeout: float = 30.0, stop: Optional[threading.Event] = None):
        """Monotonic time when the reborn learner's version counter first
        advanced past its resumed value (None if it never did) — the
        learner-side recovery probe."""
        learner = self.learner
        if learner is None:
            return None
        base = self.boots[-1]["resume_version"]
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and (stop is None or not stop.is_set()):
            if learner.version > base:
                return time.monotonic()
            time.sleep(0.02)
        return None

    def final_ledger(self) -> dict:
        """Kill any live incarnation cleanly (drain) and sum the lives."""
        with self._lock:
            live = self.learner is not None
        if live:
            self.kill(sig="term")
            self.lives[-1]["killed_at"] = None  # run end, not a chaos kill
        keys = (
            "consumed", "dropped_stale", "dropped_bad", "quarantined",
            "rows_packed", "rows_replayed", "replay_admitted",
            "pending_at_death", "ready_batches_at_death", "reservoir_at_death",
            "resume_pending", "resume_reservoir",
        )
        total = {k: sum(l[k] for l in self.lives) for k in keys}
        total["incarnations"] = len(self.lives)
        return total


class ScheduleRunner:
    """Execute a schedule's kill events on a daemon thread, relative to
    a shared epoch `t0`, routed by each event's kill-target selector:
    broker kills against a BrokerIncarnations, learner kills (SIGTERM or
    SIGKILL variant) against a LearnerIncarnations."""

    def __init__(
        self,
        schedule: FaultSchedule,
        broker: Optional[BrokerIncarnations],
        t0: float,
        learner: Optional[LearnerIncarnations] = None,
        server: Optional[object] = None,
    ):
        self.schedule = schedule
        self.broker = broker
        self.learner_inc = learner
        # kill@T:D@server routing: ServeIncarnations is the real
        # controller; any object with kill()/restart() still routes
        # (duck-typed — the recovery probe engages only when the
        # controller exposes wait_first_request).
        self.server_inc = server
        self.t0 = t0
        for ev in schedule.kills():
            if ev.target == "learner" and learner is None:
                raise ValueError("schedule kills the learner but no LearnerIncarnations given")
            if ev.target == "broker" and broker is None:
                raise ValueError("schedule kills the broker but no BrokerIncarnations given")
            if ev.target == "server" and server is None:
                raise ValueError(
                    "schedule kills the inference server but no server "
                    "controller given (supply a ServeIncarnations, or any "
                    "object with kill()/restart())"
                )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # (kill_index, restart_monotonic, first_enqueue_monotonic | None)
        self.recovery: List[dict] = []

    def start(self) -> "ScheduleRunner":
        self._thread = threading.Thread(target=self._run, daemon=True, name="chaos-kills")
        self._thread.start()
        return self

    def _sleep_until(self, at_s: float) -> bool:
        """Sleep to schedule-offset at_s; False if stopped first."""
        while not self._stop.is_set():
            remaining = (self.t0 + at_s) - time.monotonic()
            if remaining <= 0:
                return True
            self._stop.wait(min(remaining, 0.2))
        return False

    def _sleep_wall(self, duration_s: float) -> bool:
        """Sleep a wall-relative duration; False if stopped first. The
        rolling executor paces on wall time, not schedule offsets —
        restart/probe latencies vary and each replica's down window must
        be the configured P regardless of how long the previous
        replica's recovery took."""
        deadline = time.monotonic() + duration_s
        while not self._stop.is_set():
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return True
            self._stop.wait(min(remaining, 0.2))
        return False

    def _run_rolling(self, k: int, ev) -> bool:
        """Execute one rolling@T:P@server|broker event: kill replica i,
        hold it down P seconds, restart it, wait for its recovery probe,
        then move to replica i+1 — sequential, so at most ONE replica is
        ever down (the property the zero-abandon handoff soak and the
        fabric shard-kill soak both ride on). The controller's
        kill()/restart() rotation supplies the fan-out; a bare
        ServeIncarnations / BrokerIncarnations rolls its single
        replica. Probe: first served step for the serve tier
        (wait_first_request), first re-enqueued frame for a broker
        shard (wait_first_enqueue)."""
        inc = self.server_inc if ev.target == "server" else self.broker
        count_fn = getattr(inc, "replica_count", None)
        n = int(count_fn()) if count_fn is not None else 1
        probe = getattr(inc, "wait_first_request", None) or getattr(
            inc, "wait_first_enqueue", None
        )
        for r in range(n):
            inc.kill()
            if not self._sleep_wall(ev.duration_s):
                return False
            inc.restart()
            restarted = time.monotonic()
            # Bounded probe: with session continuity (serve) or sibling
            # shards (fabric), clients legitimately stay on the
            # survivors — a short probe keeps the roll moving and None
            # is not an error here.
            first = None
            if probe is not None:
                first = probe(timeout=1.5, stop=self._stop)
            self.recovery.append(
                {
                    "kill_index": k,
                    "target": ev.target,
                    "kind": "rolling",
                    "replica": r,
                    "at_s": ev.at_s,
                    "down_s": round(ev.duration_s, 3),
                    "recovery_s": None if first is None else round(first - restarted, 3),
                }
            )
            if self._stop.is_set():
                return False
        return True

    def _run(self) -> None:
        kills = self.schedule.kills()
        for k, ev in enumerate(kills):
            if not self._sleep_until(ev.at_s):
                return
            if ev.kind == "rolling":
                if not self._run_rolling(k, ev):
                    return
                continue
            if ev.target == "learner":
                self.learner_inc.kill(sig=ev.signal)
                if not self._sleep_until(ev.at_s + ev.duration_s):
                    return
                self.learner_inc.restart()
                restarted = time.monotonic()
                first = self.learner_inc.wait_first_step(timeout=30.0, stop=self._stop)
                self.recovery.append(
                    {
                        "kill_index": k,
                        "target": "learner",
                        "sig": ev.signal,
                        "at_s": ev.at_s,
                        "down_s": round(ev.duration_s, 3),
                        "recovery_s": None if first is None else round(first - restarted, 3),
                    }
                )
                continue
            if ev.target == "server":
                self.server_inc.kill()
                if not self._sleep_until(ev.at_s + ev.duration_s):
                    return
                self.server_inc.restart()
                restarted = time.monotonic()
                # Recovery probe = first post-restart SERVED step
                # (ServeIncarnations.wait_first_request); a bare
                # kill()/restart() object (tests) reports None. The wait
                # is bounded by the NEXT scheduled event: in a
                # multi-replica topology sticky clients stay on the
                # survivor, so a reborn replica can legitimately idle —
                # a full 30s probe would silently push every later kill
                # off its schedule.
                probe = getattr(self.server_inc, "wait_first_request", None)
                first = None
                if probe is not None:
                    budget = 30.0
                    if k + 1 < len(kills):
                        budget = max(
                            0.5,
                            min(budget, (self.t0 + kills[k + 1].at_s) - time.monotonic()),
                        )
                    first = probe(timeout=budget, stop=self._stop)
                self.recovery.append(
                    {
                        "kill_index": k,
                        "target": "server",
                        "at_s": ev.at_s,
                        "down_s": round(ev.duration_s, 3),
                        "recovery_s": None if first is None else round(first - restarted, 3),
                    }
                )
                continue
            self.broker.kill()
            if not self._sleep_until(ev.at_s + ev.duration_s):
                return
            self.broker.restart()
            restarted = time.monotonic()
            # recovery probe: poll the reborn incarnation's first-enqueue
            # stamp for up to 30s (clients are backing off with jitter)
            probe = getattr(self.broker, "wait_first_enqueue", None)
            first = probe(timeout=30.0, stop=self._stop) if probe is not None else None
            self.recovery.append(
                {
                    "kill_index": k,
                    "target": "broker",
                    "at_s": ev.at_s,
                    "down_s": round(ev.duration_s, 3),
                    "recovery_s": None if first is None else round(first - restarted, 3),
                }
            )

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
