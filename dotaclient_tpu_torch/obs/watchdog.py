"""Acting watchdog (own copy of dotaclient_tpu/obs/watchdog.py): turns the
learner's own telemetry into liveness.

The failure modes this catches all share one trait: the process stays
up, so nothing restarts it, and the cluster silently stops learning —
a stalled train loop (wedged device, deadlocked collective), input
starvation (actors dead, broker partitioned), a NaN'd loss (never
self-heals; every later step is wasted), and a quiet steps/s collapse.

The watchdog is a side thread reading MetricsLogger.latest() plus the
live version counter — data the learner already produces; it adds ZERO
work to the loop. On failure it escalates by consecutive strikes:

  strike 1                log a warning (grep-able, alert-able)
  strike cfg.dump_after   dump the flight recorder (evidence before the
                          pod dies — the dump is the artifact a human
                          reads after the restart)
  strike cfg.trip_after   trip: /healthz flips to 503, and the k8s
                          liveness probe restarts the pod

Strikes are counted at the cadence of the EVIDENCE, not the check:

- LIVE detectors (stall, NaN loss) read state that is current at every
  check, so each failing check is a strike.
- WINDOW detectors (starvation, steps/s regression) read
  MetricsLogger.latest(), which only refreshes once per metrics window
  (every metrics_every steps). Each window is judged exactly ONCE —
  a strike per consecutive FAILING WINDOW. Re-judging the same sample
  every interval_s would either restart a learner that already
  recovered mid-window (the stale >threshold value keeps failing until
  the next log) or, if stale samples were skipped instead, never
  accumulate the consecutive strikes sustained starvation deserves.

A fully healthy check clears the strikes AND the trip — if the
condition self-heals before the probe's failureThreshold, the pod
lives. All thresholds under --obs.watchdog.*, default off.

Testability: check() is a plain method driven by an injectable
monotonic clock; the background thread is just `while not
stop.wait(interval): check()`. Tests drive check() directly with a fake
clock — no sleeps in tier-1.
"""

from __future__ import annotations

import logging
import math
import statistics
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from dotaclient_tpu_torch.config import WatchdogConfig

_log = logging.getLogger(__name__)


class Watchdog:
    def __init__(
        self,
        cfg: WatchdogConfig,
        latest_fn: Callable[[], Dict[str, float]],
        version_fn: Callable[[], int],
        recorder=None,
        time_fn: Callable[[], float] = time.monotonic,
        latest_seq_fn: Optional[Callable[[], int]] = None,
    ):
        self.cfg = cfg
        self._latest = latest_fn
        self._version = version_fn
        # Identity of the metrics window latest_fn reflects (the learner
        # passes MetricsLogger.latest_step). latest() only refreshes
        # every metrics_every steps, so per-check detectors must know
        # whether they are re-reading a window they already judged.
        self._latest_seq = latest_seq_fn
        self._recorder = recorder
        self._now = time_fn
        self._lock = threading.Lock()
        t = self._now()
        self._start_t = t
        # The version baseline is captured on the FIRST check(), not
        # here: any version write that lands before the watchdog's first
        # look (checkpoint restore at boot) must read as "where the
        # counter starts", never as a train-step heartbeat — a restore
        # counted as the first advance would end the boot grace before
        # the first step and crashloop a restored learner whose cold
        # start exceeds stall_s.
        self._last_version: Optional[int] = None
        self._last_advance_t = t
        self._booted = False  # flips on the first advance OBSERVED between checks
        # Rate samples for the regression baseline; appended once per
        # JUDGED metrics window so the per-check cadence never floods
        # the window with duplicates of the same logged sample.
        self._rates: deque = deque(maxlen=max(int(cfg.window), 1))
        # Window-detector state: which metrics window was last judged,
        # and per-detector consecutive-failing-WINDOW counts + the
        # verdict text that holds until the next window overrides it.
        self._judged_seq: Optional[int] = None
        self._win_counts: Dict[str, int] = {"starvation": 0, "regression": 0}
        self._win_reasons: Dict[str, str] = {}
        self._last_rate_version: Optional[int] = None  # legacy-path dedup
        self._live_strikes = 0  # consecutive failing checks (stall/NaN)
        self._dumped = False  # one flight-recorder dump per unhealthy episode
        self._warned_sig = None  # last (strikes, reasons) warned about
        self.strikes = 0  # reported: max(live strikes, window strikes)
        self.tripped = False
        self.trips_total = 0
        self.checks_done = 0
        self.reasons: List[str] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ checks

    def _live_failures(self, now: float, latest: Dict[str, float]) -> List[str]:
        """Detectors whose evidence is current at every check."""
        cfg = self.cfg
        fails: List[str] = []

        # STALL — the version counter is the loop's heartbeat. Before the
        # first advance the threshold is the (larger) boot grace: compile
        # + restore + first-batch wait must not read as a stall, or the
        # liveness restart replays the same slow boot forever.
        v = int(self._version())
        stall_s = cfg.stall_s if self._booted else max(cfg.stall_s, cfg.boot_grace_s)
        if self._last_version is None:
            # First look: baseline only. The grace clock keeps running
            # from construction; only an advance observed BETWEEN checks
            # (a real train step) ends boot.
            self._last_version = v
        elif v != self._last_version:
            self._last_version = v
            self._last_advance_t = now
            self._booted = True
        elif now - self._last_advance_t > stall_s:
            fails.append(
                f"stall: version {v} unchanged for "
                f"{now - self._last_advance_t:.0f}s (> {stall_s:.0f}s"
                f"{'' if self._booted else ', boot grace'})"
            )

        # NaN/inf loss — never self-heals; restart is the cure.
        if cfg.nan_check:
            loss = latest.get("loss")
            if loss is not None and not math.isfinite(float(loss)):
                fails.append(f"nan_loss: latest loss is {loss!r}")
        return fails

    def _judge_window(
        self, latest: Dict[str, float], seq: Optional[int], v: int
    ) -> None:
        """Window detectors: judge each metrics window exactly once.

        latest() refreshes every metrics_every steps while checks run
        every interval_s, so without the once-per-window gate a single
        sample would be re-judged dozens of times: a transient bad
        window keeps striking a learner that already recovered, and the
        regression baseline floods with duplicates of the newest sample.
        The verdict (and its consecutive-WINDOW strike count) holds
        until the next window overrides it. check() only calls this
        with an internally consistent (latest, seq) pair; seq None
        means no identity is wired (latest_seq_fn=None), which degrades
        to judging every check with the baseline deduped on version
        advance — the pre-identity behavior."""
        cfg = self.cfg
        if seq is not None:
            if seq == self._judged_seq:
                return  # same window: verdicts and counts hold
            self._judged_seq = seq
        # What one count unit is: a metrics window when the identity is
        # wired, a (possibly re-read) check otherwise.
        unit = "windows" if seq is not None else "checks"

        # STARVATION — fetch-phase fraction from the StepPhaseTimer
        # scalars (inert unless obs.step_phases produced them).
        if cfg.starvation_frac > 0:
            frac = latest.get("compute_phase_fetch_frac")
            if frac is not None and float(frac) > cfg.starvation_frac:
                n = self._win_counts["starvation"] + 1
                self._win_counts["starvation"] = n
                self._win_reasons["starvation"] = (
                    f"starvation: fetch phase {float(frac):.0%} of step wall "
                    f"(> {cfg.starvation_frac:.0%}; {n} consecutive {unit})"
                )
            else:
                self._win_counts["starvation"] = 0

        # REGRESSION — this window's steps/s vs the median of the
        # trailing windows (one baseline sample per window, appended
        # AFTER judging so a window is never compared to itself).
        if cfg.regression_frac > 0:
            rate = latest.get("env_steps_per_sec")
            if rate is None:
                self._win_counts["regression"] = 0
            else:
                rate = float(rate)
                failed = False
                if len(self._rates) == self._rates.maxlen:
                    baseline = statistics.median(self._rates)
                    if baseline > 0 and rate < cfg.regression_frac * baseline:
                        failed = True
                        n = self._win_counts["regression"] + 1
                        self._win_counts["regression"] = n
                        self._win_reasons["regression"] = (
                            f"regression: {rate:.1f} env-steps/s < "
                            f"{cfg.regression_frac:.2f} x trailing median "
                            f"{baseline:.1f} ({n} consecutive {unit})"
                        )
                if not failed:
                    self._win_counts["regression"] = 0
                # Baseline append: once per window when identity is
                # wired (we only reach here on a fresh seq); the legacy
                # path dedups on version advance so a re-served sample
                # still can't flood the median with duplicates.
                if seq is not None or v != self._last_rate_version:
                    self._rates.append(rate)
                    self._last_rate_version = v

    def check(self) -> Dict:
        """Run every detector once; escalate or clear. Returns verdict().
        Never raises — a watchdog that dies IS the failure mode it
        exists to catch, so detector errors log and count as healthy."""
        try:
            now = self._now()
            # Bracketed read: identity, sample, identity again. The
            # learner's log() can land between any two of these reads;
            # judging would then pair one window's step with another
            # window's scalars (mis-attributed verdict, and the real
            # window permanently skipped as already-judged). Steps are
            # monotonic, so an unchanged before/after identity proves
            # the middle latest() read came from that exact window —
            # anything else (mismatch, or a reader raising) leaves the
            # window UNJUDGED with its identity unconsumed, and the
            # next check 5s later judges it with stable data.
            pair_ok = True
            seq: Optional[int] = None
            if self._latest_seq is not None:
                try:
                    seq = int(self._latest_seq())
                except Exception:
                    pair_ok = False
            try:
                latest = self._latest()
            except Exception:
                latest = {}
                pair_ok = False
            if pair_ok and self._latest_seq is not None:
                try:
                    pair_ok = int(self._latest_seq()) == seq
                except Exception:
                    pair_ok = False
            live = self._live_failures(now, latest)
            if pair_ok:
                # _live_failures just synced _last_version to the
                # current version — the legacy append-dedup key.
                self._judge_window(latest, seq, int(self._last_version))
        except Exception:
            _log.exception("watchdog check failed; treating as healthy")
            live = []
        with self._lock:
            self.checks_done += 1
            win_reasons = [
                self._win_reasons[k] for k, c in self._win_counts.items() if c > 0
            ]
            if not live and not win_reasons:
                if self.tripped:
                    _log.warning("watchdog recovered; /healthz back to 200")
                self._live_strikes = 0
                self._dumped = False
                self._warned_sig = None
                self.strikes = 0
                self.reasons = []
                self.tripped = False
                return self._verdict_locked()
            self._live_strikes = self._live_strikes + 1 if live else 0
            # One ladder, two cadences: live detectors strike per failing
            # CHECK, window detectors per failing WINDOW.
            self.strikes = max(
                self._live_strikes, max(self._win_counts.values(), default=0)
            )
            self.reasons = live + win_reasons
            strikes = self.strikes
            fails = self.reasons
            dump_now = (
                strikes >= self.cfg.dump_after
                and not self._dumped
                and self._recorder is not None
            )
            if dump_now:
                self._dumped = True
            # Warn once per DISTINCT verdict, not per check: a held
            # window verdict would otherwise re-emit the identical
            # strike line every interval_s for the rest of the window —
            # dozens of alert firings for one already-judged sample.
            sig = (strikes, tuple(fails))
            warn_now = sig != self._warned_sig
            if warn_now:
                self._warned_sig = sig
        # Escalation I/O outside the lock: dump() can hit a slow disk and
        # verdict()/healthz readers must never block behind it.
        if warn_now:
            _log.warning("watchdog strike %d: %s", strikes, "; ".join(fails))
        if dump_now:
            self._recorder.record("watchdog", strikes=strikes, reasons=fails)
            self._recorder.dump("watchdog", once=False)
        if strikes >= self.cfg.trip_after:
            with self._lock:
                if not self.tripped:
                    self.tripped = True
                    self.trips_total += 1
                    _log.error(
                        "watchdog TRIPPED after %d strikes (%s); /healthz -> 503",
                        strikes,
                        "; ".join(fails),
                    )
        return self.verdict()

    # ----------------------------------------------------------- surface

    def _verdict_locked(self) -> Dict:
        return {
            "enabled": True,
            "ok": not self.tripped,
            "tripped": self.tripped,
            "strikes": self.strikes,
            "reasons": list(self.reasons),
            "trips_total": self.trips_total,
            "checks_done": self.checks_done,
            "uptime_s": round(self._now() - self._start_t, 1),
        }

    def verdict(self) -> Dict:
        with self._lock:
            return self._verdict_locked()

    def scalars(self) -> Dict[str, float]:
        """The watchdog_* gauge family for the scrape surface."""
        with self._lock:
            return {
                "watchdog_ok": 0.0 if self.tripped else 1.0,
                "watchdog_strikes": float(self.strikes),
                "watchdog_trips_total": float(self.trips_total),
                "watchdog_checks_total": float(self.checks_done),
            }

    # ------------------------------------------------------------ thread

    def start(self) -> "Watchdog":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def _run():
            while not self._stop.wait(self.cfg.interval_s):
                self.check()

        self._thread = threading.Thread(target=_run, daemon=True, name="obs-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
