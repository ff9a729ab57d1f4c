"""Flight recorder (own copy of dotaclient_tpu/obs/flight_recorder.py):
bounded ring of recent pipeline events per process, dumped to a JSON
artifact when something dies.

The evidence of a failure (which chunks were in flight, what the staging
consumer was doing, when the last weight broadcast landed) evaporates
with the process. The ring keeps the last `ring_size` events in memory at O(1) cost per event and
writes them out on: a crash (sys.excepthook / threading.excepthook), a
BatchLayoutError (the staging consumer's fatal path calls dump before
dying), SIGTERM (the k8s eviction signal), or an explicit dump() call.

Dump artifacts are JSON: {reason, role, pid, time, events: [...]} at
`<dump_dir>/flight_<role>_<pid>_<reason>_<stamp>.json`. Events are
whatever record() was handed — pipeline trace hops (obs/trace.py
mirrors every hop here), staging admissions, weight swaps — each with a
wall-clock `t`.

Handler installation is opt-in (ObsConfig.install_handlers) and
chaining: the previous excepthook/signal handler still runs, so the
recorder never eats a crash or a termination another component owns. The
learner's SIGTERM drain handler, installed after it, replaces the SIGTERM
trigger: a drain is a clean exit.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Optional

_log = logging.getLogger(__name__)


class FlightRecorder:
    def __init__(self, role: str, ring_size: int = 2048, dump_dir: str = ""):
        self.role = role
        self.dump_dir = dump_dir
        self._ring: deque = deque(maxlen=max(int(ring_size), 1))
        self._lock = threading.Lock()
        self._dumped_reasons = set()  # one artifact per distinct reason
        # name -> provider() of extra dump payload (the staging quarantine
        # ring): state too bulky to mirror into the event ring per
        # occurrence but essential in a post-mortem.
        self._sections: dict = {}
        self.events_recorded = 0
        self.last_dump_path: Optional[str] = None

    # ------------------------------------------------------------ record

    def record(self, event: str, t: Optional[float] = None, **fields) -> None:
        rec = {"t": time.time() if t is None else t, "ev": event}
        if fields:
            rec.update(fields)
        with self._lock:
            self._ring.append(rec)
            self.events_recorded += 1

    def add_section(self, name: str, provider) -> None:
        """Register a named dump section: `provider()` is called at dump
        time and its (JSON-serializable) return lands under
        payload["sections"][name]. Used by owners of bounded evidence
        rings — the staging quarantine — whose full contents belong in a
        post-mortem but not in the per-event ring."""
        with self._lock:
            self._sections[name] = provider

    def snapshot(self, max_events: int = 256, max_bytes: int = 262144) -> dict:
        """The GET /debug/flight view: the newest `max_events` events and
        the dump sections, halved oldest-first (then the sections dropped)
        until the JSON fits `max_bytes`. Touches no disk and marks no
        reason, so a fleet-wide fan-in may hit every process at once."""
        with self._lock:
            events = list(self._ring)[-max(int(max_events), 0):]
            recorded = self.events_recorded
            providers = list(self._sections.items())
        sections = {}
        for name, provider in providers:
            try:
                sections[name] = provider()
            except Exception:  # a recorder must never add a second failure
                sections[name] = "<section provider failed>"
        payload = {"role": self.role, "pid": os.getpid(), "time": time.time(), "events_recorded": recorded,
                   "truncated": False, "events": events, "sections": sections}
        while len(json.dumps(payload, default=str)) > max_bytes:
            if payload["events"]:
                half = len(payload["events"]) // 2
                payload["events"] = payload["events"][-half:] if half else []
            elif payload["sections"]:
                payload["sections"] = {}
            else:
                break
            payload["truncated"] = True
        return payload

    # -------------------------------------------------------------- dump

    def dump(self, reason: str, once: bool = True) -> Optional[str]:
        """Write the ring to a JSON artifact; returns its path (None when
        an identical-reason dump already happened and once=True, or the
        write failed — a recorder must never add a second failure)."""
        with self._lock:
            if once and reason in self._dumped_reasons:
                return None
            self._dumped_reasons.add(reason)
            events = list(self._ring)
            providers = list(self._sections.items())
        sections = {}
        for name, provider in providers:
            try:
                sections[name] = provider()
            except Exception:  # a recorder must never add a second failure
                sections[name] = "<section provider failed>"
        stamp = time.strftime("%Y%m%dT%H%M%S")
        safe_reason = "".join(c if c.isalnum() or c in "-_" else "_" for c in reason)[:64]
        directory = self.dump_dir or os.getcwd()
        path = os.path.join(
            directory, f"flight_{self.role}_{os.getpid()}_{safe_reason}_{stamp}.json"
        )
        try:
            os.makedirs(directory, exist_ok=True)
            payload = {
                "reason": reason,
                "role": self.role,
                "pid": os.getpid(),
                "time": time.time(),
                "events_recorded": self.events_recorded,
                "events": events,
            }
            if sections:
                payload["sections"] = sections
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)  # never leave a half-written artifact
        except Exception:
            _log.exception("flight recorder dump failed (%s)", reason)
            return None
        self.last_dump_path = path
        _log.warning("flight recorder dumped %d events to %s", len(events), path)
        return path

    # ----------------------------------------------------- dump triggers

    def install_handlers(self) -> None:
        """Chain SIGTERM + excepthook + threading.excepthook dump
        triggers. SIGTERM only installs from the main thread (signal
        module restriction); the hooks install anywhere."""
        prev_excepthook = sys.excepthook

        def _excepthook(tp, val, tb):
            self.dump(f"crash_{tp.__name__}")
            prev_excepthook(tp, val, tb)

        sys.excepthook = _excepthook

        prev_thread_hook = threading.excepthook

        def _thread_hook(args):
            if args.exc_type is not SystemExit:
                self.dump(f"thread_crash_{args.exc_type.__name__}")
            prev_thread_hook(args)

        threading.excepthook = _thread_hook

        if threading.current_thread() is threading.main_thread():
            try:
                prev_term = signal.getsignal(signal.SIGTERM)

                def _on_term(signum, frame):
                    self.dump("sigterm")
                    if prev_term is signal.SIG_IGN:
                        return  # an explicitly IGNORED signal must stay ignored
                    if callable(prev_term):
                        prev_term(signum, frame)
                    else:  # default disposition: re-raise for termination
                        signal.signal(signal.SIGTERM, signal.SIG_DFL)
                        os.kill(os.getpid(), signal.SIGTERM)

                signal.signal(signal.SIGTERM, _on_term)
            except (ValueError, OSError):  # non-main thread race / exotic env
                pass
