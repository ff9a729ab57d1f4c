"""Racecheck: a vector-clock happens-before race sanitizer for the
repo's threads — the dynamic half of graftcheck.

lockcheck (the lock-order substrate) sees lock-ORDER hazards; it cannot see a
plain data race: two threads writing one attribute with no
happens-before edge between them at all. This module detects exactly
that, mechanically, from one test run:

- **Happens-before tracking.** Every thread carries a vector clock.
  Repo-created sync objects carry shadow clocks and convey HB edges the
  way the runtime actually synchronizes: ``Lock``/``RLock`` release →
  next acquire; ``Condition`` rides its lock (wait = release +
  reacquire); ``Event.set`` → a ``wait()``/``is_set()`` that observes
  it; ``queue.Queue`` put → the get that receives that item (FIFO
  shadow), plus ``task_done`` → ``join``; ``Thread.start`` → the
  child's first step, child's last step → ``join``. The scope
  discipline is lockcheck's: only objects whose creation frame lives in
  this repo are instrumented — stdlib/torch internals stay native.
- **CUDA events.** A copy's CUDA event orders host threads too: the
  thread that sees ``query()`` return True (or returns from
  ``synchronize()``) runs after the ``record()`` that armed it.
  ``monitor.watch_events(torch.cuda.Event)`` wraps the class's
  ``record`` as a send and a completed ``query``/``synchronize`` as a
  receive (a re-record drops the old shadow clock, as ``Event.clear``
  does), so an order carried only by a ring slot's copy event is an HB
  edge, never a race report. The caller hands the class in: this
  module never imports torch.
- **Attribute-write tracing.** Opted-in instances (``monitor.watch(obj)``
  — the learner, the staging consumer/assembler/pack pool,
  TransferRing/RingSlot, CheckpointWorker, WeightPublisher, the
  InferenceServer and RemotePolicyClient are the intended set) get their class
  ``__setattr__`` wrapped; every attribute REBIND is checked
  FastTrack-style against the last write's epoch. Two writes to one
  attribute with neither ordered before the other is a race report
  carrying both sites. Writes only, by design: the repo's sanctioned
  read patterns (single GIL-atomic reads of rebound references) are
  exactly the ones a read-tracer would drown in, and the write-write
  case is the one that corrupts state.
- **Reasoned suppressions.** ``monitor.suppress("Class.attr", reason)``
  files matching reports under ``monitor.suppressed`` — an empty reason
  raises, the graftlint GRAFT000 discipline. The nightly soak asserts
  ``monitor.races == []`` with every suppression justified.

Production never imports this module; tests opt in via the
``racecheck`` fixture of tests/torch_sanitizers.py and the GPU
smoke's phase 25 installs it around a learner and a server — each
installs, runs, uninstalls. One
instrumentation substrate may own ``threading`` at a time — racecheck
and lockcheck fixtures are mutually exclusive within a test (install
refuses a patched ``threading.Lock``). Pure stdlib: importing this
module never imports torch, numpy or JAX.
"""

from __future__ import annotations

import collections
import os
import queue as _queue_mod
import sys
import threading
import weakref
from typing import Dict, List, Optional, Tuple

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# Captured at import time, before any install() can patch them: the
# monitor's own state lock must never be instrumented, and uninstall()
# must restore exactly these.
_NATIVE_LOCK = threading.Lock
_NATIVE_RLOCK = threading.RLock
_NATIVE_CONDITION = threading.Condition
_NATIVE_EVENT = threading.Event
_NATIVE_THREAD = threading.Thread
_NATIVE_QUEUE = _queue_mod.Queue


def _join(dst: Dict[int, int], src: Optional[Dict[int, int]]) -> None:
    if not src:
        return
    for k, v in src.items():
        if dst.get(k, 0) < v:
            dst[k] = v


def _leq_epoch(tid: int, clock: int, vc: Dict[int, int]) -> bool:
    """epoch (tid, clock) happened-before (or equals) vc."""
    return vc.get(tid, 0) >= clock


class RaceMonitor:
    """Registry + vector-clock state shared by every instrumented object."""

    def __init__(self, scope_root: Optional[str] = _REPO_ROOT):
        self.scope_root = scope_root
        self._state_lock = _NATIVE_LOCK()
        # uid lives in a threading.local, NOT on the thread object and
        # NEVER via threading.current_thread(): for an unregistered
        # thread (mid-bootstrap, foreign) current_thread() constructs a
        # _DummyThread whose __init__ touches an Event — under
        # scope_root=None that Event is itself instrumented and the
        # bookkeeping re-enters unboundedly (the lockcheck _thread_name
        # lesson). A thread-local also survives OS ident recycling: a
        # new thread on a reused ident gets a fresh slot, never a dead
        # thread's clock.
        self._tls = threading.local()
        # thread uid → vector clock. uids are monitor-assigned (thread
        # idents get recycled by the OS; a reused ident would inherit a
        # dead thread's clock and mint false HB edges).
        self._vcs: Dict[int, Dict[int, int]] = {}
        self._uid_counter = 0
        # sync-object shadow clocks, keyed by the wrapper's own id —
        # wrappers hold the key alive for their lifetime.
        self._sync_vc: Dict[int, Dict[int, int]] = {}
        # (id(obj), attr) → (writer uid, writer clock, thread name, site)
        self._last_write: Dict[Tuple[int, str], Tuple[int, int, str, str]] = {}
        self.races: List[Dict] = []
        self.suppressed: List[Dict] = []
        self._suppressions: Dict[str, str] = {}  # "Class.attr" → reason
        self._race_keys: set = set()  # dedupe: one report per (cls, attr, pair)
        self.writes_traced = 0
        self._watched: "weakref.WeakSet" = weakref.WeakSet()
        self._ignore_attrs: Dict[type, set] = {}
        self._patched_setattr: Dict[type, object] = {}
        # event class → {method name: the class's own attribute, or None
        # when inherited}, for uninstall to put back exactly
        self._patched_events: Dict[type, Dict[str, object]] = {}
        # events recorded under this monitor, held (strongly) until
        # uninstall: no id of one can be recycled while its shadow clock
        # is live, and no weakref ever points at a device event (a weakref
        # finalizer on torch.cuda.Event crashed the interpreter's exit)
        self._events: Dict[int, object] = {}
        self.event_records = self.event_observed = 0  # the device edges' two ends
        self._installed = False
        # every wrapper this monitor minted — uninstall() makes them
        # inert (the lockcheck contract: objects that outlive the test
        # in module/registry state must stop feeding a dead monitor).
        self._made: "weakref.WeakSet" = weakref.WeakSet()
        # id-recycling defense, the sync-object/watched-instance analog
        # of the thread-uid rule above: _sync_vc and _last_write key by
        # id(), and CPython reuses addresses after GC — a new lock at a
        # dead lock's address would inherit its clock and mint false HB
        # edges that MASK real races. weakref finalizers enqueue dead
        # ids here (list.append is GIL-atomic; the finalizer must NOT
        # take _state_lock — GC can fire inside a locked region and
        # deadlock on the non-reentrant lock), and every monitored op
        # drains the queue under the lock BEFORE touching the tables.
        # An address can only be reused after its finalizer ran, so the
        # stale entry is always gone before a recycled id is consulted.
        self._dead_ids: List[int] = []

    # ------------------------------------------------------------- clocks

    def _uid(self) -> int:
        u = getattr(self._tls, "uid", None)
        if u is None:
            with self._state_lock:
                self._uid_counter += 1
                u = self._uid_counter
            self._tls.uid = u  # each thread writes only its own slot
        return u

    @staticmethod
    def _thread_name() -> str:
        """Current thread's name WITHOUT threading.current_thread() —
        see the _tls comment in __init__ for why."""
        ident = threading.get_ident()
        t = getattr(threading, "_active", {}).get(ident)
        return t.name if t is not None else f"thread-{ident}"

    def _vc(self, uid: int) -> Dict[int, int]:
        """Caller holds _state_lock."""
        vc = self._vcs.get(uid)
        if vc is None:
            vc = self._vcs[uid] = {uid: 1}
        return vc

    def _snapshot_and_tick(self, uid: int) -> Dict[int, int]:
        """Caller holds _state_lock: copy the thread's clock, then
        advance it — the release/send half of every HB edge."""
        vc = self._vc(uid)
        snap = dict(vc)
        vc[uid] = vc.get(uid, 0) + 1
        return snap

    # ----------------------------------------------------- HB primitives

    def _on_collected(self, oid: int) -> None:
        """GC finalizer: queue the dead object's id for pruning. Runs
        at collection time — never takes _state_lock (see _dead_ids)."""
        self._dead_ids.append(oid)

    def _prune_dead_locked(self) -> None:
        """Caller holds _state_lock: drop table entries whose object
        died, so a recycled address starts from a clean slate."""
        while self._dead_ids:
            oid = self._dead_ids.pop()
            self._sync_vc.pop(oid, None)
            for key in [k for k in self._last_write if k[0] == oid]:
                del self._last_write[key]

    def hb_send(self, channel_id: int) -> None:
        """This thread's clock flows into `channel_id` (lock release,
        Event.set, task_done)."""
        uid = self._uid()
        with self._state_lock:
            self._prune_dead_locked()
            slot = self._sync_vc.setdefault(channel_id, {})
            _join(slot, self._snapshot_and_tick(uid))

    def hb_recv(self, channel_id: int) -> None:
        """`channel_id`'s clock flows into this thread (lock acquire,
        observed Event, queue join)."""
        uid = self._uid()
        with self._state_lock:
            self._prune_dead_locked()
            _join(self._vc(uid), self._sync_vc.get(channel_id))

    def hb_reset(self, channel_id: int) -> None:
        """Drop `channel_id`'s shadow clock (Event.clear): a wait that
        observes a LATER set must join only post-clear setters —
        accumulated pre-clear clocks would order the observer after
        threads it never synchronized with, masking real races."""
        with self._state_lock:
            self._sync_vc.pop(channel_id, None)

    def hb_transfer_out(self, fifo: "collections.deque") -> None:
        """Queue put: the putter's clock rides the item (FIFO shadow)."""
        uid = self._uid()
        with self._state_lock:
            fifo.append(self._snapshot_and_tick(uid))

    def hb_transfer_in(self, fifo: "collections.deque") -> None:
        """Queue get: join the clock that rode the received item."""
        uid = self._uid()
        with self._state_lock:
            if fifo:
                _join(self._vc(uid), fifo.popleft())

    # -------------------------------------------------------- write check

    def _site(self) -> str:
        frame = sys._getframe(2)
        while frame is not None and frame.f_code.co_filename == __file__:
            frame = frame.f_back
        if frame is None:
            return "<unknown>"
        path = frame.f_code.co_filename
        if self.scope_root and path.startswith(self.scope_root + os.sep):
            path = os.path.relpath(path, self.scope_root)
        return f"{path}:{frame.f_lineno}"

    def record_write(self, obj, cls_name: str, attr: str) -> None:
        site = self._site()
        uid = self._uid()
        tname = self._thread_name()
        key = (id(obj), attr)
        with self._state_lock:
            self._prune_dead_locked()
            self.writes_traced += 1
            vc = self._vc(uid)
            prev = self._last_write.get(key)
            if prev is not None:
                p_uid, p_clock, p_tname, p_site = prev
                if p_uid != uid and not _leq_epoch(p_uid, p_clock, vc):
                    label = f"{cls_name}.{attr}"
                    # unordered site pair: the same race observed in both
                    # directions by a hot loop is ONE report, not two
                    race_key = (label, frozenset((p_site, site)))
                    if race_key not in self._race_keys:
                        self._race_keys.add(race_key)
                        report = {
                            "attr": label,
                            "first_thread": p_tname,
                            "first_site": p_site,
                            "second_thread": tname,
                            "second_site": site,
                        }
                        reason = self._suppressions.get(label)
                        if reason is not None:
                            report["reason"] = reason
                            self.suppressed.append(report)
                        else:
                            self.races.append(report)
            self._last_write[key] = (uid, vc.get(uid, 0), tname, site)

    # ------------------------------------------------------------ opt-in

    def watch(self, obj, ignore: Tuple[str, ...] = ()) -> None:
        """Trace attribute rebinds on `obj`. The class __setattr__ is
        wrapped once per class; only watched INSTANCES pay the check.
        `ignore` names attrs excluded for this object's class (pure
        construction-time scratch, etc.)."""
        cls = type(obj)
        self._ignore_attrs.setdefault(cls, set()).update(ignore)
        if cls not in self._patched_setattr:
            orig = cls.__setattr__

            def traced_setattr(inst, name, value, _orig=orig, _cls=cls):
                m = _ACTIVE_MONITOR
                if (
                    m is not None
                    and inst in m._watched
                    and name not in m._ignore_attrs.get(_cls, ())
                ):
                    m.record_write(inst, _cls.__name__, name)
                _orig(inst, name, value)

            cls.__setattr__ = traced_setattr
            self._patched_setattr[cls] = orig
        self._watched.add(obj)
        weakref.finalize(obj, self._on_collected, id(obj))

    def watch_events(self, event_cls) -> None:
        """Convey happens-before through a device-event class (the
        caller passes ``torch.cuda.Event``): ``record()`` sends the
        recording thread's clock into the event's shadow, replacing what
        an earlier record left there; a ``query()`` that returns True
        and a returned ``synchronize()`` receive it. The send runs BEFORE
        the real record, so no observer can see the completion without
        its edge."""
        if event_cls in self._patched_events:
            return
        saved = {
            name: event_cls.__dict__.get(name)
            for name in ("record", "query", "synchronize")
        }
        orig_record = event_cls.record
        orig_query = event_cls.query
        orig_sync = event_cls.synchronize

        def record(ev, *args, **kwargs):
            m = _ACTIVE_MONITOR
            if m is not None:
                m._event_send(ev)
            return orig_record(ev, *args, **kwargs)

        def query(ev):
            done = orig_query(ev)
            m = _ACTIVE_MONITOR
            if done and m is not None:
                m._event_recv(ev)
            return done

        def synchronize(ev):
            out = orig_sync(ev)
            m = _ACTIVE_MONITOR
            if m is not None:
                m._event_recv(ev)
            return out

        event_cls.record = record
        event_cls.query = query
        event_cls.synchronize = synchronize
        self._patched_events[event_cls] = saved

    def _event_send(self, ev) -> None:
        uid = self._uid()
        with self._state_lock:
            self._prune_dead_locked()
            self._events[id(ev)] = ev
            self.event_records += 1
            # replace, not join: an observer of THIS record's completion
            # is ordered after this recorder only
            self._sync_vc[id(ev)] = self._snapshot_and_tick(uid)

    def _event_recv(self, ev) -> None:
        """A completed query/synchronize: join the recorder's clock. An
        event never recorded under this monitor conveys nothing."""
        if self._events.get(id(ev)) is ev:
            self.hb_recv(id(ev))
            self.event_observed += 1

    def suppress(self, attr_label: str, reason: str) -> None:
        """Suppress races on "Class.attr" WITH a reason — the graftlint
        escape-hatch discipline: silence must always be justified."""
        if not reason or not reason.strip():
            raise ValueError(
                f"racecheck suppression for {attr_label!r} needs a non-empty "
                f"reason — silence must always be justified"
            )
        self._suppressions[attr_label] = reason.strip()

    # ----------------------------------------------------------- factories

    def _creation_in_scope(self) -> bool:
        frame = sys._getframe(2)
        while frame is not None and frame.f_code.co_filename == __file__:
            frame = frame.f_back
        if frame is None:
            return False
        path = frame.f_code.co_filename
        if self.scope_root is None:
            return True
        root = self.scope_root.rstrip(os.sep)
        if path != root and not path.startswith(root + os.sep):
            return False
        return "site-packages" not in path.split(os.sep)

    def _mint(self, obj):
        self._made.add(obj)
        weakref.finalize(obj, self._on_collected, id(obj))
        return obj

    def make_lock(self):
        if not self._creation_in_scope():
            return _NATIVE_LOCK()
        return self._mint(_HBLock(self, _NATIVE_LOCK()))

    def make_rlock(self):
        if not self._creation_in_scope():
            return _NATIVE_RLOCK()
        return self._mint(_HBLock(self, _NATIVE_RLOCK()))

    def make_condition(self, lock=None):
        # Same rationale as lockcheck.make_condition: a default-lock
        # Condition builds its RLock inside threading.py (out of scope),
        # so build the instrumented backing lock HERE.
        if lock is None and self._creation_in_scope():
            lock = self._mint(_HBLock(self, _NATIVE_RLOCK()))
        return _NATIVE_CONDITION(lock) if lock is not None else _NATIVE_CONDITION()

    def make_event(self):
        if not self._creation_in_scope():
            return _NATIVE_EVENT()
        return self._mint(_HBEvent(self, _NATIVE_EVENT()))

    def make_queue(self, maxsize: int = 0):
        if not self._creation_in_scope():
            return _NATIVE_QUEUE(maxsize)
        return self._mint(_HBQueue(self, maxsize))

    def make_thread(self, *args, **kwargs):
        if not self._creation_in_scope():
            return _NATIVE_THREAD(*args, **kwargs)
        return self._mint(_HBThread(self, *args, **kwargs))

    # ----------------------------------------------------------- lifecycle

    def install(self) -> "RaceMonitor":
        global _ACTIVE_MONITOR
        if self._installed:
            return self
        if threading.Lock is not _NATIVE_LOCK:
            raise RuntimeError(
                "another instrumentation (racecheck or lockcheck) already "
                "owns threading — the fixtures are mutually exclusive"
            )
        self._installed = True
        _ACTIVE_MONITOR = self
        threading.Lock = self.make_lock  # type: ignore[assignment]
        threading.RLock = self.make_rlock  # type: ignore[assignment]
        threading.Condition = self.make_condition  # type: ignore[assignment]
        threading.Event = self.make_event  # type: ignore[assignment]
        threading.Thread = self.make_thread  # type: ignore[assignment]
        _queue_mod.Queue = self.make_queue  # type: ignore[assignment]
        return self

    def uninstall(self) -> None:
        global _ACTIVE_MONITOR
        if not self._installed:
            return
        self._installed = False
        _ACTIVE_MONITOR = None
        threading.Lock = _NATIVE_LOCK  # type: ignore[assignment]
        threading.RLock = _NATIVE_RLOCK  # type: ignore[assignment]
        threading.Condition = _NATIVE_CONDITION  # type: ignore[assignment]
        threading.Event = _NATIVE_EVENT  # type: ignore[assignment]
        threading.Thread = _NATIVE_THREAD  # type: ignore[assignment]
        _queue_mod.Queue = _NATIVE_QUEUE  # type: ignore[assignment]
        # restore every patched __setattr__: watched instances that
        # outlive the test must stop paying the trace into a dead monitor
        for cls, orig in self._patched_setattr.items():
            cls.__setattr__ = orig
        self._patched_setattr.clear()
        for cls, saved in self._patched_events.items():
            for name, attr in saved.items():
                if attr is None:
                    delattr(cls, name)
                else:
                    setattr(cls, name, attr)
        self._patched_events.clear()
        with self._state_lock:
            for oid in self._events:
                self._sync_vc.pop(oid, None)
            self._events.clear()
        # inert every wrapper we minted: sync objects that outlive the
        # test in module/registry state keep working as the wrapped
        # native with no bookkeeping (the lockcheck uninstall contract)
        for obj in list(self._made):
            obj._monitor = None

    def __enter__(self) -> "RaceMonitor":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def report(self) -> Dict:
        with self._state_lock:
            return {
                "writes_traced": self.writes_traced,
                "threads": len(self._vcs),
                "races": list(self.races),
                "suppressed": len(self.suppressed),
                "event_records": self.event_records,
                "event_observed": self.event_observed,
            }


# The one active monitor (install() refuses nesting). Module-global so
# the per-class traced __setattr__ closures go inert on uninstall even
# when an instance outlives its test.
_ACTIVE_MONITOR: Optional[RaceMonitor] = None


class _HBLock:
    """Duck-typed Lock/RLock conveying happens-before: release sends this
    thread's clock into the lock's shadow, acquire joins it. Condition
    protocol implemented (wait = full release + reacquire) so waits
    convey the same edge."""

    def __init__(self, monitor: RaceMonitor, real):
        self._monitor: Optional[RaceMonitor] = monitor
        self._real = real

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._real.acquire(blocking, timeout)
        if ok and self._monitor is not None:
            self._monitor.hb_recv(id(self))
        return ok

    def release(self) -> None:
        if self._monitor is not None:
            self._monitor.hb_send(id(self))
        self._real.release()

    def locked(self) -> bool:
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # Condition protocol (threading.Condition drives these on its lock)
    def _release_save(self):
        if self._monitor is not None:
            self._monitor.hb_send(id(self))
        if hasattr(self._real, "_release_save"):
            return self._real._release_save()
        self._real.release()
        return None

    def _acquire_restore(self, saved) -> None:
        if saved is not None and hasattr(self._real, "_acquire_restore"):
            self._real._acquire_restore(saved)
        else:
            self._real.acquire()
        if self._monitor is not None:
            self._monitor.hb_recv(id(self))

    def _is_owned(self) -> bool:
        if hasattr(self._real, "_is_owned"):
            return self._real._is_owned()
        if self._real.acquire(False):
            self._real.release()
            return False
        return True

    def __getattr__(self, name):
        return getattr(self._real, name)


class _HBEvent:
    """threading.Event conveying happens-before: set() publishes the
    setter's clock; a wait() or is_set() that OBSERVES the set joins it
    — the flag-handshake HB edge the THR rules assume."""

    def __init__(self, monitor: RaceMonitor, real):
        self._monitor: Optional[RaceMonitor] = monitor
        self._real = real

    def set(self) -> None:
        if self._monitor is not None:
            self._monitor.hb_send(id(self))
        self._real.set()

    def clear(self) -> None:
        if self._monitor is not None:
            self._monitor.hb_reset(id(self))
        self._real.clear()

    def is_set(self) -> bool:
        v = self._real.is_set()
        if v and self._monitor is not None:
            self._monitor.hb_recv(id(self))
        return v

    def wait(self, timeout: Optional[float] = None) -> bool:
        v = self._real.wait(timeout)
        if v and self._monitor is not None:
            self._monitor.hb_recv(id(self))
        return v

    def __getattr__(self, name):
        return getattr(self._real, name)


class _HBQueue(_NATIVE_QUEUE):
    """queue.Queue conveying happens-before per ITEM: the putter's clock
    rides a FIFO shadow and joins into whichever thread receives that
    item. ``task_done``→``join`` conveys the completion edge. The
    shadow ops run inside ``_put``/``_get`` — under the queue's own
    mutex, so shadow order is exactly item order."""

    def __init__(self, monitor: RaceMonitor, maxsize: int = 0):
        self._monitor: Optional[RaceMonitor] = monitor
        self._hb_fifo: "collections.deque" = collections.deque()
        super().__init__(maxsize)

    def _put(self, item) -> None:
        if self._monitor is not None:
            self._monitor.hb_transfer_out(self._hb_fifo)
        super()._put(item)

    def _get(self):
        if self._monitor is not None:
            self._monitor.hb_transfer_in(self._hb_fifo)
        return super()._get()

    def task_done(self) -> None:
        if self._monitor is not None:
            self._monitor.hb_send(id(self))
        super().task_done()

    def join(self) -> None:
        super().join()
        if self._monitor is not None:
            self._monitor.hb_recv(id(self))


class _HBThread(_NATIVE_THREAD):
    """threading.Thread conveying fork/join happens-before: start()
    snapshots the parent's clock for the child's first step; join()
    (and is_alive() observing death) joins the child's final clock."""

    def __init__(self, monitor: RaceMonitor, *args, **kwargs):
        self._monitor: Optional[RaceMonitor] = monitor
        self._hb_parent: Optional[Dict[int, int]] = None
        self._hb_final: Optional[Dict[int, int]] = None
        super().__init__(*args, **kwargs)

    def start(self) -> None:
        m = self._monitor
        if m is not None:
            uid = m._uid()
            with m._state_lock:
                self._hb_parent = m._snapshot_and_tick(uid)
        super().start()

    def run(self) -> None:
        m = self._monitor
        if m is not None:
            uid = m._uid()
            with m._state_lock:
                _join(m._vc(uid), self._hb_parent)
        try:
            super().run()
        finally:
            if m is not None:
                uid = m._uid()
                with m._state_lock:
                    self._hb_final = dict(m._vc(uid))

    def join(self, timeout: Optional[float] = None) -> None:
        super().join(timeout)
        m = self._monitor
        if m is not None and not self.is_alive() and self._hb_final is not None:
            uid = m._uid()
            with m._state_lock:
                _join(m._vc(uid), self._hb_final)
