"""Runtime lock instrumentation: the dynamic half of the THR rules.

THR002 sees lexically nested ``with self.lock`` pairs; it cannot see an
order established ACROSS objects (staging's stats lock taken while a
reservoir method takes its own) or through callbacks. This module
instruments ``threading.Lock`` at test time and records what actually
happened:

- **lock-order inversions** — per-thread stack of currently held
  instrumented locks; acquiring B while holding A records the directed
  edge A→B (keyed by each lock's CREATION SITE, so every
  ``StagingBuffer._stats_lock`` is one node regardless of instance
  count). A later acquisition establishing B→A is an inversion: two
  threads interleaving those paths deadlock.
- **over-held locks** — a hold longer than ``hold_threshold_s`` is
  recorded; the repo's locks exist to make SNAPSHOTS atomic, so a long
  hold means I/O or compute crept under a lock that scrape/hot-path
  threads contend on (the Watchdog's "escalation I/O outside the lock"
  rule, as a harness check).

Scope discipline keeps this safe and cheap: ``install()`` patches
``threading.Lock``/``RLock``/``Condition``, but the factories only
instrument locks whose creation frame lives inside this repo — stdlib
``queue.Queue``, logging, and torch internals keep native locks. A bare
``threading.Condition()`` from repo code gets an instrumented backing
RLock attributed to the Condition call site (its default RLock would
otherwise be created inside threading.py and escape the scope filter).
The wrapper implements the Condition wait protocol itself
(``_release_save``/``_acquire_restore``/``_is_owned``), so a
``cond.wait()`` pauses the hold clock — waiting is not holding — and
reacquisition re-enters order tracking.

Production never imports this module; tests opt in via the
``lockcheck`` fixture of tests/torch_sanitizers.py and the GPU
smoke's phase 25 installs it around a learner run — each installs,
runs, and uninstalls; assertions on ``monitor.inversions`` /
``monitor.over_held`` belong to the caller. Pure stdlib: importing this
module never imports torch or numpy.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

from dotaclient_tpu_torch.analysis.core import bfs_path

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Captured at import time, before any install() can patch threading:
# the monitor's own state lock must NEVER be instrumented (an
# instrumented state lock would re-enter on_acquired → self-deadlock),
# and uninstall() must restore exactly this factory.
_NATIVE_LOCK = threading.Lock
_NATIVE_RLOCK = threading.RLock
_NATIVE_CONDITION = threading.Condition


def _thread_name(ident: Optional[int] = None) -> str:
    """Name of the thread with `ident` (default: current) WITHOUT
    threading.current_thread(): for an unregistered thread
    (mid-bootstrap, or foreign) current_thread() constructs a
    _DummyThread, whose __init__ creates an Event — under
    scope_root=None that Event's Condition is itself instrumented, and
    acquiring it re-enters on_acquired → unbounded recursion."""
    if ident is None:
        ident = threading.get_ident()
    t = getattr(threading, "_active", {}).get(ident)
    return t.name if t is not None else f"thread-{ident}"


class LockMonitor:
    """Registry + detector state shared by every instrumented lock."""

    def __init__(
        self, hold_threshold_s: float = 0.2, scope_root: Optional[str] = _REPO_ROOT
    ):
        self.hold_threshold_s = hold_threshold_s
        # Only instrument locks created under this path (default: the
        # repo checkout). Pass None to instrument everything (fixture
        # corpus tests use tmp paths).
        self.scope_root = scope_root
        # thread ident → stack of currently held instrumented locks,
        # guarded by _state_lock. Monitor-global (not threading.local):
        # threading.Lock legally allows acquire-in-A/release-in-B
        # handoff, and the releasing thread must be able to strip the
        # entry from the ACQUIRING thread's stack — a thread-local stack
        # would keep a phantom there forever, minting false order edges.
        self._held: Dict[int, List["InstrumentedLock"]] = {}
        # site-pair → (thread name, where the second acquire happened)
        self._edges: Dict[Tuple[str, str], Tuple[str, str]] = {}
        # adjacency mirror of _edges for the cycle search
        self._adj: Dict[str, List[str]] = {}
        self._state_lock = _NATIVE_LOCK()  # guards edges + reports
        self.inversions: List[Dict] = []
        # cycles already reported, keyed by their site set — a hot loop
        # re-nesting a known-inverted pair must not mint one report per
        # iteration (the soak asserts on inversions; a real inversion
        # would otherwise bury its one distinct cycle in thousands of
        # duplicates)
        self._reported_cycles: set = set()
        self.over_held: List[Dict] = []
        self.acquisitions = 0
        self._installed: Optional[Tuple] = None
        # every InstrumentedLock this monitor minted — uninstall() makes
        # them inert. Locks created during a test can outlive it in
        # module/registry state (a broker hub, a cached transport); left
        # live they would keep paying bookkeeping into a dead monitor
        # (over_held growing unboundedly) for the rest of the process.
        self._made: "weakref.WeakSet[InstrumentedLock]" = weakref.WeakSet()

    # ------------------------------------------------------------ factory

    def _creation_site(self) -> Optional[str]:
        """file:line of the frame that called Lock(), skipping ourselves;
        None when out of scope (→ hand back a native lock)."""
        import sys

        frame = sys._getframe(2)
        while frame is not None and frame.f_code.co_filename == __file__:
            frame = frame.f_back
        if frame is None:
            return None
        path = frame.f_code.co_filename
        if self.scope_root is not None:
            # separator-anchored: /repo must not claim /repo-backup/...
            root = self.scope_root.rstrip(os.sep)
            if path != root and not path.startswith(root + os.sep):
                return None
            # a venv installed INSIDE the checkout is not repo code —
            # torch/numpy locks from repo/.venv/.../site-packages must
            # stay native per the module contract
            if "site-packages" in path.split(os.sep):
                return None
        rel = os.path.relpath(path, self.scope_root) if self.scope_root else path
        return f"{rel}:{frame.f_lineno}"

    def make_lock(self):
        site = self._creation_site()
        if site is None:
            return _NATIVE_LOCK()
        return self._mint(InstrumentedLock(self, _NATIVE_LOCK(), site))

    def make_rlock(self):
        site = self._creation_site()
        if site is None:
            return _NATIVE_RLOCK()
        return self._mint(InstrumentedLock(self, _NATIVE_RLOCK(), site, reentrant=True))

    def _mint(self, lock: "InstrumentedLock") -> "InstrumentedLock":
        self._made.add(lock)
        return lock

    def make_condition(self, lock=None):
        """Condition() with NO lock creates its RLock inside threading.py
        — out of scope for the Lock factory, which would leave every
        default-lock Condition (WeightPublisher._cond, the checkpoint
        mirror) invisible to the monitor. Build the backing RLock HERE,
        attributed to the Condition() call site."""
        if lock is None:
            site = self._creation_site()
            if site is not None:
                lock = self._mint(InstrumentedLock(self, _NATIVE_RLOCK(), site, reentrant=True))
        return _NATIVE_CONDITION(lock) if lock is not None else _NATIVE_CONDITION()

    def install(self) -> "LockMonitor":
        """Patch threading.Lock/RLock/Condition with the scoped factory;
        uninstall restores the import-time natives exactly (idempotent
        both ways, and a nested install of a second monitor is refused —
        two monitors patching over each other would corrupt both
        graphs)."""
        if self._installed is not None:
            return self
        if threading.Lock is not _NATIVE_LOCK:
            raise RuntimeError("another LockMonitor is already installed")
        self._installed = (_NATIVE_LOCK, _NATIVE_RLOCK, _NATIVE_CONDITION)
        threading.Lock = self.make_lock  # type: ignore[assignment]
        threading.RLock = self.make_rlock  # type: ignore[assignment]
        threading.Condition = self.make_condition  # type: ignore[assignment]
        return self

    def uninstall(self) -> None:
        if self._installed is None:
            return
        threading.Lock, threading.RLock, threading.Condition = self._installed  # type: ignore[assignment]
        self._installed = None
        # Inert every lock we minted: locks that outlive the monitor in
        # module/registry state must stop feeding a dead graph (the
        # wrapped native keeps working — only the bookkeeping stops).
        # Under _state_lock: a thread that outlived its test can be
        # inside on_acquired/on_released right now, indexing the very
        # _holders list this clears.
        with self._state_lock:
            for lk in list(self._made):
                lk._monitor = None
                lk._holders.clear()

    def __enter__(self) -> "LockMonitor":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # ---------------------------------------------------------- callbacks

    def on_acquired(self, lock: "InstrumentedLock") -> None:
        now = time.monotonic()
        tname = _thread_name()
        ident = threading.get_ident()
        with self._state_lock:
            held = self._held.setdefault(ident, [])
            self.acquisitions += 1
            for outer in held:
                if outer.site == lock.site:
                    continue
                edge = (outer.site, lock.site)
                if edge not in self._edges:
                    self._edges[edge] = (tname, lock.site)
                    self._adj.setdefault(outer.site, []).append(lock.site)
                # general cycle, not just the reversed pair: taking
                # outer→lock here deadlocks if lock already reaches
                # outer through ANY recorded chain (A→B, B→C, C→A is
                # as fatal as A→B/B→A under a 3-way interleave)
                back = self._site_path(lock.site, outer.site)
                if back is not None and frozenset([outer.site] + back) not in self._reported_cycles:
                    self._reported_cycles.add(frozenset([outer.site] + back))
                    self.inversions.append(
                        {
                            "first": outer.site,
                            "then": lock.site,
                            "thread": tname,
                            "cycle": [outer.site] + back,
                            "conflicts_with": {
                                "first": lock.site,
                                "then": back[1],
                                "thread": self._edges[(lock.site, back[1])][0],
                            },
                        }
                    )
            held.append(lock)
            lock._holders.append((ident, now))

    def _site_path(self, src: str, dst: str) -> Optional[List[str]]:
        """Shortest [src, …, dst] over recorded order edges, or None.
        Caller holds _state_lock; the graph is a handful of creation
        sites, so BFS per nested acquisition is noise. Shares core's
        bfs_path with THR002 so the static and dynamic detectors agree
        on which cycles they report."""
        return bfs_path(self._adj, src, dst)

    @staticmethod
    def _drop_held(held: List["InstrumentedLock"], lock, all_levels: bool) -> bool:
        # release may be out of LIFO order (rare but legal) — remove by id;
        # all_levels drops every recursion level (Condition.wait on an
        # RLock releases them all at once via _release_save)
        dropped = False
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lock:
                del held[i]
                dropped = True
                if not all_levels:
                    break
        return dropped

    def on_released(
        self, lock: "InstrumentedLock", now: float, all_levels: bool = False
    ) -> int:
        ident = threading.get_ident()
        with self._state_lock:
            # Whose stack owns this entry? Our own acquisition if we
            # have one; otherwise this is a cross-thread handoff
            # release (plain Lock: acquired in A, released here) and
            # the OLDEST recorded holder is the phantom to strip — the
            # real lock was already released before this callback, so
            # any NEWER holder re-acquired it legitimately in the gap
            # and its entry must survive. The acquire timestamp rides
            # in the holder entry (NOT a thread-local clock): a handoff
            # release must consume the ACQUIRER's timestamp, or it
            # lingers and inflates that thread's next hold of this
            # lock into a false over_held report.
            holders = lock._holders
            idents = [h[0] for h in holders]
            target = ident if ident in idents else (idents[0] if idents else None)
            t0 = None
            levels = 0
            if target is not None:
                if all_levels:
                    # Condition.wait on an RLock drops every recursion
                    # level at once; the hold began at the OUTERMOST
                    # (oldest) acquire. The dropped-level count goes
                    # back to the caller so _acquire_restore can mirror
                    # it on wake — restoring one entry for a depth-2
                    # hold would starve the outer release's bookkeeping.
                    mine = [h for h in holders if h[0] == target]
                    t0 = mine[0][1]
                    levels = len(mine)
                    lock._holders = [h for h in holders if h[0] != target]
                else:
                    # own release pops the NEWEST level (LIFO, RLock
                    # recursion); a handoff release strips the OLDEST —
                    # the phantom from the original acquire — so a
                    # holder that re-acquired in the gap between the
                    # real release and this bookkeeping keeps its live
                    # timestamp (consuming the live entry instead would
                    # leave the stale phantom to inflate the holder's
                    # real release into a false over_held)
                    if target == ident:
                        order = range(len(holders) - 1, -1, -1)
                    else:
                        order = range(len(holders))
                    for i in order:
                        if holders[i][0] == target:
                            t0 = holders[i][1]
                            del holders[i]
                            levels = 1
                            break
                self._drop_held(self._held.get(target, []), lock, all_levels)
            held_s = now - t0 if t0 is not None else 0.0
            if held_s > self.hold_threshold_s:
                self.over_held.append(
                    {
                        "site": lock.site,
                        "held_s": round(held_s, 4),
                        # blame the HOLDER: on a handoff release the
                        # current thread is just the messenger, and the
                        # report exists to point at the code path that
                        # kept work under the lock
                        "thread": _thread_name(target),
                    }
                )
            return levels

    def report(self) -> Dict:
        with self._state_lock:
            return {
                "acquisitions": self.acquisitions,
                "edges": len(self._edges),
                "inversions": list(self.inversions),
                "over_held": list(self.over_held),
            }


class InstrumentedLock:
    """Duck-typed threading.Lock recording acquisition order + hold time.

    Works as the lock under a ``threading.Condition`` and inside
    ``with`` statements; anything exotic (``_at_fork_reinit``…)
    delegates to the wrapped native lock.
    """

    def __init__(self, monitor: LockMonitor, real, site: str, reentrant: bool = False):
        # None after the minting monitor uninstalls: the lock keeps
        # working as the wrapped native, with no bookkeeping
        self._monitor: Optional[LockMonitor] = monitor
        self._real = real
        self.site = site
        self._reentrant = reentrant
        # (holder thread ident, monotonic acquire time) pairs, oldest
        # first (guarded by the monitor's state lock; see on_released)
        self._holders: List[Tuple[int, float]] = []

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._real.acquire(blocking, timeout)
        if ok and self._monitor is not None:
            self._monitor.on_acquired(self)
        return ok

    def release(self) -> None:
        now = time.monotonic()
        self._real.release()
        if self._monitor is not None:
            self._monitor.on_released(self, now)

    def locked(self) -> bool:
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- Condition protocol -------------------------------------------
    # Defined HERE (not delegated raw) so a cond.wait() on this lock
    # pauses the hold clock: waiting is not holding, and raw delegation
    # to an RLock's C-level _release_save would bypass the wrapper and
    # count the whole wait as one giant hold.

    def _release_save(self):
        now = time.monotonic()
        if hasattr(self._real, "_release_save"):
            state = self._real._release_save()  # RLock: all levels at once
        else:
            self._real.release()  # plain lock inside a Condition
            state = None
        levels = (
            self._monitor.on_released(self, now, all_levels=True)
            if self._monitor is not None
            else 0
        )
        # ride the dropped-level count through the opaque saved state:
        # Condition hands it straight back to _acquire_restore
        return (state, levels)

    def _acquire_restore(self, saved) -> None:
        state, levels = saved
        if state is not None and hasattr(self._real, "_acquire_restore"):
            self._real._acquire_restore(state)
        else:
            self._real.acquire()
        # mirror every dropped recursion level, or the outer release of
        # a nested `with cond:` hold finds no holder entry after a wait
        # and its hold time / order edges vanish from the record
        if self._monitor is not None:
            for _ in range(max(1, levels)):
                self._monitor.on_acquired(self)

    def _is_owned(self) -> bool:
        if hasattr(self._real, "_is_owned"):
            return self._real._is_owned()
        if self._real.acquire(False):
            self._real.release()
            return False
        return True

    def __getattr__(self, name):
        # anything else the wrapped primitive grows in future pythons
        return getattr(self._real, name)
