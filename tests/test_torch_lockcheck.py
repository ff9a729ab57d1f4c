"""The port's lock sanitizer (dotaclient_tpu_torch/analysis/lockcheck.py),
twin of tests/test_lockcheck.py: the dynamic half of the THR rules.

The deterministic tests drive inversions and holds directly: an order
violation is a property of the acquisition GRAPH, detectable from one
thread without constructing the deadlock. One test runs the same
scripted scenario under the reference's monitor and the port's and
holds them to the same reports. The nightly soak runs the port's
StagingBuffer + WeightPublisher + Watchdog composition under
instrumentation (nightly AND slow, as the reference's). The GPU smoke's
phase 25 runs the flagship learner under this monitor on the card.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from dotaclient_tpu.analysis.lockcheck import LockMonitor as RefLockMonitor
from dotaclient_tpu_torch.analysis.lockcheck import LockMonitor
from torch_sanitizers import inversion_scenario, lockcheck  # noqa: F401 (the port's fixture)


def test_deliberately_inverted_pair_is_detected(lockcheck):
    """Acceptance bar: the fixture detects an A→B / B→A inversion."""
    assert type(lockcheck).__module__ == "dotaclient_tpu_torch.analysis.lockcheck"
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    assert lockcheck.inversions == []  # one order seen: no verdict yet
    with b:
        with a:
            pass
    assert len(lockcheck.inversions) == 1
    inv = lockcheck.inversions[0]
    assert inv["first"] != inv["then"]
    assert "test_torch_lockcheck.py" in inv["first"]


def test_repeated_inversion_reports_once(lockcheck):
    """A hot loop re-nesting a known-inverted pair mints ONE report, not
    one per iteration — a real inversion in the 3 s production soak
    would otherwise bury its single distinct cycle in thousands of
    duplicate entries."""
    a = threading.Lock()
    b = threading.Lock()
    with a:
        with b:
            pass
    for _ in range(100):
        with b:
            with a:
                pass
    assert len(lockcheck.inversions) == 1


def test_inversion_detected_across_threads(lockcheck):
    """The cross-thread shape of the same bug: worker takes A→B, main
    takes B→A (sequenced by an event so the test can never deadlock)."""
    a = threading.Lock()
    b = threading.Lock()
    done = threading.Event()

    def worker():
        with a:
            with b:
                pass
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    assert done.wait(5)
    t.join(5)
    with b:
        with a:
            pass
    assert len(lockcheck.inversions) == 1
    assert lockcheck.inversions[0]["conflicts_with"]["thread"] != threading.current_thread().name


def test_three_lock_cycle_is_detected(lockcheck):
    """No pair is ever reversed, but A→B, B→C, C→A closes a cycle that
    deadlocks under a 3-way interleave — the detector must find general
    cycles, not just reversed pairs."""
    a = threading.Lock()
    b = threading.Lock()
    c = threading.Lock()
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    assert lockcheck.inversions == []  # still acyclic
    with c:
        with a:
            pass
    assert len(lockcheck.inversions) == 1, lockcheck.inversions
    cycle = lockcheck.inversions[0]["cycle"]
    assert cycle[0] == cycle[-1] or len(set(cycle)) == 3, cycle
    assert len(set(cycle)) == 3  # the three distinct creation sites


def test_consistent_order_is_clean(lockcheck):
    a = threading.Lock()
    b = threading.Lock()
    for _ in range(3):
        with a:
            with b:
                pass
    assert lockcheck.inversions == []
    assert lockcheck.acquisitions >= 6


def test_over_held_lock_is_recorded():
    monitor = LockMonitor(hold_threshold_s=0.02)
    with monitor:
        lock = threading.Lock()
        with lock:
            time.sleep(0.05)
        with lock:
            pass  # short hold: normally not recorded
    # >= not ==: the "short" hold only needs a >20ms scheduler stall on
    # a loaded box to be recorded too — the deliberate one must be.
    assert any(o["held_s"] >= 0.05 for o in monitor.over_held), monitor.over_held
    assert all("test_torch_lockcheck.py" in o["site"] for o in monitor.over_held)


def test_condition_on_instrumented_lock_roundtrips(lockcheck):
    """threading.Condition built on an instrumented lock must work — the
    WeightPublisher/checkpoint mirror pattern."""
    lock = threading.Lock()
    cond = threading.Condition(lock)
    box = []

    def producer():
        with cond:
            box.append(1)
            cond.notify()

    t = threading.Thread(target=producer)
    with cond:
        t.start()
        assert cond.wait_for(lambda: box, timeout=5)
    t.join(5)
    assert box == [1]
    assert lockcheck.inversions == []


def test_default_condition_lock_is_instrumented(lockcheck):
    """threading.Condition() with no lock (the WeightPublisher/_mirror
    pattern): its backing RLock would be created inside threading.py and
    escape the scope filter — the patched Condition factory attributes
    it to the Condition() call site instead."""
    cond = threading.Condition()
    assert hasattr(cond._lock, "site")
    assert "test_torch_lockcheck.py" in cond._lock.site
    with cond:
        cond.notify_all()
    assert lockcheck.acquisitions >= 1


def test_condition_wait_is_not_counted_as_holding():
    """waiting is not holding: a long cond.wait must not produce an
    over_held record, but a long hold WITHOUT waiting must."""
    monitor = LockMonitor(hold_threshold_s=0.05)
    with monitor:
        cond = threading.Condition()
        with cond:
            cond.wait(timeout=0.25)  # releases the lock for the wait
        # if waiting counted as holding, held_s would be >= the 0.25s
        # wait; threshold-scale entries from a scheduler stall are not
        # the bug this test is about
        waited = [o for o in monitor.over_held if o["held_s"] >= 0.2]
        assert waited == [], monitor.over_held
        with cond:
            time.sleep(0.1)  # genuinely held past the threshold
    assert any(o["held_s"] >= 0.1 for o in monitor.over_held), monitor.over_held


def test_cross_thread_release_leaves_no_phantom(lockcheck):
    """threading.Lock legally allows acquire-in-A/release-in-B handoff;
    the releasing thread must strip the entry from the ACQUIRING
    thread's held-stack, or every later acquisition on A records a
    false phantom→X order edge."""
    handoff = threading.Lock()
    other = threading.Lock()
    handoff.acquire()
    t = threading.Thread(target=handoff.release)
    t.start()
    t.join(5)
    with other:  # a phantom would mint a handoff→other edge here
        pass
    report = lockcheck.report()
    assert report["edges"] == 0, report
    assert lockcheck.inversions == []


def test_handoff_stale_timestamp_does_not_inflate_later_hold():
    """Acquire timestamps ride in the holder entries, not a per-thread
    clock: after an acquire-in-A/release-in-B handoff, a stale A-side
    timestamp would make A's NEXT release of the same lock compute
    held_s from the long-gone original acquire — a false over_held from
    the harness that exists to report real ones."""
    monitor = LockMonitor(hold_threshold_s=0.2)
    with monitor:
        lock = threading.Lock()
        lock.acquire()  # main acquires...
        t = threading.Thread(target=lock.release)
        t.start()
        t.join(5)  # ...worker releases (handoff out)
        time.sleep(0.25)  # a stale main-side timestamp now exceeds the threshold
        got = threading.Event()
        done = threading.Event()

        def reacquire():
            lock.acquire()
            got.set()
            done.wait(5)

        t2 = threading.Thread(target=reacquire, daemon=True)
        t2.start()
        assert got.wait(5)
        lock.release()  # handoff back: main releases the worker's ~0ms hold
        done.set()
        t2.join(5)
    fake = [o for o in monitor.over_held if o["held_s"] >= 0.2]
    assert fake == [], monitor.over_held


def test_handoff_gap_reacquire_keeps_the_live_hold():
    """The race inside a handoff release: A holds, B releases, and A
    re-acquires in the gap between B's real release and B's bookkeeping
    callback. B's release must consume A's OLDEST entry (the phantom
    from the original acquire), not the live re-acquire — eating the
    live timestamp leaves the stale phantom to inflate A's real release
    into a false over_held. The gap is reproduced deterministically by
    running B's two release steps (real release, then bookkeeping)
    around A's re-acquire."""
    monitor = LockMonitor(hold_threshold_s=0.05)
    with monitor:
        lock = threading.Lock()
        lock.acquire()  # A (main): holders = [(A, t0)]
        now = time.monotonic()
        lock._real.release()  # B's step 1: the real handoff release
        time.sleep(0.1)  # t0 goes stale past the threshold
        lock.acquire()  # A re-acquires in the gap: [(A, t0), (A, t1)]
        t = threading.Thread(target=monitor.on_released, args=(lock, now))
        t.start()  # B's step 2: bookkeeping must strip the (A, t0) phantom
        t.join(5)
        lock.release()  # A's real release of the ~0ms live hold
    fake = [o for o in monitor.over_held if o["held_s"] >= 0.05]
    assert fake == [], monitor.over_held


def test_handoff_over_held_blames_the_holder():
    """On a handoff release the current thread is just the messenger —
    the over_held report must name the thread that HELD the lock."""
    monitor = LockMonitor(hold_threshold_s=0.05)
    with monitor:
        lock = threading.Lock()
        lock.acquire()  # MainThread holds...
        time.sleep(0.1)  # ...past the threshold
        t = threading.Thread(target=lock.release, name="releaser")
        t.start()
        t.join(5)
    blamed = [o["thread"] for o in monitor.over_held if o["held_s"] >= 0.1]
    assert blamed == ["MainThread"], monitor.over_held


def test_nested_condition_wait_restores_all_hold_levels():
    """A depth-2 `with cond:` hold around a wait(): _release_save drops
    both recorded levels, so _acquire_restore must mirror both back —
    restoring one entry would starve the OUTER release's bookkeeping
    (its hold time and order edges silently vanish)."""
    monitor = LockMonitor(hold_threshold_s=0.05)
    with monitor:
        cond = threading.Condition()
        with cond:
            with cond:
                cond.wait(timeout=0.02)
                time.sleep(0.1)  # genuinely held past the threshold, post-wait
        assert cond._lock._holders == []  # fully released, no leftovers
    # BOTH releases must see the restore timestamp: inner ~0.1s,
    # outer ~0.1s+ε — a single restored entry yields only one report
    long_holds = [o for o in monitor.over_held if o["held_s"] >= 0.1]
    assert len(long_holds) == 2, monitor.over_held


def test_scope_root_none_instruments_everything(tmp_path):
    """scope_root=None disables the creation-site filter — the fixture
    corpus use case, where lint fixtures live under a tmp path far from
    the repo checkout."""
    src = "import threading\nlock = threading.Lock()\n"
    corpus = tmp_path / "corpus_mod.py"
    corpus.write_text(src)
    with LockMonitor(scope_root=None) as monitor:
        ns = {}
        exec(compile(src, str(corpus), "exec"), ns)
        # thread bootstrap under instrument-everything: a new thread's
        # Event/Condition are instrumented too, and mid-bootstrap
        # current_thread() would mint a _DummyThread whose own Event
        # re-enters the monitor — must not recurse (see _thread_name)
        ran = []
        t = threading.Thread(target=lambda: ran.append(1))
        t.start()
        t.join(5)
        assert ran == [1]
    assert hasattr(ns["lock"], "site")
    assert str(corpus) in ns["lock"].site


def test_out_of_scope_locks_stay_native(lockcheck):
    """stdlib/queue/JAX locks must not be instrumented — only locks
    created by repo files are wrapped."""
    import queue

    q = queue.Queue()
    q.put(1)
    assert q.get() == 1
    # queue's internal mutex was created inside the stdlib → native type
    assert not hasattr(q.mutex, "site")


def test_uninstalled_monitor_locks_go_inert():
    """A lock that outlives its monitor in module/registry state (a
    broker hub, a cached transport) must stop feeding the dead graph
    after uninstall — no acquisition counting, no over_held growth, no
    phantom holder entries — while still working as the wrapped
    native."""
    monitor = LockMonitor(hold_threshold_s=0.01)
    with monitor:
        lock = threading.Lock()
    base = monitor.acquisitions
    lock.acquire()
    time.sleep(0.05)  # would exceed the threshold if still instrumented
    lock.release()
    assert monitor.acquisitions == base
    assert monitor.over_held == []
    assert lock._holders == []
    assert lock.acquire(False)  # still a functioning lock
    lock.release()


def test_uninstall_restores_native_factory():
    monitor = LockMonitor()
    native = threading.Lock
    monitor.install()
    try:
        assert threading.Lock is not native
    finally:
        monitor.uninstall()
    assert threading.Lock is native
    lock = threading.Lock()
    assert not hasattr(lock, "site")


def test_nonblocking_and_timeout_acquire(lockcheck):
    lock = threading.Lock()
    assert lock.acquire(blocking=False)
    assert not lock.acquire(blocking=False)  # failed acquire: no record
    lock.release()
    assert lock.acquire(timeout=1)
    lock.release()
    assert lockcheck.inversions == []


def test_same_inversions_as_the_reference():
    """The scripted scenario (an inverted pair, a three-lock cycle) under
    the reference's LockMonitor and under the port's: the same two
    inversions, cycle for cycle, site for site."""
    reports = []
    for cls in (RefLockMonitor, LockMonitor):
        with cls() as monitor:
            inversion_scenario()
        reports.append(monitor.report())
    ref, port = reports
    assert len(port["inversions"]) == 2, port
    assert port["inversions"] == ref["inversions"]
    assert (port["edges"], port["acquisitions"]) == (ref["edges"], ref["acquisitions"])
    assert all("torch_sanitizers.py" in site for inv in port["inversions"] for site in inv["cycle"])


@pytest.mark.nightly
@pytest.mark.slow
def test_production_lock_graph_soak(lockcheck):
    """The port's staging (replay on) + publisher + watchdog threads under
    instrumentation for a few hundred frames: no inversion, no lock held
    for seconds."""
    from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig, WatchdogConfig
    from dotaclient_tpu_torch.obs.watchdog import Watchdog
    from dotaclient_tpu_torch.runtime.learner import WeightPublisher
    from dotaclient_tpu_torch.runtime.staging import StagingBuffer
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect
    from torch_sanitizers import port_frames

    L, H = 4, 8
    cfg = LearnerConfig(batch_size=4, seq_len=L, native_packer=False, platform="cpu",
                        policy=PolicyConfig(unit_embed_dim=16, lstm_hidden=H, mlp_hidden=16))
    cfg.replay.enabled = True
    mem.reset("torch-lockcheck-soak")
    broker = connect("mem://torch-lockcheck-soak")
    version = {"v": 0}
    staging = StagingBuffer(cfg, broker, version_fn=lambda: version["v"]).start()
    publisher = WeightPublisher(broker, lambda payload: payload).start()
    latest = {"loss": 1.0}
    watchdog = Watchdog(WatchdogConfig(enabled=True, interval_s=0.01), lambda: dict(latest),
                        lambda: version["v"]).start()
    frames = port_frames(4, L=L, H=H)
    try:
        deadline = time.monotonic() + 3.0
        i = 0
        while time.monotonic() < deadline:
            broker.publish_experience(frames[i % len(frames)])
            publisher.submit([("w", np.ones(4, np.float32))], i)
            if i % 10 == 0:
                staging.stats()
                watchdog.verdict()
                version["v"] = min(version["v"] + 1, 8)
                staging.get_batch(timeout=0.01)
            if i % 25 == 0:
                assert staging.snapshot_state(timeout=1.0) is not None
            i += 1
            if i % 50 == 0:
                time.sleep(0.01)
        staging.quiesce()
        drain_deadline = time.monotonic() + 5.0
        while not staging.drained() and time.monotonic() < drain_deadline:
            staging.get_batch(timeout=0.05)
        assert staging.drained()
        assert staging.snapshot_state(timeout=1.0) is not None
    finally:
        watchdog.stop()
        staging.stop()
        publisher.stop()

    report = lockcheck.report()
    assert report["inversions"] == [], report
    stuck = [o for o in report["over_held"] if o["held_s"] > 1.0]
    assert stuck == [], report["over_held"]
    assert report["acquisitions"] > 100
