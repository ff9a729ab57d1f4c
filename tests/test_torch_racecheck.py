"""The port's race sanitizer (dotaclient_tpu_torch/analysis/racecheck.py),
twin of tests/test_racecheck.py: the vector-clock happens-before
sanitizer, graftcheck's dynamic race half.

The deterministic tests drive each HB edge directly (a race is a
property of the clock ORDER, so a true race is detectable even when the
schedule serializes the writes). The port adds CUDA events as an edge
(record → a completed query / synchronize), tested here on a fake event
class with the same host surface; the GPU smoke's phase 25 runs it on
torch.cuda.Event beside the flagship learner. One test runs the same
scripted scenario under the reference's monitor and the port's and holds
them to the same report. The nightly soak runs the port's staging pool
mode + publisher + checkpoint worker + serve hot-swap (nightly AND slow,
as the reference's).
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import pytest

from dotaclient_tpu.analysis.racecheck import RaceMonitor as RefRaceMonitor
from dotaclient_tpu_torch.analysis.racecheck import RaceMonitor
from torch_sanitizers import racecheck, race_scenario  # noqa: F401 (the port's fixture)


class Box:
    """Plain watched object; attribute writes are the race surface."""

    def __init__(self):
        self.x = 0


class FakeEvent:
    """A device event's host surface (record / query / synchronize), for
    watch_events on the CPU: complete once `done` is set."""

    def __init__(self):
        self.done = False

    def record(self, stream=None):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        while not self.done:
            time.sleep(0.001)


def _run_thread(fn, name=None):
    t = threading.Thread(target=fn, name=name)
    t.start()
    return t


# ----------------------------------------------------------- detection


def test_unsynchronized_write_write_race_is_detected(racecheck):
    """Acceptance bar: two threads writing one attribute with no HB edge
    between them is reported, with both sites."""
    assert type(racecheck).__module__ == "dotaclient_tpu_torch.analysis.racecheck"
    box = Box()
    racecheck.watch(box)
    started = threading.Event()

    def worker():
        box.x = 1
        started.set()

    t = _run_thread(worker, name="racer")
    # wait via the NATIVE protocol object below the monitor's radar: a
    # monitored Event would legitimately order the writes and hide the race
    deadline = time.monotonic() + 5
    while not started._real.is_set() and time.monotonic() < deadline:
        time.sleep(0.001)
    box.x = 2
    t.join()
    assert len(racecheck.races) == 1
    race = racecheck.races[0]
    assert race["attr"] == "Box.x"
    assert {race["first_thread"], race["second_thread"]} >= {"racer"}
    assert "test_torch_racecheck.py" in race["first_site"]


def test_race_reported_once_per_site_pair(racecheck):
    """A hot loop re-racing the same pair of sites mints ONE report —
    the soak must not bury one distinct race in thousands of copies."""
    box = Box()
    racecheck.watch(box)
    stop = threading.Event()

    def worker():
        while not stop._real.is_set():
            box.x = 1

    t = _run_thread(worker)
    for _ in range(200):
        box.x = 2
    stop.set()
    t.join()
    assert len(racecheck.races) == 1


# ------------------------------------------------------------ HB edges


def test_lock_conveys_happens_before(racecheck):
    """The main-thread write happens BEFORE t.join(), so the lock's
    release→acquire edge is the ONLY thing ordering the writes — a
    regression in _HBLock's HB bookkeeping fails this test instead of
    hiding behind the join edge."""
    box = Box()
    racecheck.watch(box)
    lk = threading.Lock()
    wrote = []  # plain list: GIL-visible, conveys no monitored HB edge

    def worker():
        with lk:
            box.x = 1
        wrote.append(1)

    t = _run_thread(worker)
    deadline = time.monotonic() + 5
    while not wrote and time.monotonic() < deadline:
        time.sleep(0.001)
    with lk:
        box.x = 2
    t.join()
    assert racecheck.races == []


def test_queue_conveys_happens_before_per_item(racecheck):
    """put → the get that RECEIVES that item: the staging intake's
    pop-thread→assembler handoff edge."""
    box = Box()
    racecheck.watch(box)
    q = queue.Queue()

    def producer():
        box.x = 1
        q.put("frames")

    t = _run_thread(producer)
    assert q.get(timeout=5) == "frames"
    box.x = 2  # ordered: rode the item
    t.join()
    assert racecheck.races == []


def test_event_set_wait_conveys_happens_before(racecheck):
    box = Box()
    racecheck.watch(box)
    ev = threading.Event()

    def worker():
        box.x = 1
        ev.set()

    t = _run_thread(worker)
    assert ev.wait(timeout=5)
    box.x = 2
    t.join()
    assert racecheck.races == []


def test_event_clear_resets_happens_before_scope(racecheck):
    """clear() drops the accumulated shadow clock: a waiter observing a
    LATER set joins only post-clear setters. Without the reset, T4
    would inherit T1's clock through the recycled event and the genuine
    T1/T4 write-write race would be silently masked."""
    box = Box()
    racecheck.watch(box)
    ev = threading.Event()
    t1_done = []  # plain list: no monitored HB edge

    def t1():
        box.x = 1
        ev.set()
        t1_done.append(1)

    a = _run_thread(t1, name="t1")
    deadline = time.monotonic() + 5
    while not t1_done and time.monotonic() < deadline:
        time.sleep(0.001)
    # main never wait()ed on ev, so main is NOT ordered after t1
    ev.clear()
    ev.set()  # slot now carries main's clock only

    def t4():
        assert ev.wait(timeout=5)
        box.x = 2  # ordered after MAIN's set, NOT after t1's write

    b = _run_thread(t4, name="t4")
    b.join()
    a.join()
    assert len(racecheck.races) == 1, racecheck.races
    assert {racecheck.races[0]["first_thread"], racecheck.races[0]["second_thread"]} == {
        "t1",
        "t4",
    }


def test_thread_start_join_convey_happens_before(racecheck):
    box = Box()
    racecheck.watch(box)
    box.x = 1  # before start: ordered into the child

    def worker():
        box.x = 2

    t = _run_thread(worker)
    t.join()
    box.x = 3  # after join: ordered after the child
    assert racecheck.races == []


def test_condition_wait_notify_conveys_happens_before(racecheck):
    box = Box()
    racecheck.watch(box)
    cond = threading.Condition()
    wrote = []

    def worker():
        with cond:
            box.x = 1
            wrote.append(True)
            cond.notify()

    with cond:
        t = _run_thread(worker)
        cond.wait_for(lambda: bool(wrote), timeout=5)
        box.x = 2
    t.join()
    assert racecheck.races == []


def test_task_done_join_conveys_completion_edge(racecheck):
    """queue.task_done → queue.join: the assembler's ingest-visibility
    handshake (drained()'s unfinished_tasks station rides on it)."""
    box = Box()
    racecheck.watch(box)
    q = queue.Queue()
    q.put("work")

    def worker():
        q.get()
        box.x = 1
        q.task_done()

    t = _run_thread(worker)
    q.join()
    box.x = 2
    t.join()
    assert racecheck.races == []


# ------------------------------------------------------- suppressions


def test_suppression_with_reason_files_separately(racecheck):
    box = Box()
    racecheck.watch(box)
    racecheck.suppress("Box.x", "single-reader gauge; drift of one write is fine")
    go = threading.Event()

    def worker():
        box.x = 1
        go.set()

    t = _run_thread(worker)
    deadline = time.monotonic() + 5
    while not go._real.is_set() and time.monotonic() < deadline:
        time.sleep(0.001)
    box.x = 2
    t.join()
    assert racecheck.races == []
    assert len(racecheck.suppressed) == 1
    assert racecheck.suppressed[0]["reason"].startswith("single-reader")


def test_suppression_without_reason_is_refused(racecheck):
    with pytest.raises(ValueError):
        racecheck.suppress("Box.x", "   ")


def test_watch_ignore_list_excludes_attrs(racecheck):
    box = Box()
    racecheck.watch(box, ignore=("x",))
    go = threading.Event()

    def worker():
        box.x = 1
        go.set()

    t = _run_thread(worker)
    deadline = time.monotonic() + 5
    while not go._real.is_set() and time.monotonic() < deadline:
        time.sleep(0.001)
    box.x = 2
    t.join()
    assert racecheck.races == []
    assert racecheck.writes_traced == 0


# ------------------------------------------------------ scope/lifecycle


def test_out_of_scope_primitives_stay_native(racecheck):
    """stdlib-created sync objects keep native types — the lockcheck
    scope discipline, shared."""
    import logging

    # logging's module lock was created inside the stdlib
    handler = logging.Handler()
    assert type(handler.lock).__module__ != "dotaclient_tpu_torch.analysis.racecheck"


def test_uninstall_restores_everything():
    native = (
        threading.Lock,
        threading.Event,
        threading.Thread,
        queue.Queue,
    )
    monitor = RaceMonitor()
    monitor.install()
    try:
        assert threading.Lock is not native[0]
        box = Box()
        monitor.watch(box)
        assert type(box).__setattr__ is not object.__setattr__
        q = queue.Queue()
        lk = threading.Lock()
    finally:
        monitor.uninstall()
    assert (threading.Lock, threading.Event, threading.Thread, queue.Queue) == native
    assert type(box).__setattr__ is object.__setattr__
    box.x = 9  # inert: no bookkeeping into the dead monitor
    assert monitor.writes_traced <= 2
    # minted wrappers that outlive the monitor go inert but keep working
    assert q._monitor is None and lk._monitor is None
    q.put(1)
    assert q.get() == 1 and len(q._hb_fifo) == 0
    with lk:
        pass


def test_dead_object_state_is_pruned(racecheck):
    """id-recycling defense: a collected sync object's shadow clock and
    a collected watched object's last-write entries are pruned at the
    next monitored op, so a new object allocated at the recycled address
    can never inherit a dead object's clock (which would mint false HB
    edges that MASK real races — the thread-uid hazard, object-keyed)."""
    import gc

    lk = threading.Lock()
    with lk:
        pass  # populate the shadow clock
    lock_id = id(lk)
    box = Box()
    racecheck.watch(box)
    box.x = 1
    box_id = id(box)
    with racecheck._state_lock:
        assert lock_id in racecheck._sync_vc
        assert any(k[0] == box_id for k in racecheck._last_write)
    del lk, box
    gc.collect()
    # any monitored op drains the dead-id queue before table use
    with threading.Lock():
        pass
    with racecheck._state_lock:
        assert lock_id not in racecheck._sync_vc
        assert not any(k[0] == box_id for k in racecheck._last_write)


def test_mutual_exclusion_with_lockcheck():
    """One substrate owns threading at a time: installing racecheck over
    an installed lockcheck (or vice versa) is refused loudly."""
    from dotaclient_tpu_torch.analysis.lockcheck import LockMonitor

    lm = LockMonitor().install()
    try:
        with pytest.raises(RuntimeError):
            RaceMonitor().install()
    finally:
        lm.uninstall()
    rm = RaceMonitor().install()
    try:
        with pytest.raises(RuntimeError):
            LockMonitor().install()
    finally:
        rm.uninstall()


def test_instrumented_objects_keep_working_semantics(racecheck):
    """Queue maxsize/timeout, non-blocking lock acquire, event clear —
    the wrappers must be behaviorally transparent."""
    q = queue.Queue(maxsize=1)
    q.put(1)
    with pytest.raises(queue.Full):
        q.put(2, timeout=0.05)
    assert q.get() == 1
    lk = threading.Lock()
    assert lk.acquire(blocking=False)
    assert not lk.acquire(blocking=False)
    lk.release()
    ev = threading.Event()
    assert not ev.wait(timeout=0.01)
    ev.set()
    ev.clear()
    assert not ev.is_set()


# -------------------------------------------------- production surfaces


def test_staging_pool_mode_runs_clean(racecheck):
    """The port's parallel host feed (pop + assembler + pack workers,
    Python packer) under the sanitizer: zero races across a
    quiesce/drain cycle."""
    from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig, StagingConfig
    from dotaclient_tpu_torch.runtime.staging import StagingBuffer
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect
    from torch_sanitizers import port_frames

    cfg = LearnerConfig(
        batch_size=4,
        seq_len=8,
        native_packer=False,
        platform="cpu",
        policy=PolicyConfig(unit_embed_dim=16, lstm_hidden=8, mlp_hidden=16),
        staging=StagingConfig(pack_workers=2),
    )
    mem.reset("torch-racecheck-stage")
    broker = connect("mem://torch-racecheck-stage")
    buf = StagingBuffer(cfg, connect("mem://torch-racecheck-stage"), version_fn=lambda: 0)
    racecheck.watch(buf)
    buf.start()
    try:
        assert buf._pool is not None
        racecheck.watch(buf._pool)
        for f in port_frames(16, L=4, H=8):
            broker.publish_experience(f)
        got = 0
        deadline = time.monotonic() + 20
        while got < 3 and time.monotonic() < deadline:
            if buf.get_batch(timeout=2) is not None:
                got += 1
        assert got == 3
        buf.quiesce()
        deadline = time.monotonic() + 5
        while not buf.drained() and time.monotonic() < deadline:
            buf.get_batch(timeout=0.2)
    finally:
        buf.stop()
    assert racecheck.races == [], racecheck.races
    assert racecheck.writes_traced > 0  # the tracer actually saw the run


def _small_server():
    from dotaclient_tpu_torch.config import InferenceConfig, PolicyConfig
    from dotaclient_tpu_torch.serve.server import InferenceServer

    cfg = InferenceConfig(policy=PolicyConfig(unit_embed_dim=8, lstm_hidden=8, mlp_hidden=8, arch="lstm"),
                          platform="cpu")
    return InferenceServer(cfg, device="cpu")


def test_serve_swap_dual_writer_regression(racecheck):
    """swap_params (the publisher's hook thread) racing the weight-poll
    thread on params / version / _bundles / weight_swaps_total: the port's
    _swap_lock orders them — zero reports and an exact swap count."""
    srv = _small_server()
    racecheck.watch(srv)
    params = srv.params

    def swapper(base):
        for v in range(base, base + 15):
            srv.swap_params(params, v)

    threads = [
        threading.Thread(target=swapper, args=(b,), name=n)
        for b, n in ((100, "publisher-hook"), (200, "serve-weights"))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert racecheck.races == [], racecheck.races
    assert srv.weight_swaps_total == 30  # no lost update


def test_unlocked_swap_is_reported(racecheck):
    """The mutant of the regression above: a swap writing the same fields
    without _swap_lock from two threads is a race report on the server."""
    srv = _small_server()
    racecheck.watch(srv)
    params, wrote = srv.params, []

    def unlocked(v):
        srv.version = v
        wrote.append(v)

    a = threading.Thread(target=unlocked, args=(1,), name="publisher-hook")
    a.start()
    deadline = time.monotonic() + 5
    while not wrote and time.monotonic() < deadline:
        time.sleep(0.001)
    b = threading.Thread(target=unlocked, args=(2,), name="serve-weights")
    b.start()
    b.join()
    a.join()
    assert params is srv.params
    assert [r["attr"] for r in racecheck.races] == ["InferenceServer.version"]


def test_production_inert_without_fixture():
    """Importing the port's staging, learner and server never imports a
    sanitizer, and threading stays native (checked in a fresh process)."""
    import subprocess
    import sys

    code = (
        "import sys, threading\n"
        "import dotaclient_tpu_torch.runtime.staging, dotaclient_tpu_torch.runtime.learner\n"
        "import dotaclient_tpu_torch.serve.server\n"
        "bad = [m for m in sys.modules if m.startswith('dotaclient_tpu_torch.analysis.')]\n"
        "assert bad == [], bad\n"
        "assert threading.Thread.__module__ == 'threading'\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# ------------------------------------------------------- device events


def test_event_record_then_query_conveys_happens_before(racecheck):
    """A copy's event: the writer records it after its write, the other
    thread writes once query() observes completion — ordered, no race;
    the same handoff with the query skipped is a race."""
    racecheck.watch_events(FakeEvent)
    box = Box()
    racecheck.watch(box)
    ev = FakeEvent()
    recorded = []

    def writer():
        box.x = 1
        ev.record()
        ev.done = True
        recorded.append(1)

    t = _run_thread(writer, name="copy-side")
    deadline = time.monotonic() + 5
    while not recorded and time.monotonic() < deadline:
        time.sleep(0.001)
    assert ev.query()
    box.x = 2  # ordered by the observed completion
    t.join()
    assert racecheck.races == []
    assert (racecheck.event_records, racecheck.event_observed) == (1, 1)

    other = Box()
    racecheck.watch(other)
    ev2 = FakeEvent()
    recorded.clear()

    def writer2():
        other.x = 1
        ev2.record()
        ev2.done = True
        recorded.append(1)

    t = _run_thread(writer2, name="copy-side-2")
    deadline = time.monotonic() + 5
    while not recorded and time.monotonic() < deadline:
        time.sleep(0.001)
    other.x = 2  # no query, no synchronize: unordered
    t.join()
    assert [r["attr"] for r in racecheck.races] == ["Box.x"]


def test_event_synchronize_conveys_and_rerecord_replaces(racecheck):
    """synchronize() joins the recorder's clock; a re-record by another
    thread replaces the shadow, so an observer of the new record is not
    ordered after the first recorder."""
    racecheck.watch_events(FakeEvent)
    box = Box()
    racecheck.watch(box)
    ev = FakeEvent()

    def writer():
        box.x = 1
        ev.record()
        ev.done = True

    t = _run_thread(writer, name="first-recorder")
    ev.synchronize()
    box.x = 2
    t.join()
    assert racecheck.races == []

    late = Box()
    racecheck.watch(late)
    step, wrote = FakeEvent(), []

    def first():
        late.x = 1
        step.record()
        step.done = True
        wrote.append(1)

    a = _run_thread(first, name="rec-a")
    deadline = time.monotonic() + 5
    while not wrote and time.monotonic() < deadline:
        time.sleep(0.001)

    def second():
        step.record()  # replaces rec-a's clock in the shadow
        step.done = True

    b = _run_thread(second, name="rec-b")
    b.join()
    assert step.query()
    late.x = 2  # ordered after rec-b only: a race with rec-a's write
    a.join()
    assert [r["attr"] for r in racecheck.races] == ["Box.x"]


def test_unrecorded_event_conveys_nothing(racecheck):
    """An event never recorded under the monitor (query() True at birth)
    joins no clock."""
    racecheck.watch_events(FakeEvent)
    box = Box()
    racecheck.watch(box)
    wrote = []

    def writer():
        box.x = 1
        wrote.append(1)

    t = _run_thread(writer, name="writer")
    deadline = time.monotonic() + 5
    while not wrote and time.monotonic() < deadline:
        time.sleep(0.001)
    fresh = FakeEvent()
    fresh.done = True
    assert fresh.query()
    box.x = 2
    t.join()
    assert len(racecheck.races) == 1
    assert racecheck.event_observed == 0


def test_watch_events_uninstall_restores_the_class():
    orig = {name: FakeEvent.__dict__[name] for name in ("record", "query", "synchronize")}
    monitor = RaceMonitor().install()
    try:
        monitor.watch_events(FakeEvent)
        assert FakeEvent.__dict__["query"] is not orig["query"]
        ev = FakeEvent()
        ev.record()
    finally:
        monitor.uninstall()
    assert {name: FakeEvent.__dict__[name] for name in orig} == orig
    assert monitor._events == {}


# ------------------------------------------------------ parity vs reference


def test_same_races_as_the_reference():
    """The scripted write-write pair under the reference's RaceMonitor and
    under the port's: the same one report, thread and site for site."""
    reports = []
    for cls in (RefRaceMonitor, RaceMonitor):
        with cls() as monitor:
            race_scenario(monitor)
        reports.append(list(monitor.races))
    ref, port = reports
    assert len(port) == 1 and port == ref
    assert {port[0]["first_thread"], port[0]["second_thread"]} == {"racer-a", "racer-b"}
    assert "torch_sanitizers.py" in port[0]["first_site"]


# ------------------------------------------------------------- nightly lane


@pytest.mark.nightly
@pytest.mark.slow
def test_staging_serve_race_soak(racecheck):
    """The nightly soak: the port's staging pool mode + WeightPublisher +
    CheckpointWorker + serve hot-swap under the sanitizer for a few
    seconds of sustained traffic — zero unsuppressed races; every
    suppression carries a reason."""
    from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig, StagingConfig
    from dotaclient_tpu_torch.runtime.learner import CheckpointWorker, WeightPublisher
    from dotaclient_tpu_torch.runtime.staging import StagingBuffer
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect
    from torch_sanitizers import port_frames

    cfg = LearnerConfig(
        batch_size=4,
        seq_len=4,
        native_packer=False,
        platform="cpu",
        policy=PolicyConfig(unit_embed_dim=16, lstm_hidden=8, mlp_hidden=16),
        staging=StagingConfig(pack_workers=3),
    )
    mem.reset("torch-racecheck-soak")
    broker = connect("mem://torch-racecheck-soak")
    buf = StagingBuffer(cfg, connect("mem://torch-racecheck-soak"), version_fn=lambda: 0)
    racecheck.watch(buf)
    buf.start()
    racecheck.watch(buf._pool)
    publisher = WeightPublisher(broker, lambda payload: payload)
    racecheck.watch(publisher)
    publisher.start()
    saved = []
    worker = CheckpointWorker(lambda clone: clone, lambda state, v: saved.append(v))
    racecheck.watch(worker)
    worker.start()
    srv = _small_server()
    racecheck.watch(srv)
    sparams = srv.params
    frames = port_frames(8, L=4, H=8)
    stop = threading.Event()

    def swap_storm():
        v = 0
        while not stop.is_set():
            v += 1
            srv.swap_params(sparams, v)

    storm = threading.Thread(target=swap_storm, name="publisher-hook")
    storm.start()
    try:
        deadline = time.monotonic() + 3.0
        i = 0
        while time.monotonic() < deadline:
            broker.publish_experience(frames[i % len(frames)])
            publisher.submit([("w", np.ones(4, np.float32))], i)
            worker.submit({"s": np.ones(2, np.float32)}, i)
            if i % 16 == 0:
                buf.stats()
                buf.get_batch(timeout=0.05)
                srv.stats()
            i += 1
        buf.quiesce()
        drain_deadline = time.monotonic() + 5
        while not buf.drained() and time.monotonic() < drain_deadline:
            buf.get_batch(timeout=0.2)
    finally:
        stop.set()
        storm.join()
        buf.stop()
        publisher.stop()
        worker.stop()
    report = racecheck.report()
    assert report["races"] == [], report["races"]
    for s in racecheck.suppressed:
        assert s.get("reason", "").strip(), s
    assert report["writes_traced"] > 100
