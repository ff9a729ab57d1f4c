"""The port's schedule checker (dotaclient_tpu_torch/analysis/schedcheck.py)
against the reference's (dotaclient_tpu/analysis/schedcheck.py), and each
of its models against the port's own code.

The copy must explore to the reference's ExploreResult (states, maximal
schedules, exhausted, violation count) for every head model and every
mutant, and replay the reference's seeded random walks. The models then
describe the port: the ring lease against `TransferRing` / `RingSlot` and
the learner's `_LeaseReaper` (a lease goes back only once its copy's event
has completed), the prefetch lane against `PrefetchLane`, the drained()
stations against `StagingBuffer.drained()`'s source, the handoff store
against `CarryStore`, the shard-epoch fence against `ShardFence` and
`rendezvous_order`. Pure stdlib: a subprocess shows the copy imports
neither torch nor numpy."""

from __future__ import annotations

import ast
import queue
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from dotaclient_tpu.analysis import schedcheck as R
from dotaclient_tpu_torch.analysis import schedcheck as P

REPO = Path(__file__).resolve().parents[1]

# (model, constructor kwargs, mutant): every mutant each model accepts, at
# the bounds the reference's tests explore it.
MUTANTS = [
    ("RingLeaseModel", dict(depth=2, batches=3), "early_release"),
    ("RingLeaseModel", dict(depth=2, batches=4), "double_release"),
    ("DrainedModel", dict(frames=2), "no_packing_check"),
    ("DrainedModel", dict(frames=2), "downstream_first"),
    ("DrainedModel", dict(frames=2), "clear_flag_before_put"),
    ("CoalesceModel", dict(versions=3), "no_resubmit"),
    ("HotSwapModel", dict(swaps=2, ticks=2, rows=2), "per_row_read"),
    ("HandoffModel", dict(steps=5, chunk=2, kills=2), "handoff_after_ack"),
    ("HandoffModel", dict(steps=5, chunk=2, kills=2), "resume_from_stale"),
    ("HandoffModel", dict(steps=5, chunk=2, kills=2), "single_entry"),
    ("HandoffModel", dict(steps=5, chunk=2, kills=2), "dup_shift"),
    ("HandoffModel", dict(steps=5, chunk=2, kills=2, shards=2), "reshard_primary_only"),
    ("ShardEpochModel", dict(chunks=3, land_on_partition=True), "no_fence"),
    ("ShardEpochModel", dict(chunks=3, land_on_partition=False), "no_fence"),
    ("ShardEpochModel", dict(chunks=3, land_on_partition=True), "reroute_before_drain"),
    ("ShardEpochModel", dict(chunks=3, land_on_partition=False), "reroute_before_drain"),
    ("ShardEpochModel", dict(chunks=3, land_on_partition=True), "shed_newest"),
    ("ShardEpochModel", dict(chunks=3, land_on_partition=False), "shed_newest"),
    ("PrefetchModel", dict(depth=2, batches=3), "release_before_retire"),
    ("PrefetchModel", dict(depth=2, batches=3), "train_consumes_inflight"),
    ("PrefetchModel", dict(depth=2, batches=3), "drain_ignores_prefetch"),
]


def _summary(r) -> tuple:
    return r.states, r.schedules, r.exhausted, len(r.violations)


@pytest.mark.parametrize("name", sorted(R.head_models()))
def test_head_model_explores_to_the_references_result(name):
    """Every head model of the copy: exhausted, clean, not vacuous, and the
    reference's ExploreResult state for state."""
    mine, theirs = P.explore(P.head_models()[name]), R.explore(R.head_models()[name])
    assert mine.exhausted and mine.violations == [] and mine.states > 10, (name, mine.violations)
    assert _summary(mine) == _summary(theirs)


def test_the_copy_has_the_references_models_and_head_set():
    assert set(P.head_models()) == set(R.head_models())
    assert P.__all__ == R.__all__
    for name in P.__all__:
        assert hasattr(P, name), name


@pytest.mark.parametrize("model,kw,mutant", MUTANTS, ids=[f"{m}-{x}-{i}" for i, (m, _, x) in enumerate(MUTANTS)])
def test_every_mutant_is_caught_as_the_reference_catches_it(model, kw, mutant):
    """Each mutant re-introduces its bug class: the copy's exploration finds
    violations (a shard-epoch mutant under one partition fate at least, the
    test below), with the reference's states, schedules and count."""
    mine = P.explore(getattr(P, model)(mutant=mutant, **kw))
    theirs = R.explore(getattr(R, model)(mutant=mutant, **kw))
    assert mine.violations or model == "ShardEpochModel", (model, mutant)
    assert _summary(mine) == _summary(theirs)


@pytest.mark.parametrize("mutant,needle", [("no_fence", "applied twice"), ("reroute_before_drain", "UNACCOUNTED"),
                                           ("shed_newest", "lower-priority")])
def test_every_shard_epoch_mutant_fails_under_some_partition_fate(mutant, needle):
    hits = [v for land in (True, False)
            for v in P.explore(P.ShardEpochModel(chunks=3, land_on_partition=land, mutant=mutant)).violations]
    assert any(needle in v for v in hits), (mutant, hits[:3])


def test_every_mutant_a_model_accepts_is_listed():
    """MUTANTS covers each model's whole mutant set (read from the copy's
    source), so no bug class goes unchecked against the reference."""
    tree = ast.parse((REPO / "dotaclient_tpu_torch" / "analysis" / "schedcheck.py").read_text())
    accepted = set()
    for cls in (n for n in tree.body if isinstance(n, ast.ClassDef)):
        for node in ast.walk(cls):
            if isinstance(node, ast.Assert) and "mutant" in ast.unparse(node.test):
                for c in ast.walk(node.test):
                    if isinstance(c, ast.Constant) and isinstance(c.value, str):
                        accepted.add((cls.name, c.value))
    assert accepted == {(m, x) for m, _, x in MUTANTS}


def test_random_walks_replay_the_references_and_find_a_mutant():
    mine = P.random_walks(P.DrainedModel(frames=2), runs=30, seed=7)
    theirs = R.random_walks(R.DrainedModel(frames=2), runs=30, seed=7)
    assert (mine.states, mine.schedules, mine.violations) == (theirs.states, theirs.schedules, theirs.violations)
    assert not mine.exhausted
    assert P.random_walks(P.DrainedModel(frames=2, mutant="no_packing_check"), runs=300, seed=7).violations


def test_truncation_and_deadlock_are_reported():
    truncated = P.explore(P.RingLeaseModel(depth=2, batches=3), max_states=5)
    assert not truncated.exhausted
    with pytest.raises(AssertionError, match="truncated"):
        truncated.require_exhausted_clean()

    class Stuck(P._Model):
        threads = ("a",)

        def init(self):
            return {"pc": 0, "violations": []}

        def enabled(self, st, tid):
            return st["pc"] == 0

        def step(self, st, tid):
            st["pc"] = 1

        def done(self, st):
            return False

    assert any("deadlock" in v for v in P.explore(Stuck()).violations)


def test_the_copy_imports_neither_torch_nor_numpy():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        from dotaclient_tpu_torch.analysis.schedcheck import explore, head_models
        for name, m in head_models().items():
            r = explore(m)
            assert r.exhausted and not r.violations, (name, r.violations)
        for mod in ("torch", "numpy", "jax", "dotaclient_tpu"):
            assert mod not in sys.modules, mod
        """)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# ------------------------------------------------ the models against the port


def _small_io():
    from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig
    from dotaclient_tpu_torch.parallel.fused_io import FusedBatchIO
    from dotaclient_tpu_torch.parallel.train_step import batch_template

    cfg = LearnerConfig(batch_size=2, seq_len=2, policy=PolicyConfig(unit_embed_dim=8, lstm_hidden=8, mlp_hidden=8))
    return FusedBatchIO(batch_template(cfg), "cpu", single=True)


def test_ring_model_matches_the_ports_transfer_ring():
    """RingLeaseModel's lifecycle on the port's TransferRing / RingSlot:
    acquire hands out only free slots, re-zeroed (padding NOOP-legal);
    release is idempotent (the double_release mutant is unreachable through
    the API); a released slot comes back through acquire; every slot out is
    backpressure."""
    ring = _small_io().make_ring(2)
    a, b = ring.acquire(timeout=1), ring.acquire(timeout=1)
    assert a is not None and b is not None and a is not b
    assert ring.acquire(timeout=0.05) is None
    zero_mask = a.batch.obs.action_mask.copy()
    a.payload.fill_(7)
    a.release()
    a.release()
    assert ring.occupancy == 1
    c = ring.acquire(timeout=1)
    assert c is a
    assert np.array_equal(c.batch.obs.action_mask, zero_mask)
    assert int(c.payload.numpy().astype(np.int64).sum()) == int(zero_mask.sum())  # only the NOOP-legal mask bytes
    assert ring.acquire(timeout=0.05) is None
    b.release()
    c.release()
    assert ring.occupancy == 0


class _Event:
    """A copy's event: `done` says whether the copy has completed; a
    synchronize completes it."""

    def __init__(self):
        self.done = False
        self.synced = 0

    def query(self):
        return self.done

    def synchronize(self):
        self.synced += 1
        self.done = True


class _Lease:
    def __init__(self, log, i):
        self.log, self.i = log, i

    def release(self):
        self.log.append(self.i)


def test_the_lease_goes_back_only_once_its_copy_has_completed():
    """The model's retire-before-release rule on the port's _LeaseReaper: a
    lease whose copy's event has not completed stays held (the
    early-release mutant's schedule is unreachable); completed ones go back
    oldest first; with every ring slot held the reaper waits for the
    oldest copy before the next fetch; teardown releases the rest."""
    from dotaclient_tpu_torch.runtime.learner import _LeaseReaper

    released, reaper = [], _LeaseReaper()
    e0, e1 = _Event(), _Event()
    reaper.hold(_Lease(released, 0), e0)
    reaper.reap(depth=2)
    assert released == [] and e0.synced == 0  # in flight: held, and the loop does not wait
    reaper.hold(_Lease(released, 1), e1)
    e1.done = True
    reaper.reap(depth=3)
    assert released == [1]  # completed out of order: only the completed one goes back
    reaper.hold(_Lease(released, 2), _Event())
    reaper.reap(depth=2)  # both slots held: wait for the oldest copy, then release it
    assert e0.synced == 1 and released == [1, 0]
    reaper.hold(_Lease(released, 3), None)  # the CPU path: the copy finished before transfer() returned
    reaper.reap(depth=8)
    assert released == [1, 0, 3]
    reaper.release_all()
    assert sorted(released) == [0, 1, 2, 3]


def test_the_learner_holds_each_lease_with_its_copys_event():
    """Where the port's learner takes a lease: `_fetch_next` hands the
    staging lease to the reaper together with the event of the transfer it
    just issued, and reaps before each fetch, never after the copy."""
    src = (REPO / "dotaclient_tpu_torch" / "runtime" / "learner.py").read_text()
    fn = next(n for n in ast.walk(ast.parse(src)) if isinstance(n, ast.FunctionDef) and n.name == "_fetch_next")
    body = ast.unparse(fn)
    assert "self._leases.hold(lease, payload[1])" in body
    assert body.index("self._leases.reap(") < body.index("self.staging.get_batch_groups(")
    assert body.index("self.io.transfer(") < body.index("self._leases.hold(")
    assert ".release()" not in body


def test_prefetch_model_matches_the_ports_lane():
    """PrefetchModel's lane on the port's PrefetchLane: holding() covers
    the whole pop-to-handoff window (no gap a drain could slip through),
    FIFO, the fetch budget caps deliveries, idle waits use none."""
    from dotaclient_tpu_torch.runtime.learner import PrefetchLane

    source = queue.Queue()
    for i in range(3):
        source.put(i)
    seen_holding, box = [], []

    def fetch():
        try:
            item = source.get(timeout=0.3)
        except queue.Empty:
            return None, 0, 0.3, 0.0, None
        seen_holding.append(box[0].holding())
        return item, 1, 0.0, 0.0, None

    lane = PrefetchLane(fetch, depth=1, limit=2)
    box.append(lane)
    lane.start()
    got, deadline = [], time.monotonic() + 5
    while len(got) < 2 and time.monotonic() < deadline:
        try:
            item = lane.get(timeout=0.2)
        except queue.Empty:
            continue
        if item.kind == "batch":
            got.append(item.batch)
    lane.stop()
    assert got == [0, 1] and lane.fetched == 2 and source.qsize() == 1
    assert seen_holding and all(seen_holding)
    assert not lane.holding()


def test_prefetch_lane_holds_a_batch_until_the_loop_takes_it():
    """The model's handoff slot: a batch in the lane's queue is visible to
    holding() until the loop's get, and a drain's exhausted item comes
    after every queued batch (FIFO)."""
    from dotaclient_tpu_torch.runtime.learner import PrefetchLane

    items = iter([("b0", 1), (None, 0)])
    drain = threading.Event()
    drain.set()

    def fetch():
        batch, n = next(items)
        return batch, n, 0.0, 0.0, None

    lane = PrefetchLane(fetch, depth=2, drain=drain, upstream_drained=lambda: True).start()
    deadline = time.monotonic() + 5
    while lane._out.qsize() < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert lane.holding()
    assert [lane.get(timeout=1).kind for _ in range(2)] == ["batch", "exhausted"]
    lane.stop()
    assert not lane.holding()


def _drained_order(path: Path) -> list:
    tree = ast.parse(path.read_text())
    drained = next(n for cls in ast.walk(tree) if isinstance(cls, ast.ClassDef) and cls.name == "StagingBuffer"
                   for n in cls.body if isinstance(n, ast.FunctionDef) and n.name == "drained")
    tagged = []
    for node in ast.walk(drained):
        if isinstance(node, ast.Attribute) and node.attr in ("_popping", "unfinished_tasks", "_packing",
                                                               "_prefetch_probe"):
            tagged.append((node.lineno, node.col_offset, node.attr))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "empty":
            tagged.append((node.lineno, node.col_offset, "ready"))
    order = []
    for _, _, label in sorted(tagged):
        if label not in order:
            order.append(label)
    return order


def test_drained_model_station_order_matches_the_ports_staging():
    """DrainedModel's stations are StagingBuffer.drained()'s check order in
    the port: upstream first (pop locals, intake, pack locals), ready, then
    the prefetch lane (PrefetchModel's station, one hop downstream)."""
    mine = _drained_order(REPO / "dotaclient_tpu_torch" / "runtime" / "staging.py")
    theirs = _drained_order(REPO / "dotaclient_tpu" / "runtime" / "staging.py")
    assert mine == ["_popping", "unfinished_tasks", "_packing", "ready", "_prefetch_probe"]
    assert [s for s in theirs if s != "_prefetch_probe"] == mine[:4]


def test_handoff_model_matches_the_ports_carry_store():
    """HandoffModel's store on the port's CarryStore: exact-match restore
    only, the previous boundary kept, a same-boundary put replacing (the
    dup_shift catch), a third boundary rotating the oldest out, keep < 2
    refused."""
    from dotaclient_tpu_torch.serve.handoff import ST_MISS, ST_OK, ST_STALE, CarryStore

    store, z = CarryStore(), np.zeros(8, np.float32)
    assert store.get(1, 2)[0] == ST_MISS
    store.put(1, 2, 1, z, z)
    assert store.get(1, 2)[0] == ST_OK and store.get(1, 4)[0] == ST_STALE
    store.put(1, 4, 1, z, z)
    assert store.get(1, 2)[0] == ST_OK and store.get(1, 4)[0] == ST_OK
    store.put(1, 4, 2, z, z)
    assert store.get(1, 2)[0] == ST_OK
    store.put(1, 6, 2, z, z)
    assert store.get(1, 2)[0] == ST_STALE
    with pytest.raises(ValueError):
        CarryStore(keep=1)


@pytest.mark.parametrize("arrivals,expected", [
    ([(0, 0), (0, 1), (1, 1), (0, 2)], [True, True, False, False]),
    ([(0, 0), (1, 1), (0, 1)], [True, True, False]),
    ([(0, 1), (1, 1)], [True, False]),
    ([(0, 0), (2, 3), (1, 2)], [True, True, False]),
])
def test_shard_epoch_model_matches_the_ports_fence(arrivals, expected):
    """ShardEpochModel's fence decisions are the port's ShardFence.admit
    (one producer boot) on the arrival orders the model explores: in
    order, a failover republish, a stale copy after / before the
    republish, an ancient epoch."""
    from dotaclient_tpu_torch.transport.fabric import ShardFence

    fence, model = ShardFence(), P.ShardEpochModel()
    st = model.init()
    got_model = []
    for e, s in arrivals:
        before = len(st["applied"])
        model._apply(st, e, s)
        got_model.append(len(st["applied"]) == before + 1)
    assert [fence.admit(7, 100, e, s) for e, s in arrivals] == expected == got_model


def test_shard_epoch_model_matches_the_ports_router():
    """The model's A-primary / B-successor shape is the port's rendezvous
    router: one shard per key, deterministic, and with the primary gone
    its successor is the survivors' first choice."""
    from dotaclient_tpu_torch.transport.fabric import rendezvous_order

    endpoints = ["tcp://shard-a:1", "tcp://shard-b:2", "tcp://shard-c:3"]
    for key in range(64):
        order = rendezvous_order(key, endpoints)
        assert sorted(order) == [0, 1, 2] and rendezvous_order(key, endpoints) == order
        survivors = [e for i, e in enumerate(endpoints) if i != order[0]]
        assert [survivors[i] for i in rendezvous_order(key, survivors)] == [endpoints[j] for j in order[1:]]


@pytest.mark.nightly
@pytest.mark.slow
def test_schedule_soak_deeper_bounds_on_the_copy():
    """The nightly soak on the copy: wider bounds explored exhaustively,
    then long seeded random walks, still clean."""
    deep = {
        "ring_lease": P.RingLeaseModel(depth=3, batches=5),
        "prefetch": P.PrefetchModel(depth=3, batches=4),
        "drained": P.DrainedModel(frames=3, intake_cap=2, ready_cap=2),
        "coalesce": P.CoalesceModel(versions=5),
        "hot_swap": P.HotSwapModel(swaps=3, ticks=3, rows=3),
        "carry_handoff": P.HandoffModel(steps=9, chunk=3, kills=4),
        "carry_handoff_sharded": P.HandoffModel(steps=7, chunk=2, kills=3, shards=3),
    }
    for name, model in deep.items():
        result = P.explore(model, max_states=2_000_000)
        assert result.exhausted and result.violations == [], (name, result.violations)
        walks = P.random_walks(model, runs=500, seed=11, max_steps=20_000)
        assert walks.violations == [], (name, walks.violations)
