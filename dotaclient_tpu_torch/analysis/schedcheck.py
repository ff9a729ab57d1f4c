"""Schedcheck (the port's copy of dotaclient_tpu/analysis/schedcheck.py):
deterministic schedule exploration over explicit protocol models of the
port's own concurrency protocols.

Three bug classes no single test schedule hits deterministically: a ring
lease released at copy dispatch (an in-flight host-to-device copy reading
the NEXT batch's bytes), ``drained()`` declaring victory while a popped
batch lives only in a consumer thread's locals (a SIGTERM drain silently
losing frames), and checkpoint-teardown coalescing races. Those protocols
are tiny state machines; this module model-checks them as EXPLICIT
models, exhaustively, over every interleaving up to a bound, so the bug
class is excluded by search, not by luck.

Design:

- A model is a plain-Python object over an immutable-ish ``dict`` state:
  ``init()``, ``threads`` (ids), ``enabled(st, tid)``, ``step(st, tid)``
  (mutates a copy the explorer hands it), ``invariant(st)`` (violation
  strings, checked after every step), ``done(st)`` and
  ``final_check(st)``. Every transition is one atomic region of the real
  code: what happens under one lock hold, or between two preemption
  points.
- ``explore()`` runs a DFS over thread choices with two sound
  reductions: a visited-state set (two schedules reaching the same
  (shared state, pcs) need exploring once), and local-step commutation
  (a transition marked ``local`` touches only its own thread's
  pc/locals, so it commutes with everything and is taken immediately
  without branching). The result says whether the bounded set was
  EXHAUSTED; "zero violations" only counts when it was.
- ``random_walks()`` is the seeded soak mode: long schedules through the
  same models, replayable from the seed.
- Mutants: each model takes a ``mutant=`` knob that re-introduces a bug
  class (``early_release``, ``no_packing_check``, ``downstream_first``,
  ``clear_flag_before_put``, ``no_resubmit``, ``per_row_read``, ...).
  Exploration FINDS each mutant's violation and the protocol as built
  explores clean: the failing-then-fixed schedule, as a regression.

The models, the mutants and the explorer are the reference's, state for
state: the same model explores to the same ExploreResult in both copies.
What each model describes here is the port's code, named in its
docstring, and the port's tests hold each model against it
(tests/test_torch_schedcheck.py): the ring model's lifecycle against
``TransferRing`` / ``RingSlot`` and the learner's lease reaper, the
prefetch model's lane against ``PrefetchLane``, the drained() station
order against ``StagingBuffer.drained()``, the handoff store against
``CarryStore``, the shard-epoch fence against ``ShardFence`` and
``rendezvous_order``. Pure stdlib: importing this module never imports
torch or numpy, so schedule exploration runs before (and independent of)
any accelerator runtime.
"""

from __future__ import annotations

import copy
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = [
    "ExploreResult",
    "explore",
    "random_walks",
    "RingLeaseModel",
    "DrainedModel",
    "CoalesceModel",
    "HotSwapModel",
    "HandoffModel",
    "ShardEpochModel",
    "PrefetchModel",
]


def _freeze(x):
    """Recursively hashable snapshot of a state value (dicts sorted)."""
    if isinstance(x, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_freeze(v) for v in x)
    if isinstance(x, set):
        return tuple(sorted(_freeze(v) for v in x))
    return x


@dataclass
class ExploreResult:
    """Outcome of one exploration. ``exhausted`` is the honesty bit:
    zero violations from a truncated search proves nothing, and the
    acceptance tests assert on BOTH fields."""

    violations: List[str] = field(default_factory=list)
    states: int = 0
    schedules: int = 0  # maximal schedules reaching a terminal state
    exhausted: bool = True

    @property
    def ok(self) -> bool:
        return not self.violations

    def require_exhausted_clean(self) -> "ExploreResult":
        if not self.exhausted:
            raise AssertionError(
                f"exploration truncated at {self.states} states — raise the bound"
            )
        if self.violations:
            raise AssertionError("; ".join(self.violations[:5]))
        return self


def explore(model, max_states: int = 400_000) -> ExploreResult:
    """Exhaustive bounded DFS over every interleaving of `model`.

    Visited-state dedup makes this a stateful search: each reachable
    (shared state, pcs) configuration is expanded once no matter how
    many schedules reach it. Transitions the model marks local (pure
    pc/thread-local moves) are taken immediately without branching —
    they commute with every other transition, the classic
    partial-order-reduction argument. Deadlock (no enabled thread, not
    done) is itself a violation: the cancel-swallow teardown class."""
    res = ExploreResult()
    init = model.init()
    seen = {_freeze(init)}
    stack = [init]
    res.states = 1
    vset = set()

    def report(v: str) -> None:
        if v not in vset:
            vset.add(v)
            res.violations.append(v)

    while stack:
        st = stack.pop()
        enabled = [t for t in model.threads if model.enabled(st, t)]
        if not enabled:
            res.schedules += 1
            if model.done(st):
                for v in model.final_check(st):
                    report(v)
            else:
                report(f"deadlock: no enabled thread in state {model.describe(st)}")
            continue
        local = [t for t in enabled if model.is_local(st, t)]
        choices = local[:1] if local else enabled
        for tid in choices:
            nxt = copy.deepcopy(st)
            model.step(nxt, tid)
            for v in model.invariant(nxt):
                report(v)
            key = _freeze(nxt)
            if key in seen:
                continue
            if res.states >= max_states:
                res.exhausted = False
                continue
            seen.add(key)
            res.states += 1
            stack.append(nxt)
    return res


def random_walks(
    model, runs: int = 200, seed: int = 0, max_steps: int = 10_000
) -> ExploreResult:
    """Seeded random schedules through `model` — the soak mode. Never
    claims exhaustion; replayable from (runs, seed)."""
    res = ExploreResult(exhausted=False)
    rng = random.Random(seed)
    vset = set()
    for _ in range(runs):
        st = model.init()
        for _ in range(max_steps):
            enabled = [t for t in model.threads if model.enabled(st, t)]
            if not enabled:
                break
            tid = rng.choice(enabled)
            model.step(st, tid)
            res.states += 1
            for v in model.invariant(st):
                if v not in vset:
                    vset.add(v)
                    res.violations.append(v)
        res.schedules += 1
        enabled = [t for t in model.threads if model.enabled(st, t)]
        if not enabled:
            if model.done(st):
                for v in model.final_check(st):
                    if v not in vset:
                        vset.add(v)
                        res.violations.append(v)
            else:
                v = f"deadlock: no enabled thread in state {model.describe(st)}"
                if v not in vset:
                    vset.add(v)
                    res.violations.append(v)
    return res


class _Model:
    """Shared trivia: default local/done/describe hooks."""

    threads: Tuple[str, ...] = ()

    def is_local(self, st: dict, tid: str) -> bool:
        return False

    def invariant(self, st: dict) -> List[str]:
        return st.get("violations", [])

    def final_check(self, st: dict) -> List[str]:
        return []

    def describe(self, st: dict) -> str:
        return str({k: v for k, v in sorted(st.items()) if k != "violations"})


# ---------------------------------------------------------------- ring lease


class RingLeaseModel(_Model):
    """The TransferRing slot lifecycle (dotaclient_tpu_torch/parallel/
    fused_io.py TransferRing / RingSlot, the lease taken by
    runtime/staging.py and released by runtime/learner.py _LeaseReaper):

        free --acquire(packer)--> packing --ready-put--> ready
             --learner-get--> in_transfer --release-after-retire--> free

    One packer (the staging assembler) and one learner share `depth`
    slots; the learner's host-to-device copy reads the pinned slot buffer
    ASYNCHRONOUSLY (FusedBatchIO.transfer issues a non-blocking copy on a
    side stream and records an event; the host goes on at once), modeled
    as a dispatch step and a separate retire step (the event completing)
    that observes which batch generation the buffer holds at retire time.
    The protocol invariant: the retire must observe the generation the
    get dispatched; anything else is the early-lease-release corruption
    (the next batch's bytes shipped). The port retires a lease only once
    its copy's event has completed (_LeaseReaper.reap queries or
    synchronizes the event before RingSlot.release).

    ``mutant="early_release"`` re-introduces the bug class: the lease
    returns to the free queue at copy DISPATCH, before the transfer
    retires — exploration finds the packer re-acquiring and repacking
    the slot under the in-flight read. ``mutant="double_release"`` makes
    release non-idempotent twice (models losing ``RingSlot._held``): the
    free queue grows a duplicate and a later acquire hands out a slot
    that is not free."""

    threads = ("packer", "learner")

    def __init__(self, depth: int = 2, batches: int = 3, mutant: Optional[str] = None):
        assert mutant in (None, "early_release", "double_release")
        self.depth = depth
        self.batches = batches
        self.mutant = mutant

    def init(self) -> dict:
        return {
            "free": tuple(range(self.depth)),
            "slot_state": {i: "free" for i in range(self.depth)},
            "slot_gen": {i: 0 for i in range(self.depth)},
            "ready": (),  # (slot, generation at put)
            "in_flight": {},  # slot -> generation the dispatch read
            "p_pc": "acquire",
            "p_slot": None,
            "packed": 0,
            "gen": 0,
            "l_pc": "get",
            "l_slot": None,
            "l_gen": None,
            "consumed": 0,
            "violations": [],
        }

    def enabled(self, st: dict, tid: str) -> bool:
        if tid == "packer":
            if st["p_pc"] == "acquire":
                return st["packed"] < self.batches and bool(st["free"])
            if st["p_pc"] == "put":
                return len(st["ready"]) < 2  # the ready queue's maxsize
            return st["p_pc"] != "done"
        if st["l_pc"] == "get":
            return st["consumed"] < self.batches and bool(st["ready"])
        return st["l_pc"] != "done"

    def step(self, st: dict, tid: str) -> None:
        if tid == "packer":
            pc = st["p_pc"]
            if pc == "acquire":
                sid, st["free"] = st["free"][0], st["free"][1:]
                if st["slot_state"][sid] != "free":
                    st["violations"].append(
                        f"acquire handed out slot {sid} in state "
                        f"{st['slot_state'][sid]} — the free queue holds a "
                        f"duplicate (double release)"
                    )
                st["slot_state"][sid] = "packing"
                st["p_slot"] = sid
                st["p_pc"] = "pack"
            elif pc == "pack":
                sid = st["p_slot"]
                st["gen"] += 1
                st["slot_gen"][sid] = st["gen"]
                if sid in st["in_flight"]:
                    st["violations"].append(
                        f"packer wrote slot {sid} while its H2D transfer was "
                        f"in flight — the device receives the next batch's "
                        f"bytes (the early-lease-release corruption)"
                    )
                st["p_pc"] = "put"
            elif pc == "put":
                sid = st["p_slot"]
                st["slot_state"][sid] = "ready"
                st["ready"] += ((sid, st["slot_gen"][sid]),)
                st["p_slot"] = None
                st["packed"] += 1
                st["p_pc"] = "acquire" if st["packed"] < self.batches else "done"
            return
        pc = st["l_pc"]
        if pc == "get":
            (sid, gen), st["ready"] = st["ready"][0], st["ready"][1:]
            st["slot_state"][sid] = "in_transfer"
            st["l_slot"], st["l_gen"] = sid, gen
            st["l_pc"] = "dispatch"
        elif pc == "dispatch":
            sid = st["l_slot"]
            st["in_flight"][sid] = st["l_gen"]
            if self.mutant == "early_release":
                # the shipped bug: lease back to the packers at dispatch
                st["slot_state"][sid] = "free"
                st["free"] += (sid,)
            st["l_pc"] = "retire"
        elif pc == "retire":
            sid = st["l_slot"]
            observed = st["slot_gen"][sid]
            if observed != st["l_gen"]:
                st["violations"].append(
                    f"transfer of slot {sid} retired holding generation "
                    f"{observed}, dispatched with {st['l_gen']} — H2D read "
                    f"tore across a repack"
                )
            st["in_flight"].pop(sid, None)
            st["consumed"] += 1
            st["l_pc"] = "release"
        elif pc == "release":
            sid = st["l_slot"]
            if self.mutant != "early_release":
                st["slot_state"][sid] = "free"
                st["free"] += (sid,)
                if self.mutant == "double_release":
                    st["free"] += (sid,)  # _held lost: second put
            st["l_slot"] = st["l_gen"] = None
            st["l_pc"] = "get" if st["consumed"] < self.batches else "done"

    def is_local(self, st: dict, tid: str) -> bool:
        # retire/release touch shared slot state; only the terminal pc
        # moves are local — keep the reduction conservative.
        return False

    def done(self, st: dict) -> bool:
        return st["p_pc"] == "done" and st["l_pc"] == "done"

    def final_check(self, st: dict) -> List[str]:
        out = []
        if st["consumed"] != self.batches:
            out.append(
                f"learner consumed {st['consumed']} of {self.batches} batches"
            )
        if self.mutant is None and sorted(st["free"]) != list(range(self.depth)):
            out.append(f"slots lost: free queue ended as {st['free']}")
        return out


# ------------------------------------------------------------------ drained


class DrainedModel(_Model):
    """The SIGTERM-drain zero-loss protocol (dotaclient_tpu_torch/runtime/
    staging.py StagingBuffer.drained(), pool mode): frames move pop-locals → intake → pending → pack-locals →
    ready, and ``drained()`` checks the stations UPSTREAM-first —
    ``_popping`` (under the mutate lock), ``intake.unfinished_tasks``,
    ``(_packing, pending)`` (one lock hold), then ready LAST. The
    controller thread quiesces, trains out ready batches, and polls
    drained(); the invariant is conservation: when drained() returns
    True, every popped frame is either consumed or sitting in _pending
    (the checkpointable leftover) — NEVER in a thread's locals or a
    queue.

    Mutants (each a real bug class):
    - ``no_packing_check``: drained() skips the in-flight pack flag —
      the shipped bug class (batch in assembler locals declared drained).
    - ``downstream_first``: drained() reads the ready queue FIRST; a
      batch crossing pack-locals→ready between the checks is lost.
    - ``clear_flag_before_put``: the assembler clears ``_packing``
      before the ready-queue put lands (the flag pattern's ordering
      contract, inverted)."""

    threads = ("pop", "assembler", "controller")

    def __init__(
        self,
        frames: int = 2,
        batch: int = 1,
        intake_cap: int = 1,
        ready_cap: int = 1,
        mutant: Optional[str] = None,
    ):
        assert mutant in (
            None,
            "no_packing_check",
            "downstream_first",
            "clear_flag_before_put",
        )
        self.frames = frames
        self.batch = batch
        self.intake_cap = intake_cap
        self.ready_cap = ready_cap
        self.mutant = mutant

    def init(self) -> dict:
        return {
            "broker": self.frames,
            "popping": False,
            "pop_local": 0,
            "intake_items": 0,
            "intake_unfinished": 0,
            "asm_local": 0,
            "pending": 0,
            "packing": False,
            "pack_local": 0,
            "ready": 0,
            "consumed": 0,
            "quiesce": False,
            "pop_pc": "idle",
            "asm_pc": "get",
            "ctl_pc": "quiesce",
            "obs": 0,  # drained() read cursor (0 = not mid-check)
            "drained_true": False,
            "violations": [],
        }

    # -- enabledness ---------------------------------------------------

    def enabled(self, st: dict, tid: str) -> bool:
        if tid == "pop":
            if st["pop_pc"] == "idle":
                # loop top: the quiesce check happens BEFORE _popping is
                # set (the real code's loop order)
                return not st["quiesce"] and st["broker"] > 0
            if st["pop_pc"] == "put":
                return st["intake_items"] < self.intake_cap
            return True
        if tid == "assembler":
            if st["asm_pc"] == "get":
                return st["intake_items"] > 0 or st["pending"] >= self.batch
            if st["asm_pc"] == "put_ready":
                return st["ready"] < self.ready_cap
            return True
        # controller: quiesce, then poll drained()/train-out until True
        return not st["drained_true"]

    # -- transitions ---------------------------------------------------

    def step(self, st: dict, tid: str) -> None:
        if tid == "pop":
            pc = st["pop_pc"]
            if pc == "idle":
                st["popping"] = True  # set under the mutate lock
                st["pop_pc"] = "pop"
            elif pc == "pop":
                st["broker"] -= 1
                st["pop_local"] = 1
                st["pop_pc"] = "put"
            elif pc == "put":
                st["intake_items"] += 1
                st["intake_unfinished"] += 1
                st["pop_local"] = 0
                st["pop_pc"] = "clear"
            elif pc == "clear":
                st["popping"] = False  # cleared under the mutate lock
                st["pop_pc"] = "idle"
            return
        if tid == "assembler":
            pc = st["asm_pc"]
            if pc == "get":
                if st["intake_items"] > 0:
                    st["intake_items"] -= 1
                    st["asm_local"] = 1
                    st["asm_pc"] = "ingest"
                else:
                    # nothing in the intake but a batch is pending
                    st["asm_pc"] = "take"
            elif pc == "ingest":
                # one mutate-lock hold: frames land in _pending
                st["pending"] += st["asm_local"]
                st["asm_local"] = 0
                st["asm_pc"] = "task_done"
            elif pc == "task_done":
                st["intake_unfinished"] -= 1
                st["asm_pc"] = "take" if st["pending"] >= self.batch else "get"
            elif pc == "take":
                # ONE lock hold: pop the batch AND set the in-flight flag
                # (the drained() visibility contract)
                st["pending"] -= self.batch
                st["packing"] = True
                st["pack_local"] = self.batch
                st["asm_pc"] = "put_ready"
            elif pc == "put_ready":
                if self.mutant == "clear_flag_before_put":
                    st["packing"] = False
                    st["asm_pc"] = "put_ready2"
                else:
                    st["ready"] += 1
                    st["pack_local"] = 0
                    st["asm_pc"] = "clear_flag"
            elif pc == "put_ready2":
                st["ready"] += 1
                st["pack_local"] = 0
                st["asm_pc"] = "get"
            elif pc == "clear_flag":
                st["packing"] = False
                st["asm_pc"] = "get"
            return
        # controller
        pc = st["ctl_pc"]
        if pc == "quiesce":
            st["quiesce"] = True
            st["ctl_pc"] = "loop"
        elif pc == "loop":
            if st["ready"] > 0:
                # train a ready batch out before re-polling
                st["ready"] -= 1
                st["consumed"] += self.batch
            else:
                st["obs"] = 0
                st["ctl_pc"] = "check"
        elif pc == "check":
            self._drained_read(st)

    def _stations(self) -> List[str]:
        order = ["popping", "unfinished", "packing_pending", "ready"]
        if self.mutant == "no_packing_check":
            order.remove("packing_pending")
            order.append("pending_only")
            order.remove("ready")
            order.append("ready")
        if self.mutant == "downstream_first":
            order = list(reversed(order))
        return order

    def _drained_read(self, st: dict) -> None:
        """One read of the drained() sequence — each check is its own
        interleaving point, exactly like the real method's lock holds."""
        stations = self._stations()
        name = stations[st["obs"]]
        clear = {
            "popping": lambda: not st["popping"],
            "unfinished": lambda: st["intake_unfinished"] == 0,
            "packing_pending": lambda: not st["packing"]
            and st["pending"] < self.batch,
            "pending_only": lambda: st["pending"] < self.batch,
            "ready": lambda: st["ready"] == 0,
        }[name]()
        if not clear:
            st["ctl_pc"] = "loop"  # station busy: retry from the top
            st["obs"] = 0
            return
        st["obs"] += 1
        if st["obs"] < len(stations):
            return
        # every station read clear → drained() returns True
        st["drained_true"] = True
        in_flight = (
            st["pop_local"]
            + st["asm_local"]
            + st["pack_local"]
            + st["intake_items"]
            + st["ready"] * self.batch
        )
        if in_flight:
            st["violations"].append(
                f"drained() returned True with {in_flight} frame(s) still in "
                f"flight (pop_local={st['pop_local']} asm_local={st['asm_local']} "
                f"pack_local={st['pack_local']} intake={st['intake_items']} "
                f"ready={st['ready']}) — a SIGTERM drain would lose them "
                f"(the drained-while-in-locals bug class)"
            )

    def done(self, st: dict) -> bool:
        return st["drained_true"]

    def final_check(self, st: dict) -> List[str]:
        popped = self.frames - st["broker"]
        accounted = st["consumed"] + st["pending"]
        if popped != accounted:
            return [
                f"conservation: {popped} frames popped but only {accounted} "
                f"accounted (consumed {st['consumed']} + pending {st['pending']})"
            ]
        return []


# ------------------------------------------------------------- coalescing


class CoalesceModel(_Model):
    """The latest-wins single-slot worker (CheckpointWorker /
    WeightPublisher / the checkpoint aux+mirror queues): submitters
    overwrite one pending slot under the condition lock and start the
    worker iff it is not in flight; the worker drains until the slot is
    empty, then parks (clearing in-flight under the same lock hold as
    the exit decision). Invariants: the NEWEST submission is always the
    last one written (coalescing may skip, never reorder or lose the
    newest), and the system quiesces with the slot empty and the worker
    parked — a worker exiting while the slot is full is the
    cancel-swallow teardown class.

    ``mutant="no_resubmit"`` drops the submit-side wakeup (submit fills
    the slot but never starts a parked worker): exploration finds the
    newest version stranded."""

    threads = ("submitter", "worker")

    def __init__(self, versions: int = 3, mutant: Optional[str] = None):
        assert mutant in (None, "no_resubmit")
        self.versions = versions
        self.mutant = mutant

    def init(self) -> dict:
        return {
            "pending": None,
            "inflight": False,
            "written": 0,
            "superseded": 0,
            "next_v": 1,
            "w_pc": "parked",
            "w_item": None,
            "violations": [],
        }

    def enabled(self, st: dict, tid: str) -> bool:
        if tid == "submitter":
            return st["next_v"] <= self.versions
        if st["w_pc"] == "parked":
            return st["inflight"]
        return True

    def step(self, st: dict, tid: str) -> None:
        if tid == "submitter":
            # one condition-lock hold: supersede + fill + maybe start
            if st["pending"] is not None:
                st["superseded"] += 1
            st["pending"] = st["next_v"]
            st["next_v"] += 1
            if not st["inflight"] and self.mutant != "no_resubmit":
                st["inflight"] = True
            return
        pc = st["w_pc"]
        if pc == "parked":
            st["w_pc"] = "take"
        elif pc == "take":
            # one lock hold: take-or-park (exit decision under the lock)
            if st["pending"] is None:
                st["inflight"] = False
                st["w_pc"] = "parked"
            else:
                st["w_item"], st["pending"] = st["pending"], None
                st["w_pc"] = "write"
        elif pc == "write":
            if st["w_item"] < st["written"]:
                st["violations"].append(
                    f"worker wrote version {st['w_item']} after {st['written']} "
                    f"— coalescing reordered"
                )
            st["written"] = st["w_item"]
            st["w_item"] = None
            st["w_pc"] = "take"

    def done(self, st: dict) -> bool:
        return (
            st["next_v"] > self.versions
            and st["w_pc"] == "parked"
            and not st["inflight"]
        )

    def final_check(self, st: dict) -> List[str]:
        out = []
        if st["written"] != self.versions:
            out.append(
                f"newest version {self.versions} lost: worker parked with "
                f"written={st['written']} pending={st['pending']} — the "
                f"latest-wins contract broke"
            )
        return out


# --------------------------------------------------------------- hot swap


class HotSwapModel(_Model):
    """The serve hot-swap no-mixed-tick protocol (dotaclient_tpu_torch/
    serve/server.py: the (net, version) bundle under ``_swap_lock``, read
    once per tick by runtime/actor.py ``InferenceBatcher``): a swapper thread publishes (params, version)
    bundles by single reference assignment; the batcher reads the bundle
    ONCE per tick and serves every row of that tick from it. Invariant:
    all rows of one tick carry one version.

    ``mutant="per_row_read"`` re-reads the bundle per row (the code
    shape the ONE-read contract exists to forbid): a swap landing
    mid-tick produces a mixed tick."""

    threads = ("swapper", "batcher")

    def __init__(
        self,
        swaps: int = 2,
        ticks: int = 2,
        rows: int = 2,
        mutant: Optional[str] = None,
    ):
        assert mutant in (None, "per_row_read")
        self.swaps = swaps
        self.ticks = ticks
        self.rows = rows
        self.mutant = mutant

    def init(self) -> dict:
        return {
            "bundle": 0,  # published version
            "swapped": 0,
            "tick": 0,
            "row": 0,
            "tick_v": None,  # version read at tick start
            "tick_rows": (),
            "b_pc": "tick_start",
            "violations": [],
        }

    def enabled(self, st: dict, tid: str) -> bool:
        if tid == "swapper":
            return st["swapped"] < self.swaps
        return st["tick"] < self.ticks

    def step(self, st: dict, tid: str) -> None:
        if tid == "swapper":
            st["swapped"] += 1
            st["bundle"] = st["swapped"]  # one atomic rebind
            return
        pc = st["b_pc"]
        if pc == "tick_start":
            st["tick_v"] = st["bundle"]  # the ONE bundle read
            st["tick_rows"] = ()
            st["row"] = 0
            st["b_pc"] = "row"
        elif pc == "row":
            v = st["bundle"] if self.mutant == "per_row_read" else st["tick_v"]
            st["tick_rows"] += (v,)
            st["row"] += 1
            if st["row"] >= self.rows:
                if len(set(st["tick_rows"])) > 1:
                    st["violations"].append(
                        f"tick {st['tick']} served rows from versions "
                        f"{sorted(set(st['tick_rows']))} — a client observed a "
                        f"mixed tick"
                    )
                st["tick"] += 1
                st["b_pc"] = "tick_start"

    def done(self, st: dict) -> bool:
        return st["swapped"] >= self.swaps and st["tick"] >= self.ticks

    def final_check(self, st: dict) -> List[str]:
        return []


# ---------------------------------------------------------- carry handoff


class HandoffModel(_Model):
    """The session-continuity carry-handoff lifecycle (dotaclient_tpu_torch/
    serve/handoff.py CarryStore + serve/server.py + serve/client.py): stream → durable → failover-
    read → resume.

    One client steps an episode through a serving tier that can be
    killed (kill = resident carry lost, unacked in-flight reply lost,
    un-landed store writes lost; restart is immediate — the in-process
    ServeIncarnations shape). At every chunk boundary the server
    WRITE-AHEAD streams the boundary carry to a keep-two store, THEN
    acks the chunk-fill step. On a failure the client resumes: restore
    the store entry matching its last OBSERVED boundary exactly (or the
    episode-start zeros when no boundary passed), replay its buffered
    partial chunk, re-issue the failed step.

    The carry is modeled as its episode POSITION: a serve of step k from
    carry position != k is the bitwise-divergence violation (the replay
    count is the client's steps-since-boundary, so a wrong restore point
    shifts every subsequent row); an abandon is itself a violation —
    this protocol exists to make replica death an episode non-event.

    Mutants (each a shipped-bug class the fixed protocol excludes):
    - ``handoff_after_ack``: the server acks the chunk-fill step BEFORE
      the store write lands. A kill in the ack→write window leaves the
      client vouched-for boundary missing from the store — the next
      failover's resume finds nothing matching and the episode abandons.
    - ``resume_from_stale``: the server returns the NEWEST store entry
      regardless of the client's boundary. When they differ (e.g. the
      write landed but the kill ate the ack), the restored carry is at
      the wrong position and every replayed/subsequent row diverges.
    - ``single_entry``: the store keeps only the newest entry. The
      previous boundary is load-bearing — write landed + ack lost means
      the store is one boundary AHEAD of the client, and without the
      previous entry the exact-match resume refuses (abandon).
    - ``dup_shift``: a put whose boundary EQUALS the newest entry's
      shifts instead of replacing. Exploration of THIS model found the
      bug during development: a resumed client re-issues its chunk-fill
      step, the server re-writes the same boundary, the duplicate shift
      evicts the previous entry — and a second kill before the re-issued
      ack lands abandons an episode keep-two was supposed to save.
      CarryStore.put replaces on equal episode_step because of this.
    - ``reshard_primary_only`` (requires ``shards`` > 1): after a
      topology change the failover read consults ONLY the key's NEW
      rendezvous primary. Entries written before the reshard still live
      on the OLD primary (rendezvous moves a key only TO the added
      shard — survivors never trade keys), so a post-reshard resume of
      a pre-reshard boundary finds nothing and abandons. The fixed
      protocol walks the key's full shard preference order until an
      exact match — ShardedCarryStore.get mirrors this rule.

    Sharding (``shards`` > 1): the store is N independent keep-two
    shards plus a bounded ``reshard`` thread that ADDS a shard
    mid-episode. Placement models the adversarial rendezvous case — the
    added shard becomes the key's new primary (rendezvous guarantees
    only that a moved key moves TO the new shard), so writes land on
    the newest shard while older boundaries stay where they were.
    Shard REMOVAL is deliberately out of scope: a removed store pod's
    entries are gone (a drain problem, not a read-protocol problem) —
    k8s store scale-down is operator-gated (MIGRATION)."""

    def __init__(
        self,
        steps: int = 5,
        chunk: int = 2,
        kills: int = 2,
        mutant: Optional[str] = None,
        shards: int = 1,
    ):
        assert mutant in (
            None,
            "handoff_after_ack",
            "resume_from_stale",
            "single_entry",
            "dup_shift",
            "reshard_primary_only",
        )
        assert shards >= 1
        assert mutant != "reshard_primary_only" or shards > 1, (
            "reshard_primary_only only differs from the fixed protocol "
            "once a reshard can happen (shards > 1)"
        )
        self.steps = steps
        self.chunk = chunk
        self.kills = kills
        self.mutant = mutant
        self.shards = shards
        self.keep = 1 if mutant == "single_entry" else 2
        # The reshard thread exists only when a topology change can:
        # shards=1 keeps the thread set (and the explored state space)
        # exactly the single-store model's.
        self.threads = ("client", "server", "chaos") + (
            ("reshard",) if shards > 1 else ()
        )

    def init(self) -> dict:
        return {
            "c_steps": 0,  # completed steps (acks consumed)
            "c_boundary": 0,  # last OBSERVED chunk boundary
            "c_pc": "issue",
            "issued": None,  # step index in flight
            "ack": False,  # reply delivered, not yet consumed
            "failed": False,  # connection failure / UNKNOWN_CLIENT pending
            "carry": None,  # server-resident carry position
            "s_pc": "idle",
            "pending_write": None,  # mutant handoff_after_ack: write after ack
            # per-shard retained entry positions, newest first; topo =
            # shards currently in the ring (grows on reshard)
            "stores": ((),),
            "topo": 1,
            "kills": 0,
            "violations": [],
        }

    # -- enabledness ---------------------------------------------------

    def enabled(self, st: dict, tid: str) -> bool:
        if tid == "client":
            if st["c_pc"] == "issue":
                return st["c_steps"] < self.steps and st["issued"] is None
            if st["c_pc"] == "wait":
                return st["ack"] or st["failed"]
            return True  # resume
        if tid == "server":
            if st["s_pc"] == "idle":
                return st["issued"] is not None and not st["ack"] and not st["failed"]
            return True  # write / ack / late_write stages pending
        if tid == "reshard":
            # bounded topology growth while the episode is still running
            return st["topo"] < self.shards and st["c_steps"] < self.steps
        # chaos: bounded kills while the episode is still running
        return st["kills"] < self.kills and st["c_steps"] < self.steps

    # -- transitions ---------------------------------------------------

    @staticmethod
    def _shard_order(st: dict):
        """The key's shard preference order under the CURRENT topology:
        newest shard first (the adversarial-rendezvous primary), older
        shards after — the ordered walk ShardedCarryStore.get runs."""
        return range(st["topo"] - 1, -1, -1)

    def _store_push(self, st: dict, value: int) -> None:
        # Writes land on the key's CURRENT primary (placement is
        # computed at put time, the ShardedCarryStore rule). Per shard,
        # same-boundary puts REPLACE the head entry (a resumed client
        # re-issuing its chunk-fill step re-writes the same boundary;
        # shifting would evict the previous entry keep-two exists for —
        # the dup_shift mutant is that bug, found by exploring this
        # model; CarryStore.put mirrors this rule).
        p = st["topo"] - 1
        shard = st["stores"][p]
        if shard and shard[0] == value and self.mutant != "dup_shift":
            return
        stores = list(st["stores"])
        stores[p] = (value,) + shard[: self.keep - 1]
        st["stores"] = tuple(stores)

    def step(self, st: dict, tid: str) -> None:
        if tid == "client":
            pc = st["c_pc"]
            if pc == "issue":
                st["issued"] = st["c_steps"]
                st["c_pc"] = "wait"
            elif pc == "wait":
                if st["ack"]:
                    st["ack"] = False
                    st["issued"] = None
                    st["c_steps"] += 1
                    if st["c_steps"] % self.chunk == 0:
                        # the reply just consumed vouches for this
                        # boundary (write-ahead made it durable first)
                        st["c_boundary"] = st["c_steps"]
                    st["c_pc"] = "issue"
                else:  # failed
                    st["failed"] = False
                    st["issued"] = None
                    st["c_pc"] = "resume"
            elif pc == "resume":
                if st["c_boundary"] == 0:
                    restored = 0  # episode-start zeros; no store needed
                elif self.mutant == "resume_from_stale":
                    nonempty = [
                        st["stores"][i] for i in self._shard_order(st) if st["stores"][i]
                    ]
                    if not nonempty:
                        st["violations"].append(
                            "episode abandoned: resume found an empty store "
                            "for an observed boundary"
                        )
                        restored = st["c_boundary"]
                    else:
                        restored = nonempty[0][0]  # newest, match ignored
                else:
                    # The fixed read walks the key's FULL shard
                    # preference order (exact match per shard); the
                    # reshard_primary_only mutant stops at the new
                    # primary — pre-reshard boundaries become unreadable.
                    order = list(self._shard_order(st))
                    if self.mutant == "reshard_primary_only":
                        order = order[:1]
                    matches = [
                        e
                        for i in order
                        for e in st["stores"][i]
                        if e == st["c_boundary"]
                    ]
                    if matches:
                        restored = matches[0]
                    else:
                        st["violations"].append(
                            f"episode abandoned: no store entry matches observed "
                            f"boundary {st['c_boundary']} (stores {st['stores']}) — "
                            f"a durable boundary went missing"
                        )
                        restored = st["c_boundary"]  # keep exploring past it
                # replay the buffered partial chunk: steps_since_boundary
                # advances, so a wrong restore point lands off-position
                st["carry"] = restored + (st["c_steps"] - st["c_boundary"])
                st["c_pc"] = "issue"
            return
        if tid == "server":
            pc = st["s_pc"]
            if pc == "idle":
                k = st["issued"]
                if k == 0:
                    st["carry"] = 0  # EPISODE_START reset
                if st["carry"] is None:
                    st["failed"] = True  # UNKNOWN_CLIENT — no resident carry
                    return
                if st["carry"] != k:
                    st["violations"].append(
                        f"served step {k} from carry position {st['carry']} — "
                        f"resumed rows diverge bitwise (stale-carry class)"
                    )
                st["carry"] += 1
                if st["carry"] % self.chunk == 0:  # chunk-fill step
                    if self.mutant == "handoff_after_ack":
                        st["pending_write"] = st["carry"]
                        st["s_pc"] = "ack"
                    else:
                        st["s_pc"] = "write"  # WRITE-AHEAD, then ack
                else:
                    st["s_pc"] = "ack"
            elif pc == "write":
                self._store_push(st, st["carry"])
                st["s_pc"] = "ack"
            elif pc == "ack":
                st["ack"] = True
                st["s_pc"] = "late_write" if st["pending_write"] is not None else "idle"
            elif pc == "late_write":
                self._store_push(st, st["pending_write"])
                st["pending_write"] = None
                st["s_pc"] = "idle"
            return
        if tid == "reshard":
            # controller adds a store shard mid-episode; by adversarial
            # placement it becomes the key's new rendezvous primary.
            # Entries already durable on the old primary stay where they
            # are (rendezvous never moves keys between survivors) — a
            # correct read must keep walking to them.
            st["topo"] += 1
            st["stores"] = st["stores"] + ((),)
            return
        # chaos: kill + immediate restart (the in-process controller
        # shape): resident carry gone, un-landed pipeline work gone, an
        # unacked in-flight step surfaces as a connection failure; a
        # reply already delivered (ack=True) stays delivered.
        st["kills"] += 1
        st["carry"] = None
        st["s_pc"] = "idle"
        st["pending_write"] = None
        if st["issued"] is not None and not st["ack"]:
            st["failed"] = True

    def done(self, st: dict) -> bool:
        return st["c_steps"] >= self.steps

    def final_check(self, st: dict) -> List[str]:
        out = []
        if st["c_steps"] != self.steps:
            out.append(f"episode finished {st['c_steps']} of {self.steps} steps")
        for shard in st["stores"]:
            for e in shard:
                if e % self.chunk != 0:
                    out.append(f"store entry {e} is not a chunk boundary")
        return out


# ------------------------------------------------------------ shard epoch


class ShardEpochModel(_Model):
    """The broker-fabric routing/failover lifecycle (dotaclient_tpu_torch/
    transport/fabric.py FabricBroker + ShardFence + the tcp priority admission):
    route → publish → fence-check → apply.

    One client publishes `chunks` trajectory chunks of one route key
    (increasing seq; priority = seq+1 so later chunks rank higher —
    enough to force priority-admission pressure). The key's rendezvous
    primary is shard A; shard B is the failover successor, with a
    bounded admission queue (cap_b). A chaos thread PARTITIONS A once
    (publishes to it fail; frames it already holds are withheld — the
    stale-shard limbo) and later RESURRECTS it (withheld frames start
    delivering again — the late-delivery hazard the epoch fence exists
    for). `land_on_partition` selects the partition's publish fate:
    True = the frame lands but the ack is lost (the duplicate hazard),
    False = the frame is lost with the ack (the liveness hazard) — HEAD
    must explore clean under BOTH.

    Protocol under test (the FabricBroker/ShardFence rules):
    - a failed publish bumps the KEY's epoch BEFORE republishing the
      same seq to the successor;
    - the consumer fence drops epoch-stale arrivals (counted), dedupes
      same-seq arrivals (counted), applies the rest;
    - shard admission above capacity EVICTS the lowest-priority
      resident (counted) rather than refusing the newcomer.

    Invariants: no seq is ever applied twice (double-counted gradient
    data); every attempted seq is accounted — applied, fence-dropped,
    dup-dropped, priority-evicted, or shed with the client told
    (refused) — never silently lost.

    Mutants (each a real bug class the shipped protocol excludes):
    - ``no_fence``: the consumer applies whatever arrives (no epoch
      check, no seq dedup) — a resurrected A's late copy of a
      republished chunk applies twice.
    - ``reroute_before_drain``: the client re-routes the key to B
      without first resolving (republishing) the nacked in-flight
      chunk — that chunk vanishes with no ledger entry.
    - ``shed_newest``: admission above capacity refuses the NEWCOMER
      (the pre-fabric SHED) — a higher-priority chunk is shed while a
      lower-priority resident survives, the inversion priority
      admission exists to prevent.
    """

    threads = ("client", "net_a", "net_b", "chaos")

    def __init__(
        self,
        chunks: int = 3,
        cap_b: int = 1,
        land_on_partition: bool = True,
        mutant: Optional[str] = None,
    ):
        assert mutant in (None, "no_fence", "reroute_before_drain", "shed_newest")
        self.chunks = chunks
        self.cap_b = cap_b
        self.land = land_on_partition
        self.mutant = mutant

    def init(self) -> dict:
        return {
            "a_q": (),  # (epoch, seq) frames resident in shard A
            "b_q": (),  # (epoch, seq) frames resident in shard B
            "a_part": False,  # A partitioned (publishes fail, delivery withheld)
            "parts": 0,  # partitions executed (bounded to 1)
            "c_seq": 0,  # next fresh chunk index
            "c_epoch": 0,  # the key's publish epoch
            "c_down_a": False,  # client-side failover belief
            "pending": None,  # nacked seq awaiting republish
            "acked": (),  # seqs the client got an ack for
            "refused": (),  # seqs shed back to the client (it knows)
            "evicted": (),  # seqs priority-evicted at admission
            "f_epoch": 0,  # consumer fence: highest epoch seen
            "applied": (),  # apply history (a seq twice = violation)
            "fenced": (),  # epoch-stale drops
            "dup": (),  # same-seq dedup drops
            "violations": [],
        }

    # -- enabledness ---------------------------------------------------

    def _client_done(self, st: dict) -> bool:
        return st["c_seq"] >= self.chunks and st["pending"] is None

    def enabled(self, st: dict, tid: str) -> bool:
        if tid == "client":
            return not self._client_done(st)
        if tid == "net_a":
            return bool(st["a_q"]) and not st["a_part"]
        if tid == "net_b":
            return bool(st["b_q"])
        # chaos: one partition while the client still publishes, and the
        # matching resurrection whenever A is partitioned
        return (st["parts"] == 0 and not self._client_done(st)) or st["a_part"]

    # -- transitions ---------------------------------------------------

    def _apply(self, st: dict, epoch: int, seq: int) -> None:
        """Consumer fence-check + apply for one delivered frame — the
        ShardFence.admit rules (single producer boot)."""
        if self.mutant != "no_fence":
            if epoch < st["f_epoch"]:
                st["fenced"] += (seq,)
                return
            st["f_epoch"] = max(st["f_epoch"], epoch)
            if seq in st["applied"]:
                st["dup"] += (seq,)
                return
        if seq in st["applied"]:
            st["violations"].append(
                f"chunk seq {seq} applied twice — a stale shard's late "
                f"delivery was double-counted (the epoch-fence bug class)"
            )
        st["applied"] += (seq,)

    def _publish_b(self, st: dict, seq: int) -> None:
        """Publish (epoch, seq) to shard B with bounded priority
        admission (priority = seq+1)."""
        if len(st["b_q"]) >= self.cap_b:
            if self.mutant == "shed_newest":
                # the pre-fabric SHED: refuse the newcomer
                resident_min = min(s for _, s in st["b_q"])
                if seq > resident_min:
                    st["violations"].append(
                        f"admission shed chunk seq {seq} (priority {seq + 1}) "
                        f"while lower-priority seq {resident_min} stayed "
                        f"resident — the inversion priority-shed exists to "
                        f"prevent"
                    )
                st["refused"] += (seq,)
                st["pending"] = None
                if seq == st["c_seq"]:
                    st["c_seq"] += 1
                return
            # HEAD: evict the lowest-priority resident, admit the newcomer
            evict_i = min(range(len(st["b_q"])), key=lambda i: st["b_q"][i][1])
            evicted = st["b_q"][evict_i][1]
            st["b_q"] = st["b_q"][:evict_i] + st["b_q"][evict_i + 1 :]
            st["evicted"] += (evicted,)
        st["b_q"] += ((st["c_epoch"], seq),)
        st["acked"] += (seq,)
        st["pending"] = None
        if seq == st["c_seq"]:
            st["c_seq"] += 1

    def step(self, st: dict, tid: str) -> None:
        if tid == "client":
            seq = st["pending"] if st["pending"] is not None else st["c_seq"]
            if not st["c_down_a"]:
                if st["a_part"]:
                    # publish into the partition: maybe lands, ack lost
                    if self.land:
                        st["a_q"] += ((st["c_epoch"], seq),)
                    st["c_down_a"] = True
                    if self.mutant == "reroute_before_drain":
                        # the bug: move the key to B WITHOUT resolving
                        # the nacked chunk — it simply vanishes
                        st["pending"] = None
                        if seq == st["c_seq"]:
                            st["c_seq"] += 1
                    else:
                        # bump the epoch BEFORE the successor sees the
                        # key, then republish the same seq
                        st["c_epoch"] += 1
                        st["pending"] = seq
                else:
                    st["a_q"] += ((st["c_epoch"], seq),)
                    st["acked"] += (seq,)
                    st["pending"] = None
                    if seq == st["c_seq"]:
                        st["c_seq"] += 1
            else:
                self._publish_b(st, seq)
            return
        if tid == "net_a":
            (epoch, seq), st["a_q"] = st["a_q"][0], st["a_q"][1:]
            self._apply(st, epoch, seq)
            return
        if tid == "net_b":
            (epoch, seq), st["b_q"] = st["b_q"][0], st["b_q"][1:]
            self._apply(st, epoch, seq)
            return
        # chaos
        if st["a_part"]:
            st["a_part"] = False  # resurrect: withheld frames deliver again
        else:
            st["a_part"] = True
            st["parts"] += 1

    def done(self, st: dict) -> bool:
        return (
            self._client_done(st)
            and not st["a_q"]
            and not st["b_q"]
            and not st["a_part"]
        )

    def final_check(self, st: dict) -> List[str]:
        out = []
        for seq in range(self.chunks):
            accounted = (
                seq in st["applied"]
                or seq in st["fenced"]
                or seq in st["dup"]
                or seq in st["evicted"]
                or seq in st["refused"]
            )
            if not accounted:
                out.append(
                    f"chunk seq {seq} lost UNACCOUNTED — attempted but in no "
                    f"ledger (applied/fenced/dup/evicted/refused): the "
                    f"reroute-before-drain bug class"
                )
        for seq in set(st["applied"]):
            # acked chunks the fence later dropped are counted losses;
            # an applied chunk must still be unique (also inline-checked)
            if st["applied"].count(seq) > 1:
                out.append(f"chunk seq {seq} applied {st['applied'].count(seq)}x")
        return out


# ------------------------------------------------------------ prefetch lane


class PrefetchModel(_Model):
    """The overlapped learner pipeline lifecycle (dotaclient_tpu_torch/
    runtime/learner.py PrefetchLane + _fetch_next + _LeaseReaper,
    --learner.prefetch):

        ready --lane-take--> fetch-locals --put-dispatch--> in-flight
              --retire--> retired (lease released) --enqueue--> slot
              --loop-take--> train(N+1)  ‖  device still running step N

    One prefetch lane and one loop thread share a depth-1 handoff slot;
    the lane's host-to-device copy reads the staged pinned buffer
    ASYNCHRONOUSLY (a non-blocking copy on FusedBatchIO's side stream,
    its completion an event the host does not wait for), modeled as a
    dispatch step and a separate retire step (the event completing), with the ring-slot repack hazard
    carried over from RingLeaseModel: once the lease is released, the
    packer may re-zero and repack the buffer. A drain controller
    quiesces the source and polls the drained() stations — ready,
    lane-locals (the _inflight flag), handoff slot — before declaring
    the zero-loss verdict.

    Invariants: the retire observes the generation the dispatch read
    (anything else is the early-lease-release corruption); the loop trains only
    RETIRED batches (a batch handed over before its put retired could
    have its lease released and the buffer repacked under the in-flight
    read); drained()==True implies every popped batch was trained or is
    still visibly pending — never held invisibly by the lane.

    The port's lane hands the loop a batch whose copy may still be in
    flight: the loop's stream waits on the copy's event before the step
    reads it (FusedBatchIO.consume), which is the retire the model's loop
    requires, and the lease goes back only through _LeaseReaper once the
    event has completed.

    Mutants (the classes the protocol must exclude):
    - ``release_before_retire``: the lane releases the ring lease at
      put-DISPATCH — the packer repacks under the in-flight transfer
      (the early-lease-release class, one thread further from the loop).
    - ``train_consumes_inflight``: the lane enqueues the batch BEFORE
      the retire, so the loop can train a batch whose transfer is
      un-retired while its lease is already back with the packers.
    - ``drain_ignores_prefetch``: drained() skips the lane stations
      (inflight flag + handoff slot) — a SIGTERM drain declares victory
      over the batch the lane holds (the drained() loss class, one station
      further downstream)."""

    threads = ("packer", "lane", "loop", "drainer")

    def __init__(self, depth: int = 2, batches: int = 3, mutant: Optional[str] = None):
        assert mutant in (
            None,
            "release_before_retire",
            "train_consumes_inflight",
            "drain_ignores_prefetch",
        )
        self.depth = depth
        self.batches = batches
        self.mutant = mutant

    def init(self) -> dict:
        return {
            # ring slots (the staging-side buffers the lane leases)
            "free": tuple(range(self.depth)),
            "slot_gen": {i: 0 for i in range(self.depth)},
            "in_flight": {},  # slot -> generation the dispatch read
            "ready": (),  # (slot, generation) packed, awaiting the lane
            "p_pc": "acquire",
            "p_slot": None,
            "packed": 0,
            "gen": 0,
            # prefetch lane
            "lane_pc": "take",
            "lane_slot": None,
            "lane_gen": None,
            "lane_inflight": False,  # the holding() flag drained() reads
            "handoff": (),  # (slot?, gen, retired) — depth-1 queue
            # loop
            "trained": 0,
            # drain controller
            "quiesce": False,
            "drained_true": False,
            "violations": [],
        }

    # -- enabledness ---------------------------------------------------

    def enabled(self, st: dict, tid: str) -> bool:
        if tid == "packer":
            if st["p_pc"] == "acquire":
                return (
                    not st["quiesce"]
                    and st["packed"] < self.batches
                    and bool(st["free"])
                )
            if st["p_pc"] == "put":
                return len(st["ready"]) < 2
            return st["p_pc"] not in ("acquire", "done")
        if tid == "lane":
            if st["lane_pc"] == "take":
                return bool(st["ready"])
            if st["lane_pc"] == "enqueue":
                return not st["handoff"]  # depth-1 handoff slot
            return st["lane_pc"] != "take"
        if tid == "loop":
            return bool(st["handoff"]) and st["trained"] < self.batches
        # drainer: quiesce once the pipe has material, then poll until
        # the verdict lands
        return not st["drained_true"]

    # -- transitions ---------------------------------------------------

    def step(self, st: dict, tid: str) -> None:
        if tid == "packer":
            pc = st["p_pc"]
            if pc == "acquire":
                sid, st["free"] = st["free"][0], st["free"][1:]
                st["p_slot"] = sid
                st["p_pc"] = "pack"
            elif pc == "pack":
                sid = st["p_slot"]
                st["gen"] += 1
                st["slot_gen"][sid] = st["gen"]
                if sid in st["in_flight"]:
                    st["violations"].append(
                        f"packer repacked slot {sid} under an in-flight H2D "
                        f"read — the device receives the next batch's bytes "
                        f"(the early-release corruption, via the lane)"
                    )
                st["p_pc"] = "put"
            elif pc == "put":
                sid = st["p_slot"]
                st["ready"] += ((sid, st["slot_gen"][sid]),)
                st["p_slot"] = None
                st["packed"] += 1
                st["p_pc"] = "acquire"
            return
        if tid == "lane":
            pc = st["lane_pc"]
            if pc == "take":
                # one region: the pop AND the inflight flag (the
                # holding() visibility contract — set before the batch
                # can live only in lane locals)
                st["lane_inflight"] = True
                (sid, gen), st["ready"] = st["ready"][0], st["ready"][1:]
                st["lane_slot"], st["lane_gen"] = sid, gen
                st["lane_pc"] = "dispatch"
            elif pc == "dispatch":
                sid = st["lane_slot"]
                st["in_flight"][sid] = st["lane_gen"]
                if self.mutant == "release_before_retire":
                    st["free"] += (sid,)  # lease back at dispatch: the bug
                if self.mutant == "train_consumes_inflight":
                    st["lane_pc"] = "enqueue"  # hand over un-retired
                else:
                    st["lane_pc"] = "retire"
            elif pc == "retire":
                sid = st["lane_slot"]
                observed = st["slot_gen"][sid]
                if observed != st["lane_gen"]:
                    st["violations"].append(
                        f"transfer of slot {sid} retired holding generation "
                        f"{observed}, dispatched with {st['lane_gen']} — H2D "
                        f"read tore across a repack"
                    )
                st["in_flight"].pop(sid, None)
                if self.mutant != "release_before_retire":
                    st["free"] += (sid,)  # release AFTER retire (HEAD)
                st["lane_pc"] = "enqueue"
            elif pc == "enqueue":
                retired = st["lane_slot"] not in st["in_flight"]
                st["handoff"] = ((st["lane_slot"], st["lane_gen"], retired),)
                st["lane_slot"] = st["lane_gen"] = None
                # flag cleared AFTER the handoff put (holding() gap rule)
                st["lane_inflight"] = False
                st["lane_pc"] = "take"
            return
        if tid == "loop":
            (sid, gen, retired), st["handoff"] = st["handoff"][0], ()
            if not retired:
                # the mutant path: finish the lifecycle the lane skipped
                # — but the TRAIN below already consumed an un-retired
                # transfer, which is the violation
                st["violations"].append(
                    f"loop trained a batch whose H2D transfer had not "
                    f"retired (slot {sid}) — with the lease released, the "
                    f"packer can repack the buffer under the read"
                )
                st["in_flight"].pop(sid, None)
                st["free"] += (sid,)
            st["trained"] += 1
            return
        # drainer
        if not st["quiesce"]:
            st["quiesce"] = True
            return
        # drained() poll — stations in downstream order: ready, lane
        # locals, handoff slot. One atomic poll per drainer step is
        # CONSERVATIVE for finding the mutant (the real drained() reads
        # stations one lock at a time, strictly weaker), and the mutant
        # must fail even against the strong form — which it does,
        # because the skipped stations are simply never read.
        stations_clear = not st["ready"]
        if self.mutant != "drain_ignores_prefetch":
            stations_clear = (
                stations_clear
                and not st["lane_inflight"]
                and not st["handoff"]
            )
        if stations_clear:
            st["drained_true"] = True
            held = (1 if st["lane_inflight"] else 0) + len(st["handoff"]) + len(st["ready"])
            if held:
                st["violations"].append(
                    f"drained() returned True with {held} batch(es) still "
                    f"held by the prefetch pipe — a SIGTERM drain would "
                    f"lose them (the drained() loss class, prefetch station)"
                )
            if st["packed"] > st["trained"]:
                st["violations"].append(
                    f"drain verdict with {st['packed'] - st['trained']} "
                    f"packed-but-untrained batch(es) unaccounted"
                )

    def is_local(self, st: dict, tid: str) -> bool:
        return False

    def done(self, st: dict) -> bool:
        return st["drained_true"]

    def final_check(self, st: dict) -> List[str]:
        out = []
        if st["trained"] != st["packed"]:
            out.append(
                f"conservation: {st['packed']} batches packed but "
                f"{st['trained']} trained at drain"
            )
        return out


def head_models() -> Dict[str, _Model]:
    """The HEAD-protocol model set the nightly soak and the acceptance
    tests exhaust — one entry per protocol, no mutants."""
    return {
        "ring_lease": RingLeaseModel(depth=2, batches=3),
        "prefetch": PrefetchModel(depth=2, batches=3),
        "drained": DrainedModel(frames=2),
        "coalesce": CoalesceModel(versions=3),
        "hot_swap": HotSwapModel(swaps=2, ticks=2, rows=2),
        "carry_handoff": HandoffModel(steps=5, chunk=2, kills=2),
        # both partition-publish fates: the frame lands with the ack
        # lost (duplicate hazard) and the frame lost with it (liveness)
        "shard_epoch": ShardEpochModel(chunks=3, land_on_partition=True),
        "shard_epoch_lost": ShardEpochModel(chunks=3, land_on_partition=False),
    }
