"""LIF/WIRE rules: cross-layer lifecycle + wire-spec lint for graftcheck.

Three contracts of the host feed live in prose and golden-byte tests;
these rules make them lint-time mechanical:

LIF001 (error) — TransferRing lease lifecycle. A ``<ring>.acquire(...)``
binding must dispose of the slot on EVERY path: each ``raise`` reachable
after the acquire needs a preceding ``release()``, the function must
either release the lease or return it (ownership transfer to the
learner's fetch), and a straight-line double ``release()`` is flagged
(two packers would then write one buffer concurrently). The consumer
side is keyed on the copy's CUDA event: the learner dispatches a ring
slot's host-to-device copy on a side stream and records an event after
it, so a lease may go back to the packers only once an event of THAT
copy has been synchronised (``ready.synchronize()`` dominating the
release) or observed complete (the release inside the true branch of an
``if`` whose test calls ``ready.query()``). Releasing earlier lets a
packer re-zero and refill the slot under an in-flight copy, and the
device trains on the next batch's bytes. A lease is any name bound from
``<x>.last_batch_lease`` (its events: the names bound from a
``.transfer(...)`` call in the same function), or a name containing
``lease`` in a tuple target (``for lease, ready in self._held``, the
reaper idiom; its events: the tuple's other names). A lease released
with no event of its own copy fenced is a finding, wherever the
release sits.

LIF002 (error) — drained()-station reachability, the zero-loss drain
contract as a lint. In any class that defines ``drained()`` and spawns
worker threads: every ``queue.Queue`` the class constructs on ``self``
must be referenced from ``drained()``'s closure (a queue is a station
frames can occupy; an unchecked one means a SIGTERM drain can declare
victory over frames it cannot see), and every worker thread that POPS
frames (a broker ``consume_*`` call or a ``.get(...)`` on a self queue)
must, somewhere in its closure, set a ``self.<flag>`` that drained()
reads — the ``_popping``/``_packing`` in-flight-locals pattern.

WIRE001 (error) — cross-language wire-spec consistency. The DTR1/DTR3
header and dtype-map layout lives twice: ``transport/serialize.py``
(struct formats + ``_canonical_codes``) and ``csrc/packer.cc``
(``kHeaderBytes``/``kTraceExtBytes``/``kWire*`` + the dtype-map
validation loops). This rule parses BOTH sides into one spec table
(python via ``ast``, C++ via structured regex over the exact idioms the
file uses) and fails on ANY drift: header/trace sizes, wire code values,
or the canonical dtype-map bytes for every (obs f32/bf16 × aux on/off)
combination. The port's packer writes one ``[B, row_bytes]`` buffer
with row strides; its header parse keeps the idioms the regexes read.

All pure stdlib (ast/re/struct) — linting never imports the package,
torch, numpy, or JAX (the core.py contract).
"""

from __future__ import annotations

import ast
import os
import re
import struct
from typing import Dict, List, Optional, Set, Tuple

from dotaclient_tpu_torch.analysis.core import (
    PACKAGE,
    Finding,
    ModuleUnit,
    RepoContext,
    Rule,
    register,
)
from dotaclient_tpu_torch.analysis.thr_rules import _class_model, _self_attr

# ------------------------------------------------------------------ LIF001


def _attr_chain(node: ast.expr) -> str:
    """Dotted name of an attribute chain ('self._ring', 'staging.ring')."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    return ".".join(reversed(parts))


def _is_ring_acquire(call: ast.Call) -> bool:
    """An ``acquire`` whose receiver's TERMINAL component names a ring
    (``self._ring``, ``ring``, ``transfer_ring``). Anchored, not a
    substring match — ``self._wiring_lock.acquire(...)`` is an ordinary
    lock and must not be analyzed as a lease (error-severity false
    positives would force misleading suppressions)."""
    fn = call.func
    if not (isinstance(fn, ast.Attribute) and fn.attr == "acquire"):
        return False
    last = _attr_chain(fn.value).rsplit(".", 1)[-1].lower()
    return last in ("ring", "_ring") or last.endswith("_ring")


def _is_lease_read(value: ast.expr) -> bool:
    return isinstance(value, ast.Attribute) and value.attr == "last_batch_lease"


def _release_calls(fn: ast.AST, names: Set[str]) -> List[ast.Call]:
    out = []
    for sub in ast.walk(fn):
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "release"
            and isinstance(sub.func.value, ast.Name)
            and sub.func.value.id in names
        ):
            out.append(sub)
    return out


def _lease_aliases(fn: ast.AST, first: str) -> Set[str]:
    """`first` plus every simple Name later bound from an alias (the
    ``out, payload, lease = slot.batch, slot.payload, slot`` idiom)."""
    names = {first}
    changed = True
    while changed:
        changed = False
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Assign):
                continue
            targets = sub.targets[0]
            tgt_elts = targets.elts if isinstance(targets, ast.Tuple) else [targets]
            val = sub.value
            val_elts = val.elts if isinstance(val, ast.Tuple) else [val]
            if len(tgt_elts) != len(val_elts):
                continue
            for t, v in zip(tgt_elts, val_elts):
                if (
                    isinstance(t, ast.Name)
                    and isinstance(v, ast.Name)
                    and v.id in names
                    and t.id not in names
                ):
                    names.add(t.id)
                    changed = True
    return names


@register
class RingLeaseLifecycle(Rule):
    id = "LIF001"
    severity = "error"
    doc = (
        "TransferRing lease must be released or returned on every path "
        "(exception edges included); release only after its copy's event"
    )

    def run(self, module: ModuleUnit, ctx: RepoContext) -> List[Finding]:
        findings: List[Finding] = []
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            findings.extend(self._check_packer_side(module, fn))
            findings.extend(self._check_consumer_side(module, fn))
        return findings

    # -- packer side: <ring>.acquire(...) ------------------------------

    def _check_packer_side(self, module: ModuleUnit, fn: ast.AST) -> List[Finding]:
        # EVERY ring-acquire binding in the function is analyzed — a
        # second acquire (a future double-buffered packer) must not
        # slip past because the first one checked out clean.
        binds: List[Tuple[ast.Assign, str]] = []
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call):
                if _is_ring_acquire(sub.value):
                    tgt = sub.targets[0]
                    if isinstance(tgt, ast.Name):
                        binds.append((sub, tgt.id))
        findings: List[Finding] = []
        seen_alias_sets: List[Set[str]] = []
        for bind, first in binds:
            aliases = _lease_aliases(fn, first)
            findings.extend(
                self._check_one_lease(module, fn, bind, first, aliases)
            )
            if aliases not in seen_alias_sets:
                seen_alias_sets.append(aliases)
                # straight-line double release: two release() statements
                # in one block body with no re-acquire between them
                findings.extend(
                    self._double_release(module, fn, aliases, module.qualname_at(bind))
                )
        return findings

    def _check_one_lease(
        self,
        module: ModuleUnit,
        fn: ast.AST,
        bind: ast.Assign,
        first: str,
        aliases: Set[str],
    ) -> List[Finding]:
        qual = module.qualname_at(bind)
        findings: List[Finding] = []
        releases = _release_calls(fn, aliases)
        release_lines = sorted(c.lineno for c in releases)
        returns_lease = any(
            isinstance(sub, ast.Return)
            and sub.value is not None
            and any(
                isinstance(n, ast.Name) and n.id in aliases
                for n in ast.walk(sub.value)
            )
            for sub in ast.walk(fn)
        )
        if not releases and not returns_lease:
            findings.append(
                self.make(
                    module,
                    bind.lineno,
                    f"ring slot acquired into {first!r} is never released "
                    f"nor returned — the ring leaks a slot per call and "
                    f"stalls after transfer_depth batches",
                    context=qual,
                )
            )
            return findings
        # every raise lexically after the acquire needs a preceding
        # release (or the lease was already handed off via return —
        # approximated lexically, the honest-escape-hatch contract), OR
        # an enclosing try whose FINALLY releases the lease — the
        # idiomatic cleanup shape releases on every path by construction
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Raise) or sub.lineno <= bind.lineno:
                continue
            covered = any(bind.lineno < rl <= sub.lineno for rl in release_lines)
            if not covered and self._finally_releases(module, sub, aliases):
                covered = True
            if not covered:
                findings.append(
                    self.make(
                        module,
                        sub.lineno,
                        f"raise after ring acquire leaks the slot bound to "
                        f"{first!r} — release() it on the exception edge "
                        f"(a leaked slot is gone for the process lifetime)",
                        context=qual,
                    )
                )
        return findings

    @staticmethod
    def _finally_releases(
        module: ModuleUnit, raise_stmt: ast.Raise, aliases: Set[str]
    ) -> bool:
        """True when an enclosing Try's finalbody releases the lease —
        that finally runs on the raise's exception edge, so the raise
        cannot leak the slot."""
        for anc in module.ancestors(raise_stmt):
            if isinstance(anc, ast.Try) and anc.finalbody:
                for stmt in anc.finalbody:
                    for sub in ast.walk(stmt):
                        if (
                            isinstance(sub, ast.Call)
                            and isinstance(sub.func, ast.Attribute)
                            and sub.func.attr == "release"
                            and isinstance(sub.func.value, ast.Name)
                            and sub.func.value.id in aliases
                        ):
                            return True
        return False

    def _double_release(
        self, module: ModuleUnit, fn: ast.AST, aliases: Set[str], qual: str
    ) -> List[Finding]:
        findings: List[Finding] = []
        for block_owner in ast.walk(fn):
            for body in (
                getattr(block_owner, "body", None),
                getattr(block_owner, "orelse", None),
                getattr(block_owner, "finalbody", None),
            ):
                if not isinstance(body, list):
                    continue
                seen_release = False
                for stmt in body:
                    if isinstance(stmt, ast.Expr) and isinstance(
                        stmt.value, ast.Call
                    ):
                        call = stmt.value
                        if (
                            isinstance(call.func, ast.Attribute)
                            and call.func.attr == "release"
                            and isinstance(call.func.value, ast.Name)
                            and call.func.value.id in aliases
                        ):
                            if seen_release:
                                findings.append(
                                    self.make(
                                        module,
                                        stmt.lineno,
                                        "ring slot released twice on one "
                                        "path — the free queue gains a "
                                        "duplicate and two packers write "
                                        "one buffer concurrently",
                                        context=qual,
                                    )
                                )
                            seen_release = True
                    elif isinstance(stmt, ast.Assign) and isinstance(
                        stmt.value, ast.Call
                    ):
                        if _is_ring_acquire(stmt.value):
                            seen_release = False
        return findings

    # -- consumer side: the copy-event fence -------------------------

    def _check_consumer_side(self, module: ModuleUnit, fn: ast.AST) -> List[Finding]:
        findings: List[Finding] = []
        for lease, events, scope in _lease_bindings(fn):
            for call in _release_calls(fn, {lease}):
                if scope is not None and not _inside(module, call, scope):
                    continue
                if _event_fenced(module, fn, call, events, scope):
                    continue
                findings.append(
                    self.make(
                        module,
                        call.lineno,
                        f"lease {lease!r} released before its copy's event "
                        f"completed — no synchronize() of that copy's event "
                        f"dominates this release() and it is not under a "
                        f"query() of it, so a packer can re-zero and refill "
                        f"the slot under the in-flight host-to-device read",
                        context=module.qualname_at(call),
                    )
                )
        return findings


_TRANSFER_CALLS = ("transfer",)


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _lease_bindings(fn: ast.AST) -> List[Tuple[str, Set[str], Optional[ast.AST]]]:
    """(lease name, its event names, binding scope) for every lease the
    function binds. Scope is the binding ``for`` loop (fences count only
    inside it: a name synchronised before the loop is another copy's
    event) or, for an assignment, the Assign node itself (fences count
    only after it)."""
    out: List[Tuple[str, Set[str], Optional[ast.AST]]] = []
    transfer_names: Set[str] = set()
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Assign) and any(
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr in _TRANSFER_CALLS
            for n in ast.walk(sub.value)
        ):
            for tgt in sub.targets:
                transfer_names |= _names_in(tgt)
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Assign):
            tgt, val = sub.targets[0], sub.value
            tgts = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
            vals = val.elts if isinstance(val, ast.Tuple) else [val]
            if len(tgts) == len(vals):
                for t, v in zip(tgts, vals):
                    if isinstance(t, ast.Name) and _is_lease_read(v):
                        out.append((t.id, set(transfer_names), sub))
            if isinstance(tgt, ast.Tuple) and not isinstance(val, ast.Tuple):
                out.extend(_tuple_leases(tgt, sub))
        elif isinstance(sub, (ast.For, ast.AsyncFor)) and isinstance(
            sub.target, ast.Tuple
        ):
            out.extend(_tuple_leases(sub.target, sub))
    return out


def _tuple_leases(tgt: ast.Tuple, scope: ast.AST):
    names = [e.id for e in tgt.elts if isinstance(e, ast.Name)]
    for name in names:
        if "lease" in name.lower():
            events = {n for n in names if n != name and n != "_"}
            yield name, events, scope


def _inside(module: ModuleUnit, node: ast.AST, scope: ast.AST) -> bool:
    if isinstance(scope, ast.Assign):
        return node.lineno > scope.lineno
    return any(anc is scope for anc in module.ancestors(node))


def _event_call(node: ast.AST, events: Set[str], methods: Tuple[str, ...]) -> bool:
    """Does `node` contain ``E.<method>()`` with E rooted at one of the
    lease's event names (``ready``, ``payload[1]``)?"""
    for sub in ast.walk(node):
        if (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr in methods
            and _names_in(sub.func.value) & events
        ):
            return True
    return False


def _sync_statement(stmt: ast.stmt, events: Set[str]) -> bool:
    """``E.synchronize()`` as a statement, or under ``if E is not None:``
    / ``if E:`` (no event means the copy was synchronous: a CPU tensor)."""
    if isinstance(stmt, ast.Expr):
        return _event_call(stmt, events, ("synchronize",))
    if isinstance(stmt, ast.If) and _names_in(stmt.test) & events:
        test = stmt.test
        guards = isinstance(test, ast.Name) or (
            isinstance(test, ast.Compare)
            and len(test.ops) == 1
            and isinstance(test.ops[0], ast.IsNot)
        )
        return guards and any(_sync_statement(b, events) for b in stmt.body)
    return False


def _event_fenced(
    module: ModuleUnit,
    fn: ast.AST,
    release_call: ast.Call,
    events: Set[str],
    scope: Optional[ast.AST],
) -> bool:
    """True iff, inside the lease's binding scope, the release sits in
    the true branch of an ``if`` whose test queries or synchronises one
    of the lease's events, or a synchronising statement precedes it in
    its own block or an ancestor block (the fence dominates the
    release)."""
    if not events:
        return False
    parents = module.parents
    stmt: ast.AST = release_call
    while stmt in parents and not isinstance(stmt, ast.stmt):
        stmt = parents[stmt]
    while stmt is not None and stmt is not fn and stmt is not scope:
        parent = parents.get(stmt)
        if (
            isinstance(parent, ast.If)
            and stmt in parent.body
            and _event_call(parent.test, events, ("query", "synchronize"))
        ):
            return True
        for body in (
            getattr(parent, "body", None),
            getattr(parent, "orelse", None),
            getattr(parent, "finalbody", None),
        ):
            if isinstance(body, list) and stmt in body:
                for before in body[: body.index(stmt)]:
                    if isinstance(scope, ast.Assign) and before.lineno <= scope.lineno:
                        continue
                    if _sync_statement(before, events):
                        return True
                break
        stmt = parent
    return False


# ------------------------------------------------------------------ LIF002

_CHANNEL_FACTORIES = {"Queue": "queue", "Thread": "thread"}


@register
class DrainedStationCoverage(Rule):
    id = "LIF002"
    severity = "error"
    doc = (
        "queue/thread added to a drained()-bearing class must be visible "
        "to drained()'s station checks (the zero-loss drain contract)"
    )

    def run(self, module: ModuleUnit, ctx: RepoContext) -> List[Finding]:
        findings: List[Finding] = []
        for cls in ast.walk(module.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            model = _class_model(module, cls)
            drained = model.methods.get("drained")
            if drained is None or not model.spawns_thread():
                continue
            drained_reads = self._closure_attr_reads(model, drained)
            # 1. every self.<attr> = queue.Queue(...) must be read by
            #    drained()'s closure
            for meth in model.methods.values():
                for sub in ast.walk(meth):
                    if not (
                        isinstance(sub, ast.Assign)
                        and isinstance(sub.value, ast.Call)
                    ):
                        continue
                    f = sub.value.func
                    name = (
                        f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
                    )
                    if name != "Queue":
                        continue
                    for tgt in sub.targets:
                        attr = _self_attr(tgt)
                        if attr is not None and attr not in drained_reads:
                            findings.append(
                                self.make(
                                    module,
                                    sub.lineno,
                                    f"queue self.{attr} is a station frames "
                                    f"can occupy, but {cls.name}.drained() "
                                    f"never checks it — a SIGTERM drain can "
                                    f"declare victory over frames it cannot "
                                    f"see (frames lost on a drain)",
                                    context=f"{cls.name}.{model.module.qualname_at(sub).split('.')[-1]}",
                                )
                            )
            # 2. every frame-popping worker must set an in-flight flag
            #    drained() reads (the _popping/_packing pattern)
            for entry in model.worker_entries:
                closure_fns = [entry] + [
                    model.methods[n]
                    for n in model._closure([entry])
                    if n in model.methods
                ]
                if not self._pops_frames(closure_fns):
                    continue
                flags = self._flags_written(closure_fns)
                if not (flags & drained_reads):
                    name = getattr(entry, "name", "<worker>")
                    findings.append(
                        self.make(
                            module,
                            entry.lineno,
                            f"worker {cls.name}.{name} pops frames but sets "
                            f"no in-flight flag drained() reads — frames "
                            f"held in its locals are invisible to the drain "
                            f"(set a self.<flag> under the mutate lock, the "
                            f"_popping/_packing pattern)",
                            context=f"{cls.name}.{name}",
                        )
                    )
        return findings

    @staticmethod
    def _closure_attr_reads(model, drained: ast.FunctionDef) -> Set[str]:
        fns = [drained] + [
            model.methods[n] for n in model._closure([drained]) if n in model.methods
        ]
        reads: Set[str] = set()
        for fn in fns:
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Attribute):
                    attr = _self_attr(sub)
                    if attr is not None:
                        reads.add(attr)
        return reads

    @staticmethod
    def _pops_frames(fns: List[ast.AST]) -> bool:
        for fn in fns:
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Call) and isinstance(
                    sub.func, ast.Attribute
                ):
                    if sub.func.attr.startswith("consume_"):
                        return True
                    if sub.func.attr == "get" and isinstance(
                        sub.func.value, ast.Attribute
                    ):
                        if _self_attr(sub.func.value) is not None:
                            return True
        return False

    @staticmethod
    def _flags_written(fns: List[ast.AST]) -> Set[str]:
        flags: Set[str] = set()
        for fn in fns:
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Assign) and isinstance(
                    sub.value, ast.Constant
                ):
                    if isinstance(sub.value.value, bool):
                        for tgt in sub.targets:
                            attr = _self_attr(tgt)
                            if attr is not None:
                                flags.add(attr)
        return flags


# ----------------------------------------------------------------- WIRE001


class WireSpec:
    """One side's view of the DTR wire contract."""

    def __init__(self):
        self.header_bytes: Optional[int] = None
        self.trace_ext_bytes: Optional[int] = None
        self.codes: Dict[str, int] = {}  # f32/i32/u8/bf16 → wire code
        # canonical dtype-map bytes per (obs_bf16, aux)
        self.maps: Dict[Tuple[bool, bool], bytes] = {}

    def diffs(self, other: "WireSpec") -> List[str]:
        out = []
        if self.header_bytes != other.header_bytes:
            out.append(
                f"header size {self.header_bytes} (py) vs "
                f"{other.header_bytes} (cc)"
            )
        if self.trace_ext_bytes != other.trace_ext_bytes:
            out.append(
                f"trace extension {self.trace_ext_bytes} (py) vs "
                f"{other.trace_ext_bytes} (cc)"
            )
        for k in sorted(set(self.codes) | set(other.codes)):
            if self.codes.get(k) != other.codes.get(k):
                out.append(
                    f"wire code {k}: {self.codes.get(k)} (py) vs "
                    f"{other.codes.get(k)} (cc)"
                )
        for key in sorted(set(self.maps) | set(other.maps)):
            a, b = self.maps.get(key), other.maps.get(key)
            if a != b:
                obs, aux = key
                out.append(
                    f"canonical dtype-map (obs_bf16={obs}, aux={aux}): "
                    f"{list(a) if a else a} (py) vs {list(b) if b else b} (cc)"
                )
        return out


def parse_serialize_spec(path: str) -> Tuple[Optional[WireSpec], List[str]]:
    """The python side: struct formats + wire-code constants + the
    ``_canonical_codes`` list algebra, all by AST."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    spec = WireSpec()
    errors: List[str] = []
    fmts: Dict[str, str] = {}
    code_names: Dict[str, int] = {}
    canon: Optional[ast.FunctionDef] = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            # _HDR = struct.Struct("<...>")
            if (
                isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Attribute)
                and node.value.func.attr == "Struct"
                and node.value.args
                and isinstance(node.value.args[0], ast.Constant)
            ):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        fmts[tgt.id] = node.value.args[0].value
            # _WIRE_F32, _WIRE_I32, _WIRE_U8, _WIRE_BF16 = 0, 1, 2, 3
            if (
                len(node.targets) == 1
                and isinstance(node.targets[0], ast.Tuple)
                and isinstance(node.value, ast.Tuple)
            ):
                for t, v in zip(node.targets[0].elts, node.value.elts):
                    if (
                        isinstance(t, ast.Name)
                        and t.id.startswith("_WIRE_")
                        and isinstance(v, ast.Constant)
                    ):
                        code_names[t.id] = v.value
        elif isinstance(node, ast.FunctionDef) and node.name == "_canonical_codes":
            canon = node
    for want in ("_HDR", "_HDR2"):
        if want not in fmts:
            errors.append(f"{os.path.basename(path)}: no struct format {want}")
    if errors:
        return None, errors
    try:
        spec.header_bytes = struct.calcsize(fmts["_HDR"])
        spec.trace_ext_bytes = struct.calcsize(fmts["_HDR2"]) - spec.header_bytes
    except struct.error as e:
        errors.append(f"{os.path.basename(path)}: bad struct format: {e}")
        return None, errors
    for name, short in (
        ("_WIRE_F32", "f32"),
        ("_WIRE_I32", "i32"),
        ("_WIRE_U8", "u8"),
        ("_WIRE_BF16", "bf16"),
    ):
        if name in code_names:
            spec.codes[short] = code_names[name]
        else:
            errors.append(f"{os.path.basename(path)}: wire code {name} not found")
    if canon is None:
        errors.append(f"{os.path.basename(path)}: _canonical_codes not found")
        return None, errors
    segments, aux_segments = _parse_canonical_codes(canon, code_names, errors)
    # a segment symbol that is not a known _WIRE_* constant (a local
    # alias refactor, a new code) is an extraction miss, not a KeyError
    # crash — the whole-lint-run-dies failure mode is the one this
    # errors channel exists to prevent
    for sym, _count in segments + aux_segments:
        if sym != "<obs>" and sym not in code_names:
            errors.append(
                f"_canonical_codes: unknown code symbol {sym!r} (not a "
                f"_WIRE_* constant)"
            )
    if errors:
        return None, errors
    for obs_bf16 in (False, True):
        obs_code = spec.codes["bf16"] if obs_bf16 else spec.codes["f32"]
        base = []
        for sym, count in segments:
            code = obs_code if sym == "<obs>" else code_names[sym]
            base += [code] * count
        aux = list(base)
        for sym, count in aux_segments:
            code = obs_code if sym == "<obs>" else code_names[sym]
            aux += [code] * count
        spec.maps[(obs_bf16, False)] = bytes(base)
        spec.maps[(obs_bf16, True)] = bytes(aux)
    return spec, errors


def _parse_canonical_codes(
    fn: ast.FunctionDef, code_names: Dict[str, int], errors: List[str]
) -> Tuple[List[Tuple[str, int]], List[Tuple[str, int]]]:
    """Segments of the ``[code] * n + ...`` list algebra; the obs
    parameter name becomes the ``<obs>`` placeholder. Returns
    (base segments, aux-appended segments)."""
    param_names = {a.arg for a in fn.args.args}

    def segs_of(expr: ast.expr) -> List[Tuple[str, int]]:
        if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
            return segs_of(expr.left) + segs_of(expr.right)
        if (
            isinstance(expr, ast.BinOp)
            and isinstance(expr.op, ast.Mult)
            and isinstance(expr.left, ast.List)
            and len(expr.left.elts) == 1
            and isinstance(expr.right, ast.Constant)
        ):
            elt = expr.left.elts[0]
            if isinstance(elt, ast.Name):
                sym = "<obs>" if elt.id in param_names else elt.id
                return [(sym, expr.right.value)]
        errors.append("_canonical_codes: unrecognized list algebra")
        return []

    base: List[Tuple[str, int]] = []
    aux: List[Tuple[str, int]] = []
    for stmt in fn.body:
        if isinstance(stmt, ast.Assign) and isinstance(
            stmt.targets[0], ast.Name
        ):
            base = segs_of(stmt.value)
        elif isinstance(stmt, ast.If):
            for sub in stmt.body:
                if isinstance(sub, ast.AugAssign):
                    aux = segs_of(sub.value)
    if not base:
        errors.append("_canonical_codes: base map not found")
    return base, aux


_CC_CONST_RE = re.compile(
    r"\bconstexpr\s+\w+\s+(kHeaderBytes|kTraceExtBytes)\s*=\s*(\d+)\s*;"
)
_CC_CODE_RE = re.compile(r"\bkWire(F32|I32|U8|Bf16)\s*=\s*(\d+)")
_CC_NMAP_RE = re.compile(r"\bn_map\s*=\s*aux\s*\?\s*(\d+)\s*:\s*(\d+)\s*;")
_CC_OBS_HEAD_RE = re.compile(
    r"\boc\s*!=\s*kWire(\w+)\s*&&\s*oc\s*!=\s*kWire(\w+)"
)
_CC_LOOP_RE = re.compile(
    r"for\s*\(\s*\w+\s+i\s*=\s*(\d+)\s*;\s*i\s*<\s*(n_map|\d+)\s*;\s*\+\+i\s*\)\s*"
    r"if\s*\(\s*m\[i\]\s*!=\s*(oc|kWire\w+)\s*\)\s*return false;"
)


def parse_packer_spec(path: str) -> Tuple[Optional[WireSpec], List[str]]:
    """The C side: constants + the dtype-map validation loops, via
    structured regex over the exact idioms packer.cc uses (a layout
    edit that breaks the extraction is itself a finding: packer.cc
    layout changes must keep this parseable)."""
    with open(path, encoding="utf-8") as f:
        src = f.read()
    spec = WireSpec()
    errors: List[str] = []
    for name, value in _CC_CONST_RE.findall(src):
        if name == "kHeaderBytes":
            spec.header_bytes = int(value)
        else:
            spec.trace_ext_bytes = int(value)
    if spec.header_bytes is None or spec.trace_ext_bytes is None:
        errors.append("packer.cc: kHeaderBytes/kTraceExtBytes not found")
    short = {"F32": "f32", "I32": "i32", "U8": "u8", "Bf16": "bf16"}
    for name, value in _CC_CODE_RE.findall(src):
        spec.codes[short[name]] = int(value)
    if len(spec.codes) != 4:
        errors.append(f"packer.cc: found wire codes {sorted(spec.codes)} of 4")
    n_map = _CC_NMAP_RE.search(src)
    if n_map is None:
        errors.append("packer.cc: n_map = aux ? A : B not found")
    obs_head = _CC_OBS_HEAD_RE.search(src)
    if obs_head is None:
        errors.append("packer.cc: obs-code head check (oc != kWire…) not found")
    loops = _CC_LOOP_RE.findall(re.sub(r"\s+", " ", src))
    if not loops:
        errors.append("packer.cc: dtype-map validation loops not found")
    if errors:
        return None, errors
    n_aux, n_base = int(n_map.group(1)), int(n_map.group(2))
    obs_allowed = {short.get(obs_head.group(1)), short.get(obs_head.group(2))}
    if obs_allowed != {"f32", "bf16"}:
        errors.append(
            f"packer.cc: obs head check allows {sorted(obs_allowed)}, "
            f"expected f32/bf16"
        )
        return None, errors
    for _start, _end, want in loops:
        # a validation loop comparing against a code name this table
        # does not know (a new kWireI64) is an extraction miss, never a
        # KeyError that kills the whole lint run
        if want != "oc" and want[5:] not in short:
            errors.append(f"packer.cc: unknown wire code {want} in a loop")
    if errors:
        return None, errors
    for aux, total in ((False, n_base), (True, n_aux)):
        for obs_bf16 in (False, True):
            obs_code = spec.codes["bf16"] if obs_bf16 else spec.codes["f32"]
            arr: List[Optional[int]] = [None] * total
            arr[0] = obs_code  # m[0] via the oc head check
            for start, end_s, want in loops:
                start = int(start)
                end = total if end_s == "n_map" else int(end_s)
                end = min(end, total)
                if want == "oc":
                    code = obs_code
                else:
                    code = spec.codes[short[want[5:]]]
                for i in range(start, end):
                    arr[i] = code
            if any(v is None for v in arr):
                holes = [i for i, v in enumerate(arr) if v is None]
                errors.append(
                    f"packer.cc: dtype-map entries {holes} not constrained "
                    f"by any validation loop (aux={aux})"
                )
                return None, errors
            spec.maps[(obs_bf16, aux)] = bytes(arr)  # type: ignore[arg-type]
    return spec, errors


@register
class WireSpecDrift(Rule):
    id = "WIRE001"
    severity = "error"
    doc = (
        "DTR wire layout drift between transport/serialize.py and "
        "csrc/packer.cc"
    )

    def run_repo(self, ctx: RepoContext) -> List[Finding]:
        ser = ctx.serialize_path or os.path.join(
            ctx.root, PACKAGE, "transport", "serialize.py"
        )
        cc = ctx.packer_cc_path or os.path.join(ctx.root, PACKAGE, "csrc", "packer.cc")
        ser_ok, cc_ok = os.path.exists(ser), os.path.exists(cc)
        if not ser_ok and not cc_ok:
            # a corpus with no wire layer at all (fixture tmp trees) has
            # nothing to cross-check — the one legitimate skip
            return []
        ser_rel = os.path.relpath(ser, ctx.root).replace(os.sep, "/")
        cc_rel = os.path.relpath(cc, ctx.root).replace(os.sep, "/")
        if ser_ok != cc_ok:
            # HALF the pair present = one side was moved/renamed out from
            # under the cross-check; vanishing silently would leave wire
            # drift unchecked forever while the docs promise loudness
            missing = cc_rel if ser_ok else ser_rel
            present = ser_rel if ser_ok else cc_rel
            return [
                self.make(
                    present,
                    1,
                    f"wire-spec cross-check lost half its pair: {missing} "
                    f"is missing — if the file moved, update the WIRE001 "
                    f"default paths (analysis/core.py) so the "
                    f"serialize.py↔packer.cc drift check keeps running",
                )
            ]
        findings: List[Finding] = []
        # belt and braces: ANY unexpected source shape becomes a loud
        # extraction-failed finding, never an exception that kills the
        # whole lint run and loses every other rule's findings
        try:
            py_spec, py_errs = parse_serialize_spec(ser)
        except Exception as e:  # noqa: BLE001 — the contract is loud-not-dead
            py_spec, py_errs = None, [f"extractor crashed: {e!r}"]
        for e in py_errs:
            findings.append(
                self.make(ser_rel, 1, f"wire-spec extraction failed: {e}")
            )
        try:
            cc_spec, cc_errs = parse_packer_spec(cc)
        except Exception as e:  # noqa: BLE001
            cc_spec, cc_errs = None, [f"extractor crashed: {e!r}"]
        for e in cc_errs:
            findings.append(
                self.make(cc_rel, 1, f"wire-spec extraction failed: {e}")
            )
        if py_spec is None or cc_spec is None:
            return findings
        for diff in py_spec.diffs(cc_spec):
            findings.append(
                self.make(
                    cc_rel,
                    1,
                    f"DTR wire layout drifted between serialize.py and "
                    f"packer.cc: {diff} — one side will quarantine or "
                    f"mis-parse every frame the other emits",
                )
            )
        return findings
