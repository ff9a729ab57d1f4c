"""THR rules: thread-safety discipline for thread-spawning classes.

The repo's concurrency model is deliberately narrow: a class owns its
daemon thread(s), worker methods write instance attributes, and public
methods on other threads read them. The failures this invites (torn
multi-read state, stale-window double-judging) were repaired in the
code this package was ported from, and the repaired code converged on
two disciplines these rules now enforce:

THR001 — every attribute WRITTEN from the worker body and READ from a
public method must either be (a) lock-guarded on both sides by a lock
attribute of the instance, or (b) written only by atomic REBINDING
(``self.x = <fresh object>``) and read exactly once in the reading
method (bind to a local, then use the local) — the ``MetricsLogger.
_latest_rec`` single-tuple pattern. In-place mutation from the worker
(``self.d[k] = v``, ``self.l.append(...)``, ``del self.l[:n]``) never
qualifies for (b): a reader iterating or double-reading sees torn
state. When a class spawns MULTIPLE worker threads (Thread() under a
loop/comprehension), augmented assignment (``self.n += 1``) is also
demoted to a mutation — concurrent read-modify-write loses updates.

THR002 — lock-acquisition ORDER must be consistent package-wide. Every
lexically nested ``with self.lockA: ... with self.lockB:`` contributes
a directed edge (Class.lockA → Class.lockB); a cycle in the package-
wide graph is a potential deadlock (the runtime counterpart,
analysis/lockcheck.py, catches the dynamic cross-object cases static
analysis cannot see).

Known approximations (by design — suppress with a reason where the code
is right and the rule is blind): cross-OBJECT mutation
(``self._reservoir.offer(...)`` mutating reservoir internals) is
invisible; ``queue.Queue``/``Event`` method calls are treated as
thread-safe; happens-before established by ``Event.wait`` handshakes is
not modeled.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from dotaclient_tpu_torch.analysis.core import (
    Finding,
    ModuleUnit,
    RepoContext,
    Rule,
    bfs_path,
    register,
)

# In-place mutators on plain containers. Deliberately EXCLUDES the
# thread-safe queue/event idioms (put/get/set/clear-on-Event...) — a
# queue.Queue attribute is the sanctioned cross-thread channel.
_MUTATORS = {
    "append",
    "appendleft",
    "extend",
    "insert",
    "remove",
    "discard",
    "add",
    "update",
    "setdefault",
    "popleft",
    "popitem",
}

_LOCK_FACTORIES = {"Lock", "RLock", "Condition"}

REBIND, MUTATE = "rebind", "mutate"


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' for a `self.x` expression, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _is_lock_factory(call: ast.expr) -> bool:
    if not isinstance(call, ast.Call):
        return False
    fn = call.func
    name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
    return name in _LOCK_FACTORIES


def _thread_target(call: ast.Call) -> Optional[ast.expr]:
    """The target= expr of a threading.Thread(...) construction."""
    fn = call.func
    name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
    if name != "Thread":
        return None
    for kw in call.keywords:
        if kw.arg == "target":
            return kw.value
    return None


def _class_model(module: ModuleUnit, node: ast.ClassDef) -> "_ClassModel":
    """One _ClassModel per class, shared by THR001 and THR002 (building
    one walks every method; doing it twice doubled THR lint time)."""
    cache = getattr(module, "_class_model_cache", None)
    if cache is None:
        cache = module._class_model_cache = {}
    model = cache.get(id(node))
    if model is None:
        model = cache[id(node)] = _ClassModel(module, node)
    return model


class _ClassModel:
    """Everything THR001 needs to know about one class."""

    def __init__(self, module: ModuleUnit, node: ast.ClassDef):
        self.module = module
        self.node = node
        self.methods: Dict[str, ast.FunctionDef] = {
            n.name: n
            for n in node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        self.lock_attrs: Set[str] = set()
        self.worker_entries: List[ast.AST] = []  # method or nested def nodes
        self.multi_worker = False
        self._collect_locks_and_targets()

    def _collect_locks_and_targets(self) -> None:
        for meth in self.methods.values():
            for sub in ast.walk(meth):
                if (
                    isinstance(sub, (ast.Assign, ast.AnnAssign))
                    and sub.value is not None
                    and _is_lock_factory(sub.value)
                ):
                    # `self._lock: threading.Lock = threading.Lock()` is
                    # the same lock as the unannotated form
                    targets = sub.targets if isinstance(sub, ast.Assign) else [sub.target]
                    for tgt in targets:
                        attr = _self_attr(tgt)
                        if attr is not None:
                            self.lock_attrs.add(attr)
                if isinstance(sub, ast.Call):
                    target = _thread_target(sub)
                    if target is None:
                        continue
                    # Thread() under a loop/comprehension → several
                    # workers share the written attributes.
                    for anc in self.module.ancestors(sub):
                        if isinstance(
                            anc, (ast.For, ast.While, ast.ListComp, ast.GeneratorExp)
                        ):
                            self.multi_worker = True
                        if anc is meth:
                            break
                    attr = _self_attr(target)
                    if attr is not None and attr in self.methods:
                        self.worker_entries.append(self.methods[attr])
                    elif isinstance(target, ast.Name):
                        # nested def used as target (watchdog's _run)
                        for sub2 in ast.walk(meth):
                            if (
                                isinstance(sub2, ast.FunctionDef)
                                and sub2.name == target.id
                            ):
                                self.worker_entries.append(sub2)

    def spawns_thread(self) -> bool:
        return bool(self.worker_entries)

    def _closure(self, entries: List[ast.AST]) -> Set[str]:
        """Method names reachable from `entries` via self.m() calls."""
        names: Set[str] = set()
        frontier = list(entries)
        while frontier:
            fn = frontier.pop()
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Call):
                    attr = _self_attr(sub.func)
                    if attr in self.methods and attr not in names:
                        names.add(attr)
                        frontier.append(self.methods[attr])
        return names

    def worker_method_names(self) -> Set[str]:
        direct = {
            e.name for e in self.worker_entries if isinstance(e, ast.FunctionDef)
        }
        return direct | self._closure(self.worker_entries)

    def is_guarded(self, node: ast.AST, boundary: ast.AST) -> bool:
        """Is `node` under a `with self.<lock>:` inside `boundary`?"""
        for anc in self.module.ancestors(node):
            if isinstance(anc, ast.With):
                for item in anc.items:
                    attr = _self_attr(item.context_expr)
                    if attr in self.lock_attrs:
                        return True
            if anc is boundary:
                break
        return False

    def writes_in(self, fns: List[ast.AST]) -> Dict[str, List[Tuple[str, bool, int]]]:
        """{attr: [(kind, guarded, line)]} for worker-side writes."""
        out: Dict[str, List[Tuple[str, bool, int]]] = {}

        def record(attr: str, kind: str, node: ast.AST, fn: ast.AST) -> None:
            if self.multi_worker and kind == REBIND:
                # With several workers, any read-modify-write of the same
                # attribute loses updates: `+=`, and equally
                # `self.n = self.n + 1`.
                rhs = getattr(node, "value", None)
                reads_self = rhs is not None and any(
                    _self_attr(s) == attr
                    for s in ast.walk(rhs)
                    if isinstance(s, ast.Attribute)
                )
                if isinstance(node, ast.AugAssign) or reads_self:
                    kind = MUTATE
            out.setdefault(attr, []).append(
                (kind, self.is_guarded(node, fn), node.lineno)
            )

        for fn in fns:
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Assign):
                    for tgt in sub.targets:
                        targets = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
                        for t in targets:
                            attr = _self_attr(t)
                            if attr is not None:
                                record(attr, REBIND, sub, fn)
                            elif isinstance(t, ast.Subscript):
                                attr = _self_attr(t.value)
                                if attr is not None:
                                    record(attr, MUTATE, sub, fn)
                elif isinstance(sub, ast.AugAssign):
                    attr = _self_attr(sub.target)
                    if attr is not None:
                        record(attr, REBIND, sub, fn)
                    elif isinstance(sub.target, ast.Subscript):
                        attr = _self_attr(sub.target.value)
                        if attr is not None:
                            record(attr, MUTATE, sub, fn)
                elif isinstance(sub, ast.Delete):
                    for t in sub.targets:
                        base = t.value if isinstance(t, ast.Subscript) else t
                        attr = _self_attr(base)
                        if attr is not None:
                            record(attr, MUTATE, sub, fn)
                elif isinstance(sub, ast.Call):
                    # self.attr.append(...) style container mutation
                    if isinstance(sub.func, ast.Attribute):
                        attr = _self_attr(sub.func.value)
                        if attr is not None and sub.func.attr in _MUTATORS:
                            record(attr, MUTATE, sub, fn)
        return out


@register
class UnguardedSharedAttr(Rule):
    id = "THR001"
    severity = "error"
    doc = (
        "attribute written by a worker thread and read from a public "
        "method without the instance lock or a single atomic read"
    )

    def run(self, module: ModuleUnit, ctx: RepoContext) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(module, node))
        return findings

    def _check_class(self, module: ModuleUnit, node: ast.ClassDef) -> List[Finding]:
        model = _class_model(module, node)
        if not model.spawns_thread():
            return []
        worker_names = model.worker_method_names()
        worker_fns: List[ast.AST] = list(model.worker_entries) + [
            model.methods[n] for n in worker_names if n in model.methods
        ]
        writes = model.writes_in(worker_fns)
        if not writes:
            return []

        # Reader closure: public methods (and private helpers they call)
        # that are NOT part of the worker body. __init__ and dunders are
        # construction-time, not cross-thread readers.
        public = [
            name
            for name in model.methods
            if not name.startswith("_") and name not in worker_names
        ]
        reader_names = set(public) | model._closure(
            [model.methods[n] for n in public]
        )
        reader_names -= worker_names

        findings: List[Finding] = []
        for rname in sorted(reader_names):
            fn = model.methods.get(rname)
            if fn is None:
                continue
            reads: Dict[str, List[ast.Attribute]] = {}
            written_in_reader: Set[str] = set()
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Attribute) and isinstance(
                    sub.ctx, ast.Load
                ):
                    attr = _self_attr(sub)
                    if attr in writes:
                        reads.setdefault(attr, []).append(sub)
                elif isinstance(sub, (ast.Assign, ast.AugAssign)):
                    tgts = (
                        sub.targets if isinstance(sub, ast.Assign) else [sub.target]
                    )
                    for t in tgts:
                        attr = _self_attr(t)
                        if attr is not None:
                            written_in_reader.add(attr)
            for attr, sites in sorted(reads.items()):
                wkinds = writes[attr]
                writes_guarded = all(g for _, g, _ in wkinds)
                all_rebind = all(k == REBIND for k, _, _ in wkinds)
                reads_guarded = all(model.is_guarded(s, fn) for s in sites)
                if writes_guarded and reads_guarded:
                    continue
                if all_rebind and len(sites) == 1 and attr not in written_in_reader:
                    # single atomic read of a rebound reference — the
                    # sanctioned lock-free pattern
                    continue
                # No line numbers or read counts in the message — it
                # feeds the baseline fingerprint, which must not churn
                # on unrelated edits (core.py fingerprint contract).
                what = (
                    "mutated in place" if not all_rebind else "rebound unguarded"
                )
                findings.append(
                    self.make(
                        module,
                        sites[0].lineno,
                        f"self.{attr} is {what} by worker thread(s) of "
                        f"{node.name} and read from {node.name}.{rname}() "
                        f"without the instance lock or the single-atomic-"
                        f"read discipline — guard both sides with the "
                        f"lock, or rebind atomically and read once into a "
                        f"local",
                        context=f"{node.name}.{rname}",
                    )
                )
        return findings


@register
class LockOrderConsistency(Rule):
    id = "THR002"
    severity = "error"
    doc = "inconsistent lock acquisition order across the package"

    def run_repo(self, ctx: RepoContext) -> List[Finding]:
        # edge: (Class.lockA → Class.lockB) from lexically nested withs
        edges: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
        for module in ctx.modules:
            for cls in ast.walk(module.tree):
                if not isinstance(cls, ast.ClassDef):
                    continue
                model = _class_model(module, cls)
                if not model.lock_attrs:
                    continue
                for outer in ast.walk(cls):
                    if not isinstance(outer, ast.With):
                        continue
                    o_locks = self._locks_of(outer, model)
                    if not o_locks:
                        continue
                    # (held, acquired, site) pairs. `with self.a, self.b:`
                    # is sugar for nesting — items acquire left to right,
                    # so every ordered pair within one With is an edge too
                    pairs = []
                    for i, o_attr in enumerate(o_locks):
                        for i_attr in o_locks[i + 1 :]:
                            if i_attr != o_attr:
                                pairs.append((o_attr, i_attr, outer))
                    for inner in ast.walk(outer):
                        if inner is outer or not isinstance(inner, ast.With):
                            continue
                        for i_attr in self._locks_of(inner, model):
                            for o_attr in o_locks:
                                if i_attr != o_attr:
                                    pairs.append((o_attr, i_attr, inner))
                    for o_attr, i_attr, site in pairs:
                        # module-qualified: two unrelated classes that
                        # happen to share a name in different modules
                        # hold DISTINCT locks — merging them would mint
                        # a spurious inversion. Every lexical edge for a
                        # class comes from its defining module, so real
                        # inversions still pair up.
                        key = (
                            f"{module.relpath}:{cls.name}.{o_attr}",
                            f"{module.relpath}:{cls.name}.{i_attr}",
                        )
                        edges.setdefault(
                            key,
                            (
                                module.relpath,
                                site.lineno,
                                module.qualname_at(site),
                            ),
                        )
        adj: Dict[str, List[str]] = {}
        for a, b in edges:
            adj.setdefault(a, []).append(b)

        def back_path(src: str, dst: str) -> Optional[List[str]]:
            """Shortest [src, …, dst] over recorded edges (core.bfs_path,
            shared with lockcheck's runtime graph)."""
            return bfs_path(adj, src, dst)

        findings: List[Finding] = []
        reported: set = set()
        for (a, b), (path, line, qual) in sorted(edges.items()):
            # general cycles, not just reversed pairs: A→B, B→C, C→A
            # deadlocks under a 3-way interleave exactly like A→B/B→A
            back = back_path(b, a)
            if back is None:
                continue
            # report each cycle once, from its lexicographically first
            # edge (sorted iteration) — dedupe on the node set
            cycle_nodes = frozenset(back)
            if cycle_nodes in reported:
                continue
            reported.add(cycle_nodes)
            # qualname, not file:line, in the message: it feeds the
            # baseline fingerprint, which must survive line shifts
            rpath, _rline, rqual = edges[(b, back[1] if len(back) > 1 else a)]
            if len(back) == 2:
                detail = f"{b} → {a} in {rpath} ({rqual})"
            else:
                detail = f"the chain {' → '.join(back)} elsewhere (via {rqual})"
            findings.append(
                self.make(
                    path,
                    line,
                    f"lock order inversion: {a} → {b} here, but "
                    f"{detail} — pick one order package-wide or deadlock "
                    f"is one unlucky schedule away",
                    context=qual,
                )
            )
        return findings

    @staticmethod
    def _locks_of(node: ast.With, model: _ClassModel) -> List[str]:
        out = []
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr in model.lock_attrs:
                out.append(attr)
        return out
