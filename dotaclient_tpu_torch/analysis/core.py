"""Graftlint framework: rule registry, suppressions, baseline, driver.

Design constraints, in order:

- PURE AST. Linting the package must never import the package (or
  torch, numpy or JAX): the tier-1 lint test has to run before — and
  independent of — any accelerator runtime. Rules parse source with ``ast`` and cross-
  reference other files (config.py, obs/registry.py, k8s/*.yaml) by
  parsing them too, never by importing.
- Heuristic rules, honest escape hatches. Static thread/tracer analysis
  over dynamic Python is an approximation; the discipline is enforced by
  making every exception EXPLICIT: an inline
  ``# graftlint: disable=RULE(reason)`` with a non-empty reason, or a
  baseline entry with a non-empty reason. A suppression without a reason
  is itself a finding (GRAFT000) — silence must always be justified.
- Ratchet, don't boil the ocean. The checked-in baseline
  (``analysis/baseline.json``) pins pre-existing findings so only NEW
  violations fail CI; a baseline entry whose finding no longer exists is
  STALE and fails (the baseline can only shrink). Fingerprints hash the
  (rule, path, enclosing-qualname, message) — not line numbers — so
  unrelated edits don't churn the baseline.

Two rule shapes share one registry:

- module rules: ``run(module, ctx)`` called once per parsed file;
- repo rules:  ``run_repo(ctx)`` called once per lint with the whole
  parsed module set (cross-file checks: lock order, flag drift).
"""

from __future__ import annotations

import ast
import hashlib
import io
import json
import os
import re
import time
import tokenize
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

# The linted package and its cross-file inputs, relative to the repo
# root. The native packer lives under csrc/ beside the CUDA kernels.
PACKAGE = "dotaclient_tpu_torch"
_DEFAULT_INPUTS = (
    ((PACKAGE, "config.py"), "config_path"),
    ((PACKAGE, "obs", "registry.py"), "registry_path"),
    (("k8s",), "k8s_dir"),
    ((PACKAGE, "scripts"), "scripts_dir"),
    ((PACKAGE, "transport", "serialize.py"), "serialize_path"),
    ((PACKAGE, "csrc", "packer.cc"), "packer_cc_path"),
)
BASELINE_REL = (PACKAGE, "analysis", "baseline.json")

# Severity levels, in escalation order. "error" fails the default gate;
# "warning" fails only under --strict (the nightly invocation).
SEVERITIES = ("warning", "error")

_SUPPRESS_MARK_RE = re.compile(r"#\s*graftlint:\s*disable\s*=\s*")
_SUPPRESS_RULE_RE = re.compile(r"([A-Z]+\d+)")
_SUPPRESS_SEP_RE = re.compile(r"\s*,\s*")


def bfs_path(adj: Dict[str, List[str]], src: str, dst: str) -> Optional[List[str]]:
    """Shortest ``[src, …, dst]`` over directed edges, or None.

    The one cycle-search both lock-order detectors share — THR002's
    lexical edge graph and lockcheck's runtime acquisition graph — so
    the static and dynamic views can't drift on which cycles they
    report. Neighbors expand in sorted order for deterministic output.
    """
    if src == dst:
        return [src]
    prev: Dict[str, Optional[str]] = {src: None}
    queue: deque = deque([src])
    while queue:
        node = queue.popleft()
        for nxt in sorted(adj.get(node, ())):
            if nxt in prev:
                continue
            prev[nxt] = node
            if nxt == dst:
                path = [dst]
                while prev[path[-1]] is not None:
                    path.append(prev[path[-1]])
                return path[::-1]
            queue.append(nxt)
    return None


@dataclass(frozen=True)
class Finding:
    rule: str
    severity: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str
    context: str = ""  # enclosing Class.method qualname (fingerprint stability)

    def fingerprint(self) -> str:
        digest = hashlib.sha1(self.message.encode()).hexdigest()[:10]
        return f"{self.rule}:{self.path}:{self.context}:{digest}"

    def render(self) -> str:
        ctx = f" [{self.context}]" if self.context else ""
        return f"{self.path}:{self.line}: {self.rule} {self.severity}:{ctx} {self.message}"


class Suppressions:
    """Inline ``# graftlint: disable=RULE(reason)`` index for one file.

    A suppression on line N covers findings reported at line N and line
    N+1 (comment-above style), matching how black/flake8 users write
    them. Empty OR MISSING reasons are recorded separately — the bare
    flake8-habit form ``disable=THR001`` with no ``(reason)`` does NOT
    suppress, and the driver reports each as a GRAFT000 error so the
    author learns the required syntax instead of silently keeping the
    finding. Only genuine COMMENT tokens are parsed — prose like this
    docstring mentioning the syntax is not a suppression and cannot
    GRAFT000-fail the gate.
    """

    def __init__(self, source: str):
        self._by_line: Dict[int, Dict[str, str]] = {}
        self.missing_reason: List[Tuple[int, str]] = []  # (line, rule)
        for lineno, text in self._comments(source):
            mark = _SUPPRESS_MARK_RE.search(text)
            if not mark:
                continue
            # comma-separated items from the marker on; stop at the
            # first non-item text so trailing prose can't misparse
            pos = mark.end()
            while True:
                item = _SUPPRESS_RULE_RE.match(text, pos)
                if not item:
                    break
                rule = item.group(1)
                pos = item.end()
                if pos < len(text) and text[pos] == "(":
                    # paren-balanced reason scan — reasons naturally
                    # contain calls ("len() is one GIL-atomic read"),
                    # which a [^)]* capture would silently truncate at
                    # the first close paren
                    depth, start = 1, pos + 1
                    i = start
                    while i < len(text) and depth:
                        if text[i] == "(":
                            depth += 1
                        elif text[i] == ")":
                            depth -= 1
                        i += 1
                    reason = text[start : i - 1] if depth == 0 else text[start:]
                    pos = i
                else:
                    reason = ""
                if not reason.strip():
                    self.missing_reason.append((lineno, rule))
                else:
                    self._by_line.setdefault(lineno, {})[rule] = reason.strip()
                sep = _SUPPRESS_SEP_RE.match(text, pos)
                if not sep:
                    break
                pos = sep.end()

    @staticmethod
    def _comments(source: str) -> Iterator[Tuple[int, str]]:
        """(lineno, text) of every COMMENT token. Tokenizing (vs raw
        line scanning) keeps docstrings and string literals that
        MENTION the disable syntax from registering as suppressions."""
        try:
            for tok in tokenize.generate_tokens(io.StringIO(source).readline):
                if tok.type == tokenize.COMMENT:
                    yield tok.start[0], tok.string
        except (tokenize.TokenError, IndentationError, SyntaxError):
            # the file already ast.parse'd, so this is near-unreachable;
            # a tokenize quirk must not crash the whole lint run
            return

    def covers(self, rule: str, line: int) -> bool:
        for candidate in (line, line - 1):
            if rule in self._by_line.get(candidate, {}):
                return True
        return False


class ModuleUnit:
    """One parsed source file plus the derived indexes rules share."""

    def __init__(self, abspath: str, relpath: str, source: str, tree: ast.Module):
        self.abspath = abspath
        self.relpath = relpath
        self.source = source
        self.tree = tree
        self.suppressions = Suppressions(source)
        # parent links: ancestry queries (lock-guard With detection)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    def qualname_at(self, node: ast.AST) -> str:
        """Dotted Class.method path enclosing `node` (may be "")."""
        parts: List[str] = []
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                parts.append(cur.name)
            cur = self.parents.get(cur)
        return ".".join(reversed(parts))

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)


@dataclass
class RepoContext:
    """Paths + parsed modules for one lint run. The cross-file inputs
    (config.py, obs/registry.py, k8s/) are overridable so the fixture
    corpus can exercise the OBS rules hermetically.

    Cross-file sources are parsed ONCE per lint run and shared across
    all rule families through `source_of`/`ast_of`/`script_modules` —
    before these caches, every family re-parsed config.py, the argparse
    binaries, and the scripts/ drivers on its own."""

    root: str
    modules: List[ModuleUnit] = field(default_factory=list)
    config_path: Optional[str] = None
    registry_path: Optional[str] = None
    k8s_dir: Optional[str] = None
    scripts_dir: Optional[str] = None
    serialize_path: Optional[str] = None
    packer_cc_path: Optional[str] = None
    _source_cache: Dict[str, Optional[str]] = field(
        default_factory=dict, repr=False, compare=False
    )
    _ast_cache: Dict[str, Optional[ast.Module]] = field(
        default_factory=dict, repr=False, compare=False
    )
    _script_modules: Optional[List[ModuleUnit]] = field(
        default=None, repr=False, compare=False
    )

    def source_of(self, path: str) -> Optional[str]:
        """Memoized file read (None on OSError) — one disk read per
        cross-file input per lint run, shared by every rule family."""
        key = os.path.abspath(path)
        if key not in self._source_cache:
            try:
                with open(key, encoding="utf-8") as f:
                    self._source_cache[key] = f.read()
            except OSError:
                self._source_cache[key] = None
        return self._source_cache[key]

    def ast_of(self, path: str) -> Optional[ast.Module]:
        """Memoized ``ast.parse`` of `path` (None on read/syntax error).
        Package files already parsed into `modules` are served from
        their ModuleUnit, never re-parsed."""
        key = os.path.abspath(path)
        if key not in self._ast_cache:
            for m in self.modules:
                if m.abspath == key:
                    self._ast_cache[key] = m.tree
                    break
            else:
                source = self.source_of(key)
                try:
                    self._ast_cache[key] = (
                        None if source is None else ast.parse(source, filename=key)
                    )
                except SyntaxError:
                    self._ast_cache[key] = None
        return self._ast_cache[key]

    def script_modules(self) -> List[ModuleUnit]:
        """The scripts/ bench+soak drivers as parsed ModuleUnits, once
        per lint run (OBS002 argv scanning and the SVC fleet-graph
        rules both read them). The port's drivers live inside the
        package, so a driver already parsed as a package module is
        served from its ModuleUnit, never parsed twice."""
        if self._script_modules is None:
            self._script_modules = []
            if self.scripts_dir and os.path.isdir(self.scripts_dir):
                by_abs = {m.abspath: m for m in self.modules}
                for path in _iter_py_files([self.scripts_dir]):
                    unit = by_abs.get(os.path.abspath(path))
                    if unit is None:
                        unit = next(iter(parse_modules(self.root, [path])), None)
                    if unit is not None:
                        self._script_modules.append(unit)
        return self._script_modules

    def all_modules(self) -> List[ModuleUnit]:
        """Package modules plus the drivers outside the package, each
        once (rules that read both must not see a driver twice)."""
        seen = {m.abspath for m in self.modules}
        return list(self.modules) + [
            m for m in self.script_modules() if m.abspath not in seen
        ]


class Rule:
    """Base: subclasses set `id`, `severity`, `doc` and implement
    either run(module, ctx) (per-file) or run_repo(ctx) (whole-repo)."""

    id: str = ""
    severity: str = "error"
    doc: str = ""

    def run(self, module: ModuleUnit, ctx: RepoContext) -> List[Finding]:
        return []

    def run_repo(self, ctx: RepoContext) -> List[Finding]:
        return []

    def make(
        self, module_or_path, line: int, message: str, context: str = ""
    ) -> Finding:
        path = (
            module_or_path.relpath
            if isinstance(module_or_path, ModuleUnit)
            else str(module_or_path)
        )
        return Finding(self.id, self.severity, path, line, message, context)


RULES: Dict[str, Rule] = {}


def register(rule_cls):
    """Class decorator: instantiate and index by rule id."""
    rule = rule_cls()
    assert rule.id and rule.id not in RULES, f"bad/duplicate rule id {rule.id!r}"
    assert rule.severity in SEVERITIES
    RULES[rule.id] = rule
    return rule_cls


def _ensure_rules_loaded() -> None:
    # Import for the registration side effect; deferred so `import
    # dotaclient_tpu_torch.analysis.core` alone stays cheap and
    # cycle-free. The reference's JAX rules (jit regions) have nothing
    # to check here: the port has no jit region.
    from dotaclient_tpu_torch.analysis import (  # noqa: F401
        lif_rules,
        obs_rules,
        proto_rules,
        thr_rules,
    )


# ------------------------------------------------------------------ baseline


def load_baseline(path: str) -> Tuple[Dict[str, str], List[str]]:
    """Returns ({fingerprint: reason}, [format errors]). Every entry must
    carry a non-empty reason — an unexplained baseline entry is just a
    suppression nobody can audit."""
    if not os.path.exists(path):
        return {}, []
    with open(path) as f:
        data = json.load(f)
    entries = data.get("entries", {})
    errors: List[str] = []
    out: Dict[str, str] = {}
    for fp, meta in entries.items():
        reason = (meta or {}).get("reason", "") if isinstance(meta, dict) else ""
        if not str(reason).strip():
            errors.append(f"baseline entry {fp} has no reason")
            continue
        out[fp] = str(reason).strip()
    return out, errors


def write_baseline(
    path: str,
    findings: List[Finding],
    reason: str,
    keep_reasons: Optional[Dict[str, str]] = None,
) -> None:
    """Regenerate the baseline from current findings (--write-baseline).
    The shared `reason` placeholder applies only to NEW entries — an
    entry already in `keep_reasons` (the loaded baseline) keeps its
    hand-audited justification; regenerating must never erase the audit
    trail. A human is expected to edit the new entries' reasons before
    committing."""
    keep_reasons = keep_reasons or {}
    entries = {}
    for f in findings:
        fp = f.fingerprint()
        entries[fp] = {
            "rule": f.rule,
            "path": f.path,
            "context": f.context,
            "message": f.message,
            "reason": keep_reasons.get(fp, reason),
        }
    parent = os.path.dirname(os.path.abspath(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"entries": entries}, fh, indent=2, sort_keys=True)
        fh.write("\n")


# -------------------------------------------------------------------- driver


@dataclass
class LintReport:
    findings: List[Finding]  # new: not suppressed, not baselined
    suppressed: List[Finding]
    baselined: List[Finding]
    stale_baseline: List[str]  # fingerprints with no current finding
    invalid: List[Finding]  # GRAFT000: suppression/baseline hygiene
    files_scanned: int = 0
    # wall seconds per rule id — the nightly --strict budget ledger:
    # a rule family that grows past its share shows up here, in --json,
    # before it shows up as a timed-out gate
    rule_seconds: Dict[str, float] = field(default_factory=dict)

    def failures(self, strict: bool = False) -> List[str]:
        """Human-readable list of everything that fails this run. The
        baseline hygiene checks (stale entries, reason-less
        suppressions) fail at EVERY strictness — the ratchet only works
        if the escape hatches stay audited."""
        out = [f.render() for f in self.findings if strict or f.severity == "error"]
        out += [f.render() for f in self.invalid]
        out += [
            f"baseline entry is stale (no current finding): {fp}"
            for fp in self.stale_baseline
        ]
        return out

    def to_json(self, strict: bool = False) -> Dict:
        return {
            "ok": not self.failures(strict),
            "files_scanned": self.files_scanned,
            "new": [f.render() for f in self.findings],
            "suppressed": len(self.suppressed),
            "baselined": len(self.baselined),
            "stale_baseline": self.stale_baseline,
            "invalid": [f.render() for f in self.invalid],
            "rule_seconds": {
                rule: round(secs, 4)
                for rule, secs in sorted(self.rule_seconds.items())
            },
        }


def _iter_py_files(paths: List[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            yield p
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for name in sorted(filenames):
                    if name.endswith(".py"):
                        yield os.path.join(dirpath, name)


def parse_modules(root: str, paths: List[str]) -> List[ModuleUnit]:
    modules = []
    for abspath in _iter_py_files(paths):
        with open(abspath, encoding="utf-8") as f:
            source = f.read()
        try:
            tree = ast.parse(source, filename=abspath)
        except SyntaxError:
            # not ours to judge — the interpreter/test suite owns syntax
            continue
        rel = os.path.relpath(abspath, root).replace(os.sep, "/")
        modules.append(ModuleUnit(abspath, rel, source, tree))
    return modules


def lint_repo(
    root: str,
    paths: Optional[List[str]] = None,
    baseline_path: Optional[str] = None,
    rules: Optional[List[str]] = None,
) -> LintReport:
    """Lint `paths` (default: the dotaclient_tpu_torch package under `root`)
    against all registered rules (or the `rules` subset).

    With an explicit `paths` subset, the WHOLE package is still parsed
    and analyzed — cross-file rules (lock order, flag consumption) and
    stale-baseline accounting are only meaningful over the full module
    set — but reported findings are restricted to files under `paths`.
    """
    _ensure_rules_loaded()
    root = os.path.abspath(root)
    package = os.path.join(root, PACKAGE)
    selected_rel: Optional[set] = None
    if paths is None:
        modules = parse_modules(root, [package])
    else:
        by_abs = {m.abspath: m for m in parse_modules(root, [package])}
        subset_abs = [os.path.abspath(p) for p in _iter_py_files(paths)]
        # linted paths may live outside the package; in-package ones are
        # already parsed above — selecting by path costs no second parse
        for m in parse_modules(root, [p for p in subset_abs if p not in by_abs]):
            by_abs[m.abspath] = m
        selected_rel = {
            os.path.relpath(p, root).replace(os.sep, "/") for p in subset_abs
        }
        modules = list(by_abs.values())
    ctx = RepoContext(root=root, modules=modules)
    for parts, attr in _DEFAULT_INPUTS:
        cand = os.path.join(root, *parts)
        if getattr(ctx, attr) is None and os.path.exists(cand):
            setattr(ctx, attr, cand)

    active = [RULES[r] for r in rules] if rules else list(RULES.values())
    raw: List[Finding] = []
    rule_seconds: Dict[str, float] = {}
    for rule in active:
        started = time.perf_counter()
        for module in ctx.modules:
            raw.extend(rule.run(module, ctx))
        raw.extend(rule.run_repo(ctx))
        rule_seconds[rule.id] = time.perf_counter() - started

    # Partition: inline suppressions first, then the baseline.
    by_rel = {m.relpath: m for m in ctx.modules}
    baseline_reasons: Dict[str, str] = {}
    invalid: List[Finding] = []
    if baseline_path is None:
        baseline_path = os.path.join(root, *BASELINE_REL)
    try:
        baseline_reasons, errs = load_baseline(baseline_path)
    except (ValueError, OSError) as e:
        errs = [f"baseline unreadable: {e}"]
    for msg in errs:
        invalid.append(
            Finding("GRAFT000", "error", os.path.relpath(baseline_path, root), 0, msg)
        )
    for m in ctx.modules:
        for line, rule in m.suppressions.missing_reason:
            invalid.append(
                Finding(
                    "GRAFT000",
                    "error",
                    m.relpath,
                    line,
                    f"graftlint suppression for {rule} has an empty reason — "
                    f"write disable={rule}(why this is safe)",
                )
            )

    new: List[Finding] = []
    suppressed: List[Finding] = []
    baselined: List[Finding] = []
    seen_fps = set()
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        # a suppressed finding still EXISTS: its fingerprint counts as
        # seen, or adding a reasoned inline suppression to a baselined
        # finding would fail the gate with a misleading "stale (no
        # current finding)" for an entry whose finding is right there
        fp = f.fingerprint()
        seen_fps.add(fp)
        mod = by_rel.get(f.path)
        if mod is not None and mod.suppressions.covers(f.rule, f.line):
            suppressed.append(f)
            continue
        if fp in baseline_reasons:
            baselined.append(f)
        else:
            new.append(f)
    # a rule subset can only judge its own rules' entries: an entry of a
    # rule that did not run is not stale, it was not looked for
    active_ids = {rule.id for rule in active}
    stale = sorted(
        fp
        for fp in baseline_reasons
        if fp not in seen_fps and fp.split(":", 1)[0] in active_ids
    )
    if selected_rel is not None:
        # Subset lint: the full-package analysis above keeps cross-file
        # rules and stale accounting honest; the REPORT covers only what
        # the caller asked to lint.
        new = [f for f in new if f.path in selected_rel]
        suppressed = [f for f in suppressed if f.path in selected_rel]
        baselined = [f for f in baselined if f.path in selected_rel]
        # module-level hygiene follows the selection; baseline-file
        # errors (non-.py path) always fail
        invalid = [
            f
            for f in invalid
            if not f.path.endswith(".py") or f.path in selected_rel
        ]
    return LintReport(
        findings=new,
        suppressed=suppressed,
        baselined=baselined,
        stale_baseline=stale,
        invalid=invalid,
        files_scanned=len(ctx.modules) if selected_rel is None else len(selected_rel),
        rule_seconds=rule_seconds,
    )
