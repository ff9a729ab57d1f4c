"""graftproto extraction: the static fleet contract graph.

The fleet's tiers talk over three string-typed surfaces — HTTP routes
(obs/http.py registrations), Prometheus meter names (obs/registry.py +
the per-tier stats sources), and config grammars (--control.policy,
--fleet.alerts, --league.policy, chaos specs). This module extracts all
three sides of every such contract by AST/regex, never by import:

- **served routes per binary**: starting from each ``_BINARY_CONFIGS``
  entrypoint module, walk the package-internal import graph (including
  function-body gated imports — the transport/base.py ``connect``
  idiom) and collect every ``MetricsHTTPServer(...)`` construction
  reached. ``/metrics`` + ``/healthz`` are unconditional; ``/profile``,
  ``/debug/flight`` and the ``json_routes``/``query_routes``/
  ``post_routes`` dict-literal keys follow the constructor keywords.
- **emitted meters per binary**: every meter-shaped string constant and
  every f-string constant head in the binary's reachable module set —
  deliberately an over-approximation (a name anywhere in the tier's
  code counts as exported); the drift class this catches is the RENAME,
  which removes the literal everywhere at once.
- **consumer demands**: constant route tails of ``f"http://…"`` URL
  literals and of the ``urlopen``/``Request``/``_get``/``_post``/
  ``_get_json`` call idioms across the package and the scripts/
  drivers; k8s probe paths and ``prometheus.io/path`` annotations
  scoped to their container's binary; policy/alert clause meters and
  grammar literals from the manifests and soak drivers.
- **ledger identities**: the ``LEDGERS`` tuple in obs/fleet.py, term by
  term — (ledger, meter, tier) — the conservation-audit contract.

proto_rules.py cross-checks consumer edges against producers (SVC001–
SVC004). Everything here is pure AST — the lint process must never
import the package, torch, JAX, or numpy; SVC003's grammar proof runs the real
parsers in a subprocess precisely to keep that invariant.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

from dotaclient_tpu_torch.analysis.core import PACKAGE, ModuleUnit, RepoContext
from dotaclient_tpu_torch.analysis.obs_rules import (
    _BINARY_CONFIGS,
    _item_blocks,
    binary_modules,
)

# the conservation ledgers' home (SVC004 reads LEDGERS there)
FLEET_REL = f"{PACKAGE}/obs/fleet.py"

# policy-clause tier vocabulary → the binary whose reachable modules
# must export the clause's meter (control/policy.py VALID_TIERS plus
# the fleetd alert surface, which scrapes its own rollups)
TIER_BINARIES = {
    "actor": "dotaclient_tpu_torch.runtime.actor",
    "broker": "dotaclient_tpu_torch.transport.fabric",
    "server": "dotaclient_tpu_torch.serve.server",
    "store": "dotaclient_tpu_torch.serve.handoff",
    "learner": "dotaclient_tpu_torch.runtime.learner",
    "league": "dotaclient_tpu_torch.league.server",
    "control": "dotaclient_tpu_torch.control.server",
    "fleet": "dotaclient_tpu_torch.obs.fleetd",
    "fleetd": "dotaclient_tpu_torch.obs.fleetd",
}

# control/scrape.py aggregate_tier suffixes + synthesized specials —
# "serve_load_occupancy.mean" resolves through the base name; "up" and
# "scraped" exist for every tier without any exporter
AGG_SUFFIXES = (".mean", ".max", ".sum")
AGG_SPECIALS = ("up", "scraped")

# endpoint-variable keywords → target binary, checked in order against
# the identifiers inside the URL expression (NOT the enclosing scope:
# serve/server.py fetches league routes from inside InferenceServer).
# Generic words (ep, endpoint, server…) deliberately resolve to no
# target — those edges are checked against the whole-fleet route union.
_HINTS: Tuple[Tuple[str, str], ...] = (
    ("fleetd", "dotaclient_tpu_torch.obs.fleetd"),
    ("fleet", "dotaclient_tpu_torch.obs.fleetd"),
    ("league", "dotaclient_tpu_torch.league.server"),
    ("control", "dotaclient_tpu_torch.control.server"),
    ("handoff", "dotaclient_tpu_torch.serve.handoff"),
    ("broker", "dotaclient_tpu_torch.transport.fabric"),
    ("fabric", "dotaclient_tpu_torch.transport.fabric"),
)

# call names whose string/f-string args carry route literals
_URL_CALLS = frozenset({"urlopen", "Request"})
_HELPER_CALLS = frozenset({"_get", "_post", "_get_json", "get_json"})

_ROUTE_RE = re.compile(r"^/[A-Za-z0-9_\-./]*$")
_METER_RE = re.compile(r"^[a-z][a-z0-9]*(?:_[a-z0-9]+)+$")
_METER_HEAD_RE = re.compile(r"^[a-z][a-z0-9_]*_$")

# yaml arg-item: - "--flag" / - --flag / - "--flag=value"
_ARG_ITEM_RE = re.compile(r'^\s*-\s*"?(--[A-Za-z0-9_.\-]+?)(?:=(.*?))?"?\s*$')
_VALUE_ITEM_RE = re.compile(r'^\s*-\s*"?(.*?)"?\s*$')
_HTTPGET_FLOW_RE = re.compile(r"httpGet:\s*\{\s*path:\s*\"?([^\s,}\"]+)")
_PROM_PATH_RE = re.compile(r"prometheus\.io/path:\s*\"?([^\s\"]+)")

# manifest/driver grammar surfaces → the real parser that owns each one
# (grammar_check.py maps these ids to import paths in the subprocess)
GRAMMAR_FLAGS = {
    "control.policy": "control_policy",
    "fleet.alerts": "fleet_alerts",
    "league.policy": "league_policy",
    "chaos.spec": "chaos_spec",
    "chaos": "chaos_spec",
    "faults": "chaos_spec",
}
GRAMMAR_CONSTS = {
    "POLICY": "control_policy",
    "ALERTS": "fleet_alerts",
    "MATCH_POLICY": "league_policy",
    "CHAOS": "chaos_spec",
    "FAULTS": "chaos_spec",
}


class ServedRoute(NamedTuple):
    route: str
    relpath: str
    line: int


class ConsumedRoute(NamedTuple):
    route: str
    relpath: str
    line: int
    hint: Optional[str]  # target binary module, or None = union check
    context: str


class ProbeRoute(NamedTuple):
    route: str
    relpath: str
    line: int
    binary: str


class ClauseMeter(NamedTuple):
    meter: str  # base name, aggregation suffix stripped
    tier: str
    relpath: str
    line: int
    grammar: str  # "control_policy" | "fleet_alerts"


class GrammarLiteral(NamedTuple):
    grammar: str
    text: str
    relpath: str
    line: int


class LedgerRef(NamedTuple):
    ledger: str
    meter: str
    tier: str
    line: int


def _pkg_rel(dotted: str) -> Tuple[str, str]:
    """Candidate relpaths (module file, package __init__) for a dotted
    package-internal module name."""
    base = dotted.replace(".", "/")
    return f"{base}.py", f"{base}/__init__.py"


class FleetGraph:
    """The contract graph for one lint run (build once, cached on the
    RepoContext — every SVC rule reads the same extraction)."""

    def __init__(self, ctx: RepoContext):
        self.ctx = ctx
        self.by_rel: Dict[str, ModuleUnit] = {m.relpath: m for m in ctx.modules}
        self._imports: Dict[str, Set[str]] = {}
        self._reach_cache: Dict[str, Set[str]] = {}
        self._served_cache: Dict[str, Dict[str, ServedRoute]] = {}
        self._emit_cache: Dict[str, Tuple[Set[str], Set[str]]] = {}
        # binaries present in this corpus: dotted module → entry relpath
        self.binaries: Dict[str, str] = {}
        for dotted in _BINARY_CONFIGS:
            for rel in _pkg_rel(dotted):
                if rel in self.by_rel:
                    self.binaries[dotted] = rel
                    break
        for m in ctx.modules:
            self._imports[m.relpath] = self._module_imports(m)

    # ------------------------------------------------------ import graph

    def _resolve(self, dotted: str) -> Optional[str]:
        for rel in _pkg_rel(dotted):
            if rel in self.by_rel:
                return rel
        return None

    def _module_imports(self, m: ModuleUnit) -> Set[str]:
        """Package-internal import edges, including function-body gated
        imports (ast.walk, not just module top level — the lazy-import
        idiom is exactly how binaries defer their heavy deps)."""
        out: Set[str] = set()
        # enclosing package parts — identical for x/y.py and
        # x/__init__.py (level-1 relative imports resolve to x.*)
        pkg_parts = m.relpath.split("/")[:-1]
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.startswith(PACKAGE):
                        rel = self._resolve(alias.name)
                        if rel:
                            out.add(rel)
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    anchor = pkg_parts[: len(pkg_parts) - (node.level - 1)]
                    base = ".".join(anchor + ([base] if base else []))
                if not base.startswith(PACKAGE):
                    continue
                rel = self._resolve(base)
                if rel:
                    out.add(rel)
                for alias in node.names:
                    sub = self._resolve(f"{base}.{alias.name}")
                    if sub:
                        out.add(sub)
        out.discard(m.relpath)
        return out

    def reachable(self, entry_rel: str) -> Set[str]:
        """Transitive import closure from an entrypoint, self included."""
        cached = self._reach_cache.get(entry_rel)
        if cached is None:
            seen = {entry_rel}
            frontier = [entry_rel]
            while frontier:
                rel = frontier.pop()
                for nxt in self._imports.get(rel, ()):
                    if nxt not in seen:
                        seen.add(nxt)
                        frontier.append(nxt)
            cached = self._reach_cache[entry_rel] = seen
        return cached

    # ------------------------------------------------------ served routes

    @staticmethod
    def _served_in(m: ModuleUnit) -> List[ServedRoute]:
        out: List[ServedRoute] = []
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = (
                node.func.attr
                if isinstance(node.func, ast.Attribute)
                else getattr(node.func, "id", "")
            )
            if fname != "MetricsHTTPServer":
                continue
            routes = {"/metrics", "/healthz"}
            for kw in node.keywords:
                val = kw.value
                none_const = isinstance(val, ast.Constant) and val.value is None
                if kw.arg in ("json_routes", "query_routes", "post_routes"):
                    if isinstance(val, ast.Dict):
                        for key in val.keys:
                            if (
                                isinstance(key, ast.Constant)
                                and isinstance(key.value, str)
                                and key.value.startswith("/")
                            ):
                                routes.add(key.value)
                elif kw.arg == "flight_provider" and not none_const:
                    routes.add("/debug/flight")
                elif kw.arg == "profile_handler" and not none_const:
                    routes.add("/profile")
            for route in sorted(routes):
                out.append(ServedRoute(route, m.relpath, node.lineno))
        return out

    def served_by(self, binary: str) -> Dict[str, ServedRoute]:
        """route → registration site, over the binary's reachable set."""
        cached = self._served_cache.get(binary)
        if cached is None:
            cached = {}
            entry = self.binaries.get(binary)
            if entry:
                for rel in sorted(self.reachable(entry)):
                    for sr in self._served_in(self.by_rel[rel]):
                        cached.setdefault(sr.route, sr)
            self._served_cache[binary] = cached
        return cached

    def served_union(self) -> Set[str]:
        """Every route served by any binary or any scripts/ driver's own
        surface (soak harnesses stand up fake tiers; their self-dialed
        routes are contracts too, just not any production binary's)."""
        cached = getattr(self, "_served_union", None)
        if cached is None:
            cached = set()
            for binary in self.binaries:
                cached.update(self.served_by(binary))
            for script in self.ctx.script_modules():
                cached.update(sr.route for sr in self._served_in(script))
            self._served_union = cached
        return cached

    def has_http_layer(self) -> bool:
        """False when the corpus contains no MetricsHTTPServer call at
        all (a synthetic lint tree with no wire/obs layer): the route
        rules skip rather than flag every consumer of a surface the
        corpus doesn't model."""
        return bool(self.served_union())

    # ----------------------------------------------------- emitted meters

    def emitted_by(self, binary: str) -> Tuple[Set[str], Set[str]]:
        """(exact literals, f-string heads) over the binary's reachable
        modules. Membership test for meter M: exact, or startswith a
        head (the ``out[f"fleet_ledger_{name}_…"]`` compose idiom)."""
        cached = self._emit_cache.get(binary)
        if cached is None:
            exact: Set[str] = set()
            heads: Set[str] = set()
            entry = self.binaries.get(binary)
            if entry:
                for rel in self.reachable(entry):
                    for node in ast.walk(self.by_rel[rel].tree):
                        if isinstance(node, ast.Constant) and isinstance(
                            node.value, str
                        ):
                            if _METER_RE.match(node.value):
                                exact.add(node.value)
                        elif isinstance(node, ast.JoinedStr) and node.values:
                            first = node.values[0]
                            if (
                                isinstance(first, ast.Constant)
                                and isinstance(first.value, str)
                                and _METER_HEAD_RE.match(first.value)
                            ):
                                heads.add(first.value)
            cached = self._emit_cache[binary] = (exact, heads)
        return cached

    def exports_meter(self, binary: str, meter: str) -> bool:
        exact, heads = self.emitted_by(binary)
        if meter in exact:
            return True
        return any(meter.startswith(h) for h in heads)

    # -------------------------------------------------- consumed routes

    def consumed_routes(self) -> List[ConsumedRoute]:
        out: List[ConsumedRoute] = []
        for m in self.ctx.all_modules():
            if m.relpath.startswith(f"{PACKAGE}/analysis/"):
                continue  # the lint's own extraction patterns aren't edges
            out.extend(self._consumed_in(m))
        return out

    def _consumed_in(self, m: ModuleUnit) -> List[ConsumedRoute]:
        out: List[ConsumedRoute] = []
        claimed: Set[int] = set()
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = (
                node.func.attr
                if isinstance(node.func, ast.Attribute)
                else getattr(node.func, "id", "")
            )
            if fname not in _URL_CALLS and fname not in _HELPER_CALLS:
                continue
            for arg in node.args:
                if isinstance(arg, ast.JoinedStr):
                    claimed.add(id(arg))
                    ref = self._route_of_joined(arg, m)
                    if ref:
                        out.append(ref)
                elif (
                    fname in _HELPER_CALLS
                    and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)
                    and arg.value.startswith("/")
                ):
                    route = self._clean_route(arg.value)
                    if route:
                        # hint: endpoint-arg identifiers, else the
                        # enclosing class (LeagueClient._get("/match"))
                        idents = set()
                        for other in node.args:
                            if other is not arg:
                                idents |= _idents(other)
                        if isinstance(node.func, ast.Attribute):
                            idents |= _idents(node.func.value)
                        hint = _hint_of(idents) or _hint_of(
                            {m.qualname_at(node).split(".")[0].lower()}
                        )
                        out.append(
                            ConsumedRoute(
                                route, m.relpath, arg.lineno, hint,
                                m.qualname_at(node),
                            )
                        )
        # URL f-strings bound to a variable first (base = f"http://…";
        # urlopen(f"{base}/metrics") is caught above, the direct
        # url = f"http://{ep}/route" assignment here)
        for node in ast.walk(m.tree):
            if isinstance(node, ast.JoinedStr) and id(node) not in claimed:
                first = node.values[0] if node.values else None
                if (
                    isinstance(first, ast.Constant)
                    and isinstance(first.value, str)
                    and first.value.startswith(("http://", "https://"))
                ):
                    ref = self._route_of_joined(node, m)
                    if ref:
                        out.append(ref)
        return out

    @staticmethod
    def _clean_route(raw: str) -> Optional[str]:
        route = raw.split("?", 1)[0]
        if route in ("", "/") or not _ROUTE_RE.match(route):
            return None
        return route

    def _route_of_joined(self, j: ast.JoinedStr, m: ModuleUnit) -> Optional[ConsumedRoute]:
        """Constant route tail of a URL-shaped f-string: the last "/…"
        constant after the first formatted field (the host), or a "/…"
        constant head (helper-relative f"/snapshot?name={…}"). A tail
        that is itself dynamic (f"http://{ep}{path}") has no static
        route — the call-site constants cover those."""
        parts = j.values
        route_raw: Optional[str] = None
        first = parts[0] if parts else None
        if (
            isinstance(first, ast.Constant)
            and isinstance(first.value, str)
            and first.value.startswith("/")
        ):
            route_raw = first.value
        else:
            seen_field = False
            for part in parts:
                if isinstance(part, ast.FormattedValue):
                    seen_field = True
                elif (
                    seen_field
                    and isinstance(part, ast.Constant)
                    and isinstance(part.value, str)
                    and part.value.startswith("/")
                ):
                    route_raw = part.value
        if route_raw is None:
            return None
        route = self._clean_route(route_raw)
        if route is None:
            return None
        return ConsumedRoute(
            route, m.relpath, j.lineno, _hint_of(_idents(j)), m.qualname_at(j)
        )

    # ------------------------------------------------------ k8s surfaces

    def _manifests(self) -> List[Tuple[str, List[str]]]:
        cached = getattr(self, "_manifest_cache", None)
        if cached is None:
            cached = []
            k8s = self.ctx.k8s_dir
            if k8s and os.path.isdir(k8s):
                for name in sorted(os.listdir(k8s)):
                    if not name.endswith((".yaml", ".yml")):
                        continue
                    path = os.path.join(k8s, name)
                    rel = os.path.relpath(path, self.ctx.root).replace(os.sep, "/")
                    source = self.ctx.source_of(path)
                    if source is None:
                        continue
                    stripped = [
                        ln.split("#", 1)[0] for ln in source.splitlines()
                    ]
                    cached.append((rel, stripped))
            self._manifest_cache = cached
        return cached

    def _block_binaries(
        self, stripped: List[str]
    ) -> Tuple[List[Tuple[int, int, str]], Set[str]]:
        """([(start, end, binary)] for item blocks naming exactly one
        known binary, every known binary in the file). Lines are
        0-based inclusive, matching _item_blocks."""
        blocks = []
        file_mods: Set[str] = set()
        for b_start, b_end, _indent in _item_blocks(stripped):
            mods = set()
            for ln in stripped[b_start : b_end + 1]:
                mods.update(mod for mod in binary_modules(ln) if mod in _BINARY_CONFIGS)
            file_mods |= mods
            if len(mods) == 1:
                blocks.append((b_start, b_end, next(iter(mods))))
        return blocks, file_mods

    def probe_routes(self) -> List[ProbeRoute]:
        """k8s liveness/readiness httpGet paths + prometheus.io/path
        scrape annotations, each attributed to the binary whose
        container block (probes) or manifest (annotations, when the
        file runs exactly one known binary) declares them."""
        out: List[ProbeRoute] = []
        for rel, stripped in self._manifests():
            blocks, file_mods = self._block_binaries(stripped)
            sole = next(iter(file_mods)) if len(file_mods) == 1 else None
            prev_nonblank = ""
            for i, ln in enumerate(stripped):
                route: Optional[str] = None
                flow = _HTTPGET_FLOW_RE.search(ln)
                if flow:
                    route = flow.group(1)
                elif ln.strip().startswith("path:") and prev_nonblank.strip().endswith(
                    "httpGet:"
                ):
                    route = ln.split(":", 1)[1].strip().strip('"')
                if route and route.startswith("/"):
                    binary = sole
                    for b_start, b_end, mod in blocks:
                        if b_start <= i <= b_end:
                            binary = mod  # innermost resolved block wins
                    if binary:
                        out.append(ProbeRoute(route, rel, i + 1, binary))
                else:
                    prom = _PROM_PATH_RE.search(ln)
                    if prom and sole and prom.group(1).startswith("/"):
                        out.append(ProbeRoute(prom.group(1), rel, i + 1, sole))
                if ln.strip():
                    prev_nonblank = ln
        return out

    def _manifest_flag_values(
        self, stripped: List[str]
    ) -> List[Tuple[str, str, int]]:
        """(flag-without-dashes, value, 1-based line-of-value) for every
        ``- "--flag"`` arg item, taking the inline ``=value`` or the
        next arg item as the value."""
        out = []
        i = 0
        while i < len(stripped):
            m = _ARG_ITEM_RE.match(stripped[i])
            if m:
                flag = m.group(1)[2:]
                if m.group(2) is not None:
                    out.append((flag, m.group(2), i + 1))
                else:
                    for j in range(i + 1, len(stripped)):
                        if not stripped[j].strip():
                            continue
                        vm = _VALUE_ITEM_RE.match(stripped[j])
                        if vm and not vm.group(1).startswith("--"):
                            out.append((flag, vm.group(1), j + 1))
                        break
            i += 1
        return out

    def clause_meters(self) -> List[ClauseMeter]:
        """Meter names the k8s manifests' --control.policy and
        --fleet.alerts clauses key decisions on. Scripts are excluded
        deliberately: the soak drivers watch harness-synthetic meters
        (their fake tiers export them); the manifests are the deploy
        surface of record."""
        out: List[ClauseMeter] = []
        for rel, stripped in self._manifests():
            for flag, value, line in self._manifest_flag_values(stripped):
                if not value.strip():
                    continue
                if flag == "control.policy":
                    for clause in value.split(";"):
                        head = clause.split(",", 1)[0]
                        tier, sep, meter = head.partition(":")
                        if not sep:
                            continue  # malformed — SVC003's finding
                        meter = meter.strip()
                        for suffix in AGG_SUFFIXES:
                            if meter.endswith(suffix):
                                meter = meter[: -len(suffix)]
                                break
                        if meter:
                            out.append(
                                ClauseMeter(
                                    meter, tier.strip(), rel, line, "control_policy"
                                )
                            )
                elif flag == "fleet.alerts":
                    for clause in value.split(";"):
                        meter = clause.split(",", 1)[0].strip()
                        if meter:
                            out.append(
                                ClauseMeter(meter, "fleetd", rel, line, "fleet_alerts")
                            )
        return out

    # -------------------------------------------------- grammar literals

    def grammar_literals(self) -> List[GrammarLiteral]:
        """Every config-grammar string the fleet would parse at boot:
        manifest flag values, soak-driver module constants (POLICY/
        ALERTS/…), argparse defaults, and subprocess-argv flag pairs."""
        out: List[GrammarLiteral] = []
        for rel, stripped in self._manifests():
            for flag, value, line in self._manifest_flag_values(stripped):
                grammar = GRAMMAR_FLAGS.get(flag)
                if grammar and value.strip():
                    out.append(GrammarLiteral(grammar, value, rel, line))
        for script in self.ctx.script_modules():
            for node in ast.walk(script.tree):
                if isinstance(node, ast.Assign):
                    if not (
                        isinstance(node.value, ast.Constant)
                        and isinstance(node.value.value, str)
                        and node.value.value.strip()
                    ):
                        continue
                    for tgt in node.targets:
                        grammar = GRAMMAR_CONSTS.get(getattr(tgt, "id", ""))
                        if grammar:
                            out.append(
                                GrammarLiteral(
                                    grammar, node.value.value,
                                    script.relpath, node.lineno,
                                )
                            )
                elif isinstance(node, ast.Call):
                    fname = (
                        node.func.attr
                        if isinstance(node.func, ast.Attribute)
                        else getattr(node.func, "id", "")
                    )
                    if fname == "add_argument":
                        flag_name = ""
                        for arg in node.args:
                            if (
                                isinstance(arg, ast.Constant)
                                and isinstance(arg.value, str)
                                and arg.value.startswith("--")
                            ):
                                flag_name = arg.value[2:]
                        grammar = GRAMMAR_FLAGS.get(flag_name)
                        if grammar:
                            for kw in node.keywords:
                                if (
                                    kw.arg == "default"
                                    and isinstance(kw.value, ast.Constant)
                                    and isinstance(kw.value.value, str)
                                    and kw.value.value.strip()
                                ):
                                    out.append(
                                        GrammarLiteral(
                                            grammar, kw.value.value,
                                            script.relpath, kw.value.lineno,
                                        )
                                    )
                elif isinstance(node, ast.List):
                    elts = node.elts
                    for i, elt in enumerate(elts[:-1]):
                        if not (
                            isinstance(elt, ast.Constant)
                            and isinstance(elt.value, str)
                            and elt.value.startswith("--")
                        ):
                            continue
                        grammar = GRAMMAR_FLAGS.get(elt.value[2:])
                        nxt = elts[i + 1]
                        if (
                            grammar
                            and isinstance(nxt, ast.Constant)
                            and isinstance(nxt.value, str)
                            and nxt.value.strip()
                        ):
                            out.append(
                                GrammarLiteral(
                                    grammar, nxt.value, script.relpath, nxt.lineno
                                )
                            )
        return out

    # --------------------------------------------------- ledger identities

    def ledger_terms(self) -> Tuple[List[LedgerRef], Optional[str]]:
        """((ledger, meter, tier) terms of obs/fleet.py LEDGERS, error).
        No fleet.py in the corpus → ([], None): nothing to pin. A
        fleet.py whose LEDGERS can't be extracted → loud error — the
        WIRE001 discipline: an auditor the lint can no longer read is
        itself drift, never a silent skip."""
        m = self.by_rel.get(FLEET_REL)
        if m is None:
            return [], None
        assign = None
        for node in ast.walk(m.tree):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
            if any(getattr(t, "id", "") == "LEDGERS" for t in targets):
                assign = node
                break
        if assign is None:
            return [], "obs/fleet.py defines no LEDGERS assignment"
        value = assign.value
        if not isinstance(value, (ast.Tuple, ast.List)):
            return [], "LEDGERS is not a literal tuple of LedgerSpec(...) calls"
        terms: List[LedgerRef] = []
        for spec in value.elts:
            if not (
                isinstance(spec, ast.Call)
                and getattr(spec.func, "id", getattr(spec.func, "attr", ""))
                == "LedgerSpec"
            ):
                return [], "LEDGERS entry is not a LedgerSpec(...) call"
            name = ""
            term_nodes: List[ast.expr] = []
            for kw in spec.keywords:
                if kw.arg == "name" and isinstance(kw.value, ast.Constant):
                    name = str(kw.value.value)
                elif kw.arg == "terms" and isinstance(
                    kw.value, (ast.Tuple, ast.List)
                ):
                    term_nodes = kw.value.elts
            if spec.args and isinstance(spec.args[0], ast.Constant):
                name = str(spec.args[0].value)
            if not name or not term_nodes:
                return [], "LedgerSpec without a literal name= and terms= tuple"
            for tn in term_nodes:
                if not (
                    isinstance(tn, ast.Call)
                    and getattr(tn.func, "id", getattr(tn.func, "attr", ""))
                    == "LedgerTerm"
                ):
                    return [], f"ledger {name!r} has a non-LedgerTerm term"
                fields: Dict[str, ast.expr] = {}
                for pos, arg in enumerate(tn.args):
                    fields[("meter", "tier", "sign")[pos] if pos < 3 else str(pos)] = arg
                for kw in tn.keywords:
                    if kw.arg:
                        fields[kw.arg] = kw.value
                meter = fields.get("meter")
                tier = fields.get("tier")
                if not (
                    isinstance(meter, ast.Constant)
                    and isinstance(meter.value, str)
                    and isinstance(tier, ast.Constant)
                    and isinstance(tier.value, str)
                ):
                    return [], f"ledger {name!r} term without literal meter/tier"
                terms.append(LedgerRef(name, meter.value, tier.value, tn.lineno))
        if not terms:
            return [], "LEDGERS extracted to zero terms"
        return terms, None


def _idents(node: ast.AST) -> Set[str]:
    """Lowercased identifier words inside an expression — the hint text
    for endpoint-variable → binary resolution."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id.lower())
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr.lower())
    return out


def _hint_of(idents: Set[str]) -> Optional[str]:
    text = " ".join(sorted(idents))
    for key, binary in _HINTS:
        if key in text:
            return binary
    return None


def fleet_graph(ctx: RepoContext) -> FleetGraph:
    """The per-lint-run FleetGraph, built once and cached on the ctx
    (the _registry_names idiom — four SVC rules share one extraction)."""
    cached = getattr(ctx, "_fleet_graph_cache", None)
    if cached is None:
        cached = ctx._fleet_graph_cache = FleetGraph(ctx)
    return cached
