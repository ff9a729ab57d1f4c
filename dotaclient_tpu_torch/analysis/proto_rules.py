"""SVC rules: graftproto — whole-fleet contract verification.

The fleet's cross-tier contracts are strings: HTTP route paths, meter
names, config-grammar clauses, conservation-ledger identities. Every
one used to be guarded by a hand-written pin in test_obs/test_k8s/
test_control — or by nothing. These rules cross-check the static fleet
contract graph (analysis/fleetgraph.py) so a rename on either side of
any edge fails the lint, not a 3am "meter missing" freeze:

SVC001 (error) — every consumed route (k8s probe paths and
``prometheus.io/path`` annotations, package/scripts URL literals) must
be served by its target binary: probes by the container's ``-m`` binary,
code edges by the binary the endpoint variable names (``_league_
endpoint`` → league.server), unhinted edges by *some* fleet surface.
Subsumes the hand-pinned probe-path checks test_k8s.py used to carry.

SVC002 (error) — every meter a k8s ``--control.policy`` or
``--fleet.alerts`` clause keys decisions on must (a) resolve in
obs/registry.py (exact SCALARS name, PREFIXES family, or an
``aggregate_tier`` special), and (b) be exported by the tier the clause
scrapes — the clause's tier binary for policy, fleetd's own rollups for
alerts. An unresolvable meter holds topology forever ("meter missing"
is a loud HOLD, never a scale): drift here silently disables scaling.

SVC003 (error) — every config-grammar literal (manifest policy/alert/
matchmaking clauses, soak-driver policy constants and chaos argparse
defaults) must parse with the REAL parser that reads it at boot. Runs
the parsers in one memoized subprocess (analysis/grammar_check.py) so
the lint process keeps its never-imports-the-package invariant, and
reports torch, jax/jaxlib or the JAX package leaking into the parser
import closure.

SVC004 (error) — the conservation-ledger identities fleetd audits
(obs/fleet.py LEDGERS) must term-for-term name meters that are (a)
registered and (b) exported by the emitting tier's binary — the
conservation-audit contract pinned statically. A LEDGERS tuple the extractor can no
longer read is itself a loud finding (the WIRE001 discipline), never a
silent skip.

All pure AST (SVC003's parsers excepted, by subprocess). Rules skip
cleanly on corpora with no HTTP layer / no manifests / no fleet.py —
synthetic single-file lint trees must not drown in fleet findings.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Dict, List, Tuple

from dotaclient_tpu_torch.analysis.core import Finding, RepoContext, Rule, register
from dotaclient_tpu_torch.analysis.fleetgraph import (
    AGG_SPECIALS,
    FLEET_REL,
    TIER_BINARIES,
    GrammarLiteral,
    fleet_graph,
)
from dotaclient_tpu_torch.analysis.obs_rules import _registered, _registry_names

# one subprocess per distinct literal set per lint process — test suites
# lint many tree copies carrying identical manifests; re-spawning the
# interpreter for each would dominate the whole lint's wall clock
_GRAMMAR_MEMO: Dict[Tuple, Dict] = {}


def _check_grammars(literals: List[GrammarLiteral]) -> Dict:
    """{"failures": [...], "banned_imports": [...]} from the real
    parsers, run in grammar_check.py's fresh interpreter. The parsers
    are the LINT'S OWN — fixture corpora exercise the rule against the
    real grammar, and a mutated tree under test can't redefine the
    contract it is being checked against."""
    key = tuple(sorted((lit.grammar, lit.text) for lit in literals))
    cached = _GRAMMAR_MEMO.get(key)
    if cached is None:
        here = os.path.dirname(os.path.abspath(__file__))
        repo_root = os.path.dirname(os.path.dirname(here))
        runner = os.path.join(here, "grammar_check.py")
        payload = {
            "root": repo_root,
            "items": [
                {
                    "grammar": lit.grammar,
                    "text": lit.text,
                    "path": lit.relpath,
                    "line": lit.line,
                }
                for lit in literals
            ],
        }
        try:
            proc = subprocess.run(
                [sys.executable, runner],
                input=json.dumps(payload),
                capture_output=True,
                text=True,
                timeout=60,
            )
            if proc.returncode != 0:
                cached = {"error": proc.stderr.strip()[-500:] or "non-zero exit"}
            else:
                cached = json.loads(proc.stdout)
        except (OSError, subprocess.TimeoutExpired, ValueError) as e:
            cached = {"error": repr(e)}
        _GRAMMAR_MEMO[key] = cached
    return cached


@register
class ConsumedRouteUnserved(Rule):
    id = "SVC001"
    severity = "error"
    doc = "HTTP route consumed by a tier/probe but served by no binary"

    def run_repo(self, ctx: RepoContext) -> List[Finding]:
        g = fleet_graph(ctx)
        if not g.has_http_layer():
            return []
        findings: List[Finding] = []
        for probe in g.probe_routes():
            served = g.served_by(probe.binary)
            if not served:
                continue  # binary entry not in this corpus
            if probe.route not in served:
                findings.append(
                    self.make(
                        probe.relpath,
                        probe.line,
                        f"probe/scrape path {probe.route!r} is not served by "
                        f"{probe.binary} (serves: "
                        f"{', '.join(sorted(served))}) — kubelet/prometheus "
                        f"will 404; fix the manifest or register the route",
                    )
                )
        union = g.served_union()
        for edge in g.consumed_routes():
            target = edge.hint if edge.hint in g.binaries else None
            if target is not None:
                served_map = g.served_by(target)
                if served_map and edge.route not in served_map:
                    findings.append(
                        self.make(
                            edge.relpath,
                            edge.line,
                            f"route {edge.route!r} is dialed against {target} "
                            f"but that binary serves only "
                            f"{', '.join(sorted(served_map))} — the request "
                            f"404s at runtime; fix the caller or register "
                            f"the route",
                            context=edge.context,
                        )
                    )
            elif edge.route not in union:
                findings.append(
                    self.make(
                        edge.relpath,
                        edge.line,
                        f"route {edge.route!r} is dialed here but NO fleet "
                        f"binary or driver surface serves it — the request "
                        f"can only 404; fix the caller or register the route",
                        context=edge.context,
                    )
                )
        return findings


@register
class PolicyMeterDrift(Rule):
    id = "SVC002"
    severity = "error"
    doc = "policy/alert clause meter that no registry name or scraped tier exports"

    def run_repo(self, ctx: RepoContext) -> List[Finding]:
        if not (ctx.registry_path and os.path.exists(ctx.registry_path)):
            return []
        g = fleet_graph(ctx)
        scalars, prefixes = _registry_names(ctx)
        findings: List[Finding] = []
        for cm in g.clause_meters():
            if cm.meter in AGG_SPECIALS:
                continue  # aggregate_tier synthesizes up/scraped per tier
            surface = (
                "--control.policy"
                if cm.grammar == "control_policy"
                else "--fleet.alerts"
            )
            if not _registered(cm.meter, scalars, prefixes):
                findings.append(
                    self.make(
                        cm.relpath,
                        cm.line,
                        f"{surface} clause keys on meter {cm.meter!r}, which "
                        f"resolves to no obs/registry.py SCALARS name or "
                        f"PREFIXES family — the clause can only ever read "
                        f"'meter missing' and freeze topology; fix the "
                        f"clause or register the meter",
                    )
                )
                continue
            binary = TIER_BINARIES.get(cm.tier)
            if binary is None or binary not in g.binaries:
                continue
            if not g.exports_meter(binary, cm.meter):
                findings.append(
                    self.make(
                        cm.relpath,
                        cm.line,
                        f"{surface} clause keys on meter {cm.meter!r} for "
                        f"tier {cm.tier!r}, but no module reachable from "
                        f"{binary} exports that name — the scrape never "
                        f"carries it and the clause freezes on 'meter "
                        f"missing'; fix the clause or export the meter",
                    )
                )
        return findings


@register
class GrammarParseDrift(Rule):
    id = "SVC003"
    severity = "error"
    doc = "config-grammar literal that the real parser rejects at boot"

    def run_repo(self, ctx: RepoContext) -> List[Finding]:
        g = fleet_graph(ctx)
        literals = g.grammar_literals()
        if not literals:
            return []
        result = _check_grammars(literals)
        if "error" in result:
            # the proof infrastructure failing is a gate failure, not a
            # skip — otherwise a broken runner silently passes everything
            first = literals[0]
            return [
                self.make(
                    first.relpath,
                    first.line,
                    f"grammar check subprocess failed "
                    f"({result['error']}) — cannot prove any config "
                    f"grammar literal parses; fix "
                    f"analysis/grammar_check.py",
                )
            ]
        findings: List[Finding] = []
        for failure in result.get("failures", ()):
            findings.append(
                self.make(
                    failure["path"],
                    int(failure["line"]),
                    f"{failure['grammar']} literal does not parse with the "
                    f"real parser — the binary refuses to boot: "
                    f"{failure['error']}",
                )
            )
        for mod in result.get("banned_imports", ()):
            first = literals[0]
            findings.append(
                self.make(
                    first.relpath,
                    first.line,
                    f"importing the config-grammar parsers pulled {mod!r} "
                    f"into the interpreter — the control/league/fleet "
                    f"tiers are torch-free and import nothing of the JAX "
                    f"package by contract; gate the import",
                )
            )
        return findings


@register
class LedgerTermDrift(Rule):
    id = "SVC004"
    severity = "error"
    doc = "conservation-ledger term whose meter the emitting tier does not export"

    def run_repo(self, ctx: RepoContext) -> List[Finding]:
        g = fleet_graph(ctx)
        terms, err = g.ledger_terms()
        fleet_rel = FLEET_REL
        if err is not None:
            return [
                self.make(
                    fleet_rel,
                    1,
                    f"conservation-ledger extraction failed ({err}) — the "
                    f"audit identities can no longer be statically "
                    f"verified; keep LEDGERS a literal tuple of "
                    f"LedgerSpec(name=…, terms=(LedgerTerm(\"meter\", "
                    f"\"tier\", …), …))",
                )
            ]
        if not terms:
            return []
        have_registry = bool(
            ctx.registry_path and os.path.exists(ctx.registry_path)
        )
        scalars_prefixes = ((), ())
        if have_registry:
            scalars_prefixes = _registry_names(ctx)
        findings: List[Finding] = []
        for term in terms:
            if have_registry and not _registered(
                term.meter, scalars_prefixes[0], scalars_prefixes[1]
            ):
                findings.append(
                    self.make(
                        fleet_rel,
                        term.line,
                        f"ledger {term.ledger!r} term {term.meter!r} is not "
                        f"in obs/registry.py — the audit sums a meter no "
                        f"dashboard can select; register it or drop the "
                        f"term",
                        context="LEDGERS",
                    )
                )
                continue
            binary = TIER_BINARIES.get(term.tier)
            if binary is None:
                findings.append(
                    self.make(
                        fleet_rel,
                        term.line,
                        f"ledger {term.ledger!r} term {term.meter!r} names "
                        f"unknown tier {term.tier!r} — fleetd scrapes no "
                        f"such target class; fix the tier name",
                        context="LEDGERS",
                    )
                )
                continue
            if binary not in g.binaries:
                continue  # tier binary not in this corpus
            if not g.exports_meter(binary, term.meter):
                findings.append(
                    self.make(
                        fleet_rel,
                        term.line,
                        f"ledger {term.ledger!r} sums {term.meter!r} over "
                        f"tier {term.tier!r}, but no module reachable from "
                        f"{binary} exports that name — the audit term reads "
                        f"permanently absent and the identity silently "
                        f"loses a leg; fix the term or export the meter",
                        context="LEDGERS",
                    )
                )
        return findings
