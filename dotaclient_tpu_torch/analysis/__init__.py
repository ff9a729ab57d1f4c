"""Graftcheck of the port (twin of dotaclient_tpu/analysis/): repo-native
static analysis and dynamic sanitizers for the hazards the port ships —
thread-safety discipline around its daemon threads, the transfer ring's
copy-event fence, observability and config contract drift, the fleet's
string-typed contracts, and the concurrency protocols of the host feed
and the serve tier.

Static rule families (see the sibling modules for the full rule docs):

- THR (thr_rules.py)  — classes that spawn a ``threading.Thread`` must
  guard worker-written attributes read from public methods with the
  instance lock, or read them as a single atomic rebound reference; plus
  package-wide lock-acquisition-order consistency.
- OBS (obs_rules.py)  — scalar names logged to MetricsLogger must exist
  in ``obs/registry.py``; ``--flags`` in ``k8s/*.yaml`` and in the
  drivers' subprocess argv lists must exist in the spawned binary's
  namespace; defined config fields must be read somewhere.
- LIF/WIRE (lif_rules.py) — TransferRing lease lifecycle (released or
  returned on every path, never before its copy's CUDA event has been
  synchronised or observed complete), drained()-station reachability,
  and WIRE001: the DTR wire layout extracted from BOTH
  transport/serialize.py (ast) and csrc/packer.cc (structured regex)
  into one spec table, failing on any drift.
- SVC (proto_rules.py over fleetgraph.py) — HTTP routes, policy and
  alert meters, config-grammar literals (parsed by the real parsers in
  a subprocess, grammar_check.py) and conservation-ledger terms must
  resolve against their producers.

The reference's JAX rules are not ported: they check jit regions, and
the port has none.

Runtime counterparts (opt-in only, production-inert — no module of the
port imports them):

- ``lockcheck.py``  — instrumented ``threading.Lock`` recording
  per-thread acquisition order: lock-order inversions + over-held locks.
- ``racecheck.py``  — vector-clock happens-before race sanitizer:
  repo-created locks/conditions/events/queues/threads and, on request,
  CUDA events convey HB edges; opted-in instances get attribute-write
  tracing; write-write pairs with no HB ordering are race reports
  (reasoned suppressions only).
- ``schedcheck.py`` — deterministic schedule exploration over explicit
  models of the port's concurrency protocols (the transfer-ring lease,
  the prefetch lane, the drain stations, checkpoint coalescing, the
  serve hot-swap, the carry handoff, the fabric's shard-epoch fence),
  every bounded interleaving exhausted, with mutants that re-introduce
  each bug class.

The lint path is pure stdlib + ``ast``: linting the package never
imports the package, torch, numpy or JAX. Importing this package
imports only core.py (stdlib). Entry point:
``python -m dotaclient_tpu_torch.scripts.lint_graft``.
"""

from __future__ import annotations

from dotaclient_tpu_torch.analysis.core import (
    Finding,
    LintReport,
    lint_repo,
    load_baseline,
    write_baseline,
)

__all__ = [
    "Finding",
    "LintReport",
    "lint_repo",
    "load_baseline",
    "write_baseline",
]
