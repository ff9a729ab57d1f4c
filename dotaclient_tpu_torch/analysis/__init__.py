"""Analysis tools of the port (twin of dotaclient_tpu/analysis/).

- ``schedcheck.py``: deterministic schedule exploration over explicit
  models of the port's concurrency protocols (the transfer-ring lease, the
  prefetch lane, the drain stations, checkpoint coalescing, the serve
  hot-swap, the carry handoff, the fabric's shard-epoch fence), every
  bounded interleaving exhausted, with mutants that re-introduce each bug
  class. Pure stdlib.

The reference's lint rules, lock and race sanitizers and fleet graph are
not ported yet (ROADMAP.md A.20). Importing this package imports nothing.
"""
