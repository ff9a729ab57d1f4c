"""Matchmaking policy grammar (own copy of dotaclient_tpu/league/policy.py).

    policy   := clause (";" clause)*
    clause   := kind ("@" weight)?
    kind     := "uniform" | "prioritized" | "exploiter"
    weight   := positive float (default 1.0)

Each GET /match draws ONE clause, categorically by weight, then samples
under that clause's rule:

- `uniform`     — flat draw over the serve-assigned population.
- `prioritized` — PFSP-hard over observed results: an opponent's weight
  is its win rate against the agent (+ a floor so nobody is ever
  unpickable).
- `exploiter`   — the caller plays the exploiter role against the main
  live tree (model 0), seeding exploiter candidates with the games their
  promotion gate needs.

A malformed spec fails at boot (ValueError): a typo'd kind must stop the
service, not matchmake uniform in silence.
"""

from __future__ import annotations

from typing import List, NamedTuple

KINDS = ("uniform", "prioritized", "exploiter")


class MatchClause(NamedTuple):
    kind: str
    weight: float


def parse_match_policy(spec: str) -> List[MatchClause]:
    clauses: List[MatchClause] = []
    for raw in str(spec).split(";"):
        part = raw.strip()
        if not part:
            continue
        kind, sep, weight_s = part.partition("@")
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(
                f"unknown matchmaking kind {kind!r} in {spec!r}; "
                f"want one of {list(KINDS)}"
            )
        weight = 1.0
        if sep:
            try:
                weight = float(weight_s)
            except ValueError:
                raise ValueError(f"malformed clause weight in {part!r}")
            if not weight > 0.0:
                raise ValueError(f"clause weight must be > 0 in {part!r}")
        clauses.append(MatchClause(kind, weight))
    if not clauses:
        raise ValueError(f"empty matchmaking policy {spec!r}")
    return clauses
