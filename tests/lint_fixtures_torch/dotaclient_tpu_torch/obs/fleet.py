"""Fixture conservation ledger for SVC004. One good term (the fixture
actor exports actor_fixture_sent_total) and one bad term:
fleet_ghost_dropped_total is registered, but no module reachable from
the actor binary exports it — the audit identity silently loses a leg.
Never imported — AST only."""

from typing import NamedTuple, Tuple


class LedgerTerm(NamedTuple):
    meter: str
    tier: str
    sign: float
    kind: str = "counter"
    required: bool = True


class LedgerSpec(NamedTuple):
    name: str
    doc: str
    terms: Tuple[LedgerTerm, ...]


LEDGERS: Tuple[LedgerSpec, ...] = (
    LedgerSpec(
        name="fixture_producer",
        doc="frames published minus frames dropped",
        terms=(
            LedgerTerm("actor_fixture_sent_total", "actor", +1.0),
            # SVC004: registered, but the actor tier never exports it
            LedgerTerm("fleet_ghost_dropped_total", "actor", -1.0),
        ),
    ),
)
