"""Fixture actor binary for SVC004: exports actor_fixture_sent_total
(the good ledger term) and deliberately does NOT export
fleet_ghost_dropped_total (the bad term obs/fleet.py sums over this
tier). Never imported — AST only."""

ROLLUP = {"actor_fixture_sent_total": 0.0}


def tick():
    ROLLUP["actor_fixture_sent_total"] += 1.0
