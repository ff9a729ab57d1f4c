"""Mini scalar registry for the OBS001 fixtures. Never imported."""

SCALARS = {
    "good_scalar": "a documented scalar",
    "loss": "a documented loss",
    # SVC fixtures: alert meter fleetd exports (SVC002 good side), the
    # actor-side ledger term (SVC004 good side), and a term that is
    # registered but that NO actor-reachable module exports (SVC004 bad)
    "fleet_fixture_ok": "fleetd rollup the alert fixture watches",
    "actor_fixture_sent_total": "frames the fixture actor published",
    "fleet_ghost_dropped_total": "registered but exported by no tier",
}

PREFIXES = {
    "fam_": "a documented dynamic family",
}
