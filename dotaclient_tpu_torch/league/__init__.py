"""The standing league service (torch twin of dotaclient_tpu/league/): one
queryable population shared by the fleet.

- league/registry.py  disk-backed snapshots with lineage records;
- league/policy.py    the matchmaking clause grammar;
- league/server.py    LeagueService: GET /match, POST /result (TrueSkill,
                      eval/rating.py), /leaderboard, /lineage,
                      /assignments for the serve tier's model slots,
                      /snapshot; `python -m dotaclient_tpu_torch.league.server`;
- league/client.py    a stdlib HTTP client of that surface.

Numpy for the snapshot trees, the standard library for everything else:
nothing here touches the device.
"""

from dotaclient_tpu_torch.league.policy import MatchClause, parse_match_policy
from dotaclient_tpu_torch.league.registry import SnapshotRegistry

__all__ = ["MatchClause", "parse_match_policy", "SnapshotRegistry"]
