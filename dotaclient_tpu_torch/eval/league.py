"""A local league (own copy of dotaclient_tpu/eval/league.py): the
opponent pool of one self-play actor, with PFSP draws.

Snapshots are frozen copies of the weight frames the actor receives
anyway, as flax-named numpy pairs (transport/params.py), each rated with
TrueSkill against the live agent. `sample_opponent` draws with
`np.random.RandomState(seed)` exactly as the reference does, so for one
seed and one result sequence the opponents are the reference's.

PFSP curves f(p), p = P(agent beats the snapshot): "hard" (1-p)^2 (the
opponents the agent loses to), "even" p(1-p) (those near 50%), "uniform"
1 (plain fictitious self-play). Host-side only.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from dotaclient_tpu_torch.eval.rating import RatingTable, win_probability

NamedParams = List[Tuple[str, np.ndarray]]  # (flax name, f32 array): transport/params.py

AGENT = "agent"

# PFSP weighting curves f(p) where p = P(agent beats snapshot):
#   hard:    (1-p)^2  — mostly the opponents we lose to (AlphaStar main-exploiter flavour)
#   even:    p(1-p)   — opponents near 50%, the highest-information games
#   uniform: 1        — plain fictitious self-play
_PFSP_CURVES = {
    "hard": lambda p: (1.0 - p) ** 2,
    "even": lambda p: p * (1.0 - p),
    "uniform": lambda p: np.ones_like(p),
}


class Snapshot(NamedTuple):
    name: str  # "v<version>"
    version: int
    named_params: NamedParams  # wire-format flat params


class League:
    """Bounded snapshot pool with TrueSkill bookkeeping and PFSP draws."""

    def __init__(
        self,
        capacity: int = 8,
        snapshot_every: int = 20,
        mode: str = "hard",
        seed: int = 0,
    ):
        if mode not in _PFSP_CURVES:
            raise ValueError(f"unknown pfsp mode {mode!r}; want one of {sorted(_PFSP_CURVES)}")
        self.capacity = capacity
        self.snapshot_every = snapshot_every
        self.mode = mode
        self.table = RatingTable()
        self.table.add(AGENT)
        self._snapshots: Dict[str, Snapshot] = {}
        self._last_snap_version: Optional[int] = None
        self._rng = np.random.RandomState(seed)
        # the league_* counters stats() exports: admissions, evictions,
        # draws, results
        self.snapshots_total = 0
        self.evictions_total = 0
        self.opponent_samples_total = 0
        self.results_total = 0

    # ------------------------------------------------------------ snapshots

    def __len__(self) -> int:
        return len(self._snapshots)

    @property
    def names(self) -> List[str]:
        return list(self._snapshots)

    def maybe_snapshot(self, version: int, named_params: NamedParams) -> bool:
        """Admit `named_params` as snapshot v<version> if it is
        `snapshot_every` versions past the previous snapshot. The snapshot
        inherits the agent's current rating (it IS the agent, frozen).

        A version REGRESSION (learner restarted without a checkpoint, or
        a dead-boot straggler frame resynced the agent backwards —
        apply_weight_frame) resets the cadence anchor:
        without the reset, a stale high-version snapshot would make
        `version - last < snapshot_every` hold for the entire new boot
        and silently disable league snapshotting."""
        if self._last_snap_version is not None and version < self._last_snap_version:
            self._last_snap_version = None
        if self._last_snap_version is not None and version - self._last_snap_version < self.snapshot_every:
            return False
        name = f"v{version}"
        if name in self._snapshots:
            return False
        # copy: the caller may mutate its arrays (unflatten targets)
        frozen = [(k, np.array(v, copy=True)) for k, v in named_params]
        self._snapshots[name] = Snapshot(name, version, frozen)
        self.table.add(name, rating=self.table.get(AGENT))
        self._last_snap_version = version
        self.snapshots_total += 1
        if len(self._snapshots) > self.capacity:
            self._evict()
        return True

    def _evict(self) -> None:
        """Drop the weakest snapshot, never the newest — the pool should
        track the frontier of past strength, not a museum of early junk."""
        newest = max(self._snapshots.values(), key=lambda s: s.version).name
        candidates = [n for n in self._snapshots if n != newest]
        # weakest by mu (strength estimate) — conservative would punish
        # barely-played snapshots for their uncertainty, not their skill
        weakest = min(candidates, key=lambda n: self.table.get(n).mu)
        del self._snapshots[weakest]
        self.evictions_total += 1

    # ------------------------------------------------------------- sampling

    def sample_opponent(self) -> Optional[Snapshot]:
        """PFSP draw from the pool; None while the pool is empty (caller
        falls back to mirror self-play against the live weights)."""
        if not self._snapshots:
            return None
        names = list(self._snapshots)
        agent = self.table.get(AGENT)
        p = np.asarray([win_probability(agent, self.table.get(n)) for n in names])
        w = _PFSP_CURVES[self.mode](p) + 1e-6  # floor: nobody is ever unpickable
        w = w / w.sum()
        self.opponent_samples_total += 1
        return self._snapshots[names[int(self._rng.choice(len(names), p=w))]]

    # -------------------------------------------------------------- results

    def record_result(self, opponent: str, win: float) -> None:
        """win > 0: agent beat `opponent`; < 0: lost; == 0: decided draw.

        Head-to-head on purpose, even for 5v5: a league match is ONE
        policy (controlling its whole team) against ONE frozen snapshot,
        so the entities being rated are the policies — the two-team
        partial-play update (rating.rate_teams / record_teams) is for
        rosters whose members carry separate ratings (mixed-snapshot
        teams, per-hero ratings), which this league never forms."""
        if opponent not in self._snapshots:
            return  # opponent already evicted — rating signal is stale
        self.results_total += 1
        if win > 0:
            self.table.record(AGENT, opponent)
        elif win < 0:
            self.table.record(opponent, AGENT)
        else:
            self.table.record(AGENT, opponent, draw=True)

    # ------------------------------------------------------------- metrics

    def stats(self) -> Dict[str, float]:
        """The league_* scalars: pool occupancy and the cumulative
        admission, eviction, draw and result counters."""
        return {
            "league_pool_size": float(len(self._snapshots)),
            "league_snapshots_total": float(self.snapshots_total),
            "league_evictions_total": float(self.evictions_total),
            "league_opponent_samples_total": float(self.opponent_samples_total),
            "league_results_total": float(self.results_total),
        }
