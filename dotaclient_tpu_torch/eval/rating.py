"""TrueSkill ratings (own copy of dotaclient_tpu/eval/rating.py): agent
strength against the scripted bots and between league members.

The 1v1 and the two-team updates are the closed forms of the TrueSkill
factor graph (Herbrich et al., 2006), with the `trueskill` package's
default constants. Pure Python float math, the reference's operation for
operation, so a rating here equals the reference's exactly.
"""

from __future__ import annotations

import functools
import math
import statistics
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

# Canonical TrueSkill constants (same defaults as the trueskill package,
# so ratings are comparable with reference-era numbers).
MU = 25.0
SIGMA = MU / 3.0
BETA = SIGMA / 2.0
TAU = SIGMA / 100.0
DRAW_PROB = 0.10

@dataclass(frozen=True)
class Rating:
    mu: float = MU
    sigma: float = SIGMA

    @property
    def conservative(self) -> float:
        """mu − 3σ: the displayable "skill" (99.7% lower confidence)."""
        return self.mu - 3.0 * self.sigma


_NORMAL = statistics.NormalDist()
_pdf = _NORMAL.pdf
_cdf = _NORMAL.cdf


@functools.lru_cache(maxsize=None)
def draw_margin(
    draw_prob: float = DRAW_PROB, beta: float = BETA, n_players: int = 2
) -> float:
    """ε such that P(|performance diff| < ε) = draw_prob for a match with
    `n_players` total participants (√n·β is the performance-difference
    scale; n=2 is the 1v1 case). Cached — callers pass constant args."""
    if draw_prob <= 0.0:
        return 0.0
    return _NORMAL.inv_cdf(0.5 * (draw_prob + 1.0)) * math.sqrt(n_players) * beta


def _v_win(t: float, eps: float) -> float:
    x = t - eps
    denom = _cdf(x)
    if denom < 1e-12:  # extreme upset: linear tail of the truncated normal
        return -x
    return _pdf(x) / denom


def _w_win(t: float, eps: float) -> float:
    v = _v_win(t, eps)
    return v * (v + t - eps)


def _v_draw(t: float, eps: float) -> float:
    abs_t = abs(t)
    denom = _cdf(eps - abs_t) - _cdf(-eps - abs_t)
    if denom < 1e-12:
        v = eps - abs_t  # limit of the truncated-normal mean
    else:
        v = (_pdf(-eps - abs_t) - _pdf(eps - abs_t)) / denom
    # v computed for |t| is ≤ 0 (a draw under-performs the favourite);
    # mirror it for the underdog.
    return v if t >= 0 else -v


def _w_draw(t: float, eps: float) -> float:
    abs_t = abs(t)
    denom = _cdf(eps - abs_t) - _cdf(-eps - abs_t)
    if denom < 1e-12:
        return 1.0
    v = _v_draw(t, eps)
    return v * v + ((eps - abs_t) * _pdf(eps - abs_t) + (eps + abs_t) * _pdf(-eps - abs_t)) / denom


def rate_1v1(
    winner: Rating,
    loser: Rating,
    draw: bool = False,
    beta: float = BETA,
    tau: float = TAU,
    draw_prob: float = DRAW_PROB,
    fix_loser: bool = False,
) -> Tuple[Rating, Rating]:
    """One head-to-head update; returns (new_winner, new_loser).

    `fix_loser=True` leaves the loser's rating untouched — used to anchor
    the scripted-bot baselines so the agent's curve is measured against a
    fixed yardstick rather than a drifting one.
    """
    sw2 = winner.sigma**2 + tau**2
    sl2 = loser.sigma**2 + tau**2
    c2 = 2.0 * beta**2 + sw2 + sl2
    c = math.sqrt(c2)
    t = (winner.mu - loser.mu) / c
    eps = draw_margin(draw_prob, beta) / c
    if draw:
        v, w = _v_draw(t, eps), _w_draw(t, eps)
    else:
        v, w = _v_win(t, eps), _w_win(t, eps)
    w = min(max(w, 0.0), 1.0 - 1e-6)  # keep sigma² strictly positive

    new_winner = Rating(
        mu=winner.mu + sw2 / c * v,
        sigma=math.sqrt(sw2 * (1.0 - sw2 / c2 * w)),
    )
    if fix_loser:
        return new_winner, loser
    new_loser = Rating(
        mu=loser.mu - sl2 / c * v,
        sigma=math.sqrt(sl2 * (1.0 - sl2 / c2 * w)),
    )
    return new_winner, new_loser


def rate_teams(
    winners: "list[Rating]",
    losers: "list[Rating]",
    draw: bool = False,
    beta: float = BETA,
    tau: float = TAU,
    draw_prob: float = DRAW_PROB,
    fix_losers: bool = False,
) -> Tuple["list[Rating]", "list[Rating]"]:
    """Two-TEAM TrueSkill update (5v5 eval — VERDICT r3 weak item 7).

    Two teams is still a closed form of the factor graph (Herbrich et
    al. 2006 §4: team performance = sum of player performances, so the
    team-difference marginal is one truncated Gaussian — message passing
    only becomes iterative with >2 teams):

      c² = (n_w + n_l)·β² + Σ_w(σ_i²+τ²) + Σ_l(σ_i²+τ²)
      t  = (Σ_w μ_i − Σ_l μ_i)/c,  ε = Φ⁻¹((p_draw+1)/2)·√(n_w+n_l)·β/c
      μ_i ← μ_i ± (σ_i²+τ²)/c · v(t, ε)      (+ winners, − losers)
      σ_i² ← (σ_i²+τ²)·(1 − (σ_i²+τ²)/c² · w(t, ε))

    Each player moves in proportion to their OWN uncertainty — the
    partial-play credit assignment the 1v1 rule can't express.
    `rate_teams([a], [b])` reduces exactly to `rate_1v1(a, b)` (pinned
    in tests). `fix_losers` anchors the losing side (scripted-bot
    yardstick teams).
    """
    if not winners or not losers:
        raise ValueError("both teams need at least one player")
    n_total = len(winners) + len(losers)
    sw2 = [r.sigma**2 + tau**2 for r in winners]
    sl2 = [r.sigma**2 + tau**2 for r in losers]
    c2 = n_total * beta**2 + sum(sw2) + sum(sl2)
    c = math.sqrt(c2)
    t = (sum(r.mu for r in winners) - sum(r.mu for r in losers)) / c
    eps = draw_margin(draw_prob, beta, n_players=n_total) / c
    if draw:
        v, w = _v_draw(t, eps), _w_draw(t, eps)
    else:
        v, w = _v_win(t, eps), _w_win(t, eps)
    w = min(max(w, 0.0), 1.0 - 1e-6)

    new_winners = [
        Rating(mu=r.mu + s2 / c * v, sigma=math.sqrt(s2 * (1.0 - s2 / c2 * w)))
        for r, s2 in zip(winners, sw2)
    ]
    if fix_losers:
        return new_winners, list(losers)
    new_losers = [
        Rating(mu=r.mu - s2 / c * v, sigma=math.sqrt(s2 * (1.0 - s2 / c2 * w)))
        for r, s2 in zip(losers, sl2)
    ]
    return new_winners, new_losers


def win_probability(a: Rating, b: Rating, beta: float = BETA) -> float:
    """P(a beats b) under the model — also the PFSP opponent-sampling
    signal for league self-play."""
    denom = math.sqrt(2.0 * beta**2 + a.sigma**2 + b.sigma**2)
    return _cdf((a.mu - b.mu) / denom)


def team_win_probability(
    team_a: "list[Rating]", team_b: "list[Rating]", beta: float = BETA
) -> float:
    """P(team_a beats team_b); reduces to win_probability for 1v1."""
    n = len(team_a) + len(team_b)
    denom = math.sqrt(
        n * beta**2
        + sum(r.sigma**2 for r in team_a)
        + sum(r.sigma**2 for r in team_b)
    )
    return _cdf((sum(r.mu for r in team_a) - sum(r.mu for r in team_b)) / denom)


class RatingTable:
    """Named ratings with anchored entries (scripted-bot yardsticks)."""

    def __init__(self):
        self._ratings: Dict[str, Rating] = {}
        self._anchored: Dict[str, bool] = {}
        self.games: Dict[str, int] = {}

    def add(self, name: str, rating: Optional[Rating] = None, anchored: bool = False) -> Rating:
        """Register a player; re-adding an existing name is a no-op (it must
        not reset a tracked rating or silently un-anchor a yardstick)."""
        if name not in self._ratings:
            self._ratings[name] = rating if rating is not None else Rating()
            self._anchored[name] = anchored
            self.games.setdefault(name, 0)
        return self._ratings[name]

    def get(self, name: str) -> Rating:
        if name not in self._ratings:
            self.add(name)
        return self._ratings[name]

    def record(self, winner: str, loser: str, draw: bool = False) -> None:
        rw, rl = self.get(winner), self.get(loser)
        new_w, new_l = rate_1v1(rw, rl, draw=draw)
        if not self._anchored.get(winner):
            self._ratings[winner] = new_w
        if not self._anchored.get(loser):
            self._ratings[loser] = new_l
        self.games[winner] = self.games.get(winner, 0) + 1
        self.games[loser] = self.games.get(loser, 0) + 1

    def record_teams(self, winners: "list[str]", losers: "list[str]", draw: bool = False) -> None:
        """One team-vs-team result; per-name anchoring is respected
        (an anchored name on either side keeps its rating — the rest of
        its team still updates from the shared team evidence)."""
        new_w, new_l = rate_teams(
            [self.get(n) for n in winners], [self.get(n) for n in losers], draw=draw
        )
        for name, new in zip(winners + losers, new_w + new_l):
            if not self._anchored.get(name):
                self._ratings[name] = new
            self.games[name] = self.games.get(name, 0) + 1

    def leaderboard(self):
        return sorted(self._ratings.items(), key=lambda kv: -kv[1].conservative)


__all__ = [
    "Rating",
    "RatingTable",
    "rate_1v1",
    "rate_teams",
    "win_probability",
    "team_win_probability",
    "draw_margin",
    "MU",
    "SIGMA",
    "BETA",
    "TAU",
    "DRAW_PROB",
]
