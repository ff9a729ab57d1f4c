"""The port's TrueSkill (dotaclient_tpu_torch/eval/rating.py) against the
reference (dotaclient_tpu/eval/rating.py): pure Python float math, so
every value must be EQUAL, not within a tolerance — seeded 1v1 and team
games, the v/w functions, draw margins, win probabilities and a rating
table with anchors."""

from __future__ import annotations

import random

import pytest

from dotaclient_tpu.eval import rating as jr
from dotaclient_tpu_torch.eval import rating as tr


def _pair(rs: random.Random):
    mu, sigma = rs.uniform(-10, 60), rs.uniform(0.05, 12)
    return tr.Rating(mu, sigma), jr.Rating(mu, sigma)


def _same(a, b):
    assert (a.mu, a.sigma, a.conservative) == (b.mu, b.sigma, b.conservative)


def test_constants_equal():
    for name in ("MU", "SIGMA", "BETA", "TAU", "DRAW_PROB"):
        assert getattr(tr, name) == getattr(jr, name)
    _same(tr.Rating(), jr.Rating())


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("draw", [False, True])
def test_rate_1v1_equals_the_reference(seed, draw):
    rs = random.Random(seed)
    for _ in range(200):
        (tw, jw), (tl, jl) = _pair(rs), _pair(rs)
        fix = rs.random() < 0.2
        ours = tr.rate_1v1(tw, tl, draw=draw, fix_loser=fix)
        theirs = jr.rate_1v1(jw, jl, draw=draw, fix_loser=fix)
        for a, b in zip(ours, theirs):
            _same(a, b)
        assert tr.win_probability(tw, tl) == jr.win_probability(jw, jl)


@pytest.mark.parametrize("n_w,n_l", [(1, 1), (2, 2), (5, 5), (1, 5), (3, 2)])
@pytest.mark.parametrize("draw", [False, True])
def test_rate_teams_equals_the_reference(n_w, n_l, draw):
    rs = random.Random(100 * n_w + n_l)
    for _ in range(100):
        w = [_pair(rs) for _ in range(n_w)]
        lo = [_pair(rs) for _ in range(n_l)]
        fix = rs.random() < 0.2
        ours = tr.rate_teams([a for a, _ in w], [a for a, _ in lo], draw=draw, fix_losers=fix)
        theirs = jr.rate_teams([b for _, b in w], [b for _, b in lo], draw=draw, fix_losers=fix)
        for side_a, side_b in zip(ours, theirs):
            for a, b in zip(side_a, side_b):
                _same(a, b)
        assert tr.team_win_probability([a for a, _ in w], [a for a, _ in lo]) == \
            jr.team_win_probability([b for _, b in w], [b for _, b in lo])
    with pytest.raises(ValueError):
        tr.rate_teams([], [tr.Rating()])


def test_v_w_functions_and_draw_margin_equal_including_the_tails():
    for t in [-40.0, -12.0, -5.0, -1.0, -1e-3, 0.0, 1e-3, 0.5, 3.0, 9.0, 40.0]:
        for eps in [0.0, 1e-4, 0.1, 0.7, 2.0]:
            for f in ("_v_win", "_w_win", "_v_draw", "_w_draw"):
                assert getattr(tr, f)(t, eps) == getattr(jr, f)(t, eps), (f, t, eps)
    for p in (0.0, 0.05, 0.1, 0.5):
        for n in (2, 4, 10):
            assert tr.draw_margin(p, tr.BETA, n) == jr.draw_margin(p, jr.BETA, n)


@pytest.mark.parametrize("seed", range(3))
def test_rating_table_games_equal_the_reference(seed):
    """A seeded sequence of 1v1 and team results over named players, the
    scripted yardsticks anchored: ratings, games and leaderboard equal."""
    rs = random.Random(seed)
    ours, theirs = tr.RatingTable(), jr.RatingTable()
    for t in (ours, theirs):
        t.add("scripted", anchored=True)
        t.add("scripted_hard", (tr if t is ours else jr).Rating(30.0, 1.0), anchored=True)
        t.add("scripted", (tr if t is ours else jr).Rating(1.0, 1.0))  # no-op: the name is taken
    names = ["agent", "scripted", "scripted_hard"] + [f"v{i}" for i in range(8)]
    for _ in range(300):
        draw = rs.random() < 0.15
        if rs.random() < 0.7:
            a, b = rs.sample(names, 2)
            ours.record(a, b, draw=draw)
            theirs.record(a, b, draw=draw)
        else:
            k = rs.randint(1, 4)
            pick = rs.sample(names, 2 * k)
            ours.record_teams(pick[:k], pick[k:], draw=draw)
            theirs.record_teams(pick[:k], pick[k:], draw=draw)
    assert ours.games == theirs.games
    assert [n for n, _ in ours.leaderboard()] == [n for n, _ in theirs.leaderboard()]
    for (n, a), (_, b) in zip(ours.leaderboard(), theirs.leaderboard()):
        _same(a, b)
    _same(ours.get("scripted"), tr.Rating())
    _same(ours.get("scripted_hard"), tr.Rating(30.0, 1.0))
