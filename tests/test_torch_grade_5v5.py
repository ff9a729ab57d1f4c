"""The port's 5v5 grader (dotaclient_tpu_torch/scripts/grade_5v5.py)
against the reference's scripts/grade_5v5.py: the same flags and
defaults, the same eval config, the same grading on the same episode
outcomes (the anchored team TrueSkill through both packages' rate_teams
and record_teams, both bars, P(final beats init), grade_5v5.json and the
LEAGUE.md fields), and one real 5v5 eval episode on the same params
(carried across by load_named), env seed and key: actions equal up to
the first near tie of the perturbed logits, each tick's logp within the
serve test's f32 tolerance."""

import asyncio
import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.config import ActorConfig as JActorConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.env.fake_dotaservice import FakeDotaService as JFakeDotaService
from dotaclient_tpu.env.service import LocalDotaServiceStub as JLocalDotaServiceStub
from dotaclient_tpu.eval.rating import Rating as JRating
from dotaclient_tpu.models import policy as JP
from dotaclient_tpu.transport.serialize import flatten_params
from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
from dotaclient_tpu_torch.eval.rating import Rating
from dotaclient_tpu_torch.models.policy import init_params
from dotaclient_tpu_torch.ops import threefry
from dotaclient_tpu_torch.runtime.actor import make_group_key_step
from dotaclient_tpu_torch.scripts import grade_5v5 as G
from dotaclient_tpu_torch.scripts import train_league as TL
from dotaclient_tpu_torch.transport.params import load_named

REPO = Path(__file__).resolve().parents[1]
# tests/test_torch_serve.py: a sampled index may differ from jax's only where
# jax's two largest perturbed logits lie within the noises' bounds (GAP_TOL)
# plus the policies' own f32 agreement twice (two logits); logp within it.
GAP_TOL, ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def ref():
    sys.path.insert(0, str(REPO / "scripts"))  # the reference imports train_league from its own folder
    try:
        spec = importlib.util.spec_from_file_location("ref_grade_5v5", REPO / "scripts" / "grade_5v5.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(str(REPO / "scripts"))
    return mod


def _fields(md: str) -> list:
    return re.findall(r"^(?:- ([a-z ]+(?:\([^)]*\))?):|## (seed) )", md, flags=re.M)


def test_flags_and_defaults_equal_the_reference(ref):
    ours, theirs = vars(G.parse_args([])), vars(ref.parse_args([]))
    assert ours.pop("out_dir") == "league_run_5v5_torch" and theirs.pop("out_dir") == "league_run_5v5"
    assert ours.pop("platform") == ""  # the card, unless the caller asks for the CPU
    assert ours == theirs
    assert (G.N, G.TEAM_RADIANT, G.TEAM_DIRE) == (ref.N, ref.TEAM_RADIANT, ref.TEAM_DIRE)
    assert G.train_config5 is TL.train_config5  # the league run's own path, as the reference's


class _Stop(Exception):
    pass


def test_eval_config_is_the_references(ref, monkeypatch):
    seen = []

    def step(cfg):
        seen.append(cfg)
        raise _Stop

    monkeypatch.setattr(ref, "make_actor_step", step)
    pol = TL.config5(0, 5, 2, "x")[0]
    with pytest.raises(_Stop):
        ref.eval_team(JPolicyConfig(**dataclasses.asdict(pol)), None, 1, 7, ref.RatingTable(), "init")
    a, b = dataclasses.asdict(G.eval_config(pol, 7, "cpu")), dataclasses.asdict(seen[0])
    assert a.pop("platform") == "cpu"  # the reference's ActorConfig defaults to "cpu" too (ROADMAP §C)
    b.pop("platform")
    assert a == b


# one canned outcome stream per policy: (mean team return, win, net-worth gap)
OUTCOMES = {
    "init": [(-3.1, -1, -300), (-2.9, 0, -50), (-3.3, -1, -420), (-2.2, 1, 80)],
    "final": [(-1.2, 1, 40), (-1.9, -1, -120), (-0.8, 1, 160), (-1.5, 0, 0)],
}


def _canned_episodes(mod, monkeypatch):
    """Replace the episode with the canned outcome streams, init then final
    per seed, in eval order."""
    order = []

    async def episode(cfg, step_fn, params, stub, rng, np_rng):
        if not order:
            order.extend(OUTCOMES["init"] + OUTCOMES["final"])
        ret, win, gap = order.pop(0)
        return ret, win, gap, rng

    monkeypatch.setattr(mod, "_team_episode", episode)


def test_team_ratings_from_one_outcome_list_are_the_references(ref, monkeypatch):
    _canned_episodes(G, monkeypatch)
    _canned_episodes(ref, monkeypatch)
    pol = TL.config5(0, 5, 2, "x")[0]
    table, jtable = G.anchored_table(), ref.RatingTable()
    for i in range(G.N):
        jtable.add(f"hard_bot_{i}", JRating(), anchored=True)
    for prefix in ("init", "final"):
        got = G.eval_team(pol, None, 4, 7, table, prefix, "cpu")
        want = ref.eval_team(JPolicyConfig(**dataclasses.asdict(pol)), None, 4, 7, jtable, prefix)
        assert {k: got[k] for k in got if k != "ratings"} == {k: want[k] for k in want if k != "ratings"}
        assert [(r.mu, r.sigma) for r in got["ratings"]] == pytest.approx([(r.mu, r.sigma) for r in want["ratings"]],
                                                                          rel=1e-12, abs=1e-12)
    # the anchored bots kept their rating; every name played every episode
    assert all(table.get(f"hard_bot_{i}") == Rating() for i in range(G.N))
    assert table.games == jtable.games


def _canned_train(pol_cls, version):
    def train(seed, updates, team_size, n_actors, out_dir, ppo_reuse=False, platform=""):
        assert team_size == 5 and ppo_reuse
        return {"policy": pol_cls(), "init_params": None, "final_params": None, "aux_keys": ["aux_loss"],
                "league_sizes": [3, 4], "episodes": 11 + seed, "pool_dead": 0, "version": version,
                "env_steps": 4096 + seed, "ppo": "2x2 kl_stop 0.05"}

    return train


@pytest.mark.parametrize("version", [3, 2], ids=["every_update", "short"])
def test_grading_json_and_summary_are_the_references(ref, monkeypatch, tmp_path, version):
    _canned_episodes(G, monkeypatch)
    _canned_episodes(ref, monkeypatch)
    monkeypatch.setattr(G, "train_config5", _canned_train(TL.PolicyConfig, version))
    monkeypatch.setattr(ref, "train_config5", _canned_train(JPolicyConfig, version))
    argv = ["--updates", "3", "--seeds", "0", "1", "--eval_episodes", "4"]
    rc = G.main(argv + ["--platform", "cpu", "--out_dir", str(tmp_path / "port")])
    rc_ref = ref.main(argv + ["--out_dir", str(tmp_path / "ref")])
    got = json.loads((tmp_path / "port" / "grade_5v5.json").read_text())
    want = json.loads((tmp_path / "ref" / "grade_5v5.json").read_text())
    assert _approx_equal(got, want)
    assert all(s["return_bar"] and s["trueskill_bar"] for s in got)  # the canned final team beats init
    assert rc == rc_ref == (0 if G.grade_ok(got, 3) else 1) == (0 if version == 3 else 1)
    md, md_ref = (tmp_path / "port" / "LEAGUE.md").read_text(), (tmp_path / "ref" / "LEAGUE.md").read_text()
    assert _fields(md) == _fields(md_ref) == _fields((REPO / "league_run_5v5" / "LEAGUE.md").read_text())


def _approx_equal(a, b) -> bool:
    if isinstance(a, dict):
        assert set(a) == set(b)
        return all(_approx_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        assert len(a) == len(b)
        return all(_approx_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-12, abs=1e-12)
        return True
    assert a == b
    return True


# ------------------------------------------------------ one real episode


def _recording(step_fn, log, to_np):
    def step(params, state, obs_b, rng):
        out = step_fn(params, state, obs_b, rng)
        log.append(dict(state=state, obs=obs_b, rng=np.asarray(rng), action=to_np(out[1]), logp=np.asarray(out[2])))
        return out

    return step


def _jax_perturbed(jparams, jpol, rec):
    """The reference step's perturbed logits at one tick, head by head [5, K]."""
    _, out = JP.PolicyNet(jpol).apply(jparams, rec["state"], rec["obs"])
    r4 = jax.random.split(jax.random.split(jnp.asarray(rec["rng"]))[1], 4)
    return [np.asarray(jax.random.gumbel(k, lp.shape) + lp) for k, lp in zip(r4, out.dist)]


@pytest.mark.parametrize("seed", [7, 8])
def test_eval_episode_matches_the_reference(ref, seed):
    pol = TL.config5(0, 5, 2, "x")[0]
    jpol = JPolicyConfig(**dataclasses.asdict(pol))
    jparams = JP.init_params(jpol, jax.random.PRNGKey(seed))
    net = load_named(init_params(pol, torch.Generator().manual_seed(0), torch.device("cpu")), flatten_params(jparams))
    jcfg = JActorConfig(**{k: v for k, v in dataclasses.asdict(G.eval_config(pol, seed)).items()
                           if k not in ("policy", "platform")}, policy=jpol)
    jlog, log = [], []
    jstep = _recording(ref.make_actor_step(jcfg), jlog, lambda a: np.stack([np.asarray(x) for x in a]))
    step = _recording(make_group_key_step(pol), log, lambda a: torch.stack(tuple(a)).numpy())
    loop = asyncio.new_event_loop()
    try:
        want = loop.run_until_complete(ref._team_episode(jcfg, jstep, jparams, JLocalDotaServiceStub(JFakeDotaService()),
                                                         jax.random.PRNGKey(seed), np.random.RandomState(seed)))
        got = loop.run_until_complete(G._team_episode(G.eval_config(pol, seed, "cpu"), step, net,
                                                      LocalDotaServiceStub(FakeDotaService()), threefry.prng_key(seed),
                                                      np.random.RandomState(seed)))
    finally:
        loop.close()
    compared = 0
    for t, (w, g) in enumerate(zip(jlog, log)):
        assert np.array_equal(g["rng"], w["rng"]), t  # the key stream is jax's, bit for bit
        np.testing.assert_allclose(g["logp"], w["logp"], rtol=1e-6, atol=ATOL)
        if not np.array_equal(g["action"], w["action"]):
            perturbed = _jax_perturbed(jparams, jpol, w)
            for h, row in zip(*np.nonzero(g["action"] != w["action"])):
                top = np.sort(perturbed[h][row])
                assert top[-1] - top[-2] < GAP_TOL + 2 * ATOL, (t, h, row, top[-2:])
            break  # the episodes part at a near tie: compare no further
        compared += 1
    else:
        # no tie: the whole episode is the reference's
        assert len(log) == len(jlog) and compared == len(jlog) > 0
        assert got[1:3] == want[1:3] and got[0] == pytest.approx(want[0], abs=1e-6)
        assert np.array_equal(got[3], np.asarray(want[3]))
    assert compared >= 1
