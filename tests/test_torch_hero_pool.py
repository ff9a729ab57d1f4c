"""The port's hero-pool run (dotaclient_tpu_torch/scripts/train_hero_pool.py)
against the reference's scripts/train_hero_pool.py: the same flags and
defaults, the same learner, self-play and eval configs field by field,
the same 3/3 bar deciding the exit code on the same run and eval results
(HERO_POOL.md with the reference's fields), and a short run on the CPU."""

import dataclasses
import importlib.util
import re
import types
from pathlib import Path

import pytest
import torch

from dotaclient_tpu_torch.scripts import train_hero_pool as HP

REPO = Path(__file__).resolve().parents[1]
HEROES = HP.POOL.split(",")


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("ref_train_hero_pool", REPO / "scripts" / "train_hero_pool.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fields(md: str) -> list:
    """The summary's field labels: `- label:` lines, in order (a hero's
    line counts as its label)."""
    return re.findall(r"^- ([a-z ]+):", md, flags=re.M)


def test_flags_and_defaults_equal_the_reference(ref):
    ours, theirs = vars(HP.parse_args([])), vars(ref.parse_args([]))
    assert ours.pop("out_dir") == "hero_pool_run_torch" and theirs.pop("out_dir") == "hero_pool_run"
    assert ours.pop("platform") == ""  # the card, unless the caller asks for the CPU
    assert ours == theirs
    assert (HP.BROKER, HP.POOL) == (ref.BROKER, ref.POOL)


class _Fakes:
    """Stands in for the learner, the actor pool and the self-play actors
    of one package's main: records the configs, plays canned episodes
    (hero, return) and reports a canned version and dead count."""

    def __init__(self, records, version, dead, net):
        self.records, self.version, self.dead, self.net = records, version, dead, net
        self.learner_cfg, self.actor_cfgs = None, []

    def actor(self, acfg, broker, actor_id, stub):
        self.actor_cfgs.append(acfg)
        return types.SimpleNamespace(last_heroes=[])

    def pool(self, make_actor, n, on_episode=None):
        fakes = self

        class Pool:
            dead = fakes.dead

            def start(self):
                actors = [make_actor(i) for i in range(n)]
                for k, (hero, ret) in enumerate(fakes.records):
                    actors[k % n].last_heroes = [hero]
                    on_episode(k % n, actors[k % n], ret)
                return self

            def stop(self, timeout=30.0, raise_on_dead=False):
                pass

        return Pool()

    def learner(self, lcfg, broker, device=None):
        fakes = self
        self.learner_cfg = lcfg

        class Learner:
            version = 0
            state = types.SimpleNamespace(params={}, net=fakes.net)

            def run(self, num_steps=None, batch_timeout=60.0, max_idle=None):
                self.version = fakes.version

            def close(self):
                pass

        return Learner()


def _patch(mod, monkeypatch, fakes, evals):
    monkeypatch.setattr(mod, "SelfPlayActor", fakes.actor)
    monkeypatch.setattr(mod, "ActorPool", fakes.pool)
    monkeypatch.setattr(mod, "Learner", fakes.learner)
    calls = iter(evals)
    monkeypatch.setattr(mod, "eval_per_hero", lambda *a, **k: next(calls))


CASES = {
    "every_hero_better": ([-2.0, -1.9, -2.2], [0.7, -0.1, 1.9], 0, 4),
    "one_hero_worse": ([-2.0, -1.9, -2.2], [0.7, -2.1, 1.9], 0, 4),
    "one_hero_equal": ([-2.0, -1.9, -2.2], [0.7, -1.9, 1.9], 0, 4),
    "dead_actor": ([-2.0, -1.9, -2.2], [0.7, -0.1, 1.9], 1, 4),
    "short": ([-2.0, -1.9, -2.2], [0.7, -0.1, 1.9], 0, 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bar_configs_and_summary_are_the_references(ref, monkeypatch, tmp_path, case):
    init, final, dead, version = CASES[case]
    evals = [dict(zip(HEROES, init)), dict(zip(HEROES, final))]
    records = [(HEROES[k % 3], 0.1 * k) for k in range(7)]
    mine = _Fakes(records, version, dead, torch.nn.Linear(2, 2))
    theirs = _Fakes(records, version, dead, None)
    _patch(HP, monkeypatch, mine, evals)
    _patch(ref, monkeypatch, theirs, evals)
    argv = ["--updates", "4", "--eval_episodes", "2", "--seed", "3"]
    rc = HP.main(argv + ["--platform", "cpu", "--out_dir", str(tmp_path / "port")])
    rc_ref = ref.main(argv + ["--out_dir", str(tmp_path / "ref")])
    deltas = {h: f - i for h, i, f in zip(HEROES, init, final)}
    assert rc == rc_ref == (0 if HP.hero_pool_ok(dead, version, 4, HEROES, deltas) else 1)
    assert rc == (0 if case == "every_hero_better" else 1)
    md, md_ref = (tmp_path / "port" / "HERO_POOL.md").read_text(), (tmp_path / "ref" / "HERO_POOL.md").read_text()
    assert _fields(md) == _fields(md_ref) == _fields((REPO / "hero_pool_run" / "HERO_POOL.md").read_text())
    assert (tmp_path / "port" / "metrics.jsonl").read_text() == (tmp_path / "ref" / "metrics.jsonl").read_text()
    # the configs each main built, field by field
    want, got = dataclasses.asdict(theirs.learner_cfg), dataclasses.asdict(mine.learner_cfg)
    assert got.pop("platform") == "cpu" and want.pop("platform") == ""
    assert got.pop("log_dir") == str(tmp_path / "port" / "learner_logs")
    assert want.pop("log_dir") == str(tmp_path / "ref" / "learner_logs")
    assert got == want
    assert len(mine.actor_cfgs) == len(theirs.actor_cfgs) == 2
    for a, b in zip(mine.actor_cfgs, theirs.actor_cfgs):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a.pop("platform") == "cpu"  # the reference's ActorConfig defaults to "cpu" (ROADMAP §C)
        b.pop("platform")
        assert a == b


def test_eval_config_is_the_references(ref, monkeypatch):
    import dotaclient_tpu.eval.evaluator as jev

    seen = []

    class Evaluator:
        def __init__(self, cfg, stub=None):
            seen.append(cfg)

        def evaluate(self, params, n_episodes=10):
            return types.SimpleNamespace(mean_return=0.5)

        def close(self):
            pass

    monkeypatch.setattr(jev, "Evaluator", Evaluator)
    pol = HP.run_configs(HP.parse_args([]))[0]
    out = ref.eval_per_hero({}, ref_policy(pol), HEROES, 3, 7)
    assert out == {h: 0.5 for h in HEROES} and len(seen) == 3
    for hero, theirs in zip(HEROES, seen):
        a, b = dataclasses.asdict(HP.eval_config(pol, hero, 7, "cpu")), dataclasses.asdict(theirs)
        assert a.pop("platform") == "cpu"
        b.pop("platform")
        assert a == b


def ref_policy(pol):
    from dotaclient_tpu.config import PolicyConfig as JPolicyConfig

    return JPolicyConfig(**dataclasses.asdict(pol))


def test_short_run_on_the_cpu(tmp_path):
    out = tmp_path / "hp"
    rc = HP.main(["--platform", "cpu", "--updates", "2", "--eval_episodes", "1", "--out_dir", str(out)])
    md = (out / "HERO_POOL.md").read_text()
    assert rc in (0, 1) and ("**OK**" in md) == (rc == 0)  # the bar at 2 updates is chance
    assert "learner updates: 2 (ppo reuse 2x2, kl_stop 0.05)" in md and "min (CPU, incl. both eval phases)" in md
    heroes = [line.split(":")[0][2:] for line in md.splitlines() if " -> final " in line]
    assert heroes == [h.split("_")[-1] for h in HEROES]
    assert (out / "metrics.jsonl").read_text().count("\n") > 0
