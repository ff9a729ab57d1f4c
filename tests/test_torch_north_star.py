"""The port's skill run (dotaclient_tpu_torch/scripts/train_north_star.py)
against the reference's scripts/train_north_star.py: the same flags and
fixed config, a short run on the CPU that writes the reference's
metrics.jsonl keys and NORTH_STAR.md fields, both bars and the actor-pool
taint deciding the exit code, and (nightly) a full run at the reuse
settings that must clear the bar."""

import importlib.util
import json
import re
from pathlib import Path

import pytest

from dotaclient_tpu_torch.eval.evaluator import EvalResult
from dotaclient_tpu_torch.eval.rating import Rating
from dotaclient_tpu_torch.scripts import train_north_star as ns

REPO = Path(__file__).resolve().parents[1]
SHORT = ["--platform", "cpu", "--max_updates", "2", "--updates_per_eval", "1", "--eval_episodes", "1"]


def _reference_script():
    spec = importlib.util.spec_from_file_location("ref_train_north_star", REPO / "scripts" / "train_north_star.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fields(md: str) -> list:
    """The summary's field labels: `- label:` lines, in order."""
    return re.findall(r"^- ([a-z ]+):", md, flags=re.M)


def test_flags_and_fixed_config_equal_the_reference():
    ref = _reference_script()
    ours, theirs = vars(ns.parse_args([])), vars(ref.parse_args([]))
    assert ours.pop("out_dir") == "north_star_torch" and theirs.pop("out_dir") == "north_star"
    assert ours.pop("platform") == ""  # the card, unless the caller asks for the CPU
    assert ours == theirs
    for f in ("unit_embed_dim", "lstm_hidden", "mlp_hidden", "dtype"):
        assert getattr(ns.SMALL, f) == getattr(ref.SMALL, f)
    assert ns.BROKER == ref.BROKER


def test_short_run_writes_the_reference_records_and_summary(tmp_path):
    out = tmp_path / "ns"
    assert ns.main(SHORT + ["--out_dir", str(out)]) == 1  # 2 updates cannot reach the bar
    recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    ref_rec = json.loads((REPO / "north_star" / "metrics.jsonl").read_text().splitlines()[0])
    assert [r["version"] for r in recs] == [1, 2]
    assert all(list(r) == list(ref_rec) for r in recs)
    assert all(r["episodes"] <= 1 and r["wins"] + r["losses"] + r["draws"] == r["episodes"] for r in recs)
    md = (out / "NORTH_STAR.md").read_text()
    assert _fields(md) == _fields((REPO / "north_star" / "NORTH_STAR.md").read_text())
    assert "**NOT reached**" in md and "learner updates: 2  |" in md and "min (CPU)" in md
    assert "--seed 0 --platform cpu`" in md
    assert (out / "learner_logs" / "metrics.jsonl").exists()


class _WinningEvaluator:
    """Stands in for the evaluator: every round reads as a clear win."""

    def __init__(self, cfg, stub=None):
        self.rounds = 0

    def evaluate(self, params, n_episodes=10, version=0):
        assert not any(p.requires_grad for p in params.parameters())  # a frozen copy
        self.rounds += 1
        return EvalResult(version=version, episodes=n_episodes, wins=n_episodes, losses=0, draws=0, mean_return=1.0,
                          rating=Rating(mu=30.0 + self.rounds, sigma=2.0))

    def close(self):
        pass


@pytest.mark.parametrize("dead,rc", [(0, 0), (1, 1)], ids=["pass", "tainted"])
def test_both_bars_pass_and_a_dead_actor_taints(tmp_path, monkeypatch, dead, rc):
    """Two winning evaluations meet both bars (exit 0, after the second);
    a dead actor thread taints the result (exit 1)."""
    pools = []

    class Pool(ns.ActorPool):
        def stop(self, timeout=30.0, raise_on_dead=False):
            super().stop(timeout=timeout)
            self.dead += dead
            pools.append(self)

    monkeypatch.setattr(ns, "Evaluator", _WinningEvaluator)
    monkeypatch.setattr(ns, "ActorPool", Pool)
    out = tmp_path / "ns"
    assert ns.main(SHORT[:2] + ["--max_updates", "10", "--updates_per_eval", "1", "--out_dir", str(out)]) == rc
    recs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["version"] for r in recs] == [1, 2] and recs[-1]["win_rate"] == 1.0
    md = (out / "NORTH_STAR.md").read_text()
    assert ("**PASSED**" in md) == (rc == 0) and pools and pools[0].dead == dead


@pytest.mark.nightly
@pytest.mark.slow
def test_full_run_at_the_reuse_settings_clears_the_bar(tmp_path):
    """The reference's budget and reuse settings on the CPU."""
    out = tmp_path / "ns"
    rc = ns.main(["--platform", "cpu", "--ppo_epochs", "2", "--ppo_minibatches", "2", "--ppo_kl_stop", "0.05",
                  "--out_dir", str(out)])
    assert rc == 0, (out / "NORTH_STAR.md").read_text()
