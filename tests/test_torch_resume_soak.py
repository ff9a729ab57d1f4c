"""The resume soak's twin (dotaclient_tpu_torch/scripts/resume_soak.py)
against the reference (scripts/resume_soak.py): the same flags, defaults
and --quick values, the same kill schedules parsed to the same events by
both packages' FaultSchedule, and a cut CPU run (tiny f32 policy) whose
artifact carries the committed RESUME_SOAK.json's keys with every verdict
true: part A bit-exact after the SIGTERM drain (the drained state
restored bitwise), the SIGKILL life resumed at the published high-water
mark, part B's LearnerIncarnations ridden through by real actors over
tcp://, part C's inertness subprocess."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from dotaclient_tpu.chaos import schedule as jschedule
from dotaclient_tpu_torch.chaos import schedule as tschedule
from dotaclient_tpu_torch.scripts import resume_soak as R

REPO = Path(__file__).resolve().parents[1]
REFERENCE = json.loads((REPO / "RESUME_SOAK.json").read_text())
CUT = R.SMOKE_CUT  # --quick cut to both deaths in both parts (resume_soak.py)


def _events(mod, spec, seed):
    return [vars(e) for e in mod.FaultSchedule.parse(spec, seed=seed).events]


def _part_b_spec(args):
    # scripts/resume_soak.py:499-502
    return f"kill@{args.b_term_at}:{args.b_down_s}@learner:term,kill@{args.b_kill_at}:{args.b_down_s}@learner:kill"


@pytest.mark.parametrize("quick", [False, True])
def test_part_b_schedule_is_the_references(quick):
    args = R.parse_args(["--quick"] if quick else [])
    spec = _part_b_spec(args)
    assert spec == ("kill@4.0:2.0@learner:term,kill@12.0:2.0@learner:kill" if quick
                    else "kill@6.0:2.0@learner:term,kill@16.0:2.0@learner:kill")
    assert _events(tschedule, spec, args.seed) == _events(jschedule, spec, args.seed)
    assert [(e["target"], e["signal"]) for e in _events(tschedule, spec, args.seed)] == [
        ("learner", "term"), ("learner", "kill")]


def test_flags_are_the_references():
    # scripts/resume_soak.py:639-672; --out names the twin's own file and
    # --platform is the port's
    d = R.parse_args([])
    assert (d.seed, d.batch_size, d.seq_len, d.steps, d.warm_steps, d.term_at, d.kill_at, d.parity_steps,
            d.checkpoint_every, d.pending_extras, d.reservoir_seed, d.recovery_budget_s, d.drain_budget_s) == (
        11, 16, 8, 46, 6, 20, 40, 5, 7, 5, 4, 30.0, 45.0)
    assert (d.actors, d.b_duration_s, d.b_term_at, d.b_kill_at, d.b_down_s, d.shed_high, d.shed_low) == (
        2, 34.0, 6.0, 16.0, 2.0, 48, 16)
    assert (d.out, d.platform, d.quick) == ("resume_soak_torch.json", "", False)
    q = R.parse_args(["--quick"])
    assert (q.steps, q.warm_steps, q.term_at, q.kill_at, q.parity_steps, q.checkpoint_every) == (26, 6, 12, 22, 3, 5)
    assert (q.b_duration_s, q.b_term_at, q.b_kill_at) == (27.0, 4.0, 12.0)
    assert R.parse_args(["--platform", "cpu"]).platform == "cpu"
    with pytest.raises(SystemExit):
        R.parse_args(["--platform", "tpu"])


@pytest.fixture(scope="module")
def artifact():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")  # other test processes may listen on this host
        yield R.run_soak(R.cut_args(["--platform", "cpu"]))


def test_artifact_has_the_references_keys(artifact):
    assert set(REFERENCE) <= set(artifact)
    assert set(artifact["verdict"]) == set(REFERENCE["verdict"])
    for part in ("budgets", "part_a_determinism", "part_b_ride_through", "part_c_inertness"):
        assert set(REFERENCE[part]) <= set(artifact[part]), part
    for sub in ("sigterm", "sigkill", "conservation_killed"):
        assert set(REFERENCE["part_a_determinism"][sub]) <= set(artifact["part_a_determinism"][sub]), sub


def test_every_verdict_holds(artifact):
    red = [k for k, v in artifact["verdict"].items() if isinstance(v, bool) and not v]
    assert not red, red


def test_sigterm_resume_is_bit_exact_and_restores_the_drained_state(artifact):
    a = artifact["part_a_determinism"]
    assert a["sigterm"]["bit_exact_param_opt_hashes"] and a["sigterm"]["loss_parity"]
    assert a["sigterm"]["parity_versions"] == [CUT["term_at"] + 1, CUT["term_at"] + 2]
    assert a["sigterm"]["restore_bitwise"]
    assert a["sigterm"]["pending_preserved"] == 5 and a["sigterm"]["resume"]["resume_pending_frames"] == 5.0


def test_sigkill_resumes_at_the_published_high_water(artifact):
    k = artifact["part_a_determinism"]["sigkill"]
    assert k["published_hwm"] == k["resumed_at_version"] == CUT["kill_at"]
    assert k["restored_step"] == 10.0 and k["steps_lost_to_kill"] == k["version_hwm_bump"] == 4
    cons = artifact["part_a_determinism"]["conservation_killed"]
    assert cons["unaccounted_frames"] == 0 and cons["intake_balances"] == [0, 0, 0]


def test_part_b_rides_through_a_term_and_a_kill(artifact):
    b = artifact["part_b_ride_through"]
    assert [k["sig"] for k in b["kills"]] == ["term", "kill"] and len(b["lives"]) == 3
    assert b["conservation"]["unaccounted_frames"] == 0 and not any(b["conservation"]["intake_balances"])
    assert R.part_b_steps(b) > 0


def test_part_c_inertness(artifact):
    c = artifact["part_c_inertness"]
    assert c["ok"] and c["ckpt_files"] == REFERENCE["part_c_inertness"]["ckpt_files"]


@pytest.mark.nightly
@pytest.mark.slow
def test_resume_soak_quick_on_the_cpu(tmp_path):
    """The whole --quick run: every verdict true, exit 0."""
    out = tmp_path / "resume.json"
    env = dict(os.environ, DOTACLIENT_TPU_ALLOW_STRAYS="1")
    proc = subprocess.run([sys.executable, "-m", "dotaclient_tpu_torch.scripts.resume_soak", "--quick", "--platform",
                           "cpu", "--out", str(out)], cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    art = json.loads(out.read_text())
    assert all(v for v in art["verdict"].values() if isinstance(v, bool)), art["verdict"]
