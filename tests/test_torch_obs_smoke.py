"""The obs smoke's twin (dotaclient_tpu_torch/scripts/obs_smoke.py) against
the reference (scripts/obs_smoke.py): the same policies, the same required
scalars, and a CPU run whose one JSON report carries the reference's keys
(read from the reference's source) with `ok` true: 20 learner steps with the
whole surface live, POST /profile answered mid-run, fleetd's audit of the
live learner at 0 unaccounted, one remote step through a server with obs."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from dotaclient_tpu_torch.scripts import obs_smoke as OS

REPO = Path(__file__).resolve().parents[1]
REFERENCE_PATH = REPO / "scripts" / "obs_smoke.py"


def _reference_function(name: str) -> ast.FunctionDef:
    tree = ast.parse(REFERENCE_PATH.read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _dict_keys(fn: ast.FunctionDef, target=None) -> set:
    """The string keys of the dict literal `fn` assigns to `target` (None:
    the one it returns)."""
    for node in ast.walk(fn):
        if target is None and isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys}
        if target and isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and node.value.keys \
                and any(getattr(t, "id", None) == target for t in node.targets):
            return {k.value for k in node.value.keys}
    raise KeyError(target)


def _set_literal(fn: ast.FunctionDef, target: str) -> set:
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == target for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(target)


def test_required_scalars_are_the_references():
    assert OS.REQUIRED_LEARNER_SCALARS == _set_literal(_reference_function("main"), "required")
    assert OS.REQUIRED_SERVE_SCALARS == _set_literal(_reference_function("_serve_smoke"), "required")


@pytest.mark.parametrize("which", ["learner", "serve"])
def test_policies_are_the_references(which):
    from dotaclient_tpu.config import PolicyConfig as JPolicyConfig

    mine = OS.learner_policy() if which == "learner" else OS.serve_policy()
    ref = (JPolicyConfig(unit_embed_dim=16, lstm_hidden=8, mlp_hidden=16, dtype="float32") if which == "learner"
           else JPolicyConfig(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32"))
    # scripts/obs_smoke.py:65 and :276
    for f in ("unit_embed_dim", "lstm_hidden", "mlp_hidden", "dtype", "arch"):
        assert getattr(mine, f) == getattr(ref, f), f


def test_flags():
    assert OS.parse_args([]).platform == "" and OS.parse_args(["--platform", "cpu"]).platform == "cpu"
    assert OS.STEPS == 20  # scripts/obs_smoke.py:118


@pytest.fixture(scope="module")
def report():
    return OS.run_smoke(platform="cpu")


def test_report_has_the_references_keys(report):
    assert _dict_keys(_reference_function("main"), "out") | {"serve"} <= set(report)
    assert _dict_keys(_reference_function("_fleet_smoke")) <= set(report["fleet"])
    assert _dict_keys(_reference_function("_serve_smoke")) <= set(report["serve"])


def test_report_is_ok(report):
    assert report["ok"] is True, report
    assert report["steps"] == OS.STEPS and not report["missing_required_scalars"]
    assert report["profile_trace_files"] > 0 and report["profile_error"] is None
    assert report["healthz"]["watchdog"]["enabled"] is True and report["healthz"]["role"] == "learner"
    assert report["serve"]["ok"] is True and report["serve"]["healthz"]["role"] == "serve"


def test_fleet_audit_of_the_live_learner_is_clean(report):
    fleet = report["fleet"]
    assert fleet["ok"] and fleet["unaccounted_frames"] == 0.0 and fleet["targets_up"] >= 1 and fleet["polls"] >= 3
    assert set(fleet["ledgers"].values()) <= {"ok", "absent"}


@pytest.mark.nightly
@pytest.mark.slow
def test_obs_smoke_script_on_the_cpu():
    proc = subprocess.run([sys.executable, "-m", "dotaclient_tpu_torch.scripts.obs_smoke", "--platform", "cpu"],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["ok"] is True and report["steps"] == 20
    assert not report["missing_required_scalars"] and report["profile_trace_files"] > 0


# ------------------------------------------- POST /profile's warm gate


class _NoCupti:
    calls = 0

    def __call__(self):
        type(self).calls += 1
        raise LookupError("the window reached CUPTI")


def test_a_card_capture_waits_for_warm_and_raises_when_it_never_comes(tmp_path, monkeypatch):
    """On the card the window opens only once the owner reports its threads
    warm (CUPTI's enable / disable deadlocked against a first cuBLAS call);
    a process that never warms gets an error, and CUPTI is never touched."""
    from dotaclient_tpu_torch.obs import compute, cupti

    probe = _NoCupti()
    monkeypatch.setattr(cupti, "activity_trace", probe)
    monkeypatch.setattr(compute.ProfileCapture, "WARM_WAIT_S", 0.2)
    cap = compute.ProfileCapture(str(tmp_path), device="cuda", warm=lambda: False)
    with pytest.raises(RuntimeError, match="did not warm"):
        cap.capture(0.1)
    assert _NoCupti.calls == 0 and cap.captures_done == 0
    polls = iter(range(10))
    monkeypatch.setattr(compute.ProfileCapture, "WARM_WAIT_S", 30.0)
    cap = compute.ProfileCapture(str(tmp_path), device="cuda", warm=lambda: next(polls) >= 3)
    with pytest.raises(LookupError):
        cap.capture(0.1)
    assert _NoCupti.calls == 1 and next(polls) == 4


def test_the_learner_reports_warm_after_two_steps_of_its_own(tmp_path):
    """The learner's predicate counts the steps this process trained: false
    at boot, true once PROFILE_WARM_STEPS steps ran."""
    from dotaclient_tpu_torch.config import LearnerConfig, ObsConfig
    from dotaclient_tpu_torch.runtime import learner as LM
    from dotaclient_tpu_torch.scripts.chaos_soak import make_frames
    from dotaclient_tpu_torch.transport import memory as mem

    cfg = LearnerConfig(batch_size=8, seq_len=4, policy=OS.learner_policy(), broker_url="mem://warm_gate",
                        log_dir=str(tmp_path / "logs"), platform="cpu",
                        obs=ObsConfig(enabled=True, metrics_port=OS._free_port(), install_handlers=False,
                                      dump_dir=str(tmp_path)))
    mem.reset("warm_gate")
    hub = mem.MemoryBroker("warm_gate")
    for f in make_frames(cfg, 8 * (LM.PROFILE_WARM_STEPS + 2)):
        hub.publish_experience(f)
    learner = LM.Learner(cfg, mem.MemoryBroker("warm_gate"), device="cpu")
    try:
        warm = learner.obs.profiler.warm
        assert warm() is False
        assert learner.run(num_steps=LM.PROFILE_WARM_STEPS - 1, batch_timeout=30.0, max_idle=3) == 1
        assert warm() is False
        assert learner.run(num_steps=1, batch_timeout=30.0, max_idle=3) == 1
        assert warm() is True
    finally:
        learner.close()
