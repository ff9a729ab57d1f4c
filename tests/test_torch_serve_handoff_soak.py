"""The serve handoff soak's twin (dotaclient_tpu_torch/scripts/
soak_serve_handoff.py) against the reference (scripts/
soak_serve_handoff.py): the same flags, defaults and --quick values, the
same rolling schedules parsed to the same events, the same p99 and
kill-window arithmetic, and a cut CPU run (tiny f32 policy, the fleet's
envs over gRPC as the reference's) whose artifact carries the committed
SERVE_HANDOFF_SOAK.json's keys with every verdict true: the whole stream
bitwise the undisturbed arm's through rolling restarts, no abandoned
episode, store-backed resumes, p99 inside the kill windows within the
2,000 ms budget, no unaccounted frame."""

import importlib.util
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

from dotaclient_tpu.chaos import schedule as jschedule
from dotaclient_tpu_torch.chaos import schedule as tschedule
from dotaclient_tpu_torch.scripts import soak_serve_handoff as H

REPO = Path(__file__).resolve().parents[1]
REFERENCE = json.loads((REPO / "SERVE_HANDOFF_SOAK.json").read_text())
CUT = H.SMOKE_CUT  # --quick with a second parity roll (soak_serve_handoff.py)


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("ref_soak_serve_handoff", REPO / "scripts" / "soak_serve_handoff.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("quick", [False, True])
def test_rolling_schedules_are_the_references(quick):
    a = H.parse_args(["--quick"] if quick else [])
    for spec in (a.parity_rolling, a.conserve_rolling, CUT["parity_rolling"]):
        mine = [vars(e) for e in tschedule.FaultSchedule.parse(spec, seed=0).events]
        assert mine == [vars(e) for e in jschedule.FaultSchedule.parse(spec, seed=0).events], spec
        assert {(e["kind"], e["target"]) for e in mine} == {("rolling", "server")}


def test_flags_are_the_references():
    # scripts/soak_serve_handoff.py:331-349 (--out names the twin's file;
    # --platform and --env are the port's)
    d = H.parse_args([])
    assert (d.envs, d.parity_episodes, d.parity_rolling, d.p99_budget_ms, d.conserve_s, d.conserve_rolling) == (
        4, 20, "rolling@0.1:0.6@server,rolling@4.3:0.6@server,rolling@8.77:0.6@server", 2000.0, 22.0,
        "rolling@4:0.8@server")
    assert (d.out, d.platform, d.env) == ("serve_handoff_soak_torch.json", "", "grpc")
    q = H.parse_args(["--quick"])
    assert (q.parity_episodes, q.parity_rolling, q.conserve_s) == (8, "rolling@0.1:0.6@server", 16.0)


def test_p99_and_kill_windows_are_the_references(ref):
    rng = random.Random(5)
    for n in (0, 1, 7, 100, 1013):
        samples = [rng.expovariate(20.0) for _ in range(n)]
        assert H._p99(samples) == ref._p99(samples)
    lat = [rng.expovariate(20.0) for _ in range(400)]
    timeline = [(0.05 * i, min(400, 3 * i)) for i in range(200)]
    arm = {"lat_timeline": timeline, "latency_s": lat, "kill_times": [1.0, 4.02, 7.5], "restart_times": [1.6, 4.7, 8.1]}
    assert H._window_latencies(arm) == ref._window_latencies(arm)
    assert H._p99(H._window_latencies(arm)) == ref._p99(ref._window_latencies(arm))


@pytest.fixture(scope="module")
def artifact():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")  # other test processes may listen on this host
        yield H.run_soak(H.cut_args(["--platform", "cpu"]))


def test_artifact_has_the_references_keys(artifact):
    assert set(REFERENCE) <= set(artifact)
    assert set(artifact["verdict"]) == set(REFERENCE["verdict"])
    for part in ("phase_1_parity", "phase_2_conservation", "conservation", "learner"):
        assert set(REFERENCE[part]) <= set(artifact[part]), part
    assert set(REFERENCE["phase_1_parity"]["latency"]) <= set(artifact["phase_1_parity"]["latency"])


def test_every_verdict_holds(artifact):
    red = [k for k, v in artifact["verdict"].items() if isinstance(v, bool) and not v]
    assert not red, red
    assert artifact["conservation"]["unaccounted_frames"] == 0


def test_whole_stream_is_bitwise_with_no_abandon(artifact):
    p1 = artifact["phase_1_parity"]
    assert all(e["full_stream_bitwise"] for e in p1["per_env"]) and p1["matched_frames_bitwise"] > 0
    assert p1["episodes_abandoned"] == p1["baseline_abandons"] == 0 and p1["episodes_resumed"] >= 1
    assert p1["kills_executed"] >= 2 and artifact["phase_2_conservation"]["kills_executed"] == 2
    lat = p1["latency"]
    assert lat["window_samples"] > 0 and lat["p99_ms_during_restart_windows"] <= 2000.0


@pytest.mark.nightly
@pytest.mark.slow
def test_serve_handoff_soak_quick_on_the_cpu(tmp_path):
    out = tmp_path / "serve_handoff.json"
    env = dict(os.environ, DOTACLIENT_TPU_ALLOW_STRAYS="1")
    proc = subprocess.run([sys.executable, "-m", "dotaclient_tpu_torch.scripts.soak_serve_handoff", "--quick",
                           "--platform", "cpu", "--env", "grpc", "--out", str(out)], cwd=REPO, capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode in (0, 1), proc.stdout[-4000:] + proc.stderr[-4000:]
    v = json.loads(out.read_text())["verdict"]
    assert proc.returncode == (0 if all(x for x in v.values() if isinstance(x, bool)) else 1)
    # --quick's one parity roll may land between episodes (ROADMAP.md §C):
    # the cut run above holds those verdicts
    red = [k for k, x in v.items() if isinstance(x, bool) and not x and k not in H.QUICK_BY_CHANCE]
    assert not red, v
