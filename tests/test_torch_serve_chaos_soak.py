"""The serve chaos soak's twin (dotaclient_tpu_torch/scripts/
soak_serve_chaos.py) against the reference (scripts/soak_serve_chaos.py):
the same flags, defaults and --quick values, the same kill schedules
parsed to the same events, and a cut CPU run (tiny f32 policy, the
fleet's envs over gRPC as the reference's) whose artifact carries the
committed SERVE_CHAOS_SOAK.json's keys with every verdict true: every
frame before an env's first abandon bitwise the undisturbed arm's,
failover across two replicas under a live tcp:// learner, one fallback
engagement for one outage and its release, no unaccounted frame."""

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from dotaclient_tpu.chaos import schedule as jschedule
from dotaclient_tpu_torch.chaos import schedule as tschedule
from dotaclient_tpu_torch.scripts import soak_serve_chaos as S

REPO = Path(__file__).resolve().parents[1]
REFERENCE = json.loads((REPO / "SERVE_CHAOS_SOAK.json").read_text())
CUT = S.SMOKE_CUT  # --quick with three parity kills over 24 episodes (soak_serve_chaos.py)


def _events(mod, spec):
    return [vars(e) for e in mod.FaultSchedule.parse(spec, seed=0).events]


@pytest.mark.parametrize("quick", [False, True])
def test_kill_schedules_are_the_references(quick):
    a = S.parse_args(["--quick"] if quick else [])
    fallback = f"kill@{a.fallback_warm_s}:{a.fallback_down_s}@server"  # scripts/soak_serve_chaos.py:491
    for spec in (a.parity_kills, a.failover_kills, fallback, CUT["parity_kills"]):
        assert _events(tschedule, spec) == _events(jschedule, spec), spec
        assert {e["target"] for e in _events(tschedule, spec)} == {"server"}


def test_flags_are_the_references():
    # scripts/soak_serve_chaos.py:242-262 (--out names the twin's file;
    # --platform and --env are the port's)
    d = S.parse_args([])
    assert (d.envs, d.parity_episodes, d.parity_kills, d.failover_s, d.failover_kills, d.failover_budget_s) == (
        4, 24, "kill@0.9:0.8@server,kill@3.3:0.8@server", 14.0, "kill@3:1.2@server,kill@8:1.2@server", 5.0)
    assert (d.fallback_warm_s, d.fallback_down_s, d.fallback_post_s, d.fallback_after_s) == (3.0, 6.0, 6.0, 1.0)
    assert (d.out, d.platform, d.env) == ("serve_chaos_soak_torch.json", "", "grpc")
    q = S.parse_args(["--quick"])
    assert (q.parity_episodes, q.parity_kills, q.failover_s, q.failover_kills, q.fallback_down_s,
            q.fallback_post_s) == (12, "kill@0.9:0.8@server", 9.0, "kill@3:1.2@server", 4.0, 5.0)
    with pytest.raises(SystemExit):
        S.parse_args(["--env", "valve"])


def test_local_envs_share_one_service_and_grpc_serves_one():
    from dotaclient_tpu_torch.env.service import LocalDotaServiceStub

    addr, make_stub, server = S.env_stub_factory("local")
    a, b = make_stub(), make_stub()
    assert (addr, server) == ("local", None) and isinstance(a, LocalDotaServiceStub)
    assert a._servicer is b._servicer and a._ctx.peer() != b._ctx.peer()
    addr, make_stub, server = S.env_stub_factory("grpc")
    try:
        assert make_stub is None and addr.startswith("127.0.0.1:") and int(addr.split(":")[1]) > 0
    finally:
        server.stop(0)
    with pytest.raises(ValueError, match="grpc or local"):
        S.env_stub_factory("valve")


def test_local_fleet_steps_its_envs_in_process():
    """--env local: build_actors hands every env slot of the fleet an
    in-process stub, so no env slot dials gRPC."""
    from dotaclient_tpu_torch.runtime.actor import build_actors
    from dotaclient_tpu_torch.scripts.chaos_soak import tiny_policy
    from dotaclient_tpu_torch.transport import memory as mem

    addr, make_stub, _ = S.env_stub_factory("local")
    cfg = S._acfg(tiny_policy(), "127.0.0.1:1", env_addr=addr, platform="cpu", envs=3)
    mem.reset("svchaos_local")
    fleet = build_actors(cfg, mem.MemoryBroker("svchaos_local"), make_stub=make_stub)[0]
    assert [e.actor_id for e in fleet.envs] == [0, 1, 2]
    assert all(e._stub is not None and e._stub._servicer is fleet.envs[0]._stub._servicer for e in fleet.envs)
    asyncio.run(fleet.client.close())


@pytest.fixture(scope="module")
def artifact():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")  # other test processes may listen on this host
        yield S.run_soak(S.cut_args(["--platform", "cpu"]))


def test_artifact_has_the_references_keys(artifact):
    assert set(REFERENCE) <= set(artifact)
    assert set(artifact["verdict"]) == set(REFERENCE["verdict"])
    for part in ("phase_1_parity", "phase_2_failover", "phase_3_fallback", "conservation", "learner"):
        assert set(REFERENCE[part]) <= set(artifact[part]), part


def test_every_verdict_holds(artifact):
    red = [k for k, v in artifact["verdict"].items() if isinstance(v, bool) and not v]
    assert not red, red
    assert artifact["conservation"]["unaccounted_frames"] == 0


def test_parity_prefix_is_bitwise(artifact):
    p1 = artifact["phase_1_parity"]
    assert p1["matched_frames_bitwise"] > 0 and all(e["untouched_prefix_bitwise"] for e in p1["per_env"])
    assert sum(1 for l in p1["serve_lives"] if l["killed_at"] is not None) == 3


def test_failover_and_fallback_events(artifact):
    p2, p3 = artifact["phase_2_failover"], artifact["phase_3_fallback"]
    assert len(p2["client_recovery_s"]) == 1 and p2["failovers"] >= 1 and p2["fallback_engaged_ever"] == 0
    assert p3["engagements_total"] == 1 and p3["engaged_at_end"] == 0 and p3["fallback_version_at_engage"] > 0
    assert artifact["learner_steps"] > 0 and artifact["learner"]["crashed"] is False


@pytest.mark.nightly
@pytest.mark.slow
def test_serve_chaos_soak_quick_on_the_cpu(tmp_path):
    out = tmp_path / "serve_chaos.json"
    env = dict(os.environ, DOTACLIENT_TPU_ALLOW_STRAYS="1")
    proc = subprocess.run([sys.executable, "-m", "dotaclient_tpu_torch.scripts.soak_serve_chaos", "--quick",
                           "--platform", "cpu", "--env", "grpc", "--out", str(out)], cwd=REPO, capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode in (0, 1), proc.stdout[-4000:] + proc.stderr[-4000:]
    v = json.loads(out.read_text())["verdict"]
    assert proc.returncode == (0 if all(x for x in v.values() if isinstance(x, bool)) else 1)
    # --quick's one parity kill may hit no in-flight step (ROADMAP.md §C):
    # the cut run above holds that verdict
    red = [k for k, x in v.items() if isinstance(x, bool) and not x and k not in S.QUICK_BY_CHANCE]
    assert not red, v
