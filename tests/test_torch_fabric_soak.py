"""The broker-fabric soak's twin (dotaclient_tpu_torch/scripts/
soak_broker_fabric.py) against the reference (scripts/
soak_broker_fabric.py): the same chunk bytes from the same seed, the
same uid peek, the same disjoint actor ids by rendezvous, the same kill
schedules parsed to the same events, and a --quick CPU run whose artifact
carries the committed BROKER_FABRIC_SOAK.json's keys with every verdict
green: every shard generation's ledger exact, the resurrection fenced,
learner B bit-exact across its drain and restart, the classic path
inert; the scaling bar's verdict is the reference's (met, or excused by
the crc32 probe) and is left out of "every verdict" by name."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dotaclient_tpu.chaos import schedule as jschedule
from dotaclient_tpu.transport import fabric as jfabric
from dotaclient_tpu.transport import serialize as jserialize
from dotaclient_tpu_torch.chaos import schedule as tschedule
from dotaclient_tpu_torch.scripts import soak_broker_fabric as F
from dotaclient_tpu_torch.transport import serialize as tserialize

REPO = Path(__file__).resolve().parents[1]
REFERENCE = json.loads((REPO / "BROKER_FABRIC_SOAK.json").read_text())


@pytest.fixture(scope="module")
def ref():
    """The reference script as a module (its top level imports numpy only)."""
    spec = importlib.util.spec_from_file_location("ref_soak_broker_fabric", REPO / "scripts" / "soak_broker_fabric.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed,L,H,uid", [(0, 2, 8, 9000), (7, 4, 8, 50_001), (123, 4, 128, 90_017)])
def test_chunks_are_the_references_bytes(ref, seed, L, H, uid):
    mine = tserialize.serialize_rollout(F._make_rollout(L, H, 3, actor_id=41, uid=uid, rng=np.random.RandomState(seed)))
    theirs = jserialize.serialize_rollout(ref._make_rollout(L, H, 3, actor_id=41, uid=uid,
                                                            rng=np.random.RandomState(seed)))
    assert mine == theirs
    assert F._uid_of(mine) == ref._uid_of(theirs) == float(uid)


def test_disjoint_ids_are_the_references(ref):
    # the reference picks them inline (scripts/soak_broker_fabric.py:459-468)
    n = 4 * 8
    ids_a, ids_b = [], []
    for aid in range(4096):
        p = jfabric.rendezvous_order(aid, F.FABRIC_URLS)[0]
        if p in (0, 1) and len(ids_a) < n:
            ids_a.append(aid)
        elif p == 3 and len(ids_b) < n:
            ids_b.append(aid)
        if len(ids_a) == n and len(ids_b) == n:
            break
    assert F.disjoint_ids(F.FABRIC_URLS, n) == (ids_a, ids_b)


@pytest.mark.parametrize("quick", [False, True])
def test_kill_schedule_is_the_references(quick):
    # scripts/soak_broker_fabric.py:208-212, parsed with seed 7 (:267)
    spec = F.kill_spec(quick)
    assert spec == ("kill@1.5:1@broker,rolling@4:0.6@broker" if quick
                    else "kill@2:1.5@broker,kill@6:1@broker,rolling@8:0.8@broker")
    mine = [vars(e) for e in tschedule.FaultSchedule.parse(spec, seed=7).events]
    assert mine == [vars(e) for e in jschedule.FaultSchedule.parse(spec, seed=7).events]
    assert [e["kind"] for e in mine][-1] == "rolling"


def test_flags_are_the_references():
    # scripts/soak_broker_fabric.py:681-684 (--out names the twin's own
    # file; --platform is the port's)
    a = F.parse_args([])
    assert (a.out, a.quick, a.platform) == ("broker_fabric_soak_torch.json", False, "")
    assert F.parse_args(["--quick", "--platform", "cpu"]).quick


def test_scaling_bar_keys_on_the_crc32_probe():
    # scripts/soak_broker_fabric.py:143-161 (the probe) and :715-727 (the bar)
    capable = {"capable": True, "scaling_3_over_1": 3.08}
    excused = {"capable": False, "scaling_3_over_1": 0.97}
    missed = F.judge_scaling({"scaling_3_over_1": 0.975}, capable)
    assert missed["required"] and not missed["met"] and not missed["excused_by_probe"]
    assert F.judge_scaling({"scaling_3_over_1": 1.6}, capable)["met"]
    assert F.judge_scaling({"scaling_3_over_1": 0.9}, excused)["excused_by_probe"]
    probe = F.host_probe(True)
    assert set(probe) == set(REFERENCE["host_probe"])
    assert probe["capable"] == (probe["scaling_3_over_1"] >= 2.2)


@pytest.fixture(scope="module")
def artifact():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")  # other test processes may listen on this host
        yield F.run_soak(F.parse_args(["--quick", "--platform", "cpu"]))


def test_artifact_has_the_references_keys(artifact):
    assert set(REFERENCE) <= set(artifact)
    assert set(artifact["verdict"]) == set(REFERENCE["verdict"])
    for part in ("host_probe", "phase_kill", "phase_resurrection", "phase_two_learner", "phase_scaling", "inertness"):
        assert set(REFERENCE[part]) <= set(artifact[part]), part


def _held(verdict: dict) -> dict:
    """Every verdict but the host-bound scaling bar's (ROADMAP.md §C)."""
    return {k: v for k, v in verdict.items() if k not in F.HOST_BOUND_VERDICTS}


def test_every_verdict_is_green(artifact):
    v = artifact["verdict"]
    red = [k for k, val in _held(v).items() if (val is not True if isinstance(val, bool) else val != 0)]
    assert not red, v
    assert v["unaccounted_frames"] == 0 and v["duplicate_applied_chunks"] == 0
    assert v["all_green"] == v["scaling_met_or_excused"]


def test_a_missed_armed_scaling_bar_stays_red(artifact):
    """The reference's verdict: on a host the probe calls capable, a
    missed 1.5x bar turns scaling_met_or_excused and all_green red and
    nothing else."""
    art = dict(artifact, phase_scaling=F.judge_scaling({"scaling_3_over_1": 0.975},
                                                       {"capable": True, "scaling_3_over_1": 3.08}))
    v = F.verdict_of(art)
    assert not v["scaling_met_or_excused"] and not v["all_green"]
    assert _held(v) == _held(artifact["verdict"])


def test_kill_and_rolling_keep_every_generation_exact(artifact):
    pk = artifact["phase_kill"]
    assert [e.get("kind", "kill") for e in pk["recovery"]] == ["kill", "rolling", "rolling", "rolling"]
    assert pk["per_generation_ledgers_sum_exactly"] and len(pk["shard_generations"]) == 3 + 1 + 3
    assert pk["consumer"]["fanin_residual_after_drain"] == 0


def test_learner_b_resumes_bit_exact(artifact):
    tl = artifact["phase_two_learner"]
    assert tl["bit_exact"] and tl["arm1_hash"] == tl["arm2_hash"]
    assert tl["pending_frames_saved"] == 3 and tl["resumed_at_version"] == tl["drained_at_version"] >= 2
    assert tl["learner_a"] == {"steps": 4, "consumed": 32, "cross_contaminated": False}
    assert tl["steps_trained"] == 3 * tl["steps_per_learner"]


def test_resurrection_is_fenced(artifact):
    pr = artifact["phase_resurrection"]
    assert pr["fence_dropped"] == 1 and pr["republished_chunk_delivered_exactly_once"]


@pytest.mark.nightly
@pytest.mark.slow
def test_fabric_soak_quick_on_the_cpu(tmp_path):
    out = tmp_path / "fabric.json"
    env = dict(os.environ, DOTACLIENT_TPU_ALLOW_STRAYS="1")
    proc = subprocess.run([sys.executable, "-m", "dotaclient_tpu_torch.scripts.soak_broker_fabric", "--quick",
                           "--platform", "cpu", "--out", str(out)], cwd=REPO, capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode in (0, 1), proc.stdout[-4000:] + proc.stderr[-4000:]
    v = json.loads(out.read_text())["verdict"]
    assert proc.returncode == (0 if v["all_green"] else 1)
    assert all((val is True) if isinstance(val, bool) else (val == 0) for val in _held(v).values()), v
