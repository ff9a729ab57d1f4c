"""The fleet telemetry soak's twin (dotaclient_tpu_torch/scripts/
soak_fleet_obs.py) against the reference (scripts/soak_fleet_obs.py): the
same alert, policy and theft, the same flags, the same rendezvous routing
of the producers' trace ids, a restartable shard's ports below the
kernel's ephemeral range, and a --quick run whose artifact carries the
committed FLEET_OBS_SOAK.json's keys with every verdict true: the rolling
restart read as a fence, the theft flagged within one poll window and
closed to exactly the stolen count, the alert's bundle from several
processes, the control plane scaling on fleetd's meter."""

import importlib.util
import json
import os
import subprocess
import sys
import zlib
from pathlib import Path

import pytest

from dotaclient_tpu.transport.fabric import rendezvous_order as jrendezvous
from dotaclient_tpu_torch.scripts import soak_fleet_obs as FO
from dotaclient_tpu_torch.transport.fabric import rendezvous_order as trendezvous

REPO = Path(__file__).resolve().parents[1]
REFERENCE = json.loads((REPO / "FLEET_OBS_SOAK.json").read_text())


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location("ref_soak_fleet_obs", REPO / "scripts" / "soak_fleet_obs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_alert_policy_and_theft_are_the_references(ref):
    assert (FO.ALERTS, FO.POLICY, FO.STEAL) == (ref.ALERTS, ref.POLICY, ref.STEAL)
    assert (REFERENCE["alerts"], REFERENCE["policy"]) == (FO.ALERTS, FO.POLICY)


def test_flags_are_the_references():
    # scripts/soak_fleet_obs.py:330-340 (--out names the twin's file)
    d = FO.parse_args([])
    assert (d.traffic_s, d.poll_s, d.deadline_s, d.quick) == (2.5, 0.3, 25.0, False)
    assert d.out == "fleet_obs_soak_torch.json"
    q = FO.parse_args(["--quick"])
    assert (q.traffic_s, q.poll_s, q.deadline_s) == (1.2, 0.3, 25.0)


@pytest.mark.parametrize("wid", [0, 1])
def test_producers_route_their_trace_ids_as_the_reference(wid):
    """The producers' keys (wid * 1e6 + seq) over two shard endpoints pick
    the reference's shard, for shard lists of 1 to 4 endpoints."""
    for n in (1, 2, 3, 4):
        names = [f"127.0.0.1:{20000 + 7 * i}" for i in range(n)]
        for seq in range(0, 400, 3):
            key = wid * 1_000_000 + seq
            assert trendezvous(key, names) == jrendezvous(key, names)
            assert trendezvous(key, names)[0] == max(range(n), key=lambda i: zlib.crc32(f"{key}|{names[i]}".encode()))


def test_a_restartable_shard_lies_below_the_ephemeral_range():
    """The repair: both of a ShardProc's ports come from below
    ip_local_port_range (the reference draws them from the range, where a
    restart's bind can lose its port to any outgoing connection)."""
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        low = int(f.read().split()[0])
    shards = [FO.ShardProc(i) for i in range(4)]
    ports = [p for s in shards for p in (s.port, s.obs_port)]
    assert all(10000 <= p < low for p in ports), ports
    assert len(set(ports)) == len(ports)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DOTACLIENT_TPU_ALLOW_STRAYS", "1")  # other test processes may listen on this host
        yield FO.run_soak(FO.parse_args(["--quick", "--out", str(tmp_path_factory.mktemp("fleet") / "x.json")]))


def test_artifact_has_the_references_keys(artifact):
    assert set(REFERENCE) <= set(artifact)
    assert set(artifact["verdict"]) == set(REFERENCE["verdict"])
    for part in ("phase_a", "phase_b", "control"):
        assert set(REFERENCE[part]) <= set(artifact[part]), part


def test_every_verdict_holds(artifact):
    v = artifact["verdict"]
    red = [k for k, x in v.items() if isinstance(x, bool) and not x]
    assert not red, (red, artifact["errors"], artifact["timeline"])
    assert v["frames_published"] == v["frames_consumed"] + v["frames_fenced"] + FO.STEAL


def test_the_restart_fences_exactly_what_shard_0_held(artifact):
    a = artifact["phase_a"]
    assert a["resident_at_kill"] > 0 and a["slo"]["fleet_fenced_frames"] == a["resident_at_kill"]
    assert a["slo"]["fleet_unaccounted_frames"] == 0.0 and a["shard0_launches"] == 2


def test_the_theft_closes_to_the_stolen_count(artifact):
    b = artifact["phase_b"]
    assert b["slo"]["fleet_unaccounted_frames"] == float(FO.STEAL) and artifact["frames"]["stolen"] == FO.STEAL
    assert b["ledgers"]["delivery"]["status"] == "alarm" and b["ledgers"]["shard"]["status"] == "ok"
    assert b["bundle_flight_pids"] >= 2 and {"fabric_shard", "actor", "learner"} <= set(b["bundle_flight_roles"])
    moves = artifact["control"]["moves"]
    assert moves and moves[0]["meter"] == "fleet_unaccounted_frames.max"
    assert artifact["control"]["learner_replica_history"] == [1, 2]


def test_verdict_of_reads_only_the_artifact(artifact):
    assert FO.verdict_of(json.loads(json.dumps(artifact))) == artifact["verdict"]
    broken = json.loads(json.dumps(artifact))
    broken["phase_a"]["resident_at_kill"] = 0.0
    assert FO.verdict_of(broken)["restart_read_as_fence_not_loss"] is False
    broken["phase_b"]["polls_at_detect"] = broken["phase_b"]["polls_at_steal"] + 3
    assert FO.verdict_of(broken)["loss_flagged_within_one_poll_window"] is False


@pytest.mark.nightly
@pytest.mark.slow
def test_fleet_obs_soak_quick_on_the_cpu(tmp_path):
    out = tmp_path / "fleet_obs.json"
    env = dict(os.environ, DOTACLIENT_TPU_ALLOW_STRAYS="1")
    proc = subprocess.run([sys.executable, "-m", "dotaclient_tpu_torch.scripts.soak_fleet_obs", "--quick", "--out",
                           str(out)], cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    v = json.loads(out.read_text())["verdict"]
    assert all(x for x in v.values() if isinstance(x, bool)), v
