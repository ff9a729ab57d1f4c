"""The port's fleet telemetry plane (dotaclient_tpu_torch/obs/fleet.py,
obs/fleetd.py) and host preflight (obs/preflight.py) against the
reference on the CPU: the conservation auditor on the same scrape windows
(balance, real loss, restart fence, outage freeze, absent tiers, forgotten
targets), the alert grammar and streak edges, the aggregator with
injected I/O and over real port /metrics surfaces, an end-to-end audit
over the port's real fabric shard, vector actor and learner surfaces, the
fleetd binary on k8s/fleetd.yaml's args, and check() on one faked /proc.
Every comparison is exact: the ledgers are sums of the same parsed
floats, and alerts and fences are discrete."""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from dotaclient_tpu.config import FleetConfig as JFleetConfig
from dotaclient_tpu.config import parse_config as j_parse_config
from dotaclient_tpu.obs import fleet as jfleet
from dotaclient_tpu.obs import preflight as jpreflight
from dotaclient_tpu.obs import registry as jregistry
from dotaclient_tpu_torch.config import FleetConfig, parse_config
from dotaclient_tpu_torch.obs import fleet as tfleet
from dotaclient_tpu_torch.obs import preflight as tpreflight
from dotaclient_tpu_torch.obs import registry as tregistry
from dotaclient_tpu_torch.obs.flight_recorder import FlightRecorder
from dotaclient_tpu_torch.obs.http import MetricsHTTPServer

REPO = Path(__file__).resolve().parent.parent
FLEETD_MANIFEST = REPO / "k8s" / "fleetd.yaml"
TIERS = {"actor/a0": "actor", "broker/b0": "broker", "learner/l0": "learner"}
SMALL = dict(lstm_hidden=16, unit_embed_dim=16, mlp_hidden=16, dtype="float32")


def _env():
    from tests.conftest import clean_subprocess_env

    return clean_subprocess_env(extra={"JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)})


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _samples(attempted, published, enqueued, popped, resident, wire, epochs=(1.0, 2.0, 3.0)):
    """One poll window of the three-tier scrape vocabulary, all floats."""
    return {
        "actor/a0": {"obs_boot_epoch_ms": epochs[0], "actor_publish_attempted_total": float(attempted),
                     "actor_rollouts_published_total": float(published)},
        "broker/b0": {"obs_boot_epoch_ms": epochs[1], "broker_shard_enqueued_total": float(enqueued),
                      "broker_shard_popped_total": float(popped), "broker_shard_resident": float(resident)},
        "learner/l0": {"obs_boot_epoch_ms": epochs[2], "wire_frames_obs_bf16_total": float(wire)},
    }


# ---------------------------------------------------------------- auditor


def _outage(win, key="broker/b0"):
    win = dict(win)
    win[key] = None
    return win


# (windows, tiers, fenced per window, forget after) per scenario
AUDIT_SCENARIOS = {
    "balanced": ([_samples(100, 100, 100, 90, 10, 90), _samples(250, 250, 250, 230, 20, 230)], [set(), set()]),
    "real_loss": ([_samples(100, 100, 100, 90, 10, 90), _samples(200, 200, 200, 110, 90, 107)], [set(), set()]),
    "restart_fence": ([_samples(100, 100, 100, 90, 10, 90), _samples(100, 100, 0, 0, 0, 90, epochs=(1.0, 99.0, 3.0)),
                       _samples(150, 150, 50, 45, 5, 135)], [set(), {"broker/b0"}, set()]),
    "outage_freeze": ([_samples(100, 100, 100, 90, 10, 90), _outage(_samples(150, 150, 0, 0, 0, 120)),
                       _samples(200, 200, 200, 180, 16, 180)], [set(), set(), set()]),
    "absent_tiers": ([{"learner/l0": {"wire_frames_obs_bf16_total": 50.0}}], [set()]),
}


def _nodoc(ledgers):
    """A ledger report without each ledger's doc string (the port's
    delivery doc names its one extra term)."""
    return {n: {k: v for k, v in e.items() if k != "doc"} for n, e in ledgers.items()}


def _run_auditor(mod, name):
    windows, fences = AUDIT_SCENARIOS[name]
    aud = mod.ConservationAuditor()
    trail = []
    for win, fenced in zip(windows, fences):
        tiers = {k: TIERS[k] for k in win}
        aud.observe(win, tiers, fenced)
        trail.append((_nodoc(aud.report()), aud.scalars(), {n: dict(st.anchors) for n, st in aud.state.items()}))
    return aud, trail


@pytest.mark.parametrize("name", sorted(AUDIT_SCENARIOS))
def test_auditor_equals_the_reference_window_by_window(name):
    """Ledger reports, scalars and anchors after every window are equal in
    both packages; the port's hold the reference tests' expectations."""
    ours, trail = _run_auditor(tfleet, name)
    _, jtrail = _run_auditor(jfleet, name)
    assert trail == jtrail
    st, s = ours.state, ours.scalars()
    if name == "balanced":
        assert all(st[n].status == "ok" and st[n].unaccounted == 0.0 and st[n].windows_audited == 2
                   for n in ("producer", "shard", "delivery"))
        assert s["fleet_unaccounted_frames"] == s["fleet_overaccounted_frames"] == 0.0
    elif name == "real_loss":
        assert st["delivery"].status == "alarm" and st["delivery"].unaccounted == 3.0 and st["shard"].status == "ok"
        assert s["fleet_unaccounted_frames"] == 3.0
    elif name == "restart_fence":
        assert trail[1][0]["shard"]["status"] == "fenced" and trail[1][0]["shard"]["fenced_frames"] == 10.0
        assert st["shard"].status == "ok" and st["shard"].unaccounted == 0.0 and st["delivery"].status == "ok"
        assert s["fleet_fenced_frames"] == 10.0
    elif name == "outage_freeze":
        assert trail[1][0]["shard"]["status"] == trail[1][0]["delivery"]["status"] == "stale"
        assert st["shard"].status == "alarm" and st["shard"].unaccounted == 4.0 and st["shard"].windows_frozen == 1
    else:
        assert all(st[n].status == "absent" for n in ("producer", "shard", "delivery"))
        assert s["fleet_unaccounted_frames"] == 0.0


def test_auditor_forget_target_fences_resident_levels_as_the_reference():
    out = []
    for mod in (tfleet, jfleet):
        aud = mod.ConservationAuditor()
        aud.observe(_samples(100, 100, 100, 90, 10, 90), TIERS, set())
        aud.forget_target("broker/b0", "broker")
        out.append((_nodoc(aud.report()), {n: dict(st.anchors) for n, st in aud.state.items()}))
    assert out[0] == out[1]
    assert out[0][0]["shard"]["fenced_frames"] == 10.0 and all(k[0] != "broker/b0" for k in out[0][1]["shard"])


def test_ledgers_are_the_reference_s_plus_the_staging_intake_term():
    """The reference's identities term for term, and one more optional
    gauge on the delivery ledger: frames the port learner's staging holds
    between the broker pop and the intake count."""
    ours = {s.name: s for s in tfleet.LEDGERS}
    extra = tfleet.LedgerTerm("obs_staging_intake_frames", "learner", -1.0, kind="gauge", required=False)
    assert [s.name for s in tfleet.LEDGERS] == [s.name for s in jfleet.LEDGERS]
    for ref in jfleet.LEDGERS:
        terms = [dataclasses.astuple(t) for t in ours[ref.name].terms if t != extra]
        assert terms == [dataclasses.astuple(t) for t in ref.terms]
    ref_delivery = {s.name: s for s in jfleet.LEDGERS}["delivery"]
    assert extra in ours["delivery"].terms and len(ours["delivery"].terms) == len(ref_delivery.terms) + 1
    assert tfleet.BOOT_EPOCH_METER == jfleet.BOOT_EPOCH_METER == "obs_boot_epoch_ms"


# ----------------------------------------------------------------- alerts


def test_alert_grammar_parses_the_manifest_clause_as_the_reference():
    args = _fleetd_args()
    spec = args[args.index("--fleet.alerts") + 1]
    ours = [dataclasses.astuple(r) for r in tfleet.parse_alerts(spec)]
    assert ours == [dataclasses.astuple(r) for r in jfleet.parse_alerts(spec)]
    assert [r[:4] for r in ours] == [("fleet_unaccounted_frames", "gt", 0.0, 3), ("fleet_targets_up", "lt", 1.0, 3)]
    assert tfleet.parse_alerts("") == jfleet.parse_alerts("") == []


@pytest.mark.parametrize("bad", [
    "fleet_unaccounted_frames,gt,0",  # missing for=W
    "fleet_unaccounted_frames,between,0,for=3",  # unknown op
    "fleet_unaccounted_frames,gt,zero,for=3",  # non-numeric threshold
    "fleet_unaccounted_frames,gt,0,for=0",  # W < 1
    "fleet_unaccounted_frames,gt,0,window=3",  # fourth field not for=
])
def test_alert_grammar_fails_loud_with_the_reference_s_message(bad):
    with pytest.raises(ValueError) as ours:
        tfleet.parse_alerts(bad)
    with pytest.raises(ValueError) as theirs:
        jfleet.parse_alerts(bad)
    assert str(ours.value) == str(theirs.value)


def test_alert_streak_edge_and_freeze_semantics_as_the_reference():
    script = [{"x": 9.0}, {"x": 9.0}, {"x": 9.0}, {}, {"x": 1.0}, {"x": 9.0}, {"x": 9.0}]
    trails = []
    for mod in (tfleet, jfleet):
        eng = mod.AlertEngine(mod.parse_alerts("x,gt,5,for=2"))
        trails.append([([r.meter for r in eng.evaluate(m)], eng.report()) for m in script])
    assert trails[0] == trails[1]
    edges = [e for e, _ in trails[0]]
    assert edges == [[], ["x"], [], [], [], [], ["x"]]
    assert trails[0][3][1][0]["firing"] is True and trails[0][-1][1][0]["fired_total"] == 2


@pytest.mark.parametrize("seed", [0, 1])
def test_alert_edges_equal_the_reference_on_one_meter_stream(seed):
    rs = np.random.RandomState(seed)
    spec = "a,gt,0,for=3;b,le,2,for=1;a,ne,1,for=2;c,eq,0,for=4"
    ours, theirs = (m.AlertEngine(m.parse_alerts(spec)) for m in (tfleet, jfleet))
    fired = 0
    for _ in range(400):
        meters = {k: float(rs.randint(0, 4)) for k in "abc" if rs.rand() > 0.15}
        a, b = ours.evaluate(meters), theirs.evaluate(meters)
        assert [r.raw for r in a] == [r.raw for r in b] and ours.report() == theirs.report()
        fired += len(a)
    assert fired > 20


# ------------------------------------------------------------- aggregator


def _flat_eps(win):
    return {"a0": win["actor/a0"], "b0": win["broker/b0"], "l0": win["learner/l0"]}


def _aggs(tmp_path, by_ep, alerts="", topology=None, flights=None, targets=None, control=""):
    """The same injected scrape/topology/flight I/O into a port and a
    reference FleetAggregator (bundles in separate directories)."""
    out = []
    for mod, sub in ((tfleet, "port"), (jfleet, "ref")):
        out.append(mod.FleetAggregator(
            targets=targets or {"actor": ["a0"], "broker": ["b0"], "learner": ["l0"]}, control=control, poll_s=0.01,
            stale_s=5.0, alerts=alerts, bundle_dir=str(tmp_path / sub), scrape_fn=lambda ep: by_ep.get(ep),
            topology_fn=lambda c: topology() if topology else None, flight_fn=lambda ep: (flights or {}).get(ep),
            now_fn=lambda: 1000.0))
    return out


def _same(a, b):
    ra, rb = a.poll_once(), b.poll_once()
    for r in (ra, rb):
        r["incidents"] = [os.path.basename(p) for p in r["incidents"]]
        r["ledgers"] = _nodoc(r["ledgers"])
    assert ra == rb
    assert a.scalars() == b.scalars() and a.health() == b.health()
    return ra


def test_aggregator_audits_rolls_up_and_registers_as_the_reference(tmp_path):
    by_ep = _flat_eps(_samples(100, 100, 100, 90, 10, 90))
    by_ep["l0"].update(env_steps_per_sec=500.0, compute_phase_wall_s=0.4, compute_phase_device_step_s=0.01,
                       pipeline_device_idle_s=0.02, trace_pack_mean_ms=3.0)
    ours, theirs = _aggs(tmp_path, by_ep)
    _same(ours, theirs)
    by_ep.update(_flat_eps(_samples(250, 250, 250, 230, 20, 230)))
    by_ep["l0"].update(env_steps_per_sec=500.0, compute_phase_wall_s=0.4, compute_phase_device_step_s=0.01)
    report = _same(ours, theirs)
    assert report["ok"] is True and report["ledgers"]["delivery"]["status"] == "ok"
    s = ours.scalars()
    assert s["fleet_targets_up"] == 3.0 and s["fleet_e2e_env_steps_per_sec"] == 500.0
    assert s["fleet_device_only_env_steps_per_sec"] == pytest.approx(20000.0)
    assert s["fleet_host_wall_gap"] == pytest.approx(40.0) and s["fleet_unaccounted_frames"] == 0.0
    assert tregistry.unregistered(s.keys()) == [] and jregistry.unregistered(s.keys()) == []


def test_aggregator_detects_a_fence_from_the_boot_epoch_as_the_reference(tmp_path):
    by_ep = _flat_eps(_samples(100, 100, 100, 90, 10, 90))
    ours, theirs = _aggs(tmp_path, by_ep)
    _same(ours, theirs)
    by_ep.update(_flat_eps(_samples(100, 100, 0, 0, 0, 90, epochs=(1.0, 77.0, 3.0))))
    report = _same(ours, theirs)
    assert ours.fences_total == 1 and report["targets"]["broker/b0"]["fences"] == 1
    assert ours.scalars()["fleet_fenced_frames"] == 10.0 and ours.scalars()["fleet_unaccounted_frames"] == 0.0


def test_aggregator_merges_topology_and_prunes_as_the_reference(tmp_path):
    by_ep = _flat_eps(_samples(100, 100, 100, 90, 10, 90))
    topo = {"metrics": {"learner": ["l0"]}}
    ours, theirs = _aggs(tmp_path, by_ep, targets={"actor": ["a0"], "broker": ["b0"]}, control="ctl:1",
                         topology=lambda: dict(topo["metrics"]))
    report = _same(ours, theirs)
    assert "learner/l0" in report["targets"] and ours.topology_refreshes_total == 1
    topo["metrics"] = {}
    report = _same(ours, theirs)
    assert "learner/l0" not in report["targets"] and report["ledgers"]["delivery"]["status"] == "absent"


def test_aggregator_alert_fires_and_fans_in_the_same_incident(tmp_path):
    flights = {"b0": {"role": "fabric_shard", "pid": 111, "events": [{"kind": "publish", "trace": 42}]},
               "l0": {"role": "learner", "pid": 222, "events": [{"kind": "consume", "trace": 42}]}}
    by_ep = _flat_eps(_samples(100, 100, 100, 90, 10, 90))
    ours, theirs = _aggs(tmp_path, by_ep, alerts="fleet_unaccounted_frames,gt,0,for=2", flights=flights)
    _same(ours, theirs)
    by_ep.update(_flat_eps(_samples(200, 200, 200, 150, 50, 145)))
    _same(ours, theirs)
    assert ours.incidents_total == 0
    report = _same(ours, theirs)
    assert ours.incidents_total == 1 and report["alerts"][0]["firing"] is True and ours.health()["ok"] is False
    (name,) = report["incidents"]
    bundles = [json.load(open(tmp_path / sub / name)) for sub in ("port", "ref")]
    assert bundles[0] == bundles[1]
    assert bundles[0]["value"] == 5.0 and sorted(bundles[0]["trace_index"]["42"]) == ["broker/b0", "learner/l0"]
    _same(ours, theirs)
    assert ours.incidents_total == 1  # level-triggered once


def test_aggregator_scrape_outage_freezes_without_alarm_as_the_reference(tmp_path):
    by_ep = _flat_eps(_samples(100, 100, 100, 90, 10, 90))
    ours, theirs = _aggs(tmp_path, by_ep, alerts="fleet_unaccounted_frames,gt,0,for=1")
    _same(ours, theirs)
    by_ep["b0"] = None
    report = _same(ours, theirs)
    assert report["ledgers"]["shard"]["status"] == "stale" and ours.scrape_errors_total == 1
    assert ours.incidents_total == 0


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_a_frame_moving_between_two_reads_is_not_loss_in_the_port(pkg, tmp_path):
    """Targets listed as k8s/fleetd.yaml lists them (the learner before the
    discovered brokers). In poll 3 one frame is popped and consumed
    between fleetd's broker and learner reads. The port reads upstream
    tiers first, so that frame counts downstream only: over-accounted for
    one window, never loss. The reference reads in list order, so the
    same frame reads as a window of loss and fires a for=1 loss alert."""
    live, polls, calls = {"n": 10.0}, [0], []

    def scrape(ep):
        calls.append(ep)
        if polls[0] == 3 and len([c for c in calls if c in ("b0", "l0")]) % 2 == 0:
            live["n"] += 1.0  # the frame moves after the first of the two reads of poll 3
        if ep == "b0":
            return {"broker_shard_enqueued_total": live["n"], "broker_shard_popped_total": live["n"],
                    "broker_shard_resident": 0.0}
        return {"wire_frames_obs_bf16_total": live["n"]}

    mod = tfleet if pkg == "port" else jfleet
    agg = mod.FleetAggregator(targets={"learner": ["l0"], "broker": ["b0"]},
                              alerts="fleet_unaccounted_frames,gt,0,for=1", bundle_dir=str(tmp_path),
                              scrape_fn=scrape, now_fn=lambda: 1000.0)
    trail = []
    for k in range(1, 6):
        polls[0] = k
        calls.clear()
        agg.poll_once()
        s = agg.scalars()
        trail.append((calls[0], s["fleet_unaccounted_frames"], s["fleet_overaccounted_frames"]))
    if pkg == "port":
        assert trail == [("b0", 0.0, 0.0)] * 2 + [("b0", 0.0, 1.0)] + [("b0", 0.0, 0.0)] * 2
        assert agg.scalars()["fleet_alerts_fired_total"] == 0.0
    else:
        assert trail == [("l0", 0.0, 0.0)] * 2 + [("l0", 1.0, 0.0)] + [("l0", 0.0, 0.0)] * 2
        assert agg.scalars()["fleet_alerts_fired_total"] == 1.0


def test_aggregators_agree_over_real_port_surfaces(tmp_path):
    """Both packages' aggregators over the same port MetricsHTTPServers:
    equal /fleet bodies but the poll time, then a loss at the source."""
    broker = {"broker_shard_enqueued_total": 100.0, "broker_shard_popped_total": 80.0,
              "broker_shard_resident": 20.0}
    learner = {"wire_frames_obs_bf16_total": 80.0}
    b_srv = MetricsHTTPServer(0, sources=[lambda: dict(broker)]).start()
    l_srv = MetricsHTTPServer(0, sources=[lambda: dict(learner)]).start()
    targets = {"broker": [f"127.0.0.1:{b_srv.port}"], "learner": [f"127.0.0.1:{l_srv.port}"]}
    try:
        aggs = [mod.FleetAggregator(targets=targets, bundle_dir=str(tmp_path)) for mod in (tfleet, jfleet)]

        def fleets():
            out = []
            for a in aggs:
                a.poll_once()
                body = a.fleet()
                body.pop("time")
                body["ledgers"] = _nodoc(body["ledgers"])
                body["slo"] = {k: v for k, v in body["slo"].items() if not k.endswith("_per_sec")}
                out.append(body)
            assert out[0] == out[1]
            return out[0]

        assert fleets()["ledgers"]["shard"]["status"] == "ok"
        broker.update(broker_shard_enqueued_total=200.0, broker_shard_popped_total=170.0, broker_shard_resident=30.0)
        learner["wire_frames_obs_bf16_total"] = 163.0  # 7 short
        body = fleets()
        assert body["ledgers"]["shard"]["status"] == "ok" and body["ledgers"]["delivery"]["status"] == "alarm"
        assert body["ledgers"]["delivery"]["unaccounted"] == 7.0 and body["slo"]["fleet_unaccounted_frames"] == 7.0
    finally:
        b_srv.stop()
        l_srv.stop()


# ----------------------------------------------------- /debug/flight HTTP


def test_flight_route_serves_a_capped_snapshot_and_404s_without_a_recorder():
    rec = FlightRecorder("testproc")
    for i in range(32):
        rec.record("tick", i=i, trace=i)
    srv = MetricsHTTPServer(0, sources=[lambda: {"x": 1.0}], flight_provider=rec.snapshot).start()
    bare = MetricsHTTPServer(0, sources=[lambda: {"x": 1.0}]).start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        snap = json.loads(urllib.request.urlopen(f"{base}/debug/flight", timeout=5).read())
        assert snap["role"] == "testproc" and snap["events_recorded"] == 32 and len(snap["events"]) == 32
        capped = json.loads(urllib.request.urlopen(f"{base}/debug/flight?max_events=4", timeout=5).read())
        assert [e["i"] for e in capped["events"]] == [28, 29, 30, 31]
        assert "dotaclient_obs_boot_epoch_ms" in urllib.request.urlopen(f"{base}/metrics", timeout=5).read().decode()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{bare.port}/debug/flight", timeout=5)
        assert err.value.code == 404
    finally:
        srv.stop()
        bare.stop()


# --------------------------------------- end to end over the port's tiers


@pytest.mark.parametrize("pack_workers", [1, 4])
def test_end_to_end_audit_over_the_port_s_shard_actor_and_learner_surfaces(tmp_path, pack_workers):
    """Two port fabric shard processes, a port VectorActor publishing to
    them and a port Learner consuming through FabricBroker (its staging
    classic, or the manifest's 4-worker pool with its intake queue), each
    serving its own /metrics: the port's FleetAggregator audits them live,
    and no loss alert fires while frames flow. After the learner's drain
    and the actor's stop (surfaces up), every ledger reads ok with nothing
    unaccounted; then a rogue tcp:// consumer pops 5 frames and the
    delivery ledger flags exactly 5 in the next window."""
    import asyncio

    from dotaclient_tpu_torch.config import ActorConfig, LearnerConfig, ObsConfig, PolicyConfig, PPOConfig, StagingConfig
    from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
    from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
    from dotaclient_tpu_torch.runtime.actor import VectorActor
    from dotaclient_tpu_torch.runtime.learner import Learner
    from dotaclient_tpu_torch.transport.fabric import FabricBroker
    from dotaclient_tpu_torch.transport.tcp import TcpBroker

    smports, amport, lmport = [_free_port(), _free_port()], _free_port(), _free_port()
    shards = [subprocess.Popen([sys.executable, "-m", "dotaclient_tpu_torch.transport.fabric", "--host", "127.0.0.1",
                                "--port", "0", "--metrics_port", str(m)], cwd=str(REPO), env=_env(),
                               stdout=subprocess.PIPE, text=True) for m in smports]
    learner = actor = None
    try:
        ports = [int(p.stdout.readline().split(":")[1].split(" ")[0]) for p in shards]
        url = [f"tcp://127.0.0.1:{p}" for p in ports]
        obs = dict(enabled=True, install_handlers=False, dump_dir=str(tmp_path))
        agg = tfleet.FleetAggregator(targets={"actor": [f"127.0.0.1:{amport}"],
                                              "broker": [f"127.0.0.1:{m}" for m in smports],
                                              "learner": [f"127.0.0.1:{lmport}"]},
                                     alerts="fleet_unaccounted_frames,gt,0,for=1", bundle_dir=str(tmp_path))
        agg.poll_once()  # the shard at first sight; the others not up yet
        acfg = ActorConfig(policy=PolicyConfig(**SMALL), platform="cpu", envs_per_process=2, rollout_len=8,
                           max_dota_time=20.0, obs=ObsConfig(metrics_port=amport, **obs))
        actor = VectorActor(acfg, FabricBroker(url), actor_id=3,
                            stubs=[LocalDotaServiceStub(FakeDotaService()) for _ in range(2)])
        lcfg = LearnerConfig(batch_size=4, seq_len=8, policy=PolicyConfig(**SMALL), platform="cpu",
                             ppo=PPOConfig(max_staleness=1000), obs=ObsConfig(metrics_port=lmport, **obs),
                             staging=StagingConfig(pack_workers=pack_workers))
        learner = Learner(lcfg, FabricBroker(url), device="cpu")
        loop = asyncio.new_event_loop()
        task = loop.create_task(actor.run())
        polls = 0

        def step_for(seconds):
            nonlocal polls
            end = time.monotonic() + seconds
            while time.monotonic() < end:
                loop.run_until_complete(asyncio.sleep(0.05))
                agg.poll_once()
                polls += 1

        step_for(0.5)
        import threading

        ran = []
        t = threading.Thread(target=lambda: ran.append(learner.run(batch_timeout=30.0, max_idle=4)))
        t.start()
        while t.is_alive():
            if learner.version >= 2 and not learner.drain_requested:
                # the SIGTERM drain: the fabric stops popping, staging takes
                # in every frame popped, run() returns; the surface stays up
                learner.request_drain()
            step_for(0.2)
        assert ran and ran[0] >= 2
        step_for(1.0)  # frames pile up on the shard
        actor.obs.close, close = (lambda: None), actor.obs.close  # keep the actor's surface past its stop
        task.cancel()
        loop.run_until_complete(asyncio.gather(task, return_exceptions=True))
        time.sleep(0.5)  # a pop in flight lands in the fan-in queue
        for _ in range(3):
            report = agg.poll_once()
        assert {n: report["ledgers"][n]["status"] for n in ("producer", "shard", "delivery")} == \
            {"producer": "ok", "shard": "ok", "delivery": "ok"}, report["ledgers"]
        assert all(report["ledgers"][n]["windows_audited"] > 3 for n in ("producer", "shard", "delivery"))
        s = agg.scalars()
        assert s["fleet_unaccounted_frames"] == s["fleet_overaccounted_frames"] == s["fleet_fenced_frames"] == 0.0
        assert s["fleet_alerts_fired_total"] == 0.0 and polls > 5
        a = tfleet.scrape_endpoint(f"127.0.0.1:{amport}")
        b = [tfleet.scrape_endpoint(f"127.0.0.1:{m}") for m in smports]
        assert a["actor_publish_attempted_total"] == a["actor_rollouts_published_total"] == \
            sum(x["broker_shard_enqueued_total"] for x in b) == actor.rollouts_published > 0
        victim = max(range(2), key=lambda i: b[i]["broker_shard_resident"])
        assert b[victim]["broker_shard_resident"] >= 5
        rogue = TcpBroker("127.0.0.1", ports[victim])
        stolen = rogue.consume_experience(5, timeout=2.0)
        rogue.close()
        assert len(stolen) == 5
        report = agg.poll_once()
        assert report["ledgers"]["delivery"]["status"] == "alarm" and report["ledgers"]["delivery"]["unaccounted"] == 5
        assert report["ledgers"]["shard"]["status"] == "ok" and agg.scalars()["fleet_unaccounted_frames"] == 5.0
        assert agg.incidents_total == 1
        bundle = json.load(open(report["incidents"][0]))
        assert {f["role"] for f in bundle["flights"].values() if f} == {"fabric_shard", "vector3", "learner"}
        assert bundle["trace_index"]  # the actor's publish events carry trace ids
        close()
    finally:
        if learner is not None:
            learner.close()
            learner.broker.close()
        if actor is not None:
            actor.broker.close()
        for shard in shards:
            shard.terminate()
            shard.wait(timeout=30)


def test_frames_a_stopped_pool_mode_buffer_drops_read_as_lost(tmp_path):
    """A pool-mode buffer (the manifest's 4 workers) that no learner takes
    batches from fills its ready queue, then its intake (4 drains), and
    its pop thread holds a fifth drain. While it runs, fleetd's delivery
    ledger balances: the popped frames it has not ingested count in the
    intake gauge. Stopped so, it drops those drains; they leave the gauge,
    and the next poll books exactly them as unaccounted."""
    from dotaclient_tpu.transport import serialize as jser
    from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig, PPOConfig, StagingConfig
    from dotaclient_tpu_torch.ops import batch as tbatch
    from dotaclient_tpu_torch.parallel.fused_io import FusedBatchIO
    from dotaclient_tpu_torch.runtime import staging as tstaging
    from dotaclient_tpu_torch.transport import memory as tmem
    from test_transport import make_rollout

    B, T, n = 4, 8, 80
    cfg = LearnerConfig(batch_size=B, seq_len=T, policy=PolicyConfig(**SMALL), ppo=PPOConfig(max_staleness=1000),
                        staging=StagingConfig(pack_workers=4))
    p = cfg.policy
    io = FusedBatchIO(tstaging.cast_obs_to_compute_dtype(cfg, tbatch.zeros_train_batch(B, T, p.lstm_hidden,
                                                                                       p.aux_heads)), "cpu")
    tmem.reset("fleet_stop_drop")
    broker = tmem.MemoryBroker("fleet_stop_drop")
    for i in range(n):
        broker.publish_experience(jser.serialize_rollout(make_rollout(L=T, H=p.lstm_hidden, version=0, seed=i)))
    staging = tstaging.StagingBuffer(cfg, broker, fused_io=io)

    def scrape(ep):
        if ep == "b0":
            popped = float(n - broker.experience_depth())
            return {"broker_shard_enqueued_total": float(n), "broker_shard_popped_total": popped,
                    "broker_shard_resident": n - popped}
        st = staging.stats()
        return {"wire_frames_obs_bf16_total": float(st["wire_frames_obs_bf16"]),
                "wire_frames_obs_f32_total": float(st["wire_frames_obs_f32"]),
                "obs_staging_intake_frames": float(st["intake_frames"])}

    agg = tfleet.FleetAggregator(targets={"broker": ["b0"], "learner": ["l0"]},
                                 alerts="fleet_unaccounted_frames,gt,0,for=1", bundle_dir=str(tmp_path),
                                 scrape_fn=scrape, now_fn=lambda: 1000.0)
    agg.poll_once()  # first sight: every meter 0
    staging.start()
    try:
        deadline = time.monotonic() + 30
        while staging.stats()["intake_frames"] < 5 * B and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.3)  # nothing moves while the intake is full
        held = staging.stats()["intake_frames"]
        assert held == 5 * B and staging.stats()["ready_batches"] == 2
        live = agg.poll_once()["ledgers"]["delivery"]
        assert (live["status"], live["unaccounted"]) == ("ok", 0.0)
    finally:
        staging.stop()
    st = staging.stats()
    popped = n - broker.experience_depth()
    assert st["intake_frames"] == 0 and st["consumed"] == st["wire_frames_obs_f32"] + st["wire_frames_obs_bf16"]
    assert popped - st["consumed"] == held
    report = agg.poll_once()
    assert (report["ledgers"]["delivery"]["status"], report["ledgers"]["delivery"]["unaccounted"]) == \
        ("alarm", float(held))
    assert agg.scalars()["fleet_unaccounted_frames"] == float(held)


# ------------------------------------------------------------------ fleetd


def _fleetd_args():
    import chip_smoke

    return chip_smoke.manifest_args(str(FLEETD_MANIFEST))


def _local(args):
    """The manifest's args with every cluster DNS name swapped for a dead
    local port (a test dials nothing off this host), and port 0."""
    out = list(args)
    for flag, value in (("--fleet.port", "0"), ("--fleet.control", f"127.0.0.1:{_free_port()}"),
                        ("--fleet.learners", f"127.0.0.1:{_free_port()}"),
                        ("--fleet.leagues", f"127.0.0.1:{_free_port()}")):
        out[out.index(flag) + 1] = value
    return out


def _flat(c, prefix=""):
    out = {}
    for f in dataclasses.fields(c):
        v = getattr(c, f.name)
        out.update(_flat(v, f"{prefix}{f.name}.") if dataclasses.is_dataclass(v) else {f"{prefix}{f.name}": v})
    return out


def test_the_fleetd_manifest_parses_equally_in_both_packages():
    args = _fleetd_args()
    t, j = _flat(parse_config(FleetConfig(), args)), _flat(j_parse_config(JFleetConfig(), args))
    assert t == j
    assert t["fleet.port"] == 13420 and t["fleet.poll_s"] == 5.0 and t["fleet.control"] == "control-plane:13400"
    assert t["fleet.alerts"] == "fleet_unaccounted_frames,gt,0,for=3;fleet_targets_up,lt,1,for=3"


def _boot(module, args, cwd):
    proc = subprocess.Popen([sys.executable, "-m", module, *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env(), cwd=str(cwd))
    line = proc.stdout.readline()
    if not line:
        proc.kill()
        raise AssertionError(proc.stderr.read()[-2000:])
    return proc, json.loads(line)


def test_the_port_fleetd_boots_on_the_manifest_s_args_with_the_reference_s_boot_line(tmp_path):
    lines = {}
    args = _local(_fleetd_args())
    args[args.index("--fleet.bundle_dir") + 1] = str(tmp_path / "incidents")
    control, learner, league = (args[args.index(f) + 1] for f in ("--fleet.control", "--fleet.learners",
                                                                  "--fleet.leagues"))
    for module in ("dotaclient_tpu_torch.obs.fleetd", "dotaclient_tpu.obs.fleetd"):
        proc, ready = _boot(module, args + ["--obs.dump_dir", str(tmp_path)], tmp_path)
        try:
            lines[module] = {k: v for k, v in ready.items() if k != "port"}
            if module.startswith("dotaclient_tpu_torch"):
                base = f"http://127.0.0.1:{ready['port']}"
                deadline = time.time() + 30
                body = {}
                while time.time() < deadline and body.get("polls", 0) < 1:
                    body = json.loads(urllib.request.urlopen(f"{base}/fleet", timeout=10).read())
                    time.sleep(0.2)
                assert body["polls"] >= 1 and set(body["targets"]) == {f"learner/{learner}", f"league/{league}"}
                assert body["slo"]["fleet_topology_errors_total"] >= 1  # the control plane is not up
        finally:
            proc.terminate()
            proc.wait(timeout=30)
    assert lines["dotaclient_tpu_torch.obs.fleetd"] == lines["dotaclient_tpu.obs.fleetd"] == {
        "serving": True, "control": control, "alerts": 2, "targets": sorted([f"league/{league}",
                                                                              f"learner/{learner}"])}


def test_the_fleetd_binary_serves_every_route(tmp_path):
    proc, ready = _boot("dotaclient_tpu_torch.obs.fleetd", [
        "--fleet.port", "0", "--fleet.poll_s", "0.2", "--fleet.alerts", "fleet_unaccounted_frames,gt,0,for=3",
        "--fleet.bundle_dir", str(tmp_path), "--obs.dump_dir", str(tmp_path)], tmp_path)
    try:
        assert ready["serving"] is True and ready["alerts"] == 1
        base = f"http://127.0.0.1:{ready['port']}"
        fleet, deadline = {}, time.time() + 20
        while time.time() < deadline and fleet.get("polls", 0) < 1:
            fleet = json.loads(urllib.request.urlopen(f"{base}/fleet", timeout=10).read())
            time.sleep(0.1)
        assert fleet["polls"] >= 1 and "ledgers" in fleet
        assert "dotaclient_fleet_targets" in urllib.request.urlopen(f"{base}/metrics", timeout=10).read().decode()
        assert json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=10).read())["ok"] is True
        assert json.loads(urllib.request.urlopen(f"{base}/debug/flight", timeout=10).read())["role"] == "fleetd"
    finally:
        proc.terminate()
        proc.wait(timeout=30)


@pytest.mark.parametrize("module", ["dotaclient_tpu_torch.obs.fleetd", "dotaclient_tpu.obs.fleetd"])
def test_fleetd_rejects_a_bad_alert_clause_at_boot(module, tmp_path):
    proc = subprocess.run([sys.executable, "-m", module, "--fleet.port", "0", "--fleet.alerts",
                           "fleet_unaccounted_frames,between,0"], cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=120, env=_env())
    assert proc.returncode != 0 and "alert clause" in proc.stderr


def test_fleet_meters_and_producer_counters_are_registered_in_both_registries():
    for name in ("fleet_unaccounted_frames", "fleet_overaccounted_frames", "fleet_fenced_frames",
                 "fleet_ledger_delivery_unaccounted", "fleet_ledger_shard_ok", "fleet_targets_up",
                 "fleet_fences_total", "fleet_alerts_firing", "fleet_incidents_total", "fleet_e2e_env_steps_per_sec",
                 "fleet_host_wall_gap", "control_polls_total", "control_replicas_server",
                 "actor_publish_attempted_total", "actor_rollouts_published_total", "obs_boot_epoch_ms"):
        assert tregistry.is_registered(name) and jregistry.is_registered(name), name
    terms = {t.meter for spec in tfleet.LEDGERS for t in spec.terms}
    assert tregistry.unregistered(terms) == []


# ---------------------------------------------------------------- preflight


class _FakeProc:
    """A /proc tree in memory: our process 500 (parent 400, grandparent
    1), a stray port server 601, an unrelated listener 602, a process of
    the reference 603, and a vanished pid 604."""

    def __init__(self, allow=""):
        listen = [("0100007F:1F90", "0A", "9001"), ("00000000:3456", "0A", "9002"), ("0100007F:2710", "0A", "9003"),
                  ("0100007F:0050", "01", "9004"), ("0100007F:3039", "0A", "9005")]
        head = "  sl  local_address rem_address   st tx_queue rx_queue tr tm->when retrnsmt   uid  timeout inode\n"
        rows = "".join(f"   {i}: {loc} 00000000:0000 {st} 00000000:00000000 00:00000000 00000000  1000 0 {ino}\n"
                       for i, (loc, st, ino) in enumerate(listen))
        self.files = {
            "/proc/net/tcp": head + rows,
            "/proc/500/status": "Name:\tpython\nPPid:\t400\n",
            "/proc/400/status": "Name:\tpytest\nPPid:\t1\n",
            "/proc/601/cmdline": b"python\x00-m\x00dotaclient_tpu_torch.serve.server\x00--serve.port\x008080\x00",
            "/proc/602/cmdline": b"nginx\x00-g\x00daemon off;\x00",
            "/proc/603/cmdline": b"python\x00-m\x00dotaclient_tpu.transport.fabric\x00",
            "/proc/400/cmdline": b"python\x00-m\x00pytest\x00dotaclient_tpu_torch\x00",
        }
        self.dirs = {"/proc": ["1", "400", "500", "601", "602", "603", "604", "net", "self"],
                     "/proc/601/fd": ["0", "3"], "/proc/602/fd": ["4", "5"], "/proc/603/fd": ["7"],
                     "/proc/400/fd": ["9"], "/proc/500/fd": ["1"]}
        self.links = {"/proc/601/fd/0": "/dev/null", "/proc/601/fd/3": "socket:[9001]",
                      "/proc/602/fd/4": "socket:[9002]", "/proc/602/fd/5": "socket:[9005]",
                      "/proc/603/fd/7": "socket:[9003]", "/proc/400/fd/9": "socket:[9005]",
                      "/proc/500/fd/1": "socket:[9004]"}
        self.environ = {"DOTACLIENT_TPU_ALLOW_STRAYS": allow} if allow else {}

    def open(self, path, mode="r"):
        import io

        if path not in self.files:
            raise FileNotFoundError(path)
        data = self.files[path]
        if "b" in mode:
            return io.BytesIO(data)
        return io.StringIO(data if isinstance(data, str) else data.decode())

    def listdir(self, path):
        if path not in self.dirs:
            raise FileNotFoundError(path)
        return list(self.dirs[path])

    def readlink(self, path):
        if path not in self.links:
            raise OSError(path)
        return self.links[path]

    def getpid(self):
        return 500

    def getloadavg(self):
        return (0.25, 0.5, 0.75)

    def cpu_count(self):
        return 8


def _preflight(mod, monkeypatch, allow="", ports=()):
    fake = _FakeProc(allow)
    monkeypatch.setattr(mod, "open", fake.open, raising=False)
    monkeypatch.setattr(mod, "os", fake)
    try:
        return "ok", mod.scan_listeners(ports), mod.check("smoke", ports)
    except SystemExit as e:
        return "exit", mod.scan_listeners(ports), str(e)


@pytest.mark.parametrize("allow,ports", [("", ()), ("", (12345, 80)), ("1", ()), ("0", ())])
def test_preflight_check_equals_the_reference_on_one_faked_proc(monkeypatch, allow, ports):
    """The same faked /proc through both packages' check(): the same
    strays (the port server of either package and any listener on a named
    port; never an ancestor, a non-listening socket or a foreign process
    on an unnamed port), the same failure text, and with
    DOTACLIENT_TPU_ALLOW_STRAYS=1 the same disclosure."""
    ours = _preflight(tpreflight, monkeypatch, allow, ports)
    theirs = _preflight(jpreflight, monkeypatch, allow, ports)
    if ours[0] == "ok":
        for out in (ours[2], theirs[2]):
            assert out.pop("checked_at")
    assert ours == theirs
    strays = ours[1]
    want = [{"pid": 601, "port": 8080, "cmdline": "python -m dotaclient_tpu_torch.serve.server --serve.port 8080"},
            {"pid": 603, "port": 10000, "cmdline": "python -m dotaclient_tpu.transport.fabric"}]
    if 12345 in ports:
        want.insert(2, {"pid": 602, "port": 12345, "cmdline": "nginx -g daemon off;"})
    assert strays == want
    if allow == "1":
        assert ours[0] == "ok" and ours[2]["preflight"]["strays"] == want and ours[2]["preflight"]["ok"] is False
        assert ours[2]["cpus"] == 8 and ours[2]["loadavg_1m"] == 0.25
    else:
        assert ours[0] == "exit" and "pid 601 listening on :8080" in ours[2]


def test_preflight_on_a_clean_host_returns_the_disclosure(monkeypatch):
    fake = _FakeProc()
    fake.files["/proc/net/tcp"] = fake.files["/proc/net/tcp"].splitlines(keepends=True)[0]
    monkeypatch.setattr(tpreflight, "open", fake.open, raising=False)
    monkeypatch.setattr(tpreflight, "os", fake)
    out = tpreflight.check("smoke", ports=[13400])
    assert out["preflight"] == {"label": "smoke", "ports_checked": [13400], "strays": [], "ok": True}


def test_the_fleet_daemon_in_process_equals_the_reference_s(tmp_path):
    """The binary's shape in-process: both packages' FleetDaemon take the
    same flags to the same literal targets and alert rules, and the port's
    serves /fleet, /healthz and its own /debug/flight ring."""
    from dotaclient_tpu.obs import fleetd as jfleetd
    from dotaclient_tpu_torch.obs import fleetd as tfleetd

    argv = ["--fleet.port", "0", "--fleet.poll_s", "0.1", "--fleet.brokers", "127.0.0.1:1, 127.0.0.1:2",
            "--fleet.learners", "127.0.0.1:3", "--fleet.leagues", "127.0.0.1:4", "--fleet.actors", "",
            "--fleet.alerts", "fleet_targets_up,lt,1,for=2", "--fleet.bundle_dir", str(tmp_path)]
    tcfg, jcfg = parse_config(FleetConfig(), argv), j_parse_config(JFleetConfig(), argv)
    assert tfleetd._literal_targets(tcfg.fleet) == jfleetd._literal_targets(jcfg.fleet) == {
        "broker": ["127.0.0.1:1", "127.0.0.1:2"], "learner": ["127.0.0.1:3"], "league": ["127.0.0.1:4"]}
    daemon = tfleetd.FleetDaemon(tcfg)
    assert [r.raw for r in daemon.agg.alert_engine.rules] == ["fleet_targets_up,lt,1,for=2"]
    daemon.start()
    try:
        base = f"http://127.0.0.1:{daemon.port}"
        deadline, fleet = time.time() + 20, {}
        while time.time() < deadline and not fleet.get("alerts", [{}])[0].get("firing"):
            fleet = json.loads(urllib.request.urlopen(f"{base}/fleet", timeout=10).read())
            time.sleep(0.05)
        assert fleet["alerts"][0]["firing"] and fleet["slo"]["fleet_targets_up"] == 0.0
        flight = json.loads(urllib.request.urlopen(f"{base}/debug/flight", timeout=10).read())
        assert flight["role"] == "fleetd" and "alert_fired" in [e["ev"] for e in flight["events"]]
        assert len(os.listdir(tmp_path)) == 1  # the incident bundle
    finally:
        daemon.stop()
