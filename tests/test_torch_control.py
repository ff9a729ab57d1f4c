"""The port's control plane (dotaclient_tpu_torch/control/) against the
reference (dotaclient_tpu/control/) on the CPU: the --control.policy
grammar and its malformations, PolicyEngine decision sequences on one
meter stream with an injected clock, the Prometheus-text parser over the
port's exposition, per-tier aggregation, the drivers (K8sDriver's kubectl
argv through an injected runner), the closed loop over real port surfaces,
/topology from both packages' planes built from the same flags, and
discovery: the port's and the reference's serve clients stepping a port
server they found through the port's control plane. Every comparison is
exact: the logic is discrete, and the floats compared are the same
parses of the same text."""

from __future__ import annotations

import asyncio
import dataclasses
import json
import socket
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from dotaclient_tpu.config import ControlConfig as JControlConfig
from dotaclient_tpu.config import ControlLoopConfig as JControlLoopConfig
from dotaclient_tpu.config import parse_config as j_parse_config
from dotaclient_tpu.control import drivers as jdrivers
from dotaclient_tpu.control import policy as jpolicy
from dotaclient_tpu.control import scrape as jscrape
from dotaclient_tpu.control import server as jserver
from dotaclient_tpu_torch.config import ControlConfig, ControlLoopConfig, parse_config
from dotaclient_tpu_torch.control import drivers as tdrivers
from dotaclient_tpu_torch.control import policy as tpolicy
from dotaclient_tpu_torch.control import scrape as tscrape
from dotaclient_tpu_torch.control import server as tserver
from dotaclient_tpu_torch.obs.http import MetricsHTTPServer, render_prometheus

REPO = Path(__file__).resolve().parent.parent
CONTROL_MANIFEST = REPO / "k8s" / "control.yaml"
SMALL = dict(lstm_hidden=16, unit_embed_dim=16, mlp_hidden=16, dtype="float32")
BOOT_KEYS = {"serving", "port", "driver", "tiers"}


def _env():
    from tests.conftest import clean_subprocess_env

    return clean_subprocess_env(extra={"JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)})


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _manifest_args():
    import chip_smoke

    return chip_smoke.manifest_args(str(CONTROL_MANIFEST))


def _swap(args, flag, value):
    out = list(args)
    out[out.index(flag) + 1] = value
    return out


def _local(args, port):
    """The manifest's args with --control.port `port` and the scrape lists'
    cluster DNS names swapped for dead local ports (a test dials nothing
    off this host)."""
    args = _swap(args, "--control.port", str(port))
    args = _swap(args, "--control.servers", f"127.0.0.1:{_free_port()},127.0.0.1:{_free_port()}")
    return _swap(args, "--control.brokers", ",".join(f"127.0.0.1:{_free_port()}" for _ in range(3)))


def _flat(c, prefix=""):
    out = {}
    for f in dataclasses.fields(c):
        v = getattr(c, f.name)
        out.update(_flat(v, f"{prefix}{f.name}.") if dataclasses.is_dataclass(v) else {f"{prefix}{f.name}": v})
    return out


# --------------------------------------------------------- policy grammar


def _clauses(mod, spec):
    return [dataclasses.astuple(c) for c in mod.parse_policy(spec)]


@pytest.mark.parametrize("spec", [
    "server:serve_load_occupancy.mean,high=0.8,low=0.2,min=2,max=8,cooldown=30,step=2",
    "broker:up,high=5,low=1",
    "",
    "   ",
    "server:up,high=5,low=1; broker:up,high=9,low=2",
])
def test_parse_policy_equals_the_reference(spec):
    assert _clauses(tpolicy, spec) == _clauses(jpolicy, spec)


def test_parse_policy_on_the_manifest_clause():
    spec = _manifest_args()[_manifest_args().index("--control.policy") + 1]
    got = _clauses(tpolicy, spec)
    assert got == _clauses(jpolicy, spec)
    assert got == [("server", "serve_load_occupancy.mean", 0.75, 0.25, 2, 8, 120.0, 1),
                   ("broker", "broker_shard_depth.max", 6000.0, 512.0, 3, 8, 180.0, 1)]
    (cl,) = tpolicy.parse_policy("server:serve_load_occupancy.mean,high=0.8,low=0.2,min=2,max=8,cooldown=30,step=2")
    assert cl == tpolicy.PolicyClause(tier="server", meter="serve_load_occupancy.mean", high=0.8, low=0.2, min=2,
                                      max=8, cooldown_s=30.0, step=2)


@pytest.mark.parametrize("bad", [
    "server:up,high=5,low=1;",  # trailing empty clause
    "serve_load.mean,high=5,low=1",  # missing tier:
    "gateway:up,high=5,low=1",  # unknown tier
    "server:up,high5,low=1",  # non-k=v item
    "server:up,high=5,low=1,hi=3",  # unknown key
    "server:up,high=5",  # missing low
    "server:up,low=1",  # missing high
    "server:up,high=1,low=5",  # inverted band
    "server:up,high=5,low=1,min=0",  # min < 1
    "server:up,high=5,low=1,min=4,max=2",  # max < min
    "server:up,high=5,low=1,step=0",  # step < 1
    "server:up,high=x,low=1",  # non-number
])
def test_parse_policy_rejects_malformation_with_the_reference_s_message(bad):
    with pytest.raises(ValueError) as ours:
        tpolicy.parse_policy(bad)
    with pytest.raises(ValueError) as theirs:
        jpolicy.parse_policy(bad)
    assert str(ours.value) == str(theirs.value)


# ------------------------------------------------------------ policy engine


def _engines(spec, clock):
    return (tpolicy.PolicyEngine(tpolicy.parse_policy(spec), now_fn=lambda: clock[0]),
            jpolicy.PolicyEngine(jpolicy.parse_policy(spec), now_fn=lambda: clock[0]))


def test_policy_engine_hysteresis_cooldown_and_clamps():
    """The reference's decision script, through both engines: records
    equal field for field, and the port's hold the reference test's
    expectations."""
    clock = [1000.0]
    ours, theirs = _engines("server:load.mean,high=0.8,low=0.2,min=2,max=4,cooldown=30", clock)
    script = [(0.9, 2, 0), (0.9, 3, 0), (0.9, 3, 31), (0.99, 4, 31), (0.5, 4, 0), (0.1, 4, 0), (0.05, 3, 31),
              (0.05, 2, 31)]
    got = []
    for value, cur, dt in script:
        clock[0] += dt
        (a,) = ours.evaluate({"server": {"load.mean": value}}, {"server": cur})
        (b,) = theirs.evaluate({"server": {"load.mean": value}}, {"server": cur})
        assert a == b
        got.append((a["action"], a["target"], a["reason"]))
    assert got[0][:2] == ("up", 3) and "0.9" in got[0][2]
    assert got[1][0] == "hold" and got[1][2].startswith("cooldown")
    assert got[2][1] == 4 and got[3] == ("hold", 4, "at max bound") and got[4] == ("hold", 4, "in hysteresis band")
    assert got[5][:2] == ("down", 3) and got[6][1] == 2 and got[7] == ("hold", 2, "at min bound")


def test_policy_engine_missing_meter_freezes_and_one_move_per_tier():
    clock = [0.0]
    ours, theirs = _engines("server:a.mean,high=5,low=1;server:b.max,high=5,low=1", clock)
    recs = [e.evaluate({"server": {"b.max": 9.0}}, {"server": 2}) for e in (ours, theirs)]
    assert recs[0] == recs[1]
    assert recs[0][0]["reason"] == "meter missing" and recs[0][1]["action"] == "up"
    clock[0] += 31
    recs = [e.evaluate({"server": {"a.mean": 9.0, "b.max": 9.0}}, {"server": 3}) for e in (ours, theirs)]
    assert recs[0] == recs[1]
    assert recs[0][0]["action"] == "up" and recs[0][1]["reason"] == "superseded"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policy_engine_decisions_equal_the_reference_on_one_meter_stream(seed):
    """A seeded stream of meters (some missing), replica views and clock
    steps over three clauses on two tiers: every record of every poll is
    equal in both packages."""
    rs = np.random.RandomState(seed)
    clock = [100.0]
    spec = ("server:serve_load_occupancy.mean,high=0.75,low=0.25,min=2,max=8,cooldown=12;"
            "server:up.sum,high=7,low=1,min=2,max=8,step=2;broker:broker_shard_depth.max,high=6000,low=512,min=3,max=8")
    ours, theirs = _engines(spec, clock)
    current = {"server": 2, "broker": 3}
    moves = 0
    for _ in range(300):
        clock[0] += float(rs.choice([0.5, 2.0, 5.0, 13.0]))
        meters = {"server": {}, "broker": {}}
        if rs.rand() > 0.1:
            meters["server"]["serve_load_occupancy.mean"] = float(rs.rand())
        if rs.rand() > 0.2:
            meters["server"]["up.sum"] = float(rs.randint(0, 9))
        if rs.rand() > 0.1:
            meters["broker"]["broker_shard_depth.max"] = float(rs.randint(0, 9000))
        a, b = ours.evaluate(meters, dict(current)), theirs.evaluate(meters, dict(current))
        assert a == b
        for rec in a:
            if rec["action"] != "hold":
                current[rec["tier"]] = rec["target"]
                moves += 1
    assert moves > 10


# ------------------------------------------------------- scrape + aggregate


def test_parse_prometheus_text_reads_the_port_s_exposition_as_the_reference():
    scalars = {"serve_load_occupancy": 0.75, "broker_shard_depth": 6144.0, "big_counter": 1234567890.0,
               "tiny": 1.5e-7, "control_replicas_server": 2.0}
    text = render_prometheus(scalars)
    assert "dotaclient_serve_load_occupancy 0.75" in text
    assert tscrape.parse_prometheus_text(text) == jscrape.parse_prometheus_text(text) == scalars
    junk = "# HELP x\ndotaclient_a 1\nnot a number line\nb nan_oops\n\nother_prefix_c 2\n"
    assert tscrape.parse_prometheus_text(junk) == jscrape.parse_prometheus_text(junk) == {"a": 1.0,
                                                                                           "other_prefix_c": 2.0}


@pytest.mark.parametrize("samples", [
    [{"q": 2.0}, None, {"q": 6.0, "r": 1.0}],
    [],
    [None, None],
    [{"a.b": -1.0, "x": 3.0}],
])
def test_aggregate_tier_equals_the_reference(samples):
    assert tscrape.aggregate_tier(samples) == jscrape.aggregate_tier(samples)


def test_aggregate_tier_mean_max_sum_and_up():
    agg = tscrape.aggregate_tier([{"q": 2.0}, None, {"q": 6.0, "r": 1.0}])
    assert agg["up"] == 2.0 and agg["scraped"] == 3.0
    assert agg["q.mean"] == 4.0 and agg["q.max"] == 6.0 and agg["q.sum"] == 8.0 and agg["r.mean"] == 1.0


def test_scrape_endpoint_and_health_against_a_port_surface():
    gauges = {"serve_load_occupancy": 0.5}
    health = {"ok": True, "note": "fine"}
    srv = MetricsHTTPServer(0, sources=[lambda: gauges], health_provider=lambda: dict(health)).start()
    try:
        ep = f"127.0.0.1:{srv.port}"
        first, ref = tscrape.scrape_endpoint(ep), jscrape.scrape_endpoint(ep)
        assert first == ref and set(first) == {"serve_load_occupancy", "obs_boot_epoch_ms"}
        assert first["serve_load_occupancy"] == 0.5 and first["obs_boot_epoch_ms"] > 0
        gauges["serve_load_occupancy"] = 0.9
        assert tscrape.scrape_endpoint(ep)["serve_load_occupancy"] == 0.9
        assert tscrape.scrape_health(ep) == jscrape.scrape_health(ep) == (True, health)
        health["ok"] = False  # the 503 body still carries the verdict
        assert tscrape.scrape_health(ep) == jscrape.scrape_health(ep) == (False, health)
    finally:
        srv.stop()
    assert tscrape.scrape_endpoint(ep, timeout_s=0.3) is None
    assert tscrape.scrape_health(ep, timeout_s=0.3) == (False, {})


# ----------------------------------------------------------------- drivers


def test_static_driver_observes_and_never_actuates_as_the_reference():
    for mod in (tdrivers, jdrivers):
        d = mod.StaticDriver({"server": ["a:1", "b:1"], "broker": ["c:2"], "actor": []})
        assert d.tiers() == ["broker", "server"] and d.replicas("server") == 2
        rec = d.scale("server", 5)
        assert rec == {"driver": "static", "tier": "server", "replicas": 5, "actuated": False}
        assert d.noop_scales == 1 and d.replicas("server") == 2
        assert d.topology() == {"server": ["a:1", "b:1"], "broker": ["c:2"]}
        d2 = mod.StaticDriver({"server": ["a:9100"]}, topology_map={"server": ["a:13380"]})
        assert d2.topology() == {"server": ["a:13380"]} and d2.metrics_endpoints("server") == ["a:9100"]


def test_k8s_driver_argv_pod_dns_and_failure_through_the_injected_runner():
    """The same specs and runner script: both drivers issue the same
    kubectl argv, derive the same per-pod endpoints and topology, and
    keep their view on a failed kubectl."""
    logs = []
    for mod in (tdrivers, jdrivers):
        calls, rc = [], [0]
        specs = {
            "server": mod.TierSpec(tier="server", workload="statefulset/inference", service="inference",
                                   data_port=13380, replicas=2),
            "learner": mod.TierSpec(tier="learner", workload="statefulset/learner", data_port=0, replicas=1),
        }
        d = mod.K8sDriver(specs, kubectl="kubectl", runner=lambda argv: (calls.append(argv), rc[0])[1])
        log = [d.tiers(), d.metrics_endpoints("server"), d.topology()]
        log.append(d.scale("server", 3))
        log.append((d.replicas("server"), d.metrics_endpoints("server")))
        rc[0] = 1
        log.append(d.scale("server", 4))
        log.append((d.replicas("server"), d.kubectl_calls, d.kubectl_failures, calls))
        logs.append(log)
    assert logs[0] == logs[1]
    ours = logs[0]
    assert ours[1] == ["inference-0.inference.dotaclient.svc:9100", "inference-1.inference.dotaclient.svc:9100"]
    assert ours[2] == {"server": ["inference-0.inference.dotaclient.svc:13380",
                                  "inference-1.inference.dotaclient.svc:13380"]}
    assert ours[3]["argv"] == ["kubectl", "scale", "statefulset/inference", "--replicas=3", "-n", "dotaclient"]
    assert ours[3]["actuated"] and ours[4][0] == 3 and len(ours[4][1]) == 3
    assert ours[5]["actuated"] is False and ours[6][:3] == (3, 2, 1)


def test_build_driver_static_k8s_and_reject_as_the_reference():
    def build(server_mod, cfg_mod, loop_mod, driver):
        cfg = cfg_mod(control=loop_mod(policy="server:up,high=5,low=1", driver=driver, servers="a:9100, b:9100",
                                       brokers="c:9100", namespace="other"))
        d, overrides = server_mod.build_driver(cfg)
        return (type(d).__name__, d.tiers(), overrides, {t: d.metrics_endpoints(t) for t in d.tiers()}, d.topology())

    for driver in ("static", "k8s"):
        got = build(tserver, ControlConfig, ControlLoopConfig, driver)
        assert got == build(jserver, JControlConfig, JControlLoopConfig, driver)
    assert got[0] == "K8sDriver" and got[2] == {"server": ["a:9100", "b:9100"], "broker": ["c:9100"]}
    assert got[3]["server"][0].endswith(".other.svc:9100")
    for server_mod, cfg_mod, loop_mod in ((tserver, ControlConfig, ControlLoopConfig),
                                          (jserver, JControlConfig, JControlLoopConfig)):
        with pytest.raises(ValueError, match="static|k8s"):
            build(server_mod, cfg_mod, loop_mod, "nomad")


# ------------------------------------------------------------- closed loop


class _ElasticRouter:
    """replica_count()/scale_to(n) over live port MetricsHTTPServers."""

    def __init__(self, make_replica, n):
        self._make = make_replica
        self.replicas = [make_replica(i) for i in range(n)]

    def replica_count(self):
        return len(self.replicas)

    def scale_to(self, n):
        while len(self.replicas) < n:
            self.replicas.append(self._make(len(self.replicas)))
        while len(self.replicas) > n:
            self.replicas.pop().stop()  # highest index first (the StatefulSet order)

    def endpoints(self):
        return [f"127.0.0.1:{r.port}" for r in self.replicas]

    def close(self):
        for r in self.replicas:
            r.stop()


def _plane_pair(load, clock, policy):
    """A port and a reference ControlPlane, each over its own elastic
    router of port surfaces reporting the same load gauge."""
    out = []
    for server_mod, drivers_mod, cfg_mod, loop_mod in ((tserver, tdrivers, ControlConfig, ControlLoopConfig),
                                                       (jserver, jdrivers, JControlConfig, JControlLoopConfig)):
        router = _ElasticRouter(
            lambda i: MetricsHTTPServer(0, sources=[lambda: {"serve_load_occupancy": load[0]}]).start(), 2)
        driver = drivers_mod.InProcessDriver({"server": router}, metrics={"server": router.endpoints},
                                             topology_fn=lambda r=router: {"server": r.endpoints()})
        plane = server_mod.ControlPlane(cfg_mod(control=loop_mod(port=0, poll_s=0.05, policy=policy)), driver,
                                        now_fn=lambda: clock[0])
        out.append((plane, router))
    return out


def _decisions(plane):
    """Ledger entries without the wall time and the surfaces' boot epochs."""
    out = []
    for e in plane.ledger():
        e = {k: v for k, v in e.items() if k != "t"}
        e["meters"] = {k: v for k, v in e["meters"].items() if not k.startswith("obs_boot_epoch_ms")}
        out.append(e)
    return out


def test_control_plane_closed_loop_over_real_surfaces_equals_the_reference():
    """Scrape→decide→actuate→re-scrape over real HTTP surfaces: load high
    scales 2→3 (epoch bump, ledger entry carrying the triggering meters),
    cooldown holds, load low scales back; both packages' planes ledger the
    same decisions, and the port's serves them on /topology and /metrics."""
    load, clock = [0.9], [5000.0]
    (plane, router), (jplane, jrouter) = _plane_pair(
        load, clock, "server:serve_load_occupancy.mean,high=0.8,low=0.2,min=2,max=4,cooldown=30")
    try:
        for dt, value in ((0, 0.9), (0, 0.9), (31, 0.1)):
            clock[0] += dt
            load[0] = value
            a, b = plane.poll_once(), jplane.poll_once()
            assert a["evals"] == b["evals"]
        assert _decisions(plane) == _decisions(jplane)
        assert [e["action"] for e in plane.ledger()] == ["up", "hold", "down"]
        entry = plane.ledger()[0]
        assert entry["meters"]["serve_load_occupancy.mean"] == pytest.approx(0.9)
        assert entry["meters"]["up"] == 2.0 and entry["actuation"]["actuated"]
        assert router.replica_count() == jrouter.replica_count() == 2
        assert plane.stats() == jplane.stats()
        assert plane.topology_epoch == 2
        plane.start()
        base = f"http://127.0.0.1:{plane.port}"
        with urllib.request.urlopen(f"{base}/topology", timeout=5) as resp:
            topo = json.loads(resp.read())
        assert topo == {"ok": True, "epoch": 2, "tiers": {"server": router.endpoints()},
                        "metrics": {"server": router.endpoints()}}
        scraped = tscrape.scrape_endpoint(f"127.0.0.1:{plane.port}")
        assert scraped["control_scale_ups_total"] == scraped["control_scale_downs_total"] == 1.0
        assert scraped["control_replicas_server"] == 2.0 and scraped["control_topology_epoch"] == 2.0
        flight = json.loads(urllib.request.urlopen(f"{base}/debug/flight", timeout=5).read())
        assert flight["role"] == "control" and [e["action"] for e in flight["events"]] == ["up", "down"]
    finally:
        plane.stop()
        router.close()
        jrouter.close()


def test_control_plane_scrape_outage_freezes_topology():
    """Every surface down: up=0, the policy meter missing, the tier holds
    at its current shape in both packages."""
    got = []
    for server_mod, drivers_mod, cfg_mod, loop_mod in ((tserver, tdrivers, ControlConfig, ControlLoopConfig),
                                                       (jserver, jdrivers, JControlConfig, JControlLoopConfig)):
        router = _ElasticRouter(lambda i: MetricsHTTPServer(0).start(), 2)
        eps = router.endpoints()
        router.close()
        router.replicas = [type("R", (), {"port": int(e.rpartition(":")[2]), "stop": lambda self: None})()
                           for e in eps]
        driver = drivers_mod.InProcessDriver({"server": router}, metrics={"server": router.endpoints})
        plane = server_mod.ControlPlane(cfg_mod(control=loop_mod(
            port=0, poll_s=0.05, policy="server:serve_load_occupancy.mean,high=0.8,low=0.2,min=1,max=4")), driver)
        plane._scrape_timeout = 0.3
        rnd = plane.poll_once()
        got.append((rnd["meters"], rnd["evals"], router.replica_count(), plane.scrape_errors_total))
    assert got[0] == got[1]
    meters, (ev,), replicas, errors = got[0]
    assert meters["server"]["up"] == 0.0 and ev["reason"] == "meter missing" and replicas == 2 and errors == 2


def test_json_route_error_is_500_not_a_dead_thread():
    srv = MetricsHTTPServer(0, json_routes={"/topology": lambda: 1 / 0}).start()
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/topology", timeout=5)
        assert exc.value.code == 500
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz", timeout=5) as resp:
            assert json.loads(resp.read())["ok"] is True
    finally:
        srv.stop()


def test_topology_from_both_planes_built_from_the_same_flags():
    """The same --control.* flags through each package's parse_config and
    build_driver: /topology, /healthz and /metrics answer alike (after
    one poll each over the same dead endpoints)."""
    argv = ["--control.port", "0", "--control.poll_s", "60", "--control.driver", "static",
            "--control.policy", "server:serve_load_occupancy.mean,high=0.8,low=0.2,min=2",
            "--control.servers", "127.0.0.1:1,127.0.0.1:2", "--control.brokers", "127.0.0.1:3"]
    answers = []
    for server_mod, cfg in ((tserver, parse_config(ControlConfig(), argv)),
                            (jserver, j_parse_config(JControlConfig(), argv))):
        driver, overrides = server_mod.build_driver(cfg)
        plane = server_mod.ControlPlane(cfg, driver, metrics_overrides=overrides).start()
        plane._scrape_timeout = 0.3
        try:
            plane.poll_once()
            base = f"http://127.0.0.1:{plane.port}"
            topo = json.loads(urllib.request.urlopen(f"{base}/topology", timeout=5).read())
            health = json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=5).read())
            metrics = tscrape.scrape_endpoint(f"127.0.0.1:{plane.port}")
            metrics.pop("obs_boot_epoch_ms")
            answers.append((topo, health, metrics, [{k: v for k, v in e.items() if k != "t"} for e in plane.ledger()]))
        finally:
            plane.stop()
    assert answers[0] == answers[1]
    topo, health, metrics, ledger = answers[0]
    assert topo == {"ok": True, "epoch": 0, "tiers": {"broker": ["127.0.0.1:3"],
                                                      "server": ["127.0.0.1:1", "127.0.0.1:2"]},
                    "metrics": {"broker": ["127.0.0.1:3"], "server": ["127.0.0.1:1", "127.0.0.1:2"]}}
    assert health == {"ok": True, "polls": 1, "epoch": 0, "tiers": {"broker": 1, "server": 2}}
    assert metrics["control_scrape_errors_total"] == 3.0 and ledger[0]["reason"] == "meter missing"


# --------------------------------------------------------------- discovery


def _port_server():
    from dotaclient_tpu_torch.config import InferenceConfig, PolicyConfig, ServeConfig
    from dotaclient_tpu_torch.serve.server import InferenceServer

    return InferenceServer(InferenceConfig(
        serve=ServeConfig(port=0, max_batch=4, gather_window_s=0.005, weight_poll_s=0.05),
        policy=PolicyConfig(**SMALL), seed=1, platform="cpu")).start()


def _discovery_plane(server_port):
    driver = tdrivers.StaticDriver({"server": ["unused:9100"]}, topology_map={"server": [f"127.0.0.1:{server_port}"]})
    return tserver.ControlPlane(ControlConfig(control=ControlLoopConfig(port=0, poll_s=60.0)), driver).start()


@pytest.mark.parametrize("client_pkg", ["port", "reference"])
def test_serve_clients_discover_a_port_server_through_the_port_control_plane(client_pkg):
    """`control:<plane>` as the endpoint: each package's RemotePolicyClient
    fetches the port plane's /topology at connect, adopts the data
    endpoint and steps the port server; with the plane gone and no cached
    list, the connect fails loudly."""
    if client_pkg == "port":
        from dotaclient_tpu_torch.config import PolicyConfig
        from dotaclient_tpu_torch.env import featurizer as F
        from dotaclient_tpu_torch.serve.client import RemoteInferenceError, RemotePolicyClient
    else:
        from dotaclient_tpu.config import PolicyConfig
        from dotaclient_tpu.env import featurizer as F
        from dotaclient_tpu.serve.client import RemoteInferenceError, RemotePolicyClient

    srv = _port_server()
    plane = _discovery_plane(srv.port)
    try:
        client = RemotePolicyClient(f"control:127.0.0.1:{plane.port}", PolicyConfig(**SMALL))
        assert client.endpoints == []

        async def go(c):
            try:
                return await c.step(7, F.zeros_observation(), np.zeros(2, np.uint32), episode_start=True)
            finally:
                await c.close()

        resp = asyncio.new_event_loop().run_until_complete(go(client))
        assert resp.action is not None and resp.version == 0
        assert client.endpoints == [("127.0.0.1", srv.port)]
        assert client.topology_refreshes == 1 and client.topology_epoch == 0
        dead = RemotePolicyClient(f"control:127.0.0.1:{plane.port}", PolicyConfig(**SMALL), connect_timeout_s=0.5)
        plane.stop()
        with pytest.raises(RemoteInferenceError, match="no serve endpoints"):
            asyncio.new_event_loop().run_until_complete(go(dead))
        assert dead.topology_errors >= 1
    finally:
        plane.stop()
        srv.stop()


def test_literal_endpoint_client_and_server_never_import_the_port_control_package():
    script = r"""
import sys
from dotaclient_tpu_torch.config import InferenceConfig, PolicyConfig, ServeConfig
from dotaclient_tpu_torch.serve.client import RemotePolicyClient
from dotaclient_tpu_torch.serve.server import InferenceServer

policy = PolicyConfig(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32")
client = RemotePolicyClient("a:1,b:2", policy)
assert client._control is None and len(client.endpoints) == 2
srv = InferenceServer(InferenceConfig(serve=ServeConfig(port=0, max_batch=2, gather_window_s=0.005,
                                                        weight_poll_s=0.05), policy=policy, seed=1,
                                      platform="cpu")).start()
srv.stop()
offenders = [m for m in sys.modules if m.startswith("dotaclient_tpu_torch.control") or m == "dotaclient_tpu"
             or m.startswith("dotaclient_tpu.")]
assert not offenders, offenders
print("CONTROL_INERT_OK")
"""
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=300, env=_env(),
                          cwd=str(REPO))
    assert proc.returncode == 0 and "CONTROL_INERT_OK" in proc.stdout, proc.stderr[-2000:]


# ---------------------------------------------------------------- manifest


def test_the_control_manifest_parses_equally_in_both_packages():
    args = _manifest_args()
    assert "--control.policy" in args and "--control.servers" in args and "--obs.enabled" in args
    t, j = _flat(parse_config(ControlConfig(), args)), _flat(j_parse_config(JControlConfig(), args))
    assert t == j
    assert t["control.port"] == 13400 and t["control.poll_s"] == 5.0 and t["control.driver"] == "static"
    assert t["obs.enabled"] is True and t["obs.metrics_port"] == 0


def _boot(module, args, cwd):
    proc = subprocess.Popen([sys.executable, "-m", module, *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env(), cwd=str(cwd))
    try:
        return proc, json.loads(proc.stdout.readline())
    except Exception:
        proc.kill()
        raise AssertionError(proc.stderr.read()[-2000:])


def test_the_port_binary_boots_on_the_manifest_s_args_and_prints_the_reference_s_boot_line(tmp_path):
    """k8s/control.yaml's args whole but --control.port 0 and local scrape
    lists: the port binary and the reference binary print the same one
    JSON boot line (but the bound port), and the port's serves /topology,
    /healthz and /metrics there."""
    lines = {}
    for module in ("dotaclient_tpu_torch.control.server", "dotaclient_tpu.control.server"):
        args = _local(_manifest_args(), 0) + ["--obs.dump_dir", str(tmp_path)]
        proc, ready = _boot(module, args, tmp_path)
        port = ready["port"]
        try:
            assert set(ready) == BOOT_KEYS and port > 0
            lines[module] = {k: v for k, v in ready.items() if k != "port"}
            if module.startswith("dotaclient_tpu_torch"):
                base = f"http://127.0.0.1:{port}"
                topo = json.loads(urllib.request.urlopen(f"{base}/topology", timeout=5).read())
                assert topo["tiers"]["server"] == args[args.index("--control.servers") + 1].split(",")
                assert len(topo["tiers"]["broker"]) == 3 and topo["metrics"] == topo["tiers"]
                assert json.loads(urllib.request.urlopen(f"{base}/healthz", timeout=5).read())["ok"] is True
                scraped = tscrape.scrape_endpoint(f"127.0.0.1:{port}")
                assert scraped["control_managed_tiers"] == 2.0 and scraped["control_policy_clauses"] == 2.0
        finally:
            proc.terminate()
            proc.wait(timeout=30)
    assert lines["dotaclient_tpu_torch.control.server"] == lines["dotaclient_tpu.control.server"] == {
        "serving": True, "driver": "static", "tiers": ["broker", "server"]}


def test_the_control_package_exports_the_reference_s_names():
    import dotaclient_tpu.control as jcontrol
    import dotaclient_tpu_torch.control as tcontrol

    assert tcontrol.__all__ == jcontrol.__all__
    assert all(getattr(tcontrol, n).__module__.startswith("dotaclient_tpu_torch.control.") for n in tcontrol.__all__)
