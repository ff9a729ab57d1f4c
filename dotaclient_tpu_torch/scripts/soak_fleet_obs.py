"""Fleet telemetry soak (twin of scripts/soak_fleet_obs.py): the standing
audit catches what it must and stays silent otherwise.

The fleet plane (obs/fleet.py + obs/fleetd.py) runs the soaks' post-hoc
conservation ledgers as a live service. This soak proves it with real
components at every layer:

- TWO broker fabric shards as subprocesses (`python -m
  dotaclient_tpu_torch.transport.fabric --metrics_port ...`, the
  k8s/broker.yaml invocation), each serving its broker_shard_* ledger and
  /debug/flight;
- two producer threads (real TcpBroker publishes, rendezvous-routed,
  actor_publish_* counters and a flight ring on an obs surface) and one
  learner-shaped consumer (real pops, wire_frames_obs_bf16_total on its
  own surface);
- ONE ControlPlane whose /topology "metrics" map advertises the learner
  tier (fleetd discovers the consumer there; shards and producers ride
  the literal comma lists), and whose policy scales a tier on a meter
  that fleetd serves;
- ONE in-process FleetDaemon, the fleetd binary's shape, polling,
  auditing, alerting and fanning in.

Four bars, one run:
1. CLEAN + CHAOS: steady traffic with a scrape-synchronized rolling
   restart of shard 0 (traffic frozen for a poll so the pre-kill ledger
   is scraped). The restart must read as a FENCE: its resident frames
   land in fleet_fenced_frames, exactly the level fleetd last scraped,
   and unaccounted stays zero after the quiesce.
2. INJECTED LOSS: a rogue consumer steals STEAL frames from shard 1. The
   delivery ledger must flag exactly that count within one poll window.
3. ALERT → FAN-IN: the unaccounted alert fires, and its incident bundle
   holds /debug/flight snapshots from several OS processes with a trace
   id index.
4. CONTROL ON FLEET METERS: the control plane's clause reads
   fleet_unaccounted_frames off fleetd's /metrics and scales the learner
   tier up, the meter value in its decision entry.

The shards' ports come from below the kernel's ephemeral range
(`_restart_port`): the reference draws them from it, and a port of that
range can become the local port of any outgoing connection while shard 0
is down, so its restart's bind could fail with EADDRINUSE.

Nothing here touches the CUDA device. The shard binary and this process
load torch through the port's wire module (transport/serialize.py), as
the reference's load jax; no tensor is made.

Run: python -m dotaclient_tpu_torch.scripts.soak_fleet_obs --out fleet_obs_soak_torch.json
     python -m dotaclient_tpu_torch.scripts.soak_fleet_obs --quick --out /tmp/x.json
"""

from __future__ import annotations

import argparse
import json
import os
import random
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEAL = 12  # frames the rogue consumer steals (must clear the gt,2.5 alert)
ALERTS = "fleet_unaccounted_frames,gt,2.5,for=2"
POLICY = (
    # Scale the learner tier on a meter only fleetd serves. low=-1:
    # unaccounted is never negative, so the clause can only scale up.
    "learner:fleet_unaccounted_frames.max,high=2.5,low=-1,min=1,max=2,step=1,cooldown=60"
)

_PORTS_TAKEN: set = set()


def _restart_port() -> int:
    """A free port below the kernel's ephemeral range, for a server killed
    and restarted on the same port (a port of the ephemeral range can be
    taken as the local port of an outgoing connection while the server is
    down). Never one this process handed out before."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    for _ in range(200):
        port = random.randrange(10000, low)
        if port in _PORTS_TAKEN:
            continue
        with socket.socket() as sock:
            try:
                sock.bind(("", port))
            except OSError:
                continue
        _PORTS_TAKEN.add(port)
        return port
    raise RuntimeError(f"no free port in 10000-{low - 1}")


def _get_json(endpoint: str, route: str, timeout: float = 5.0) -> dict:
    with urllib.request.urlopen(f"http://{endpoint}{route}", timeout=timeout) as r:
        return json.loads(r.read().decode("utf-8", "replace"))


class ShardProc:
    """One broker fabric shard subprocess on pinned ports, restartable in
    place (the same identity: the StatefulSet restart shape)."""

    def __init__(self, index: int):
        self.index = index
        self.port = _restart_port()
        self.obs_port = _restart_port()
        self.proc = None
        self.launches = 0

    @property
    def endpoint(self) -> str:
        return f"127.0.0.1:{self.port}"

    @property
    def obs_endpoint(self) -> str:
        return f"127.0.0.1:{self.obs_port}"

    def launch(self, deadline_s: float = 20.0) -> None:
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dotaclient_tpu_torch.transport.fabric", "--host", "127.0.0.1", "--port",
             str(self.port), "--maxlen", "100000", "--metrics_port", str(self.obs_port)],
            cwd=REPO_ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        self.launches += 1
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            try:  # obs comes up after the broker socket: one probe covers both
                _get_json(self.obs_endpoint, "/healthz", timeout=1.0)
                return
            except Exception:
                if self.proc.poll() is not None:
                    raise RuntimeError(f"shard {self.index} exited rc={self.proc.returncode}")
                time.sleep(0.05)
        raise RuntimeError(f"shard {self.index} never came up on :{self.obs_port}")

    def kill(self) -> None:
        self.proc.terminate()
        self.proc.wait(timeout=10)

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.kill()


def _tcp_client(port: int):
    from dotaclient_tpu_torch.transport.base import RetryPolicy
    from dotaclient_tpu_torch.transport.tcp import TcpBroker

    return TcpBroker(port=port, retry=RetryPolicy(window_s=1.0))


class Producer:
    """One actor-shaped publisher: rendezvous-routes every chunk over the
    shard list through real TcpBroker clients, keeps the publish ledger
    (attempted = published + shed + failed), serves it on an obs surface,
    and stamps a trace id into every payload and its flight ring (the
    incident bundle's correlation key)."""

    def __init__(self, wid: int, shards, gate: threading.Event):
        from dotaclient_tpu_torch.obs.flight_recorder import FlightRecorder
        from dotaclient_tpu_torch.obs.http import MetricsHTTPServer

        self.wid = wid
        self.shards = shards
        self.gate = gate
        self.stop_ev = threading.Event()
        self.attempted = 0
        self.published = 0
        self.failed = 0
        self.shed = 0
        self._clients = {}
        self.recorder = FlightRecorder("actor")
        self.obs = MetricsHTTPServer(0, sources=[self._stats], flight_provider=self.recorder.snapshot).start()
        self.thread = threading.Thread(target=self._run, daemon=True, name=f"soak-producer-{wid}")

    def _stats(self) -> dict:
        return {
            "actor_publish_attempted_total": float(self.attempted),
            "actor_rollouts_published_total": float(self.published),
            "broker_shed_observed_total": float(self.shed),
            "broker_shed_publish_failed_total": float(self.failed),
        }

    def _client(self, shard):
        c = self._clients.get(shard.index)
        if c is None:
            c = self._clients[shard.index] = _tcp_client(shard.port)
        return c

    def _run(self) -> None:
        from dotaclient_tpu_torch.transport.fabric import rendezvous_order  # loaded by run_soak

        names = [s.endpoint for s in self.shards]
        seq = 0
        while not self.stop_ev.is_set():
            if not self.gate.wait(timeout=0.2):
                continue
            trace_id = self.wid * 1_000_000 + seq
            payload = struct.pack(">q", trace_id) + bytes(120)
            shard = self.shards[rendezvous_order(trace_id, names)[0]]
            self.attempted += 1
            try:
                self._client(shard).publish_experience(payload)
                self.published += 1
                if seq % 8 == 0:
                    self.recorder.record("publish", trace=trace_id, shard=shard.endpoint)
            except Exception as e:
                self.failed += 1
                self._clients.pop(shard.index, None)
                self.recorder.record("publish_failed", trace=trace_id, error=type(e).__name__)
            seq += 1
            time.sleep(0.005)

    def close(self) -> None:
        self.stop_ev.set()
        if self.thread.ident is not None:
            self.thread.join(timeout=10)
        # graftlint: disable=THR001(read after join(): the worker thread has exited)
        for c in self._clients.values():
            c.close()
        self.obs.stop()


class Consumer:
    """The learner-shaped intake: pops every shard, counts each item as one
    wire frame under the staging-intake meter's name, and serves the
    counter and a throughput gauge on its obs surface (the tier fleetd
    discovers through /topology rather than a literal list)."""

    def __init__(self, shards, gate: threading.Event):
        from dotaclient_tpu_torch.obs.flight_recorder import FlightRecorder
        from dotaclient_tpu_torch.obs.http import MetricsHTTPServer

        self.shards = shards
        self.gate = gate
        self.stop_ev = threading.Event()
        self.wire = 0
        self._t0 = time.monotonic()
        self._clients = {}
        self.recorder = FlightRecorder("learner")
        self.obs = MetricsHTTPServer(0, sources=[self._stats], flight_provider=self.recorder.snapshot).start()
        self.thread = threading.Thread(target=self._run, daemon=True, name="soak-consumer")

    def _stats(self) -> dict:
        elapsed = max(time.monotonic() - self._t0, 1e-6)
        return {"wire_frames_obs_bf16_total": float(self.wire), "env_steps_per_sec": float(self.wire) / elapsed}

    def _client(self, shard):
        c = self._clients.get(shard.index)
        if c is None:
            c = self._clients[shard.index] = _tcp_client(shard.port)
        return c

    def _run(self) -> None:
        while not self.stop_ev.is_set():
            if not self.gate.wait(timeout=0.2):
                continue
            for shard in self.shards:
                try:
                    got = self._client(shard).consume_experience(32, timeout=0.02)
                except Exception:
                    self._clients.pop(shard.index, None)
                    continue
                for item in got:
                    (trace_id,) = struct.unpack(">q", item[:8])
                    self.wire += 1
                    if self.wire % 8 == 0:
                        self.recorder.record("consume", trace=trace_id)
            time.sleep(0.005)

    def close(self) -> None:
        self.stop_ev.set()
        if self.thread.ident is not None:
            self.thread.join(timeout=10)
        # graftlint: disable=THR001(read after join(): the worker thread has exited)
        for c in self._clients.values():
            c.close()
        self.obs.stop()


class StubTier:
    """Minimal InProcessDriver router: the thing the policy scales."""

    def __init__(self, n: int):
        self.n = n
        self.history = [n]

    def replica_count(self) -> int:
        return self.n

    def scale_to(self, n: int) -> None:
        self.n = int(n)
        self.history.append(self.n)


def _wait(pred, deadline_s: float, interval_s: float = 0.1):
    """Poll pred() until truthy; returns the last value (falsy on timeout)."""
    deadline = time.monotonic() + deadline_s
    value = pred()
    while not value and time.monotonic() < deadline:
        time.sleep(interval_s)
        value = pred()
    return value


def _resident(obs_endpoint: str) -> float:
    from dotaclient_tpu_torch.control.scrape import scrape_endpoint

    sample = scrape_endpoint(obs_endpoint) or {}
    return sample.get("broker_shard_resident", -1.0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="fleet_obs_soak_torch.json")
    p.add_argument("--traffic-s", type=float, default=2.5, help="steady clean traffic before and after the restart")
    p.add_argument("--poll-s", type=float, default=0.3)
    p.add_argument("--deadline-s", type=float, default=25.0, help="per-wait bound (fence seen, loss flagged, ...)")
    p.add_argument("--quick", action="store_true", help="nightly scale: shorter traffic, the same invariants")
    args = p.parse_args(argv)
    if args.quick:
        args.traffic_s = 1.2
    return args


def _slo(report: dict) -> dict:
    return {k: v for k, v in report.get("slo", {}).items() if k.startswith("fleet_")}


def verdict_of(artifact: dict) -> dict:
    """The reference's twelve bools and its four counts, read off the
    artifact alone."""
    a, b, ctl, frames = artifact["phase_a"], artifact["phase_b"], artifact["control"], artifact["frames"]
    slo_a, slo_b = a["slo"], b["slo"]
    scaled = ctl["moves"]
    r0 = a["resident_at_kill"]
    return {
        # bar 1: the clean arm closes to zero across the rolling restart
        "clean_arm_zero_unaccounted": slo_a["fleet_unaccounted_frames"] == 0.0
        and slo_a["fleet_overaccounted_frames"] == 0.0
        and all(entry["status"] == "ok" for entry in a["ledgers"].values()),
        "restart_read_as_fence_not_loss": slo_a["fleet_fences_total"] >= 1.0
        and slo_a["fleet_fenced_frames"] == r0 and r0 > 0.0,
        "producer_ledger_balanced": all(p["attempted"] == p["published"] + p["shed"] + p["failed"]
                                        for p in artifact["producers"]),
        # discovery fed the audit: the consumer arrived only through the
        # control plane's /topology "metrics" map
        "topology_discovery_served_learner_tier": any(k.startswith("learner/") for k in b["targets"])
        and slo_b["fleet_topology_refreshes_total"] >= 1.0,
        # bar 2: the theft flagged within one poll window (<= 2 polls: the
        # window in flight at steal time and the one that sees it)
        "loss_flagged_within_one_poll_window": bool(b["loss_detected"])
        and b["polls_at_detect"] - b["polls_at_steal"] <= 2,
        "loss_closes_to_exact_stolen_count": slo_b["fleet_unaccounted_frames"] == float(STEAL)
        and b["ledgers"].get("delivery", {}).get("status") == "alarm"
        and b["ledgers"].get("shard", {}).get("status") == "ok",
        # bar 3: a fired alert, one bundle, flights from > 1 OS process,
        # trace ids correlated across roles
        "alert_fired_on_loss": bool(b["alert_fired"]) and slo_b["fleet_alerts_fired_total"] >= 1.0,
        "incident_bundle_multi_process": b["bundle_flight_pids"] >= 2 and b["bundle_flights_nonempty"] >= 4,
        "incident_bundle_trace_indexed": b["bundle_trace_ids"] > 0,
        # bar 4: the control plane scaled on a fleetd-served meter, the
        # decision carrying the value that justified it
        "control_scaled_on_fleet_meter": bool(scaled) and scaled[0]["value"] is not None
        and scaled[0]["value"] > 2.5 and scaled[0]["actuation"]["actuated"] is True
        and ctl["learner_replica_history"][-1] == 2,
        "fleet_closes_end_to_end": frames["published"] == frames["consumed"] + int(slo_b["fleet_fenced_frames"]) + STEAL,
        "no_errors": not artifact["errors"],
        "frames_published": frames["published"],
        "frames_consumed": frames["consumed"],
        "frames_fenced": slo_b["fleet_fenced_frames"],
        "frames_stolen": STEAL,
    }


def run_soak(args) -> dict:
    """The four bars in one run; returns the artifact ("verdict" holds the
    bools, "wall_s" the run's seconds)."""
    from dotaclient_tpu_torch.config import ControlConfig, ControlLoopConfig, FleetConfig
    from dotaclient_tpu_torch.control.drivers import InProcessDriver
    from dotaclient_tpu_torch.control.server import ControlPlane
    from dotaclient_tpu_torch.obs.fleetd import FleetDaemon
    from dotaclient_tpu_torch.obs.preflight import check as preflight_check
    # The producers route through transport/fabric.py, which loads torch
    # (the reference's loads jax). Imported here, before traffic opens: the
    # reference imports it on the producers' threads once the gate is open,
    # and on a slow host the whole of phase A's traffic window passed before
    # the first publish, so shard 0 held nothing to fence at its restart.
    from dotaclient_tpu_torch.transport import fabric  # noqa: F401

    t_start = time.perf_counter()
    host_preflight = preflight_check("soak_fleet_obs")
    bundle_dir = tempfile.mkdtemp(prefix="fleet_soak_incidents_")
    shards = [ShardProc(i) for i in range(2)]
    producer_gate = threading.Event()
    consumer_gate = threading.Event()
    producers, consumer, plane, daemon = [], None, None, None
    timeline, errors = [], []

    def mark(event: str, **extra):
        timeline.append({"t": round(time.monotonic() - t0, 2), "event": event, **extra})

    try:
        for s in shards:
            s.launch()
        producers = [Producer(wid, shards, producer_gate) for wid in range(2)]
        consumer = Consumer(shards, consumer_gate)

        # the control plane advertises the learner tier through /topology
        # (fleetd's discovery) and scales it on a meter only fleetd serves
        learner_tier = StubTier(1)
        learner_metric_eps = [f"127.0.0.1:{consumer.obs.port}"]
        driver = InProcessDriver({"learner": learner_tier}, metrics={"learner": lambda: list(learner_metric_eps)})
        plane = ControlPlane(ControlConfig(control=ControlLoopConfig(port=0, poll_s=args.poll_s, policy=POLICY)),
                             driver).start()

        # fleetd in the binary's shape. Shards and producers ride the
        # literal lists; the consumer arrives only through /topology.
        # Anchored before traffic opens, so the audit baselines at a
        # quiescent fleet and every later quiesce must close to zero.
        fcfg = FleetConfig()
        fcfg.fleet.port = 0
        fcfg.fleet.poll_s = args.poll_s
        fcfg.fleet.stale_s = 3.0
        fcfg.fleet.control = f"127.0.0.1:{plane.port}"
        fcfg.fleet.brokers = ",".join(s.obs_endpoint for s in shards)
        fcfg.fleet.actors = ",".join(f"127.0.0.1:{pr.obs.port}" for pr in producers)
        fcfg.fleet.alerts = ALERTS
        fcfg.fleet.bundle_dir = bundle_dir
        daemon = FleetDaemon(fcfg).start()
        fleet_ep = f"127.0.0.1:{daemon.port}"
        # the policy's meter source: fleetd joins the learner tier's scrape
        # list, so the controller reads fleet_unaccounted_frames.max off it
        # (fleetd discovers and audits itself too, which must be inert)
        learner_metric_eps.append(fleet_ep)

        def fleet():
            return _get_json(fleet_ep, "/fleet")

        def slo(name: str, default: float = 0.0) -> float:
            return fleet().get("slo", {}).get(name, default)

        t0 = time.monotonic()
        if not _wait(lambda: fleet().get("polls", 0) >= 2, args.deadline_s):
            errors.append("fleetd never completed its anchor polls")

        # ---- phase A: clean traffic and a scrape-synchronized rolling restart
        producer_gate.set()
        consumer_gate.set()
        for pr in producers:
            pr.thread.start()
        consumer.thread.start()
        mark("traffic_open")
        time.sleep(args.traffic_s)

        # Freeze traffic so the pre-kill ledger is scraped: the consumer
        # first (resident builds on both shards), then the producers, then
        # two poll windows of stillness.
        consumer_gate.clear()
        time.sleep(0.8)
        producer_gate.clear()
        time.sleep(3.5 * args.poll_s)
        r0 = _resident(shards[0].obs_endpoint)
        polls_at_kill = fleet().get("polls", 0)
        shards[0].kill()
        mark("shard0_killed", resident_at_kill=r0)
        # at least one poll must see the outage (stale freeze, no alarm)
        _wait(lambda: fleet().get("polls", 0) >= polls_at_kill + 2, args.deadline_s)
        shards[0].launch()
        mark("shard0_relaunched")
        if not _wait(lambda: slo("fleet_fences_total") >= 1.0, args.deadline_s):
            errors.append("restart never read as a fence")
        producer_gate.set()
        consumer_gate.set()
        time.sleep(args.traffic_s * 0.6)

        # Quiesce A: stop producing, drain everything, let the audit settle
        producer_gate.clear()
        if not _wait(lambda: all(_resident(s.obs_endpoint) == 0.0 for s in shards), args.deadline_s):
            errors.append("shards never drained after phase A")
        polls_q = fleet().get("polls", 0)
        _wait(lambda: fleet().get("polls", 0) >= polls_q + 3, args.deadline_s)
        report_a = fleet()
        mark("phase_a_quiesced")

        # ---- phase B: injected loss → detect → alert → fan-in → scale
        producer_gate.set()
        time.sleep(0.8)  # resident builds again (the consumer still drains)
        consumer_gate.clear()
        time.sleep(0.8)  # stock shard 1 for the theft
        producer_gate.clear()
        time.sleep(3.5 * args.poll_s)  # stable windows around the theft
        polls_at_steal = fleet().get("polls", 0)
        rogue = _tcp_client(shards[1].port)
        stolen = 0
        steal_deadline = time.monotonic() + args.deadline_s
        while stolen < STEAL and time.monotonic() < steal_deadline:
            stolen += len(rogue.consume_experience(STEAL - stolen, timeout=0.5))
        rogue.close()
        mark("frames_stolen", stolen=stolen)
        if stolen != STEAL:
            errors.append(f"rogue consumer only got {stolen}/{STEAL} frames")

        detected = _wait(lambda: slo("fleet_unaccounted_frames") >= STEAL - 0.5, args.deadline_s, interval_s=0.05)
        polls_at_detect = fleet().get("polls", 0)
        mark("loss_detected", polls_elapsed=polls_at_detect - polls_at_steal)
        if not detected:
            errors.append("injected loss never flagged")

        fired = _wait(lambda: slo("fleet_alerts_fired_total") >= 1.0, args.deadline_s)
        incidents = _wait(lambda: fleet().get("incidents"), args.deadline_s)
        if not fired or not incidents:
            errors.append("alert never fired / no incident bundle")
        bundle = {}
        if incidents:
            with open(incidents[-1]) as f:
                bundle = json.load(f)

        scaled = _wait(lambda: [d for d in plane.ledger()
                                if d["action"] == "up" and d["meter"] == "fleet_unaccounted_frames.max"],
                       args.deadline_s)
        mark("control_scaled", moves=len(scaled or []))

        # Final quiesce: the fleet must close to exactly the stolen frames
        consumer_gate.set()
        _wait(lambda: all(_resident(s.obs_endpoint) == 0.0 for s in shards), args.deadline_s)
        polls_f = fleet().get("polls", 0)
        _wait(lambda: fleet().get("polls", 0) >= polls_f + 3, args.deadline_s)
        report_b = fleet()
        mark("final_quiesce")
    finally:
        producer_gate.set()  # never leave threads parked on a cleared gate
        consumer_gate.set()
        for pr in producers:
            pr.close()
        if consumer is not None:
            consumer.close()
        if daemon is not None:
            daemon.stop()
        if plane is not None:
            plane.stop()
        for s in shards:
            s.stop()

    flights = bundle.get("flights") or {}
    flight_pids = {v.get("pid") for v in flights.values() if isinstance(v, dict) and "pid" in v}
    artifact = {
        "host": "single host: 2 fabric-shard subprocesses (the k8s/broker.yaml invocation) + in-process "
                "producers/consumer/control-plane/fleetd over real HTTP + real TCP (no tensor, no CUDA device)",
        "host_preflight": host_preflight,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "alerts": ALERTS,
        "policy": POLICY,
        "poll_s": args.poll_s,
        "timeline": timeline,
        "phase_a": {
            "ledgers": report_a.get("ledgers", {}),
            "slo": _slo(report_a),
            "resident_at_kill": r0,
            "shard0_launches": shards[0].launches,
            "shard_ports": [[s.port, s.obs_port] for s in shards],
        },
        "phase_b": {
            "ledgers": report_b.get("ledgers", {}),
            "slo": _slo(report_b),
            "targets": sorted(report_b.get("targets", {})),
            "polls_at_steal": polls_at_steal,
            "polls_at_detect": polls_at_detect,
            "loss_detected": bool(detected),
            "alert_fired": bool(fired),
            "alerts": report_b.get("alerts"),
            "incident_bundles": len(incidents or []),
            "bundle_flight_roles": sorted({v.get("role") for v in flights.values() if isinstance(v, dict)}),
            "bundle_flight_pids": len(flight_pids),
            "bundle_flights_nonempty": len([v for v in flights.values() if v]),
            "bundle_trace_ids": len(bundle.get("trace_index") or {}),
        },
        "control": {"moves": scaled or [], "learner_replica_history": learner_tier.history},
        "producers": [{"attempted": p.attempted, "published": p.published, "shed": p.shed, "failed": p.failed}
                      for p in producers],
        "frames": {"published": sum(p.published for p in producers), "consumed": consumer.wire, "stolen": stolen},
        "errors": errors,
    }
    artifact["verdict"] = verdict_of(artifact)
    artifact["wall_s"] = round(time.perf_counter() - t_start, 2)
    return artifact


def main(argv=None) -> int:
    args = parse_args(argv)
    artifact = run_soak(args)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(json.dumps(artifact["verdict"], indent=2))
    return 0 if all(v for v in artifact["verdict"].values() if isinstance(v, bool)) else 1


if __name__ == "__main__":
    raise SystemExit(main())
