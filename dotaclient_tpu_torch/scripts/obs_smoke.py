"""Obs smoke (twin of scripts/obs_smoke.py): drive a short real learner and
curl its whole HTTP surface (GET /metrics, GET /healthz, GET
/debug/flight, POST /profile?seconds=N), stand up the fleet telemetry
aggregator (obs/fleetd.py FleetDaemon) against the live learner and curl
its /fleet, /metrics and /debug/flight (the conservation audit must read
zero unaccounted frames), then stand up an inference server, push one
remote policy step through it, and curl its /metrics, /healthz and
/debug/flight too.

The tier-1 tests cover each endpoint alone; this exercises the deployed
composition: one learner with obs on and the watchdog armed, the scrape
surface live while the loop trains, and an on-demand profiler capture
taken mid-run. On the CUDA device the capture records through CUPTI
(obs/cupti.py). Prints ONE JSON line:

  {"ok": true, "steps": N, "metrics_scalars": M, "healthz": {...},
   "profile_trace_dir": "...", "serve": {...}, ...}

The learner and the server run on the CUDA device unless `--platform cpu`.
`run_smoke` takes a PolicyConfig (None: the reference's small ones).

Run: python -m dotaclient_tpu_torch.scripts.obs_smoke
     python -m dotaclient_tpu_torch.scripts.obs_smoke --platform cpu
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import socket
import struct
import tempfile
import threading
import time
import urllib.request

import numpy as np

STEPS = 20
REQUIRED_LEARNER_SCALARS = frozenset((
    "dotaclient_loss",
    "dotaclient_compute_phase_wall_s",
    "dotaclient_compute_recompiles_total",
    "dotaclient_watchdog_ok",
    "dotaclient_obs_learner_version",
    "dotaclient_trace_e2e_actor_apply_s",
))
REQUIRED_SERVE_SCALARS = frozenset((
    "dotaclient_serve_requests_total",
    "dotaclient_serve_carries_resident",
    "dotaclient_serve_version",
    "dotaclient_actor_batch_occupancy",
    "dotaclient_actor_tick_rows_1",
))


def learner_policy():
    """The reference's learner policy (scripts/obs_smoke.py:65)."""
    from dotaclient_tpu_torch.config import PolicyConfig

    return PolicyConfig(unit_embed_dim=16, lstm_hidden=8, mlp_hidden=16, dtype="float32")


def serve_policy():
    """The reference's server policy (scripts/obs_smoke.py:276)."""
    from dotaclient_tpu_torch.config import PolicyConfig

    return PolicyConfig(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("", 0))
        return sock.getsockname()[1]


def _get(url: str, timeout: float = 10.0) -> bytes:
    return urllib.request.urlopen(url, timeout=timeout).read()


def _scalar_names(body: str) -> set:
    return {ln.split()[0] for ln in body.splitlines() if ln and not ln.startswith("#")}


def _device(platform: str):
    return "cpu" if platform == "cpu" else None


def learner_smoke(policy=None, platform: str = "") -> dict:
    """STEPS steps at batch 8 x seq 4 over mem:// with obs on and the
    watchdog armed, a producer thread stamping frames with the live
    version, POST /profile?seconds=1 from a side thread mid-run, then the
    surface and fleetd against it. Returns the report's learner half."""
    from dotaclient_tpu_torch.config import LearnerConfig, ObsConfig, WatchdogConfig
    from dotaclient_tpu_torch.runtime.learner import Learner
    from dotaclient_tpu_torch.scripts.chaos_soak import make_frames
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect
    from dotaclient_tpu_torch.transport.serialize import stamp_rollout_trace

    policy = learner_policy() if policy is None else policy
    port = _free_port()
    out: dict = {"ok": False}
    with tempfile.TemporaryDirectory(prefix="obs_smoke_") as tmp:
        mem.reset("obs_smoke")
        broker = connect("mem://obs_smoke")
        cfg = LearnerConfig(
            batch_size=8,
            seq_len=4,
            policy=policy,
            broker_url="mem://obs_smoke",
            log_dir=os.path.join(tmp, "logs"),
            metrics_every=2,
            platform=platform,
            obs=ObsConfig(enabled=True, metrics_port=port, install_handlers=False, dump_dir=tmp, profile_dir=tmp,
                          watchdog=WatchdogConfig(enabled=True, interval_s=1.0, stall_s=300.0)),
        )
        learner = Learner(cfg, connect("mem://obs_smoke"), device=_device(platform))
        if platform != "cpu":
            # CUPTI and its buffer callbacks (built by g++ at first use) are
            # loaded before the run: a first capture that loads them takes
            # seconds, longer than the card takes to train the run's steps
            from dotaclient_tpu_torch.obs import cupti

            cupti.activity_trace()
        base = f"http://127.0.0.1:{port}"
        # a seeded pool of full-length frames (the port's own maker), each
        # published with the live version in its header (offset 4) like a
        # real actor's: fixed-version frames age past max_staleness and the
        # run starves itself
        pool = make_frames(cfg, 97)

        stop = threading.Event()

        def produce():
            i = 0
            while not stop.is_set():
                if broker.experience_depth() < 64:
                    f = pool[i % len(pool)]
                    frame = f[:4] + struct.pack("<I", int(learner.version)) + f[8:]
                    broker.publish_experience(stamp_rollout_trace(frame, i + 1, time.time()))
                    i += 1
                else:
                    time.sleep(0.005)

        producer = threading.Thread(target=produce, daemon=True, name="obs-smoke-producer")
        producer.start()

        # the mid-run capture: POST /profile from a side thread while the
        # loop is stepping. The reference sleeps 0.5 s to let a few steps
        # land; on the card a warm process can train all STEPS in that time
        # and leave the window with no kernel, so this waits for the first
        # step (the capture itself then waits for the learner to warm).
        profile_result: dict = {}

        def capture():
            deadline = time.monotonic() + 30.0
            while learner.version < 1 and time.monotonic() < deadline:
                time.sleep(0.005)
            req = urllib.request.Request(f"{base}/profile?seconds=1", method="POST")
            t0 = time.perf_counter()
            try:
                profile_result.update(json.loads(urllib.request.urlopen(req, timeout=30).read()))
            except Exception as e:  # recorded, judged below
                profile_result["error"] = f"{type(e).__name__}: {e}"
            profile_result["answer_s"] = round(time.perf_counter() - t0, 3)

        capturer = threading.Thread(target=capture, daemon=True, name="obs-smoke-profile")
        capturer.start()
        try:
            steps = learner.run(num_steps=STEPS, batch_timeout=30.0, max_idle=3)
            capturer.join(timeout=60)

            scalar_names = _scalar_names(_get(f"{base}/metrics").decode())
            health = json.loads(_get(f"{base}/healthz"))
            missing = sorted(REQUIRED_LEARNER_SCALARS - scalar_names)
            trace_dir = profile_result.get("trace_dir", "")
            trace_files = [os.path.join(d, f) for d, _, fs in os.walk(trace_dir) for f in fs] if trace_dir else []
            kernels = _trace_kernels(trace_files)
            # the learner's crash ring over HTTP: the route every fleetd
            # incident bundle fans in from
            flight = json.loads(_get(f"{base}/debug/flight"))
            fleet = fleet_smoke(port)
            out = {
                "ok": (steps == STEPS and not missing and health.get("ok") is True
                       and health.get("watchdog", {}).get("enabled") is True and bool(trace_files)
                       and flight.get("role") == "learner" and bool(fleet.get("ok"))),
                "steps": steps,
                "metrics_scalars": len(scalar_names),
                "missing_required_scalars": missing,
                "healthz": health,
                "flight_events_recorded": flight.get("events_recorded"),
                "fleet": fleet,
                "profile_trace_dir": trace_dir,
                "profile_trace_files": len(trace_files),
                "profile_error": profile_result.get("error"),
                "profile_answer_s": profile_result.get("answer_s"),
                "profile_kernels": kernels,
            }
        finally:
            stop.set()
            producer.join(timeout=10)
            learner.close()
    return out


def _trace_kernels(paths) -> int:
    """Device kernel events in the capture's Chrome traces (0 on the CPU,
    where torch.profiler records host ops only)."""
    n = 0
    for path in paths:
        if path.endswith(".json"):
            with open(path) as f:
                n += sum(e.get("cat") == "kernel" for e in json.load(f).get("traceEvents", []))
    return n


def fleet_smoke(learner_port: int) -> dict:
    """The fleet telemetry aggregator against the live learner surface,
    its whole interface curled: /fleet (the audit must read zero
    unaccounted frames), /metrics (the fleet_* family), /debug/flight. A
    learner-only fleet has no producer or broker tiers, so those ledgers
    read "absent"; present-but-nonzero unaccounted would be an auditor
    fault, which is what this pins."""
    from dotaclient_tpu_torch.config import FleetConfig
    from dotaclient_tpu_torch.obs.fleetd import FleetDaemon

    cfg = FleetConfig()
    cfg.fleet.port = 0
    cfg.fleet.poll_s = 0.2
    cfg.fleet.stale_s = 5.0
    cfg.fleet.learners = f"127.0.0.1:{learner_port}"
    cfg.obs.enabled = True
    cfg.obs.install_handlers = False
    daemon = FleetDaemon(cfg).start()
    try:
        base = f"http://127.0.0.1:{daemon.port}"
        report: dict = {}
        deadline = time.time() + 15.0
        while time.time() < deadline:  # a few audit windows
            report = json.loads(_get(f"{base}/fleet"))
            ups = [t for t in report.get("targets", {}).values() if t.get("up")]
            if report.get("polls", 0) >= 3 and ups:
                break
            time.sleep(0.2)
        body = _get(f"{base}/metrics").decode()
        scalars = {ln.split()[0]: float(ln.split()[1]) for ln in body.splitlines() if ln and not ln.startswith("#")}
        flight = json.loads(_get(f"{base}/debug/flight"))
        ledgers = report.get("ledgers") or {}
        slo = report.get("slo") or {}
        return {
            "ok": (report.get("ok") is True and report.get("polls", 0) >= 3
                   and any(t.get("up") for t in report.get("targets", {}).values()) and bool(ledgers)
                   and all(entry.get("status") in ("ok", "absent") for entry in ledgers.values())
                   and slo.get("fleet_unaccounted_frames") == 0.0
                   and scalars.get("dotaclient_fleet_unaccounted_frames") == 0.0
                   and scalars.get("dotaclient_fleet_targets_up", 0.0) >= 1.0 and flight.get("role") == "fleetd"),
            "polls": report.get("polls"),
            "targets_up": sum(1 for t in report.get("targets", {}).values() if t.get("up")),
            "ledgers": {k: v.get("status") for k, v in ledgers.items()},
            "unaccounted_frames": slo.get("fleet_unaccounted_frames"),
            "e2e_env_steps_per_sec": slo.get("fleet_e2e_env_steps_per_sec"),
            "metrics_scalars": len(scalars),
        }
    finally:
        daemon.stop()


def serve_smoke(policy=None, platform: str = "") -> dict:
    """A live server with obs on, one real remote step through it, then its
    /metrics, /healthz and /debug/flight curled while it serves."""
    from dotaclient_tpu_torch.config import InferenceConfig, ObsConfig, ServeConfig
    from dotaclient_tpu_torch.env import featurizer as F
    from dotaclient_tpu_torch.obs import ObsRuntime
    from dotaclient_tpu_torch.serve.client import RemotePolicyClient
    from dotaclient_tpu_torch.serve.server import InferenceServer

    policy = serve_policy() if policy is None else policy
    mport = _free_port()
    cfg = InferenceConfig(
        serve=ServeConfig(port=0, max_batch=2, gather_window_s=0.005),
        policy=policy,
        obs=ObsConfig(enabled=True, metrics_port=mport, install_handlers=False),
        seed=1,
        platform=platform,
    )
    obs_rt = ObsRuntime.create(cfg.obs, role="serve")
    server = InferenceServer(cfg, obs_runtime=obs_rt).start()
    try:
        # one real remote step so the request and reset counters are live;
        # the key is jax.random.PRNGKey(0)'s raw words, as the wire carries it
        async def one_step():
            client = RemotePolicyClient(f"127.0.0.1:{server.port}", cfg.policy)
            try:
                return await client.step(7, F.zeros_observation(), np.zeros(2, np.uint32), episode_start=True)
            finally:
                await client.close()

        loop = asyncio.new_event_loop()
        try:
            resp = loop.run_until_complete(one_step())
        finally:
            loop.close()
        base = f"http://127.0.0.1:{mport}"
        names = _scalar_names(_get(f"{base}/metrics").decode())
        health = json.loads(_get(f"{base}/healthz"))
        flight = json.loads(_get(f"{base}/debug/flight"))
        missing = sorted(REQUIRED_SERVE_SCALARS - names)
        return {
            "ok": resp.status == 0 and not missing and health.get("ok") is True and health.get("role") == "serve"
            and flight.get("role") == "serve",
            "metrics_scalars": len(names),
            "missing_required_scalars": missing,
            "healthz": health,
        }
    finally:
        server.stop()  # closes obs_rt too


def run_smoke(policy=None, platform: str = "") -> dict:
    """The learner half, then the serve half; `policy` (None: the
    reference's two small policies) serves both. The report's "ok" is both
    halves' and "wall_s" its seconds."""
    t0 = time.perf_counter()
    out = learner_smoke(policy, platform)
    try:
        serve_out = serve_smoke(policy, platform)
    except Exception as e:
        serve_out = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    out["serve"] = serve_out
    out["ok"] = bool(out.get("ok")) and bool(serve_out.get("ok"))
    out["wall_s"] = round(time.perf_counter() - t0, 2)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # "" = the CUDA device; "cpu" runs the learner and the server on the host
    p.add_argument("--platform", default="", choices=("", "cpu"))
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run_smoke(platform=args.platform)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
