"""Serve-tier offered-rate / latency curve (twin of scripts/bench_serve.py;
its artifact keys, default serve_bench_torch.json).

At MATCHED env counts, does the serve tier beat a per-process vector
fleet? Per env count N, genuine actors (featurize + the in-process
FakeDotaService + chunking + wire serialization to a mem:// broker) run in
fresh subprocesses:

- vector (fresh): ONE VectorActor process, N envs, a local batched step
  per tick.
- serve: the SAME N envs as remote clients (RemoteFleet) of a dedicated
  `python -m dotaclient_tpu_torch.serve.server` subprocess (fresh per N;
  max_batch = min(N, 8), the gather window of `--gather_window_s`). At
  N >= 8 the envs split across 2 client processes: env stepping scales
  out while inference stays central, the tier's deployment shape.

The verdict's anchor is the fresh vector arm of the same run at the same
N (`serve_speedup_vs_fresh_vector`). The reference anchors to its
committed per-process curve (ACTOR_FLEET.json, a record of its own host),
which says nothing of this host: the twin keeps that row key as null.

Per arm: offered env steps/s over the measured window and the per-step
policy latency p50 / p99 (vector: the await on the batcher; serve: the
wire round trip), and the measured process's CPU use.

The server and the vector arm's net run on the CUDA device (`--platform
""`, asserted in every process that places one) or on the host
(`--platform cpu`); the remote clients hold no net. The env is in-process
in every client (bench_actors.YieldingStub): the card's machine has no
grpc. `_clean_env` gives every child the port's import path and none of
the JAX package's settings; the chip smoke starts the children its own way
(`Children`: under `-X importtime`, the server through its launch-counting
wrapper) to read their imports and launches.

Run: python -m dotaclient_tpu_torch.scripts.bench_serve [--out serve_bench_torch.json]
     [--seconds 6] [--envs 2,4,8,16] [--clients auto] [--quick] [--platform cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import platform as platform_mod
import signal
import socket
import struct
import subprocess
import sys
import time
from typing import NamedTuple, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Children(NamedTuple):
    """How the orchestrator starts its children: the interpreter (and its
    flags), the server's argv after it, and where their stderr goes (None:
    a client's is captured, the server's inherited; a directory: one file
    per child there)."""

    python: Tuple[str, ...] = (sys.executable,)
    server_argv: Tuple[str, ...] = ("-m", "dotaclient_tpu_torch.serve.server")
    stderr_dir: Optional[str] = None


# The smoke's cut: one N (4: one client process, one server boot), 1 s
# windows after 2 s of warm-up, at the flagship policy.
SMOKE_CUT = dict(envs="4", seconds=1.0, warmup=2.0)


def _clean_env():
    """The children's environment: the repo first on the import path (the
    port's modules from any working directory), no JAX or XLA settings."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p)
    return env


def _policy_flags(policy: str):
    if policy == "small":
        return ["--policy.unit_embed_dim", "16", "--policy.lstm_hidden", "16", "--policy.mlp_hidden", "16",
                "--policy.dtype", "float32"]
    return []


def _policy_cfg(policy: str):
    from dotaclient_tpu_torch.config import PolicyConfig

    if policy == "small":
        return PolicyConfig(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32")
    return PolicyConfig()


def _percentiles(samples):
    import numpy as np

    if not samples:
        return 0.0, 0.0
    lat = np.asarray(samples)
    return round(float(np.percentile(lat, 50)) * 1e3, 3), round(float(np.percentile(lat, 99)) * 1e3, 3)


# ----------------------------------------------------------- client roles


async def _measure(run_coro_fn, steps_fn, warmup_s, seconds, reset_fn):
    task = asyncio.ensure_future(run_coro_fn())
    try:
        await asyncio.sleep(warmup_s)
        reset_fn()
        s0 = steps_fn()
        c0 = time.process_time()
        t0 = time.perf_counter()
        await asyncio.sleep(seconds)
        steps = steps_fn() - s0
        elapsed = time.perf_counter() - t0
        cpu = time.process_time() - c0
    finally:
        task.cancel()
        try:
            await task
        except BaseException:
            pass
    return steps, elapsed, cpu


def _actor_cfg(args, **kw):
    from dotaclient_tpu_torch.config import ActorConfig

    return ActorConfig(rollout_len=16, max_dota_time=120.0, policy=_policy_cfg(args.policy), seed=1,
                       platform=args.platform, **kw)


def run_vector_client(args) -> dict:
    from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
    from dotaclient_tpu_torch.runtime.actor import VectorActor
    from dotaclient_tpu_torch.scripts.bench_actors import YieldingStub
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect

    service = FakeDotaService()
    mem.reset("bench_serve_vec")
    vec = VectorActor(_actor_cfg(args), connect("mem://bench_serve_vec"), actor_id=0, envs=args.envs,
                      stubs=[YieldingStub(service) for _ in range(args.envs)])
    # per-step policy latency: the env workers' await on the shared batcher
    # (the vector arm's analog of the serve wire round trip)
    lat = []
    orig_step = vec.batcher.step

    async def timed_step(*a, **k):
        t0 = time.perf_counter()
        r = await orig_step(*a, **k)
        lat.append(time.perf_counter() - t0)
        return r

    vec.batcher.step = timed_step

    def reset():
        vec.batcher.reset_meters()
        lat.clear()

    loop = asyncio.new_event_loop()
    steps, elapsed, cpu = loop.run_until_complete(
        _measure(vec.run, lambda: vec.steps_done, args.warmup_seconds, args.seconds, reset))
    loop.close()
    p50, p99 = _percentiles(lat)
    st = vec.batcher.stats()
    return {
        "offered_steps_per_sec": round(steps / elapsed, 1) if elapsed > 0 else 0.0,
        "steps": steps,
        "seconds": round(elapsed, 3),
        "p50_ms": p50,
        "p99_ms": p99,
        "samples": len(lat),
        "occupancy": round(st["actor_batch_occupancy"], 4),
        "cpu_util": round(cpu / elapsed, 2) if elapsed > 0 else 0.0,
    }


def run_remote_client(args) -> dict:
    from dotaclient_tpu_torch.config import ServeClientConfig
    from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
    from dotaclient_tpu_torch.scripts.bench_actors import YieldingStub
    from dotaclient_tpu_torch.serve.client import RemoteFleet
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect

    service = FakeDotaService()
    # no learner in the loop: serving is the freshness
    cfg = _actor_cfg(args, serve=ServeClientConfig(endpoint=args.endpoint), max_weight_age_s=0.0)
    mem.reset("bench_serve_rem")
    fleet = RemoteFleet(cfg, connect("mem://bench_serve_rem"), actor_id=args.actor_base, envs=args.envs)
    for env in fleet.envs:
        env._stub = YieldingStub(service)

    async def drive():
        async for _ in fleet.episode_stream():
            pass

    err_at = [0, 0]  # [window start, window end]

    def reset():
        fleet.client.latency_s.clear()
        err_at[0] = fleet.client.errors

    def steps_fn():
        # read at the window's start and end (before the teardown, which
        # fails in-flight steps on purpose: those are no serving failures)
        err_at[1] = fleet.client.errors
        return fleet.steps_done

    loop = asyncio.new_event_loop()
    steps, elapsed, cpu = loop.run_until_complete(_measure(drive, steps_fn, args.warmup_seconds, args.seconds, reset))
    loop.close()
    p50, p99 = _percentiles(list(fleet.client.latency_s))
    return {
        "offered_steps_per_sec": round(steps / elapsed, 1) if elapsed > 0 else 0.0,
        "steps": steps,
        "seconds": round(elapsed, 3),
        "p50_ms": p50,
        "p99_ms": p99,
        "samples": len(fleet.client.latency_s),
        "wire_errors": err_at[1] - err_at[0],
        "cpu_util": round(cpu / elapsed, 2) if elapsed > 0 else 0.0,
    }


# ---------------------------------------------------------- orchestration


def _stderr(children: Children, name: str):
    """A child's stderr: a file under children.stderr_dir, or None."""
    if children.stderr_dir is None:
        return None
    return open(os.path.join(children.stderr_dir, f"{name}.log"), "w")


def _spawn_server(args, max_batch: int, gather_window_s: float, name: str, children: Children):
    err = _stderr(children, name)
    proc = subprocess.Popen(
        [*children.python, *children.server_argv, "--serve.port", "0", "--serve.max_batch", str(max_batch),
         "--serve.gather_window_s", str(gather_window_s)]
        + (["--platform", "cpu"] if args.platform == "cpu" else []) + _policy_flags(args.policy),
        stdout=subprocess.PIPE, stderr=err, text=True, env=_clean_env(), cwd=REPO)
    if err is not None:
        err.close()
    # the ready line carries the bound port
    deadline = time.time() + 600
    line = ""
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        try:
            msg = json.loads(line)
            if msg.get("serving"):
                return proc, int(msg["port"])
        except (ValueError, KeyError, AttributeError):
            continue
    proc.kill()
    raise RuntimeError(f"inference server failed to come up (last line: {line!r})")


def _server_stats(port: int) -> dict:
    """One S_STATS round trip on a raw socket: the server's occupancy
    histogram and counters."""
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(struct.pack("<I", 0) + struct.pack("<B", 0x02))
        hdr = b""
        while len(hdr) < 5:
            hdr += s.recv(5 - len(hdr))
        (n,) = struct.unpack_from("<I", hdr)
        payload = b""
        while len(payload) < n:
            payload += s.recv(n - len(payload))
    return json.loads(payload)


def _run_client(role: str, args, envs: int, extra: list, name: str, children: Children) -> dict:
    err = _stderr(children, name)
    try:
        proc = subprocess.run(
            [*children.python, "-m", "dotaclient_tpu_torch.scripts.bench_serve", "--role", role, "--envs", str(envs),
             "--seconds", str(args.seconds), "--warmup_seconds", str(args.warmup), "--policy", args.policy,
             "--platform", args.platform, *extra],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE if err is None else err, text=True, timeout=1800,
            env=_clean_env(), cwd=REPO)
    finally:
        if err is not None:
            err.close()
    if proc.returncode != 0:
        tail = proc.stderr if err is None else open(err.name).read()
        raise RuntimeError(f"{role} client failed: {tail[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _merge_serve_clients(parts: list) -> dict:
    """C client processes' windows as one serve-arm row: rates add; the
    percentiles take the worst client (a conservative merge)."""
    return {
        "offered_steps_per_sec": round(sum(p["offered_steps_per_sec"] for p in parts), 1),
        "steps": sum(p["steps"] for p in parts),
        "seconds": max(p["seconds"] for p in parts),
        "p50_ms": max(p["p50_ms"] for p in parts),
        "p99_ms": max(p["p99_ms"] for p in parts),
        "samples": sum(p["samples"] for p in parts),
        "wire_errors": sum(p.get("wire_errors", 0) for p in parts),
        "client_processes": len(parts),
    }


def verdict_of(curve) -> dict:
    """The reference's verdict with the fresh vector arm as its anchor:
    the 1.5x bar at the largest N >= 8, every arm offering steps and no
    wire error."""
    big = [r for r in curve if r["envs"] >= 8]
    largest = max(big, key=lambda r: r["envs"]) if big else None
    speedup = largest["serve_speedup_vs_fresh_vector"] if largest else None
    return {
        "bar": 1.5,
        "baseline": "the fresh vector arm of this run (one VectorActor process, the same N, the same host)",
        "largest_matched_envs": largest["envs"] if largest else None,
        "speedup_at_largest": speedup,
        "fresh_vector_speedup_at_largest": speedup,
        "caveat": ("anchored to the same run's fresh vector arm: the reference's committed ACTOR_FLEET.json curve "
                   "is a record of its own host"),
        "ok": bool(largest and speedup >= 1.5 and all(
            r["vector"]["offered_steps_per_sec"] > 0 and r["serve"]["offered_steps_per_sec"] > 0
            and r["serve"].get("wire_errors", 0) == 0 for r in curve)),
    }


def orchestrate(args, children: Children = Children()) -> dict:
    import concurrent.futures as cf

    import torch

    from dotaclient_tpu_torch import resolve_device
    from dotaclient_tpu_torch.obs.preflight import check as preflight_check
    from dotaclient_tpu_torch.scripts.train_north_star import hardware_line

    resolve_device("cpu" if args.platform == "cpu" else None)  # the card, asserted, unless the host is asked for
    # before any child starts: a stray listener on the host skews both arms
    host_preflight = preflight_check("bench_serve")
    curve = []
    for n in [int(x) for x in args.envs.split(",") if x.strip()]:
        print(f"[{n} envs] vector arm (fresh) ...", flush=True)
        vector = _run_client("vector", args, n, [], f"vector{n}", children)
        print(f"  {vector['offered_steps_per_sec']:.0f} steps/s "
              f"(p50 {vector['p50_ms']:.1f}ms p99 {vector['p99_ms']:.1f}ms)", flush=True)
        n_clients = (2 if n >= 8 else 1) if args.clients == "auto" else int(args.clients)
        n_clients = min(n_clients, n)
        print(f"[{n} envs] serve arm ({n_clients} client proc) ...", flush=True)
        sproc, sport = _spawn_server(args, min(n, 8), args.gather_window_s, f"server{n}", children)
        try:
            per_client = n // n_clients
            counts = [per_client + (1 if i < n % n_clients else 0) for i in range(n_clients)]
            with cf.ThreadPoolExecutor(max_workers=n_clients) as ex:
                futs = [ex.submit(_run_client, "remote", args, counts[i],
                                  ["--endpoint", f"127.0.0.1:{sport}", "--actor_base", str(i * 1000)],
                                  f"remote{n}_{i}", children)
                        for i in range(n_clients)]
                parts = [f.result() for f in futs]
            serve_row = _merge_serve_clients(parts)
            stats = _server_stats(sport)
            serve_row["server"] = {
                "occupancy": round(stats.get("actor_batch_occupancy", 0.0), 4),
                "tick_rows_hist": {k.replace("actor_tick_rows_", ""): int(v) for k, v in sorted(stats.items())
                                   if k.startswith("actor_tick_rows_") and v},
                "requests_total": int(stats.get("serve_requests_total", 0)),
            }
        finally:
            sproc.send_signal(signal.SIGINT)  # the server's clean stop
            try:
                sproc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                sproc.kill()
                sproc.wait(timeout=30)
        print(f"  {serve_row['offered_steps_per_sec']:.0f} steps/s "
              f"(p50 {serve_row['p50_ms']:.1f}ms p99 {serve_row['p99_ms']:.1f}ms)", flush=True)
        curve.append({
            "envs": n,
            "vector": vector,
            "serve": serve_row,
            "vector_pr5_committed_steps_per_sec": None,  # the reference's host record: no anchor here
            "serve_speedup_vs_pr5_fleet": None,
            "serve_speedup_vs_fresh_vector": round(
                serve_row["offered_steps_per_sec"] / (vector["offered_steps_per_sec"] or 1.0), 3),
        })
    return {
        "generated_by": "dotaclient_tpu_torch/scripts/bench_serve.py",
        "host": {
            "cpus": os.cpu_count(),
            "platform": platform_mod.platform(),
            "python": platform_mod.python_version(),
            "torch": torch.__version__,
            "device": hardware_line(args.platform),
        },
        "host_preflight": host_preflight,
        "policy": args.policy,
        "seconds_per_config": args.seconds,
        "serve_config": {"gather_window_s": args.gather_window_s, "max_batch": "min(N, 8)"},
        "curve": curve,
        "verdict": verdict_of(curve),
        "notes": (
            "Matched env counts on one host. The verdict anchors to the fresh vector arm of the same run; the "
            "reference's committed per-process curve is not a record of this host, so its row keys are null. "
            "Latency is the per-step policy wait an env sees (the batcher await vs the wire round trip); the "
            "serve p50/p99 is the worst client process (a conservative merge). Rates compare within this file "
            "only."
        ),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="serve_bench_torch.json")
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--warmup", type=float, default=8.0, dest="warmup")
    p.add_argument("--envs", default="2,4,8,16")
    p.add_argument("--policy", choices=("flagship", "small"), default="flagship")
    p.add_argument("--gather_window_s", type=float, default=0.005)
    p.add_argument("--clients", default="auto",
                   help="serve-arm client processes: auto = 2 when N >= 8 (env stepping scales out; the server "
                        "is shared), else 1")
    p.add_argument("--quick", action="store_true", help="nightly scale: small policy, short windows")
    # client-role internals
    p.add_argument("--role", choices=("orchestrate", "vector", "remote"), default="orchestrate")
    p.add_argument("--endpoint", default="")
    p.add_argument("--actor_base", type=int, default=0)
    p.add_argument("--warmup_seconds", type=float, default=None)
    # "" = the CUDA device (raises without one); "cpu" the host
    p.add_argument("--platform", default="", choices=("", "cpu"))
    args = p.parse_args(argv)
    if args.quick:
        args.policy = "small"
        args.seconds = min(args.seconds, 2.0)
        args.warmup = 4.0
        args.envs = "2,8"
    if args.warmup_seconds is None:
        args.warmup_seconds = args.warmup
    return args


def cut_args(argv=()) -> argparse.Namespace:
    """The flags in argv with SMOKE_CUT applied."""
    args = parse_args(list(argv))
    for k, v in SMOKE_CUT.items():
        setattr(args, k, v)
    args.warmup_seconds = args.warmup
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.role != "orchestrate":
        args.envs = int(args.envs)
        out = run_vector_client(args) if args.role == "vector" else run_remote_client(args)
        print(json.dumps(out))
        return 0
    out = orchestrate(args)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"wrote {args.out}")
    if not out["verdict"]["ok"]:
        print("VERDICT: not met", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
