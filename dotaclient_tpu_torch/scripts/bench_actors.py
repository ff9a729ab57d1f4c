"""Offered-rate curve of the vectorized actor fleet (twin of
scripts/bench_actors.py; its artifact keys, default actor_fleet_torch.json).

Drives GENUINE actors (the policy's key step + featurize against a
FakeDotaService + wire serialization to a mem:// broker) and measures
offered env steps/s for three topologies at matched env counts N in
{1, 2, 4, 8, 16}:

- baseline_single: ONE Actor on one thread (a batch-1 step per tick), the
  per-process reference the batching story is told against;
- thread_fleet: N Actors on N threads (ActorPool), one env each, every
  thread with its own event loop and its own B=1 steps;
- vector: ONE VectorActor driving N envs on one asyncio loop, one batched
  step per tick (runtime/actor.py InferenceBatcher).

The headline ratio is vector against thread_fleet at the SAME N: same
host, same env server, same total envs. The artifact holds the curve, the
batcher meters (occupancy, gather wait, step + D2H latency), both speedups
and the extrapolated actors-per-core budget.

The env is in-process (one FakeDotaService; per env session a local stub
whose RPCs yield to the event loop once, as a network RPC would), not
gRPC: the card's machine has no grpc. The actors'
nets run on the CUDA device (`--platform ""`, asserted) or on the host
(`--platform cpu`); their T=1 step is torch ops, not the recurrence
kernel.

Run: python -m dotaclient_tpu_torch.scripts.bench_actors [--out actor_fleet_torch.json]
     [--seconds 5] [--envs 1,2,4,8,16] [--policy flagship|small] [--platform cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import os
import platform as platform_mod
import time

TARGET_OFFERED = 50_000.0  # the reference's north-star offered rate, env steps/s (its fleet target)
# The smoke's cut: envs 1 and 4, 0.5 s windows after 0.5 s of warm-up.
SMOKE_CUT = dict(envs="1,4", seconds=0.5, warmup_seconds=0.5)


def _policy(name: str):
    from dotaclient_tpu_torch.config import PolicyConfig

    if name == "small":
        return PolicyConfig(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32")
    return PolicyConfig()  # the flagship shapes (the production actor)


def _cfg(pol, platform: str, seed: int = 1):
    from dotaclient_tpu_torch.config import ActorConfig

    return ActorConfig(rollout_len=16, max_dota_time=120.0, policy=pol, seed=seed, platform=platform)


class YieldingStub:
    """An in-process env stub whose every RPC first yields to the event
    loop once, as a network RPC suspends its caller: without it an actor
    coroutine over a local stub never suspends, and nothing else on its
    loop (the measuring window, the batcher's other slots) runs."""

    def __init__(self, service):
        from dotaclient_tpu_torch.env.service import LocalDotaServiceStub

        self._inner = LocalDotaServiceStub(service)
        self.channel = self._inner.channel

    async def reset(self, request):
        await asyncio.sleep(0)
        return await self._inner.reset(request)

    async def observe(self, request):
        await asyncio.sleep(0)
        return await self._inner.observe(request)

    async def act(self, request):
        await asyncio.sleep(0)
        return await self._inner.act(request)


def _stub(service):
    return YieldingStub(service)


async def _measure_async(run_coro_fn, warmup_s, seconds, steps_fn, reset_fn=None):
    """Start the actor coroutine, warm up (first steps, first episodes),
    optionally reset meters, then count offered steps over `seconds`."""
    task = asyncio.ensure_future(run_coro_fn())
    try:
        await asyncio.sleep(warmup_s)
        if reset_fn is not None:
            reset_fn()
        s0 = steps_fn()
        t0 = time.perf_counter()
        await asyncio.sleep(seconds)
        steps = steps_fn() - s0
        elapsed = time.perf_counter() - t0
    finally:
        task.cancel()
        try:
            await task
        except BaseException:
            pass
    return steps, elapsed


def _run_loop(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def bench_single(service, pol, platform: str, seconds: float, warmup_s: float) -> dict:
    """One Actor, one thread, one env: a batch-1 step per tick."""
    from dotaclient_tpu_torch.runtime.actor import Actor
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect

    mem.reset("bench_actors_base")
    actor = Actor(_cfg(pol, platform), connect("mem://bench_actors_base"), actor_id=0, stub=_stub(service))
    steps, elapsed = _run_loop(_measure_async(actor.run, warmup_s, seconds, lambda: actor.steps_done))
    rate = steps / elapsed if elapsed > 0 else 0.0
    return {
        "mode": "single_thread_single_env",
        "offered_steps_per_sec": round(rate, 1),
        "steps": steps,
        "seconds": round(elapsed, 3),
    }


def bench_thread_fleet(service, pol, platform: str, n: int, seconds: float, warmup_s: float) -> dict:
    """N Actors on N threads (ActorPool), one env each."""
    from dotaclient_tpu_torch.runtime.actor import Actor
    from dotaclient_tpu_torch.runtime.harness import ActorPool
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect

    name = f"bench_actors_thr{n}"
    mem.reset(name)

    def make(i):
        return Actor(_cfg(pol, platform), connect(f"mem://{name}"), actor_id=i, stub=_stub(service))

    pool = ActorPool(make, n).start()
    # warm until every thread has built its actor and stepped
    deadline = time.time() + max(warmup_s * n, 60.0)
    while time.time() < deadline:
        if len(pool.actors) == n and all(a.steps_done > 0 for a in list(pool.actors)):
            break
        time.sleep(0.2)
    s0 = sum(a.steps_done for a in list(pool.actors))
    t0 = time.perf_counter()
    time.sleep(seconds)
    steps = sum(a.steps_done for a in list(pool.actors)) - s0
    elapsed = time.perf_counter() - t0
    pool.stop(timeout=10)
    rate = steps / elapsed if elapsed > 0 else 0.0
    return {
        "threads": n,
        "offered_steps_per_sec": round(rate, 1),
        "steps": steps,
        "seconds": round(elapsed, 3),
        "dead_threads": pool.dead,
    }


def bench_vector(service, pol, platform: str, n: int, seconds: float, warmup_s: float) -> dict:
    """One VectorActor at N envs per process: one batched step per tick."""
    from dotaclient_tpu_torch.runtime.actor import VectorActor
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect

    name = f"bench_actors_v{n}"
    mem.reset(name)
    vec = VectorActor(_cfg(pol, platform), connect(f"mem://{name}"), actor_id=0, envs=n,
                      stubs=[_stub(service) for _ in range(n)])
    steps, elapsed = _run_loop(_measure_async(vec.run, warmup_s, seconds, lambda: vec.steps_done,
                                              reset_fn=vec.batcher.reset_meters))
    rate = steps / elapsed if elapsed > 0 else 0.0
    stats = vec.stats()
    return {
        "envs_per_process": n,
        "offered_steps_per_sec": round(rate, 1),
        "steps": steps,
        "seconds": round(elapsed, 3),
        "batch_occupancy": round(stats["actor_batch_occupancy"], 4),
        "gather_wait_ms": round(stats["actor_gather_wait_s"] * 1e3, 4),
        "jit_step_ms": round(stats["actor_jit_step_s"] * 1e3, 4),
    }


def extrapolate(curve) -> dict:
    """The operating point: the highest-throughput N of the sweep (the
    per-process rate rises while batching amortizes dispatch and flattens
    once the loop saturates on serial host work), and the 256-actor budget
    it implies."""
    best = max(curve, key=lambda r: r["offered_steps_per_sec"]) if curve else None
    if best is None or best["offered_steps_per_sec"] <= 0:
        return None
    rate = best["offered_steps_per_sec"]
    n = best["envs_per_process"]
    return {
        "chosen_envs_per_process": n,
        "per_process_offered_steps_per_sec": rate,
        # one vector process ~= one actor core (a single actor thread)
        "actors_per_core": n,
        "cores_for_256_actors": math.ceil(256 / n),
        "offered_steps_per_sec_at_256_actors": round(256 / n * rate, 1),
        "target_offered_steps_per_sec": TARGET_OFFERED,
        "processes_for_target": math.ceil(TARGET_OFFERED / rate),
        "envs_for_target": math.ceil(TARGET_OFFERED / rate) * n,
    }


def run(args) -> dict:
    import torch

    from dotaclient_tpu_torch import resolve_device
    from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
    from dotaclient_tpu_torch.obs.preflight import check as preflight_check
    from dotaclient_tpu_torch.scripts.train_north_star import hardware_line

    warmup_s = args.warmup_seconds or max(3.0, args.seconds / 2.0)
    host_preflight = preflight_check("bench_actors")
    resolve_device("cpu" if args.platform == "cpu" else None)  # the card, asserted, unless the host is asked for
    service = FakeDotaService()
    pol = _policy(args.policy)

    print(f"baseline: single thread, single env ({args.policy} policy) ...", flush=True)
    baseline = bench_single(service, pol, args.platform, args.seconds, warmup_s)
    print(f"  {baseline['offered_steps_per_sec']:.0f} steps/s", flush=True)
    base_rate = baseline["offered_steps_per_sec"] or 1.0

    curve = []
    for n in [int(x) for x in args.envs.split(",") if x.strip()]:
        fleet = None
        if not args.skip_thread_fleet:
            print(f"thread fleet: {n} threads x 1 env ...", flush=True)
            fleet = bench_thread_fleet(service, pol, args.platform, n, args.seconds, warmup_s)
            print(f"  {fleet['offered_steps_per_sec']:.0f} steps/s", flush=True)
        print(f"vector: {n} envs/process ...", flush=True)
        row = bench_vector(service, pol, args.platform, n, args.seconds, warmup_s)
        row["speedup_vs_single"] = round(row["offered_steps_per_sec"] / base_rate, 3)
        if fleet is not None:
            row["thread_fleet_steps_per_sec"] = fleet["offered_steps_per_sec"]
            row["thread_fleet_dead_threads"] = fleet["dead_threads"]
            row["speedup_vs_thread_fleet"] = round(
                row["offered_steps_per_sec"] / (fleet["offered_steps_per_sec"] or 1.0), 3)
        print(f"  {row['offered_steps_per_sec']:.0f} steps/s (occupancy {row['batch_occupancy']:.2f}"
              + (f", {row['speedup_vs_thread_fleet']:.2f}x vs thread fleet" if fleet is not None else "") + ")",
              flush=True)
        curve.append(row)

    return {
        "generated_by": "dotaclient_tpu_torch/scripts/bench_actors.py",
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
        "baseline_single": baseline,
        "curve": curve,
        "meets_2x_bar_at_8_envs": any(
            r["envs_per_process"] >= 8 and r.get("speedup_vs_thread_fleet", 0.0) >= 2.0 for r in curve),
        "extrapolation": extrapolate(curve),
        "notes": (
            "All arms share this host (actor thread(s), the in-process fake env and the device's launch queue), "
            "so rates compare within the file, not across hosts. The headline ratio is vector vs the N-thread "
            "one-env-per-thread fleet at matched N: same cores, same env server, same total envs. The env and "
            "featurize work is serial per step and does not batch, so the vector curve flattens where its share "
            "dominates; the thread fleet additionally pays GIL-serialized B=1 step dispatch from N threads."
        ),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="actor_fleet_torch.json")
    p.add_argument("--seconds", type=float, default=5.0, help="measured window per config")
    p.add_argument("--warmup_seconds", type=float, default=0.0, help="0 = auto (max(3, seconds/2))")
    p.add_argument("--envs", default="1,2,4,8,16", help="comma list of env counts to sweep")
    p.add_argument("--policy", choices=("flagship", "small"), default="flagship")
    p.add_argument("--skip_thread_fleet", action="store_true",
                   help="skip the N-thread baseline arms (they are the slowest part)")
    # "" = the CUDA device (raises without one); "cpu" the host
    p.add_argument("--platform", default="", choices=("", "cpu"))
    return p.parse_args(argv)


def cut_args(argv=()) -> argparse.Namespace:
    """The flags in argv with SMOKE_CUT applied."""
    args = parse_args(list(argv))
    for k, v in SMOKE_CUT.items():
        setattr(args, k, v)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run(args)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
