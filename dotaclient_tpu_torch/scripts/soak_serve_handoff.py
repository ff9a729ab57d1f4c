"""Serve handoff soak (twin of scripts/soak_serve_handoff.py): the proof
that a rolling restart of the serve tier abandons no episode.

With the carry store armed (`--serve.handoff_endpoint` on the servers,
`--serve.resume` on the clients), a rolling restart across two replicas
(`rolling@T:P@server`, chaos/schedule.py) is an episode non-event. Two
phases:

1. PARITY AND ZERO ABANDON: two arms of M RemoteActors sharing one
   multiplexed client (deterministic in-process fake envs, version-0
   serving): arm A runs one undisturbed replica; arm B runs two replicas
   and a shared tcp CarryStoreServer while a ScheduleRunner's rolling
   restarts kill each replica. The bar is the whole stream: every frame
   every env publishes in arm B is bitwise arm A's, because every
   interrupted episode resumes from its last chunk boundary (the store's
   carry and a replay of at most one chunk) and the reissued step samples
   what the uninterrupted arm sampled. The p99 policy-step latency inside
   the kill-to-restart(+1 s) windows stays under an absolute budget,
   disclosed beside the undisturbed arm's p99.

2. CONSERVATION: a live tcp learner (experience in, weights out), two
   hot-swapping replicas and the store, a RemoteFleet with resume armed,
   and a rolling restart mid-stream: no abandoned episode, client resumes
   ≥ 1, and the exact frame ledger (attempted = acked + shed + failed;
   enqueued = popped + dropped_oldest + resident; popped - reply_lost -
   consumed == 0).

The servers and the learner run on the CUDA device unless `--platform
cpu`; phase 2's fleet steps its envs over gRPC (`--env grpc`) or in
process (`--env local`). `run_soak` takes a PolicyConfig (None: the
soak's tiny one).

Run: python -m dotaclient_tpu_torch.scripts.soak_serve_handoff --out serve_handoff_soak_torch.json
     python -m dotaclient_tpu_torch.scripts.soak_serve_handoff --quick --platform cpu --out /tmp/x.json
"""

from __future__ import annotations

import argparse
import asyncio
import json
import threading
import time

from dotaclient_tpu_torch.scripts.chaos_soak import tiny_policy
from dotaclient_tpu_torch.scripts.soak_serve_chaos import LiveLearner, _make_serve_inc, _ReplicaRouter

STEPS_PER_EPISODE = 12  # the fake env's steps in one max_dota_time=12 episode


def _acfg(policy, endpoint, env_addr="local", seed=100, platform="", envs=1):
    from dotaclient_tpu_torch.config import ActorConfig, RetryConfig, ServeClientConfig

    return ActorConfig(
        env_addr=env_addr,
        rollout_len=4,  # short chunks: every episode crosses >= 2 boundaries
        max_dota_time=12.0,
        policy=policy,
        seed=seed,
        max_weight_age_s=0.0,  # kills pause the version's advance
        envs_per_process=envs,
        platform=platform,
        serve=ServeClientConfig(endpoint=endpoint, timeout_s=6.0, connect_timeout_s=1.5, cooldown_s=0.3, resume=True,
                                resume_window_s=15.0, route="load"),
        retry=RetryConfig(window_s=5.0, backoff_base_s=0.05, backoff_cap_s=0.5),
    )


class _PacedStub:
    """An env stub that waits a fixed time before each observe(): episodes
    stretch over wall time, so the rolling restarts land mid-episode on
    any host. The observations are untouched and both arms wait alike."""

    def __init__(self, inner, delay_s: float):
        self._inner = inner
        self._delay = delay_s

    def __getattr__(self, name):
        return getattr(self._inner, name)

    async def observe(self, req):
        await asyncio.sleep(self._delay)
        return await self._inner.observe(req)


# --------------------------------------------------------------- phase 1


def _run_parity_arm(policy, envs, episodes_per_env, rolling_spec, seed, mem_name, deadline_s, replicas, platform=""):
    """One parity arm: M RemoteActors sharing one client, `replicas`
    serve lives sharing a fresh tcp carry store, an optional rolling
    schedule. Returns the frames, the ledgers, and the latency and kill
    timelines of the p99 window check."""
    from dotaclient_tpu_torch.chaos import FaultSchedule, ScheduleRunner
    from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
    from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
    from dotaclient_tpu_torch.serve.client import RemoteActor, RemoteInferenceError, _client_from_cfg
    from dotaclient_tpu_torch.serve.handoff import CarryStoreServer
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect
    from dotaclient_tpu_torch.transport.serialize import deserialize_rollout

    store_srv = CarryStoreServer(port=0).start()
    incs = [_make_serve_inc(policy, 1, envs, platform=platform, store_port=store_srv.port) for _ in range(replicas)]
    router = _ReplicaRouter(incs)
    mem.reset(mem_name)
    broker = connect(f"mem://{mem_name}")
    cfg = _acfg(policy, ",".join(f"127.0.0.1:{inc.port}" for inc in incs), seed=seed, platform=platform)
    client = _client_from_cfg(cfg)
    actors = [RemoteActor(cfg, broker, actor_id=j, stub=_PacedStub(LocalDotaServiceStub(FakeDotaService()), 0.04),
                          client=client) for j in range(envs)]
    deadline = time.monotonic() + deadline_s
    runner_box = {}
    # (monotonic t, latency samples so far), cut afterwards into the
    # kill-to-restart windows of the p99 check
    lat_timeline = []
    stop_sampler = threading.Event()

    def sampler():
        while not stop_sampler.is_set():
            lat_timeline.append((time.monotonic(), len(client.latency_s)))
            time.sleep(0.02)

    st = threading.Thread(target=sampler, daemon=True)
    st.start()

    async def drive():
        async def one(env):
            while env.episodes_done < episodes_per_env and time.monotonic() < deadline:
                try:
                    await env.run_episode()
                    await asyncio.sleep(0.05)
                except RemoteInferenceError:
                    # with resume armed this is the last-resort abandon
                    # (ledgered by the actor): any at all is a red verdict
                    await asyncio.sleep(0.05)

        async def arm_runner():
            # the schedule's epoch starts once ~10% of the expected steps
            # have run, so the roll hits a mid-stream fleet on any host
            if not rolling_spec:
                return
            expected = envs * episodes_per_env * STEPS_PER_EPISODE
            while sum(a.steps_done for a in actors) < expected * 0.1:
                if time.monotonic() > deadline:
                    return
                await asyncio.sleep(0.02)
            runner_box["r"] = ScheduleRunner(FaultSchedule.parse(rolling_spec, seed=0), broker=None,
                                             t0=time.monotonic(), server=router).start()

        try:
            await asyncio.gather(*(one(a) for a in actors), arm_runner())
        finally:
            await client.close()

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(drive())
    finally:
        loop.close()
    runner = runner_box.get("r")
    if runner is not None:
        runner.stop()
    stop_sampler.set()
    st.join(timeout=5)
    ledgers = [inc.final_ledger() for inc in incs]
    lives = [l for inc in incs for l in inc.ledgers]
    frames = {}
    for f in broker.consume_experience(1_000_000, timeout=0.2):
        frames.setdefault(deserialize_rollout(f).actor_id, []).append(f)
    store_stats = store_srv.stats()
    store_srv.stop()
    return {
        "frames": frames,
        "episodes_done": {a.actor_id: a.episodes_done for a in actors},
        "abandons": sum(a.episodes_abandoned for a in actors),
        "resumed": sum(a.episodes_resumed for a in actors),
        "replay_steps": sum(a.resume_replay_steps for a in actors),
        "inflight_step_failures": client.errors,
        "reconnects": client.reconnects,
        "failovers": client.failovers,
        "route_probes": client.route_probes,
        "serve_lives": lives,
        "serve_totals": {k: sum(l[k] for l in ledgers)
                         for k in ("requests", "resumes", "resume_misses", "handoff_writes", "handoff_write_errors",
                                   "replayed_steps", "unknown_client")},
        "store": store_stats,
        "recovery": None if runner is None else runner.recovery,
        "kill_times": router.kill_times(),
        "restart_times": router.restart_times(),
        "latency_s": list(client.latency_s),
        "lat_timeline": lat_timeline,
        "finished_all": all(a.episodes_done >= episodes_per_env for a in actors),
    }


def _p99(samples):
    if not samples:
        return None
    s = sorted(samples)
    return round(s[min(len(s) - 1, int(0.99 * len(s)))] * 1e3, 3)


def _window_latencies(arm):
    """The latency samples recorded inside [kill, restart + 1 s] windows,
    through the (t, n_samples) timeline."""
    timeline = arm["lat_timeline"]
    lat = arm["latency_s"]

    def count_at(t):
        n = 0
        for ts, c in timeline:
            if ts > t:
                break
            n = c
        return n

    out = []
    for kt, rt in zip(arm["kill_times"], arm["restart_times"]):
        out.extend(lat[count_at(kt):count_at(rt + 1.0)])
    return out


def phase_parity(args, policy) -> dict:
    base = _run_parity_arm(policy, args.envs, args.parity_episodes, None, 100, "svhand_base", 240.0, 1, args.platform)
    chaos = _run_parity_arm(policy, args.envs, args.parity_episodes, args.parity_rolling, 100, "svhand_roll", 360.0,
                            2, args.platform)
    per_env = []
    matched = 0
    for aid in range(args.envs):
        a = base["frames"].get(aid, [])
        b = chaos["frames"].get(aid, [])
        env_ok = len(a) == len(b) and a == b
        matched += min(len(a), len(b)) if env_ok else 0
        per_env.append({"actor_id": aid, "baseline_frames": len(a), "rolling_frames": len(b),
                        "full_stream_bitwise": env_ok})
    win_lat = _window_latencies(chaos)
    return {
        "episodes_per_env": args.parity_episodes,
        "rolling_spec": args.parity_rolling,
        "rolling_recovery": chaos["recovery"],
        "kills_executed": len(chaos["kill_times"]),
        "per_env": per_env,
        "matched_frames_bitwise": matched,
        "episodes_abandoned": chaos["abandons"],
        "episodes_resumed": chaos["resumed"],
        "replay_steps": chaos["replay_steps"],
        "inflight_step_failures": chaos["inflight_step_failures"],
        "failovers": chaos["failovers"],
        "route_probes": chaos["route_probes"],
        "serve_totals": chaos["serve_totals"],
        "store": chaos["store"],
        "baseline_abandons": base["abandons"],
        "both_arms_finished": base["finished_all"] and chaos["finished_all"],
        "latency": {
            "budget_ms": args.p99_budget_ms,
            "p99_ms_during_restart_windows": _p99(win_lat),
            "window_samples": len(win_lat),
            "p99_ms_rolling_arm_overall": _p99(chaos["latency_s"]),
            "p99_ms_baseline_arm": _p99(base["latency_s"]),
            "disclosure": "the absolute budget is coarse on purpose (the reply timeout is 6000 ms) and both arms' "
                          "raw p99 are disclosed: the claim is 'bounded, no global stall', not a latency bench",
        },
    }


# --------------------------------------------------------------- phase 2


def phase_conservation(args, policy, live) -> dict:
    from dotaclient_tpu_torch.serve.handoff import CarryStoreServer

    store_srv = CarryStoreServer(port=0).start()
    inc_a = _make_serve_inc(policy, 0, args.envs, weights_port=live.bport, platform=args.platform,
                            store_port=store_srv.port)
    inc_b = _make_serve_inc(policy, 0, args.envs, weights_port=live.bport, platform=args.platform,
                            store_port=store_srv.port)
    router = _ReplicaRouter([inc_a, inc_b])
    cfg = _acfg(policy, f"127.0.0.1:{inc_a.port},127.0.0.1:{inc_b.port}", env_addr=live.env_addr, seed=200,
                platform=args.platform, envs=args.envs)
    fleet, _, recovery, ledger = live.run_fleet_phase(cfg, args.conserve_s, args.conserve_rolling, router)
    live.producers["handoff_fleet"] = ledger
    stats = fleet.stats()
    serve = {"a": inc_a.final_ledger(), "b": inc_b.final_ledger()}
    store = store_srv.stats()
    store_srv.stop()
    return {
        "duration_s": args.conserve_s,
        "rolling_spec": args.conserve_rolling,
        "rolling_recovery": recovery,
        "kills_executed": len(router.kill_times()),
        "episodes_abandoned": stats["serve_failover_episodes_abandoned_total"],
        "episodes_resumed": stats["serve_handoff_client_resumes_total"],
        "replay_steps": stats["serve_handoff_replay_steps_total"],
        "failovers": stats["serve_failover_total"],
        "route_mode_load": stats["serve_route_load_mode"],
        "route_probes": stats["serve_route_probes_total"],
        "publish": ledger,
        "serve": serve,
        "store": store,
    }


# ------------------------------------------------------------------ main


# A cut of --quick that keeps every event its verdicts need, run by the
# smoke's phase 21 and the CPU tests: parity rolls at 0.1 and 4.3 s
# (--quick: 0.1 s only; the clients step in lockstep, so one roll can land
# between episodes and resume none: ROADMAP.md §C), conservation 10 s (16)
# with --quick's roll at 4 s.
SMOKE_CUT = dict(parity_rolling="rolling@0.1:0.6@server,rolling@4.3:0.6@server", conserve_s=10.0)

# The verdicts that --quick's one parity roll leaves to chance (ROADMAP.md
# §C): SMOKE_CUT's two rolls decide them.
QUICK_BY_CHANCE = ("kills_hit_inflight_steps", "episodes_resumed_cover_interruptions")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="serve_handoff_soak_torch.json")
    p.add_argument("--envs", type=int, default=4)
    p.add_argument("--parity-episodes", type=int, default=20)
    # three rolling events at offsets incommensurate with the ~1 s
    # episode, so the kills land at different chunk positions (the
    # store-backed and the zeros-backed resume both)
    p.add_argument("--parity-rolling", default="rolling@0.1:0.6@server,rolling@4.3:0.6@server,rolling@8.77:0.6@server")
    p.add_argument("--p99-budget-ms", type=float, default=2000.0)
    p.add_argument("--conserve-s", type=float, default=22.0)
    p.add_argument("--conserve-rolling", default="rolling@4:0.8@server")
    p.add_argument("--quick", action="store_true", help="fewer episodes, one rolling event, the same invariants")
    # "" = the CUDA device; "cpu" runs the servers and the learner on the host
    p.add_argument("--platform", default="", choices=("", "cpu"))
    # how phase 2's fleet reaches its envs: gRPC (the reference), or in process
    p.add_argument("--env", default="grpc", choices=("grpc", "local"))
    args = p.parse_args(argv)
    if args.quick:
        args.parity_episodes = 8
        args.parity_rolling = "rolling@0.1:0.6@server"
        args.conserve_s = 16.0
    return args


def cut_args(argv=()) -> argparse.Namespace:
    """`--quick` and the flags in argv, with SMOKE_CUT applied."""
    args = parse_args(["--quick", *argv])
    for k, v in SMOKE_CUT.items():
        setattr(args, k, v)
    return args


def verdict_of(args, artifact: dict) -> dict:
    p1, p2 = artifact["phase_1_parity"], artifact["phase_2_conservation"]
    cons, learner = artifact["conservation"], artifact["learner"]
    watchdog = learner["watchdog"]
    parity_ok = all(e["full_stream_bitwise"] for e in p1["per_env"])
    p99 = p1["latency"]["p99_ms_during_restart_windows"]
    return {
        # the headline: rolling restarts are an episode non-event
        "zero_abandoned_episodes": p1["episodes_abandoned"] == 0 and p2["episodes_abandoned"] == 0
        and p1["baseline_abandons"] == 0,
        "episodes_resumed_cover_interruptions": p1["episodes_resumed"] >= 1 and p2["episodes_resumed"] >= 1,
        "kills_hit_inflight_steps": p1["inflight_step_failures"] >= 1,
        "rolling_killed_every_replica": p1["kills_executed"] >= 2 and p2["kills_executed"] >= 2,
        # whole streams, not prefixes
        "parity_full_stream_bitwise": parity_ok and p1["matched_frames_bitwise"] > 0,
        "parity_both_arms_finished": p1["both_arms_finished"],
        # across both phases' kills at least one resume went through the
        # store, and boundary writes flow in both
        "store_backed_resumes": (p1["serve_totals"]["resumes"] + p2["serve"]["a"]["resumes"]
                                 + p2["serve"]["b"]["resumes"]) >= 1
        and p1["serve_totals"]["handoff_writes"] >= 1
        and p2["serve"]["a"]["handoff_writes"] + p2["serve"]["b"]["handoff_writes"] >= 1,
        "store_no_errors_or_misses": p1["serve_totals"]["handoff_write_errors"] == 0
        and p1["serve_totals"]["resume_misses"] == 0
        and p2["serve"]["a"]["resume_misses"] + p2["serve"]["b"]["resume_misses"] == 0,
        "load_routing_probed": p1["route_probes"] >= 1,
        "p99_bounded_during_restart": p99 is not None and p99 <= args.p99_budget_ms,
        "conservation_zero_unaccounted": cons["unaccounted_frames"] == 0,
        "broker_identity_holds": cons["broker_identity_holds"],
        "producer_ledgers_balance": cons["producer_ledgers_balance"],
        "learner_clean_finish": learner["crashed"] is False and not learner["fleet_errors"]
        and not watchdog.get("tripped", False) and int(watchdog.get("trips_total", 0) or 0) == 0,
        "server_kills_executed": p1["kills_executed"] + p2["kills_executed"],
    }


def run_soak(args, policy=None) -> dict:
    """The two phases; returns the artifact ("verdict" holds the bools,
    "learner_steps" the live learner's steps, "wall_s" each phase's)."""
    from dotaclient_tpu_torch.obs.preflight import check as preflight_check

    policy = tiny_policy() if policy is None else policy
    artifact = {
        "host": f"single host, in-process serve replicas, a tcp carry store, a tcp experience/weights broker, envs "
                f"over {args.env}, servers and learner on {args.platform or 'the CUDA device'}",
        "host_preflight": preflight_check("soak_serve_handoff"),
        "envs": args.envs,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "baseline_comparison": "the serve chaos soak's failover phase is the before: failover in milliseconds but "
                               "every in-flight episode abandoned per kill; this soak's bar is no abandon and the "
                               "whole stream bitwise",
    }
    wall = {}
    t = time.perf_counter()
    artifact["phase_1_parity"] = phase_parity(args, policy)
    wall["parity"] = round(time.perf_counter() - t, 2)
    print(json.dumps({k: v for k, v in artifact["phase_1_parity"].items() if k != "per_env"}), flush=True)
    t = time.perf_counter()
    live = LiveLearner(args, policy, dict(batch_size=8, seq_len=4))
    try:
        artifact["phase_2_conservation"] = phase_conservation(args, policy, live)
        print(json.dumps(artifact["phase_2_conservation"]), flush=True)
    except Exception as e:
        live.crashed = f"{type(e).__name__}: {e}"
        live.close()
        raise
    artifact["conservation"], artifact["learner"] = live.finish()
    wall["live"] = round(time.perf_counter() - t, 2)
    artifact["learner_steps"] = live.steps
    artifact["wall_s"] = wall
    artifact["verdict"] = verdict_of(args, artifact)
    return artifact


def main(argv=None) -> int:
    args = parse_args(argv)
    artifact = run_soak(args)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(json.dumps(artifact, indent=2))
    return 0 if all(v for v in artifact["verdict"].values() if isinstance(v, bool)) else 1


if __name__ == "__main__":
    raise SystemExit(main())
