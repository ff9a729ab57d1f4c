"""Serve chaos soak (twin of scripts/soak_serve_chaos.py): the proof that
serving survives the loss of a replica, against real in-process
InferenceServer kills (chaos/controller.py ServeIncarnations behind the
`kill@T:D@server` grammar), in three phases:

1. PARITY: two remote-fleet arms (M envs sharing one multiplexed client
   against a serve replica, deterministic in-process fake envs, no
   weight fanout, so both serve version 0): arm A runs undisturbed, arm
   B takes scheduled server kills. Every frame an env published before
   its first kill-induced abandon is bitwise arm A's, and the abandons
   are ledgered by the clients (episodes_abandoned) and the servers
   (carries stranded at the kill).

2. FAILOVER: two replicas, a live learner (a tcp broker: experience in,
   weights out, both replicas hot-swapping) and a ScheduleRunner killing
   the replicas in turn: the fleet fails over to the survivor within the
   recovery budget (the first remote step after each kill), and the
   frame ledger balances with no unaccounted frame.

3. FALLBACK: one replica, `--serve.fallback_local` armed: an outage
   longer than the budget engages the local fallback no earlier than
   `fallback_after_s` after it starts, the fleet keeps publishing from
   the warm tree the broker fanout refreshed (version > 0), and the
   restart disengages it: one engagement for one outage.

Conservation (phases 2 and 3, one broker lineage): attempted = acked +
shed + failed per producer; enqueued = popped + dropped_oldest +
resident at the broker; popped - reply_lost - staging consumed == 0.

The servers, the learner and the fallback run on the CUDA device unless
`--platform cpu`. Phases 2 and 3 step the fleet's envs over gRPC (`--env
grpc`, the reference's topology) or in process through
`build_actors(..., make_stub=...)` (`--env local`, for a host without
grpc). Each phase is a function; `run_soak` takes a PolicyConfig (None:
the soak's tiny one).

Run: python -m dotaclient_tpu_torch.scripts.soak_serve_chaos --out serve_chaos_soak_torch.json
     python -m dotaclient_tpu_torch.scripts.soak_serve_chaos --quick --platform cpu --out /tmp/x.json
"""

from __future__ import annotations

import argparse
import asyncio
import json
import struct
import threading
import time

from dotaclient_tpu_torch.scripts.chaos_soak import _ACTOR_AT, SENTINEL_WARM_ID, make_frames, tiny_policy


def _make_serve_inc(policy, seed, max_batch, weights_port=None, platform="", store_port=None, wrap=None):
    """ServeIncarnations whose lives poll the shared weight fanout
    (weights_port None: version-0 serving) and, with `store_port`, stream
    their carries to the store there. `wrap(server)` is applied to every
    life as it starts."""
    from dotaclient_tpu_torch.chaos import ServeIncarnations
    from dotaclient_tpu_torch.config import InferenceConfig, ServeConfig
    from dotaclient_tpu_torch.serve.server import InferenceServer
    from dotaclient_tpu_torch.transport.base import RetryPolicy
    from dotaclient_tpu_torch.transport.tcp import TcpBroker

    store = {} if store_port is None else {"handoff_endpoint": f"127.0.0.1:{store_port}", "handoff_timeout_s": 2.0}

    def make_server(port):
        cfg = InferenceConfig(
            serve=ServeConfig(port=port, max_batch=max_batch, gather_window_s=0.002, weight_poll_s=0.05, **store),
            policy=policy,
            seed=seed,
            platform=platform,
        )
        broker = TcpBroker(port=weights_port, retry=RetryPolicy(window_s=5.0)) if weights_port else None
        server = InferenceServer(cfg, broker=broker).start()
        return server if wrap is None else wrap(server)

    return ServeIncarnations(make_server, port=0)


class _MidStepKill:
    """The parity arm's server controller: each kill lands on a step
    request the live server has received and not answered. The kill arms
    a hold and waits (at most HOLD_WAIT_S) for the next request, which the
    server holds unanswered until the kill cancels it. A kill at a wall
    time alone lands between two steps whenever the clients are short of
    CPU (their env and featurizer time grows, a request's time in flight
    does not), and kills_hit_inflight_steps then reads false by pace
    alone (1 of 16 CPU runs with eight soaks at once)."""

    HOLD_WAIT_S = 2.0

    def __init__(self):
        self.inc = None  # the ServeIncarnations whose lives wrap() hooks
        self._armed, self._held = threading.Event(), threading.Event()

    def wrap(self, server):
        step_request = server._step_request

        async def held_step_request(conn, payload):
            if self._armed.is_set():
                self._armed.clear()
                self._held.set()
                await asyncio.Event().wait()  # never answered: the kill cancels this task
            return await step_request(conn, payload)

        server._step_request = held_step_request
        return server

    def kill(self):
        self._held.clear()
        self._armed.set()
        self._held.wait(self.HOLD_WAIT_S)
        self._armed.clear()
        return self.inc.kill()

    def restart(self):
        self.inc.restart()

    def wait_first_request(self, timeout=30.0, stop=None):
        return self.inc.wait_first_request(timeout, stop)


def _acfg(policy, endpoint, env_addr="local", seed=100, cooldown_s=0.4, fallback_local=False, fallback_after_s=1.0,
          platform="", envs=1):
    from dotaclient_tpu_torch.config import ActorConfig, RetryConfig, ServeClientConfig

    return ActorConfig(
        env_addr=env_addr,
        rollout_len=8,
        max_dota_time=4.0,
        policy=policy,
        seed=seed,
        max_weight_age_s=0.0,  # kills pause the version's advance
        envs_per_process=envs,
        platform=platform,
        serve=ServeClientConfig(endpoint=endpoint, timeout_s=6.0, connect_timeout_s=1.5, cooldown_s=cooldown_s,
                                fallback_local=fallback_local, fallback_after_s=fallback_after_s),
        retry=RetryConfig(window_s=5.0, backoff_base_s=0.05, backoff_cap_s=0.5),
    )


class _ReplicaRouter:
    """kill()/restart() over N ServeIncarnations: the ScheduleRunner drives
    one controller and the router hands its kill events to the replicas
    in turn (kill rep0, restart rep0, kill rep1, ...). Events never
    overlap (one runner thread), so the pending index is a stack."""

    def __init__(self, incs):
        self.incs = incs
        self._next = 0
        self._pending = []

    def replica_count(self) -> int:
        return len(self.incs)

    def kill(self):
        i = self._next % len(self.incs)
        self._next += 1
        self._pending.append(i)
        return self.incs[i].kill()

    def restart(self):
        self.incs[self._pending[-1]].restart()

    def wait_first_request(self, timeout=30.0, stop=None):
        return self.incs[self._pending[-1]].wait_first_request(timeout, stop)

    def kill_times(self):
        return sorted(t for inc in self.incs for t in inc.kill_times)

    def restart_times(self):
        return sorted(t for inc in self.incs for t in inc.restart_times)


def env_stub_factory(env: str):
    """(env_addr, make_stub, server): `grpc` serves one FakeDotaService on
    a loopback port that every env slot dials; `local` hands each slot an
    in-process stub of one shared FakeDotaService."""
    from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService

    if env == "grpc":
        from dotaclient_tpu_torch.env.service import serve as env_serve

        server, port = env_serve(FakeDotaService())
        return f"127.0.0.1:{port}", None, server
    if env != "local":
        raise ValueError(f"--env must be grpc or local, got {env!r}")
    from dotaclient_tpu_torch.env.service import LocalDotaServiceStub

    service = FakeDotaService()
    return "local", lambda: LocalDotaServiceStub(service), None


# --------------------------------------------------------------- phase 1


def _run_parity_arm(policy, envs, episodes_per_env, kills_spec, seed, mem_name, deadline_s, platform=""):
    """One parity arm: M RemoteActors sharing one multiplexed client
    against a fresh replica; returns the frames by actor id, each env's
    frame count before its first abandon, the abandons and the ledgers."""
    from dotaclient_tpu_torch.chaos import FaultSchedule, ScheduleRunner
    from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
    from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
    from dotaclient_tpu_torch.serve.client import RemoteActor, RemoteInferenceError, _client_from_cfg
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect
    from dotaclient_tpu_torch.transport.serialize import deserialize_rollout

    killer = _MidStepKill() if kills_spec else None
    inc = _make_serve_inc(policy, seed=1, max_batch=envs, platform=platform,
                          wrap=None if killer is None else killer.wrap)
    mem.reset(mem_name)
    broker = connect(f"mem://{mem_name}")
    cfg = _acfg(policy, f"127.0.0.1:{inc.port}", seed=seed, cooldown_s=0.3, platform=platform)
    client = _client_from_cfg(cfg)
    actors = [RemoteActor(cfg, broker, actor_id=j, stub=LocalDotaServiceStub(FakeDotaService()), client=client)
              for j in range(envs)]
    # first_abandon[actor_id]: frames published before the first
    # kill-induced abandon, the env's bitwise cut
    first_abandon = {}
    deadline = time.monotonic() + deadline_s
    runner = None
    if kills_spec:
        killer.inc = inc
        runner = ScheduleRunner(FaultSchedule.parse(kills_spec, seed=0), broker=None, t0=time.monotonic(),
                                server=killer)

    async def drive():
        async def one(env):
            while env.episodes_done < episodes_per_env and time.monotonic() < deadline:
                try:
                    await env.run_episode()
                    # a little pacing, so the kills land mid-run on any host;
                    # wall time never feeds the rng or the env streams
                    await asyncio.sleep(0.04)
                except RemoteInferenceError:
                    first_abandon.setdefault(env.actor_id, env.rollouts_published)
                    await asyncio.sleep(0.05)

        if runner is not None:
            runner.start()
        try:
            await asyncio.gather(*(one(a) for a in actors))
        finally:
            await client.close()

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(drive())
    finally:
        loop.close()
    if runner is not None:
        runner.stop()
    serve_ledger = inc.final_ledger()
    frames = {}
    for f in broker.consume_experience(1_000_000, timeout=0.2):
        frames.setdefault(deserialize_rollout(f).actor_id, []).append(f)
    return {
        "frames": frames,
        "first_abandon": first_abandon,
        "episodes_done": {a.actor_id: a.episodes_done for a in actors},
        "abandons": {a.actor_id: a.episodes_abandoned for a in actors},
        "inflight_step_failures": client.errors,
        "reconnects": client.reconnects,
        "serve": serve_ledger,
        "serve_lives": inc.ledgers,
        "recovery": None if runner is None else runner.recovery,
        "finished_all": all(a.episodes_done >= episodes_per_env for a in actors),
    }


def phase_parity(args, policy) -> dict:
    base = _run_parity_arm(policy, args.envs, args.parity_episodes, None, 100, "svchaos_base", 120.0, args.platform)
    chaos = _run_parity_arm(policy, args.envs, args.parity_episodes, args.parity_kills, 100, "svchaos_kill", 180.0,
                            args.platform)
    per_env = []
    parity_ok = True
    matched_frames = 0
    for aid in range(args.envs):
        a = base["frames"].get(aid, [])
        b = chaos["frames"].get(aid, [])
        cut = chaos["first_abandon"].get(aid)
        n = min(len(a), len(b)) if cut is None else min(cut, len(a), len(b))
        env_ok = (cut is None or n == cut) and a[:n] == b[:n]
        parity_ok = parity_ok and env_ok
        matched_frames += n
        per_env.append({"actor_id": aid, "baseline_frames": len(a), "chaos_frames": len(b),
                        "first_abandon_at_frame": cut, "abandons": chaos["abandons"].get(aid, 0),
                        "untouched_prefix_bitwise": env_ok})
    return {
        "episodes_per_env": args.parity_episodes,
        "kills": chaos["recovery"],
        "per_env": per_env,
        "matched_frames_bitwise": matched_frames,
        "episodes_abandoned_total": sum(chaos["abandons"].values()),
        "carries_stranded_at_kills": sum(l["carries_resident_at_kill"] for l in chaos["serve_lives"]),
        "inflight_step_failures": chaos["inflight_step_failures"],
        "serve_lives": chaos["serve_lives"],
        "baseline_serve": base["serve"],
        "chaos_serve": chaos["serve"],
        "both_arms_finished": base["finished_all"] and chaos["finished_all"],
    }


# ---------------------------------------------------- phases 2-3 plumbing


class LiveLearner:
    """The shared plumbing of the live phases: one experience and weights
    broker, the env service, and a warm learner that trains on the
    calling thread while a phase's fleet runs. `finish()` drains it and
    returns the conservation ledger and the learner's record."""

    def __init__(self, args, policy, lcfg_kw: dict, fleet_ids: int = 0):
        from dotaclient_tpu_torch.config import LearnerConfig, ObsConfig, PPOConfig, WatchdogConfig
        from dotaclient_tpu_torch.runtime.learner import Learner
        from dotaclient_tpu_torch.transport.base import RetryPolicy
        from dotaclient_tpu_torch.transport.tcp import BrokerServer, TcpBroker

        self.args = args
        self.exp_broker_server = BrokerServer(port=0, maxlen=8192).start()
        self.bport = self.exp_broker_server.port
        self.env_addr, self.make_stub, self.env_server = env_stub_factory(args.env)
        self.lcfg = LearnerConfig(
            policy=policy,
            publish_every=1,
            metrics_every=5,
            platform=args.platform,
            # a wide window: a small learner advances versions far faster
            # than any real cadence; the ledgers stay about transport
            ppo=PPOConfig(max_staleness=4096),
            obs=ObsConfig(enabled=True, install_handlers=False, step_phases=False,
                          watchdog=WatchdogConfig(enabled=True, interval_s=2.0, stall_s=30.0)),
            **lcfg_kw,
        )
        self.producers = {}
        self.fleet_errors = []
        self.crashed = None
        self.learner = Learner(self.lcfg, TcpBroker(port=self.bport, retry=RetryPolicy()),
                               device="cpu" if args.platform == "cpu" else None)
        frames = make_frames(self.lcfg, 32)
        warm_pub = TcpBroker(port=self.bport)
        n_warm = self.lcfg.batch_size + 4
        for i in range(n_warm):
            fr = bytearray(frames[i % len(frames)])
            struct.pack_into("<I", fr, _ACTOR_AT, SENTINEL_WARM_ID)
            warm_pub.publish_experience(bytes(fr))
        self.producers["warmup"] = {"attempted": n_warm, "acked": n_warm, "shed": 0, "failed": 0}
        self.learner.run(num_steps=1, batch_timeout=120.0)
        warm_pub.close()
        print("learner warm", flush=True)

    def run_fleet_phase(self, cfg, duration_s, runner_spec, router, sample_extra=None):
        """Drive a RemoteFleet for duration_s while a ScheduleRunner (if
        any) kills servers; the learner trains on this thread. Returns
        (fleet, samples, the runner's recovery, the publish ledger)."""
        from dotaclient_tpu_torch.chaos import FaultSchedule, ScheduleRunner
        from dotaclient_tpu_torch.runtime.actor import build_actors
        from dotaclient_tpu_torch.transport.base import RetryPolicy
        from dotaclient_tpu_torch.transport.tcp import TcpBroker

        fleet = build_actors(cfg, TcpBroker(port=self.bport, retry=RetryPolicy(window_s=8.0)),
                             make_stub=self.make_stub)[0]
        stop_ev = threading.Event()
        samples = []

        def fleet_main():
            async def go():
                agen = fleet.episode_stream()
                try:
                    async for _ in agen:
                        if stop_ev.is_set():
                            return
                except Exception as e:  # a fleet that died is a red verdict
                    self.fleet_errors.append(f"{type(e).__name__}: {e}")
                finally:
                    # an explicit aclose: leaving async-for leaves the
                    # generator suspended; its teardown runs here, not at GC
                    await agen.aclose()

            asyncio.run(go())

        def sampler():
            while not stop_ev.is_set():
                row = {"t": time.monotonic(), "remote_steps": fleet.client.steps,
                       "published": fleet.rollouts_published}
                if sample_extra:
                    row.update(sample_extra(fleet))
                samples.append(row)
                time.sleep(0.03)

        ft = threading.Thread(target=fleet_main, daemon=True, name="serve-soak-fleet")
        st = threading.Thread(target=sampler, daemon=True)
        t0 = time.monotonic()
        ft.start()
        st.start()
        runner = None
        if runner_spec:
            runner = ScheduleRunner(FaultSchedule.parse(runner_spec, seed=0), broker=None, t0=t0,
                                    server=router).start()
        self.learner.run(max_seconds=duration_s, batch_timeout=2.0)
        if runner is not None:
            runner.stop()
        stop_ev.set()
        ft.join(timeout=60)
        st.join(timeout=10)
        if ft.is_alive():
            # graftlint: disable=THR001(list.append is one GIL-atomic call; a wedged fleet thread can at most add its own entry)
            self.fleet_errors.append("fleet thread failed to join (teardown wedge)")
        fleet.broker.close()
        ledger = {
            "attempted": fleet.rollouts_published + fleet.rollouts_shed + fleet.rollouts_failed,
            "acked": fleet.rollouts_published,
            "shed": fleet.rollouts_shed,
            "failed": fleet.rollouts_failed,
        }
        return fleet, samples, (None if runner is None else runner.recovery), ledger

    def finish(self) -> tuple:
        """(conservation, learner record); a final drain first, so late
        publishes are consumed before the ledger."""
        try:
            learner = self.learner
            learner.run(max_seconds=3.0, batch_timeout=0.5)
            watchdog = learner.obs.watchdog.verdict() if learner.obs and learner.obs.watchdog else {}
            learner.staging.stop()
            staging_stats = learner.staging.stats()
            self.steps = int(learner.version)
            learner.close()
            if self.crashed is None:
                self.crashed = False
        finally:
            self.close()
        broker_led = self.exp_broker_server.ledger()
        producers = self.producers
        producer_totals = {k: sum(int(p.get(k, 0)) for p in producers.values())
                           for k in ("attempted", "acked", "shed", "failed")}
        producer_ledgers_ok = all(int(p["attempted"]) == int(p["acked"]) + int(p["shed"]) + int(p["failed"])
                                  for p in producers.values())
        unaccounted = broker_led["popped"] - broker_led["reply_lost"] - staging_stats["consumed"]
        conservation = {
            "producers": producers,
            "producer_totals": producer_totals,
            "broker": broker_led,
            "staging": {k: int(staging_stats[k])
                        for k in ("consumed", "dropped_stale", "dropped_bad", "quarantined", "rows_packed")},
            "staging_pending_leftover": int(staging_stats["pending_rollouts"]),
            "broker_identity_holds": broker_led["enqueued"]
            == broker_led["popped"] + broker_led["dropped_oldest"] + broker_led["resident"],
            "producer_ledgers_balance": producer_ledgers_ok,
            "died_with_broker": broker_led["resident"] + broker_led["reply_lost"],
            "unaccounted_frames": unaccounted,
        }
        learner_rec = {"versions_trained": int(staging_stats["batches"]), "crashed": self.crashed,
                       # graftlint: disable=THR001(read after run_fleet_phase joined the fleet thread)
                       "fleet_errors": self.fleet_errors, "watchdog": watchdog}
        return conservation, learner_rec

    def close(self) -> None:
        self.exp_broker_server.stop()
        if self.env_server is not None:
            self.env_server.stop(0)


def fallback_sample(fleet) -> dict:
    fb = fleet.fallback
    return {
        "fb_engaged": 1 if (fb is not None and fb.engaged) else 0,
        "fb_steps": fb.steps_total if fb else 0,
        "fb_engagements": fb.engagements if fb else 0,
        "fb_version": fb.version if fb else 0,
    }


# --------------------------------------------------------------- phase 2


def phase_failover(args, policy, live) -> dict:
    inc_a = _make_serve_inc(policy, seed=0, max_batch=args.envs, weights_port=live.bport, platform=args.platform)
    inc_b = _make_serve_inc(policy, seed=0, max_batch=args.envs, weights_port=live.bport, platform=args.platform)
    router = _ReplicaRouter([inc_a, inc_b])
    cfg = _acfg(policy, f"127.0.0.1:{inc_a.port},127.0.0.1:{inc_b.port}", env_addr=live.env_addr, seed=200,
                platform=args.platform, envs=args.envs)
    fleet, samples, recovery, ledger = live.run_fleet_phase(cfg, args.failover_s, args.failover_kills, router)
    live.producers["failover_fleet"] = ledger
    stats = fleet.stats()
    kill_ts = router.kill_times()
    recoveries = []
    for kt in kill_ts:
        before = [s for s in samples if s["t"] <= kt]
        steps_at_kill = before[-1]["remote_steps"] if before else 0
        after = [s for s in samples if s["t"] > kt and s["remote_steps"] > steps_at_kill]
        recoveries.append(None if not after else round(after[0]["t"] - kt, 3))
    return {
        "duration_s": args.failover_s,
        "endpoints": 2,
        "kills": recovery,
        "client_recovery_s": recoveries,
        "recovery_budget_s": args.failover_budget_s,
        "failovers": stats["serve_failover_total"],
        "reconnects": stats["serve_failover_reconnects_total"],
        "episodes_abandoned": stats["serve_failover_episodes_abandoned_total"],
        "carries_stranded_at_kills": sum(l["carries_resident_at_kill"] for l in inc_a.ledgers + inc_b.ledgers),
        "fallback_engaged_ever": stats["serve_fallback_engagements_total"],
        "publish": ledger,
        "serve": {"a": inc_a.final_ledger(), "b": inc_b.final_ledger()},
    }


# --------------------------------------------------------------- phase 3


def phase_fallback(args, policy, live) -> dict:
    inc_c = _make_serve_inc(policy, seed=0, max_batch=args.envs, weights_port=live.bport, platform=args.platform)
    cfg = _acfg(policy, f"127.0.0.1:{inc_c.port}", env_addr=live.env_addr, seed=300, fallback_local=True,
                fallback_after_s=args.fallback_after_s, platform=args.platform, envs=args.envs)
    spec = f"kill@{args.fallback_warm_s}:{args.fallback_down_s}@server"
    duration = args.fallback_warm_s + args.fallback_down_s + args.fallback_post_s
    fleet, samples, recovery, ledger = live.run_fleet_phase(cfg, duration, spec, inc_c,
                                                            sample_extra=fallback_sample)
    live.producers["fallback_fleet"] = ledger
    stats = fleet.stats()
    kill_t = inc_c.kill_times[0] if inc_c.kill_times else None
    # restart_times holds restart() calls only, so the restart after the
    # kill is the first entry
    restart_t = inc_c.restart_times[0] if inc_c.restart_times else None
    pre_kill = [s for s in samples if kill_t is None or s["t"] <= kill_t]
    engaged = [s for s in samples if s["fb_steps"] > 0]
    first_fb_t = engaged[0]["t"] if engaged else None
    pub_at_kill = pre_kill[-1]["published"] if pre_kill else 0
    outage = [s for s in samples if restart_t is not None and kill_t is not None and kill_t < s["t"] <= restart_t]
    post = [s for s in samples if restart_t is not None and s["t"] > restart_t]
    steps_at_restart = outage[-1]["remote_steps"] if outage else 0
    return {
        "warm_s": args.fallback_warm_s,
        "down_s": args.fallback_down_s,
        "budget_s": args.fallback_after_s,
        "kills": recovery,
        "pre_kill_fallback_steps": pre_kill[-1]["fb_steps"] if pre_kill else 0,
        "engage_delay_s": None if (first_fb_t is None or kill_t is None) else round(first_fb_t - kill_t, 3),
        "engagements_total": stats["serve_fallback_engagements_total"],
        "fallback_steps_total": stats["serve_fallback_steps_total"],
        "fallback_version_at_engage": engaged[0]["fb_version"] if engaged else 0,
        "published_during_outage": (outage[-1]["published"] - pub_at_kill) if outage else 0,
        "engaged_at_end": stats["serve_fallback_engaged"],
        "remote_steps_resumed_after_restart": bool(post) and post[-1]["remote_steps"] > steps_at_restart,
        "episodes_abandoned": stats["serve_failover_episodes_abandoned_total"],
        "publish": ledger,
        "serve": inc_c.final_ledger(),
    }


# ------------------------------------------------------------------ main


# A cut of --quick that keeps every event its verdicts need, run by the
# smoke's phase 21 and the CPU tests: parity kills at 0.9, 2.1 and 3.3 s over
# the default 24 episodes (--quick: the 0.9 s kill over 12, and 12 episodes
# end before a second kill: ROADMAP.md §C); each lands on a held step
# request (_MidStepKill); failover 6 s (9) with --quick's kill at 3 s;
# fallback 2 + 3 + 3 s (3 + 4 + 5).
SMOKE_CUT = dict(parity_episodes=24, parity_kills="kill@0.9:0.8@server,kill@2.1:0.8@server,kill@3.3:0.8@server",
                 failover_s=6.0, fallback_warm_s=2.0, fallback_down_s=3.0, fallback_post_s=3.0)

# The verdict that --quick's one parity kill leaves to chance (ROADMAP.md §C):
# SMOKE_CUT's three kills decide it.
QUICK_BY_CHANCE = ("kills_hit_inflight_steps",)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="serve_chaos_soak_torch.json")
    p.add_argument("--envs", type=int, default=4)
    p.add_argument("--parity-episodes", type=int, default=24)
    p.add_argument("--parity-kills", default="kill@0.9:0.8@server,kill@3.3:0.8@server")
    p.add_argument("--failover-s", type=float, default=14.0)
    p.add_argument("--failover-kills", default="kill@3:1.2@server,kill@8:1.2@server")
    p.add_argument("--failover-budget-s", type=float, default=5.0)
    p.add_argument("--fallback-warm-s", type=float, default=3.0)
    p.add_argument("--fallback-down-s", type=float, default=6.0)
    p.add_argument("--fallback-post-s", type=float, default=6.0)
    p.add_argument("--fallback-after-s", type=float, default=1.0)
    p.add_argument("--quick", action="store_true", help="shorter phases, 1 failover kill, the same invariants")
    # "" = the CUDA device; "cpu" runs the servers, the learner and the fallback on the host
    p.add_argument("--platform", default="", choices=("", "cpu"))
    # how phases 2-3's fleet reaches its envs: gRPC (the reference), or in process
    p.add_argument("--env", default="grpc", choices=("grpc", "local"))
    args = p.parse_args(argv)
    if args.quick:
        args.parity_episodes = 12
        args.parity_kills = "kill@0.9:0.8@server"
        args.failover_s = 9.0
        args.failover_kills = "kill@3:1.2@server"
        args.fallback_down_s = 4.0
        args.fallback_post_s = 5.0
    return args


def cut_args(argv=()) -> argparse.Namespace:
    """`--quick` and the flags in argv, with SMOKE_CUT applied."""
    args = parse_args(["--quick", *argv])
    for k, v in SMOKE_CUT.items():
        setattr(args, k, v)
    return args


def verdict_of(args, artifact: dict) -> dict:
    p1, p2, p3 = artifact["phase_1_parity"], artifact["phase_2_failover"], artifact["phase_3_fallback"]
    cons, learner = artifact["conservation"], artifact["learner"]
    parity_kills = sum(1 for l in p1["serve_lives"] if l.get("killed_at") is not None)
    failover_kills = len(p2["client_recovery_s"])
    fallback_kills = len(p3["kills"] or [])
    watchdog = learner["watchdog"]
    parity_ok = all(e["untouched_prefix_bitwise"] for e in p1["per_env"])
    return {
        "parity_untouched_rows_bitwise": parity_ok and p1["matched_frames_bitwise"] > 0,
        "parity_both_arms_finished": p1["both_arms_finished"],
        "kills_disturbed_episodes": p1["episodes_abandoned_total"] >= 1 and p1["carries_stranded_at_kills"] >= 1,
        "kills_hit_inflight_steps": p1["inflight_step_failures"] >= 1,
        "failover_switched_endpoints": p2["failovers"] >= 1,
        "failover_recovered_under_budget": bool(p2["client_recovery_s"])
        and all(r is not None and r <= args.failover_budget_s for r in p2["client_recovery_s"]),
        "failover_no_fallback_when_off": p2["fallback_engaged_ever"] == 0,
        "fallback_engaged_once": p3["engagements_total"] == 1,
        "fallback_respected_budget": p3["engage_delay_s"] is not None
        and p3["engage_delay_s"] >= args.fallback_after_s * 0.95
        and p3["pre_kill_fallback_steps"] == 0,
        "fallback_generated_during_outage": p3["published_during_outage"] >= 1 and p3["fallback_steps_total"] >= 1,
        "fallback_tree_was_warm": p3["fallback_version_at_engage"] > 0,
        "fallback_disengaged_after_recovery": p3["engaged_at_end"] == 0.0 and p3["remote_steps_resumed_after_restart"],
        # every kill produced ledgered abandons (the clients' exact
        # counters; the servers' stranded carries are an upper bound)
        "abandoned_episodes_ledgered": p1["episodes_abandoned_total"] >= parity_kills
        and p2["episodes_abandoned"] >= failover_kills
        and p3["episodes_abandoned"] >= fallback_kills,
        "server_kills_executed": parity_kills + failover_kills + fallback_kills,
        # the server-side probe gates the one-replica phases only: in
        # failover the reborn replica idles while the sticky client stays
        # on the survivor (client_recovery_s is that phase's gate)
        "all_kills_recovered_serverside": all(r["recovery_s"] is not None
                                              for r in (p1["kills"] or []) + (p3["kills"] or [])),
        "conservation_zero_unaccounted": cons["unaccounted_frames"] == 0,
        "broker_identity_holds": cons["broker_identity_holds"],
        "producer_ledgers_balance": cons["producer_ledgers_balance"],
        "learner_clean_finish": learner["crashed"] is False and not learner["fleet_errors"]
        and not watchdog.get("tripped", False) and int(watchdog.get("trips_total", 0) or 0) == 0,
    }


def run_soak(args, policy=None) -> dict:
    """The three phases; returns the artifact ("verdict" holds the bools,
    "learner_steps" the live learner's steps, "wall_s" each phase's)."""
    from dotaclient_tpu_torch.obs.preflight import check as preflight_check

    policy = tiny_policy() if policy is None else policy
    artifact = {
        "host": f"single host, in-process serve replicas, a tcp experience/weights broker, envs over {args.env}, "
                f"servers and learner on {args.platform or 'the CUDA device'}",
        "host_preflight": preflight_check("soak_serve_chaos"),
        "envs": args.envs,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    wall = {}
    t = time.perf_counter()
    artifact["phase_1_parity"] = phase_parity(args, policy)
    wall["parity"] = round(time.perf_counter() - t, 2)
    print(json.dumps({k: v for k, v in artifact["phase_1_parity"].items() if k not in ("per_env", "serve_lives")}),
          flush=True)
    t = time.perf_counter()
    live = LiveLearner(args, policy, dict(batch_size=8, seq_len=8))
    try:
        artifact["phase_2_failover"] = phase_failover(args, policy, live)
        print(json.dumps(artifact["phase_2_failover"]), flush=True)
        artifact["phase_3_fallback"] = phase_fallback(args, policy, live)
        print(json.dumps(artifact["phase_3_fallback"]), flush=True)
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
