"""Chaos soak (twin of scripts/chaos_soak.py): the closed-loop degradation
proof.

Topology (one host, real tcp transport): N genuine actors (fake env →
featurize → policy → rollout → weight hot-swap) publish through
chaos-wrapped TcpBroker clients into a watermarked BrokerServer; a live
learner (watchdog armed) consumes, trains and fans weights back out.
Three phases against ONE broker lineage:

1. BASELINE: no faults, no overload; the drain capacity and the zero
   points of the stale/bad-drop comparison.
2. CHAOS: the scripted fault schedule: frame corruption and truncation
   (→ quarantine), duplicate delivery, injected resets, latency, a
   stall, and broker KILLS (ScheduleRunner stops and restarts the real
   server; per-kill recovery = restart → first re-enqueued frame).
3. OVERLOAD: a replayer cohort offers ~2x the baseline drain on top of
   the genuine actors: the watermark must shed at admission (producers
   observe BrokerShedError and throttle) and the learner's dropped_bad /
   dropped_stale must not grow against the baseline.

Frame-conservation ledger: every producer counts attempted = acked +
shed + failed; every broker incarnation's exact post-mortem counters
satisfy enqueued = popped + dropped_oldest + resident; and

    unaccounted := popped - reply_lost - staging_consumed

is the one number with nowhere to hide. The verdict asserts it is zero,
beside the shed, quarantine and staging-intake cross-checks.

The learner and the actors run on the CUDA device unless `--platform
cpu`. `run_soak` takes a PolicyConfig, so a caller can run the soak at
another width than the CLI's tiny policy.

Run: python -m dotaclient_tpu_torch.scripts.chaos_soak --out chaos_soak_torch.json
     python -m dotaclient_tpu_torch.scripts.chaos_soak --quick --platform cpu --out /tmp/x.json
"""

from __future__ import annotations

import argparse
import json
import struct
import threading
import time

SENTINEL_WARM_ID = 999_999
# Overload phase: each train step is paced to this many seconds, so the
# learner is the drain bound (see run_soak).
PACE_S = 0.25
# Frame header offsets (transport/serialize.py DTR1/2/3): the version and
# the actor id.
_VERSION_AT, _ACTOR_AT = 4, 13


def tiny_policy():
    from dotaclient_tpu_torch.config import PolicyConfig

    return PolicyConfig(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32")


def make_frames(cfg, n_frames: int):
    """Pre-serialized rollout frames of full length (L = seq_len), drawn
    from make_train_batch's seeded stream (legal actions, valid masks)."""
    from dotaclient_tpu_torch.env import featurizer as F
    from dotaclient_tpu_torch.ops.action_dist import Action
    from dotaclient_tpu_torch.ops.batch import make_train_batch
    from dotaclient_tpu_torch.transport.serialize import Rollout, serialize_rollout

    frames = []
    k = 0
    while len(frames) < n_frames:
        b = make_train_batch(cfg, k)
        k += 1
        for i in range(min(cfg.batch_size, n_frames - len(frames))):
            frames.append(serialize_rollout(Rollout(
                obs=F.Observation(*(x[i] for x in b.obs)), actions=Action(*(a[i] for a in b.actions)),
                behavior_logp=b.behavior_logp[i], behavior_value=b.behavior_value[i], rewards=b.rewards[i],
                dones=b.dones[i], initial_state=(b.initial_state[0][i], b.initial_state[1][i]),
                version=0, actor_id=len(frames),
            )))
    return frames


# ----------------------------------------------------------------- actors


def _run_actor_phase(args, policy, port, duration, n_actors, id_base, chaos_spec, chaos_seed, t0):
    """A pool of genuine actors for `duration`; returns (publish ledger,
    summed chaos meters)."""
    from dotaclient_tpu_torch.config import ActorConfig
    from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
    from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
    from dotaclient_tpu_torch.runtime.actor import Actor
    from dotaclient_tpu_torch.runtime.harness import ActorPool
    from dotaclient_tpu_torch.transport.base import RetryPolicy
    from dotaclient_tpu_torch.transport.tcp import TcpBroker

    def make_actor(i):
        # Short retry window: a publish parked against a killed broker
        # must resolve (land after the restart, or fail and be counted)
        # well within the phase.
        broker = TcpBroker(port=port, retry=RetryPolicy(window_s=8.0))
        if chaos_spec:
            from dotaclient_tpu_torch.chaos import ChaosBroker, FaultSchedule

            # per-actor seed offset: distinct deterministic fault streams
            sched = FaultSchedule.parse(chaos_spec, seed=chaos_seed + i)
            broker = ChaosBroker(broker, sched, t0=t0)
        acfg = ActorConfig(
            env_addr="local",
            rollout_len=args.seq_len,
            max_dota_time=4.0,
            policy=policy,
            seed=100 + id_base + i,
            max_weight_age_s=0.0,  # kills legitimately pause broadcasts
            platform=args.platform,
        )
        return Actor(acfg, broker, actor_id=id_base + i, stub=LocalDotaServiceStub(FakeDotaService()))

    pool = ActorPool(make_actor, n_actors).start()
    time.sleep(duration)
    pool.stop(timeout=30.0)
    ledger = pool.publish_stats()
    ledger["attempted"] = ledger["published"] + ledger["shed"] + ledger["failed"]
    meters = {}
    for a in pool.actors:
        if getattr(a.broker, "meters", None):
            for k, v in a.broker.stats().items():
                if k.startswith("chaos_"):
                    meters[k] = meters.get(k, 0) + v
    return ledger, meters


# -------------------------------------------------------------- replayers


def _replayer(idx, port, duration, version_fn, frames, out):
    """Overload publisher: offers as fast as the broker accepts; every
    shed is honored with a jittered exponential backoff, so the offered
    load settles at drain + shed instead of at the drop-oldest cliff."""
    from dotaclient_tpu_torch.transport.base import BrokerShedError, RetryPolicy
    from dotaclient_tpu_torch.transport.tcp import TcpBroker

    policy = RetryPolicy(window_s=5.0)
    broker = TcpBroker(port=port, retry=policy)
    backoff = policy.backoff_base_s
    attempted = acked = shed = failed = 0
    throttle_s = 0.0
    t0 = time.monotonic()
    i = 0
    while time.monotonic() - t0 < duration:
        fr = bytearray(frames[i % len(frames)])
        i += 1
        struct.pack_into("<I", fr, _VERSION_AT, version_fn())  # fresh version stamp
        struct.pack_into("<I", fr, _ACTOR_AT, 5000 + idx)
        attempted += 1
        try:
            broker.publish_experience(bytes(fr))
            acked += 1
            backoff = policy.backoff_base_s
        except BrokerShedError:
            shed += 1
            d = policy.sleep_for(backoff)
            backoff = policy.next_backoff(backoff)
            throttle_s += d
            time.sleep(d)
        except (ConnectionError, OSError):
            failed += 1
            time.sleep(policy.sleep_for(backoff))
            backoff = policy.next_backoff(backoff)
    broker.close()
    wall = time.monotonic() - t0
    out[idx] = {
        "attempted": attempted,
        "acked": acked,
        "shed": shed,
        "failed": failed,
        "throttle_s": round(throttle_s, 3),
        # unthrottled offer capacity: with a working throttle the raw
        # offered rate converges to the drain, so the pressure claim is
        # judged on what the producers push while not backing off
        "pressure_fps": round(attempted / max(wall - throttle_s, 1e-9), 1),
    }


# ------------------------------------------------------------------ main


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="chaos_soak_torch.json")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--actors", type=int, default=3)
    p.add_argument("--replayers", type=int, default=4)
    p.add_argument("--batch-size", dest="batch_size", type=int, default=16)
    p.add_argument("--seq-len", dest="seq_len", type=int, default=8)
    p.add_argument("--baseline-s", dest="baseline_s", type=float, default=20.0)
    p.add_argument("--chaos-s", dest="chaos_s", type=float, default=50.0)
    p.add_argument("--overload-s", dest="overload_s", type=float, default=20.0)
    p.add_argument("--kills", default="10:3,25:3,40:3",
                   help="comma list of at:down_s broker kills inside the chaos phase")
    p.add_argument("--faults",
                   default="corrupt:0.015,truncate:0.008,dup:0.015,reset:0.006,latency:0.001~0.001,stall@16:2",
                   help="per-op fault clauses for the chaos phase (chaos/schedule.py grammar)")
    # Watermarks sized to the staleness budget: shed_high of 3 batches
    # bounds the queue wait at ~3 learner versions.
    p.add_argument("--maxlen", type=int, default=256)
    p.add_argument("--shed-high", dest="shed_high", type=int, default=48)
    p.add_argument("--shed-low", dest="shed_low", type=int, default=16)
    p.add_argument("--quick", action="store_true", help="short phases, 1 kill, the same invariants")
    # "" = the CUDA device; "cpu" runs the learner and the actors on the host
    p.add_argument("--platform", default="", choices=("", "cpu"))
    args = p.parse_args(argv)
    if args.quick:
        args.baseline_s, args.chaos_s, args.overload_s = 6.0, 16.0, 8.0
        args.kills = "4:2"
        args.actors = 2
        args.replayers = 2
    return args


def run_soak(args, policy=None) -> dict:
    """The three phases; returns the artifact (its "verdict" holds the
    bools). `policy` defaults to the tiny one."""
    from dotaclient_tpu_torch.chaos import BrokerIncarnations, FaultSchedule, ScheduleRunner
    from dotaclient_tpu_torch.config import LearnerConfig, ObsConfig, PPOConfig, WatchdogConfig
    from dotaclient_tpu_torch.obs.preflight import check as preflight_check
    from dotaclient_tpu_torch.runtime.learner import Learner
    from dotaclient_tpu_torch.transport.base import RetryPolicy
    from dotaclient_tpu_torch.transport.tcp import TcpBroker

    policy = tiny_policy() if policy is None else policy
    # a leftover broker or server would skew the host budget and could
    # cross-talk with this run's tcp traffic
    host_preflight = preflight_check("chaos_soak")

    kill_clauses = ",".join(f"kill@{c.split(':')[0]}:{c.split(':')[1]}" for c in args.kills.split(",") if c)
    chaos_spec = f"{args.faults},{kill_clauses}"
    schedule = FaultSchedule.parse(chaos_spec, seed=args.seed)

    lcfg = LearnerConfig(
        batch_size=args.batch_size,
        seq_len=args.seq_len,
        policy=policy,
        publish_every=1,
        metrics_every=5,
        platform=args.platform,
        # A small learner advances versions far faster than the actors poll
        # weights: the default 4-version staleness window would drop frames
        # for config reasons and hide the conservation story. A wide window
        # keeps dropped_stale about transport behavior.
        ppo=PPOConfig(max_staleness=256),
        obs=ObsConfig(
            enabled=True,
            install_handlers=False,  # the soak owns its signal handling
            step_phases=False,  # keep the pipelined loop
            watchdog=WatchdogConfig(enabled=True, interval_s=2.0, stall_s=30.0),
        ),
    )

    inc = BrokerIncarnations(port=0, maxlen=args.maxlen, shed_high=args.shed_high, shed_low=args.shed_low)
    port = inc.port
    artifact = {
        "host": f"single host, real tcp transport, learner on {args.platform or 'the CUDA device'}",
        "host_preflight": host_preflight,
        "seed": args.seed,
        "spec": chaos_spec,
        "policy": {"unit_embed_dim": policy.unit_embed_dim, "lstm_hidden": policy.lstm_hidden,
                   "mlp_hidden": policy.mlp_hidden, "dtype": policy.dtype},
        "watermarks": {"maxlen": args.maxlen, "shed_high": args.shed_high, "shed_low": args.shed_low},
        "batch": f"{lcfg.batch_size}x{lcfg.seq_len}",
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    producers = {}
    learner_crashed = None
    try:
        learner = Learner(lcfg, TcpBroker(port=port, retry=RetryPolicy()),
                          device="cpu" if args.platform == "cpu" else None)

        # One step outside every measured window; a sentinel actor id keeps
        # the warm frames out of the heartbeat gauge, and the warm
        # publisher's ledger keeps them in the conservation math.
        frames = make_frames(lcfg, 64)
        warm_pub = TcpBroker(port=port)
        n_warm = lcfg.batch_size + 4
        for i in range(n_warm):
            fr = bytearray(frames[i % len(frames)])
            struct.pack_into("<I", fr, _ACTOR_AT, SENTINEL_WARM_ID)
            warm_pub.publish_experience(bytes(fr))
        warm_pub.close()
        producers["warmup"] = {"attempted": n_warm, "acked": n_warm, "shed": 0, "failed": 0}
        learner.run(num_steps=1, batch_timeout=120.0)
        print("learner warm", flush=True)

        def staging_snap():
            s = learner.staging.stats()
            return {k: s[k] for k in ("consumed", "dropped_stale", "dropped_bad", "quarantined", "rows_packed")}

        # ---------------- phase 1: baseline ------------------------------
        snap0 = staging_snap()
        t_p1 = time.monotonic()
        pool_ledger = {}

        def phase1_actors():
            pool_ledger["p1"] = _run_actor_phase(args, policy, port, args.baseline_s, args.actors, 0, None, 0, None)

        th = threading.Thread(target=phase1_actors)
        th.start()
        learner.run(max_seconds=args.baseline_s + 2.0, batch_timeout=2.0)
        th.join(timeout=60)
        wall1 = time.monotonic() - t_p1
        snap1 = staging_snap()
        baseline = {
            "duration_s": round(wall1, 1),
            "consumed_frames_per_sec": round((snap1["consumed"] - snap0["consumed"]) / wall1, 1),
            "dropped_bad_delta": snap1["dropped_bad"] - snap0["dropped_bad"],
            "dropped_stale_delta": snap1["dropped_stale"] - snap0["dropped_stale"],
            "publish": pool_ledger["p1"][0],
        }
        producers["baseline_actors"] = pool_ledger["p1"][0]
        artifact["phase_1_baseline"] = baseline
        print(json.dumps(baseline), flush=True)

        # ---------------- phase 2: chaos ---------------------------------
        snap1b = staging_snap()
        t0 = time.monotonic()
        runner = ScheduleRunner(schedule, inc, t0).start()

        def phase2_actors():
            pool_ledger["p2"] = _run_actor_phase(args, policy, port, args.chaos_s, args.actors, 100, chaos_spec,
                                                 args.seed, t0)

        th = threading.Thread(target=phase2_actors)
        th.start()
        learner.run(max_seconds=args.chaos_s + 2.0, batch_timeout=2.0)
        th.join(timeout=90)
        runner.stop()
        # Inter-phase drain: the chaos actors kept publishing briefly after
        # the learner's window closed; clear that residue so the overload
        # phase's sheds are its own.
        learner.run(max_seconds=3.0, batch_timeout=0.5)
        snap2 = staging_snap()
        p2_ledger, p2_meters = pool_ledger["p2"]
        producers["chaos_actors"] = p2_ledger
        artifact["phase_2_chaos"] = {
            "duration_s": args.chaos_s,
            "kills": runner.recovery,
            "injected": p2_meters,
            "publish": p2_ledger,
            "quarantined_delta": snap2["quarantined"] - snap1b["quarantined"],
            "dropped_bad_delta": snap2["dropped_bad"] - snap1b["dropped_bad"],
        }
        print(json.dumps(artifact["phase_2_chaos"]), flush=True)

        # ---------------- phase 3: overload ------------------------------
        # Drain-budget pin: a small learner drains far faster than
        # in-process publishers can offer, which would make "2x the drain"
        # unreachable and the watermark untestable. Pacing the train step
        # emulates the production regime where the learner is the drain
        # bound; admission control is a broker property and does not care
        # why the consumer runs at that speed.
        unpaced_train_step = learner.train_step

        def paced_train_step(state, batch):
            time.sleep(PACE_S)
            return unpaced_train_step(state, batch)

        learner.train_step = paced_train_step
        snap2b = staging_snap()
        rep_out = {}
        rep_threads = [
            threading.Thread(target=_replayer, args=(i, port, args.overload_s, lambda: learner.version, frames, rep_out))
            for i in range(args.replayers)
        ]
        t_p3 = time.monotonic()
        for t in rep_threads:
            t.start()

        def phase3_actors():
            pool_ledger["p3"] = _run_actor_phase(args, policy, port, args.overload_s, args.actors, 200, None, 0, None)

        th = threading.Thread(target=phase3_actors)
        th.start()
        learner.run(max_seconds=args.overload_s + 2.0, batch_timeout=2.0)
        th.join(timeout=60)
        for t in rep_threads:
            t.join(timeout=60)
        learner.train_step = unpaced_train_step
        wall3 = time.monotonic() - t_p3
        snap3 = staging_snap()
        p3_ledger, _ = pool_ledger["p3"]
        producers["overload_actors"] = p3_ledger
        rep_totals = {k: sum(r[k] for r in rep_out.values()) for k in ("attempted", "acked", "shed", "failed")}
        rep_totals["throttle_s"] = round(sum(r["throttle_s"] for r in rep_out.values()), 3)
        producers["overload_replayers"] = rep_totals
        offered_fps = (rep_totals["attempted"] + p3_ledger["attempted"]) / wall3
        pressure_fps = sum(r["pressure_fps"] for r in rep_out.values()) + p3_ledger["attempted"] / wall3
        drained_fps = (snap3["consumed"] - snap2b["consumed"]) / wall3
        overload = {
            "duration_s": round(wall3, 1),
            "drain_budget": f"train step paced to {PACE_S * 1000:.0f}ms (the learner as the drain bound)",
            "offered_frames_per_sec": round(offered_fps, 1),
            "pressure_frames_per_sec": round(pressure_fps, 1),
            "drained_frames_per_sec": round(drained_fps, 1),
            "pressure_to_drain_ratio": round(pressure_fps / max(drained_fps, 1e-9), 2),
            "replayers": rep_totals,
            "actors": p3_ledger,
            "dropped_bad_delta": snap3["dropped_bad"] - snap2b["dropped_bad"],
            "dropped_stale_delta": snap3["dropped_stale"] - snap2b["dropped_stale"],
        }
        artifact["phase_3_overload"] = overload
        print(json.dumps(overload), flush=True)

        watchdog = learner.obs.watchdog.verdict() if learner.obs and learner.obs.watchdog else {}
        learner.staging.stop()
        staging_stats = learner.staging.stats()
        steps = int(learner.version)
        learner.close()
        learner_crashed = False
    except Exception as e:
        learner_crashed = f"{type(e).__name__}: {e}"
        raise
    finally:
        broker_total = inc.final_ledger()

    # ---------------- conservation ledger --------------------------------
    per_incarnation_ok = all(l["enqueued"] == l["popped"] + l["dropped_oldest"] + l["resident"] for l in inc.ledgers)
    producer_totals = {k: sum(int(p.get(k, 0)) for p in producers.values()) for k in ("attempted", "acked", "shed", "failed")}
    producer_totals["acked"] = sum(int(p.get("acked", p.get("published", 0))) for p in producers.values())
    producer_ledgers_ok = all(
        int(p.get("attempted", 0))
        == int(p.get("acked", p.get("published", 0))) + int(p.get("shed", 0)) + int(p.get("failed", 0))
        for p in producers.values()
    )
    chaos_meters = artifact["phase_2_chaos"]["injected"]
    dup_extras = int(chaos_meters.get("chaos_duplicated", 0))
    chaos_sheds = int(chaos_meters.get("chaos_sheds", 0))
    retransmit_extras = broker_total["enqueued"] - producer_totals["acked"] - dup_extras
    unaccounted = broker_total["popped"] - broker_total["reply_lost"] - staging_stats["consumed"]
    staging_leftover = int(staging_stats["pending_rollouts"])
    staging_balance = (staging_stats["consumed"] - staging_stats["dropped_stale"] - staging_stats["dropped_bad"]
                       - staging_stats["rows_packed"] - staging_leftover)
    conservation = {
        "producers": producers,
        "producer_totals": producer_totals,
        "broker": broker_total,
        "staging": {k: int(staging_stats[k])
                    for k in ("consumed", "dropped_stale", "dropped_bad", "quarantined", "rows_packed")},
        "staging_pending_leftover": staging_leftover,
        "dup_extras_injected": dup_extras,
        "at_least_once_retransmit_extras": retransmit_extras,
        "shed_cross_check": {
            "producers_observed": producer_totals["shed"],
            "broker_refused": broker_total["shed"],
            "chaos_injected": chaos_sheds,
            "balanced": producer_totals["shed"] == broker_total["shed"] + chaos_sheds,
        },
        "per_incarnation_identity_holds": per_incarnation_ok,
        "producer_ledgers_balance": producer_ledgers_ok,
        "died_with_broker": broker_total["resident"] + broker_total["reply_lost"],
        "staging_intake_balance": staging_balance,
        "unaccounted_frames": unaccounted,
    }
    artifact["conservation"] = conservation
    artifact["learner"] = {
        "versions_trained": int(staging_stats["batches"]),
        "steps": steps,
        "crashed": learner_crashed,
        "watchdog": watchdog,
        "quarantined_total": int(staging_stats["quarantined"]),
    }
    kills_recovered = [k for k in artifact["phase_2_chaos"]["kills"] if k["recovery_s"] is not None]
    n_kills = len(inc.kill_times)
    poison_injected = int(chaos_meters.get("chaos_corrupted", 0)) + int(chaos_meters.get("chaos_truncated", 0))
    artifact["verdict"] = {
        "conservation_zero_unaccounted": unaccounted == 0,
        "per_incarnation_identity_holds": per_incarnation_ok,
        "producer_ledgers_balance": producer_ledgers_ok,
        "shed_cross_check_balanced": conservation["shed_cross_check"]["balanced"],
        "staging_intake_balanced": staging_balance == 0,
        "no_silent_drop_oldest": broker_total["dropped_oldest"] == 0,
        "kills_executed": n_kills,
        "recovered_after_all_kills": len(kills_recovered) == n_kills and n_kills > 0,
        "overload_at_2x_drain": overload["pressure_to_drain_ratio"] >= 2.0,
        "sheds_at_admission": broker_total["shed"] > 0,
        "producers_observed_shed_and_throttled": (
            producer_totals["shed"] > 0 and producers["overload_replayers"]["throttle_s"] > 0
        ),
        "overload_no_bad_growth": overload["dropped_bad_delta"] <= baseline["dropped_bad_delta"],
        "overload_no_stale_growth": overload["dropped_stale_delta"] <= max(baseline["dropped_stale_delta"], 2),
        # Lower bound with per-kill slack (delivered poison can die
        # resident in a killed broker), floor 0: a short run can inject no
        # poison. Upper bound exact: only injected poison (possibly
        # duplicated) quarantines.
        "quarantine_caught_poison": (
            artifact["phase_2_chaos"]["quarantined_delta"] >= max(poison_injected - 2 * n_kills, 0)
            and int(staging_stats["quarantined"]) <= poison_injected + dup_extras
        ),
        "learner_clean_finish": learner_crashed is False
        and not watchdog.get("tripped", False)
        and int(watchdog.get("trips_total", 0) or 0) == 0,
    }
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
