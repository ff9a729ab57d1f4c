"""Resume soak (twin of scripts/resume_soak.py): the preemption-tolerance
proof.

Three parts, one artifact:

PART A: determinism (lockstep over mem://, the replay reservoir on). A
reference run and a kill run train on the same deterministic frame
schedule, one chunk (one train step) at a time, so every batch's rows
(fresh, reservoir, the reservoir's draws) are a function of the restored
state. The kill run dies twice:

  - SIGTERM after step T1: the drain saves the full state (params, Adam,
    the reservoir with its priorities and RNG, 5 staged pending frames,
    the version high-water) and waits for it. The param and Adam hashes
    and the losses must then be bit-exact against the uninterrupted run
    for `parity_steps` steps.
  - SIGKILL after step T2: nothing is saved at death; the next life
    restores the last periodic checkpoint, and the published high-water
    bumps its counter back to T2, so version stamps stay monotonic. The
    loss diverges boundedly; frames are conserved exactly.

Conservation: every acked frame is consumed by some life or still on the
broker at the end; every life's staging intake and reservoir balance
exactly (in-process deaths leave the dead life's counters readable).

PART B: ride-through (tcp://, real actors). An ActorPool publishes
through a BrokerServer while a ScheduleRunner runs `kill@T:D@learner:term`
and `kill@T:D@learner:kill` against LearnerIncarnations. The actors'
ledgers balance, the broker sheds and never drops silently, recovery
lands inside the budget, and every popped frame is a life's.

PART C: inertness (a subprocess). With the --ckpt.* defaults the
checkpoint directory holds only the plain per-step arrays (no aux
manifest, no version_hwm), `dotaclient_tpu_torch.chaos` is never
imported, no SIGTERM handler is installed, and no async-save machinery
exists.

The learners and the actors run on the CUDA device unless `--platform
cpu`. Each `run_part_*` takes a PolicyConfig (None: the soak's tiny one).

Run: python -m dotaclient_tpu_torch.scripts.resume_soak --out resume_soak_torch.json
     python -m dotaclient_tpu_torch.scripts.resume_soak --quick --platform cpu --out /tmp/x.json
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
import subprocess
import sys
import tempfile
import time

from dotaclient_tpu_torch.scripts.chaos_soak import _VERSION_AT, make_frames, tiny_policy

REPLAY_TARGET = 2  # reservoir rows per batch in part A (ratio 2/16)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _device(platform: str):
    return "cpu" if platform == "cpu" else None


def state_hash(state) -> str:
    """sha256 over every array of the train state (params, Adam moments,
    count, step), in name order."""
    from dotaclient_tpu_torch.runtime.checkpoint import state_arrays

    import numpy as np

    h = hashlib.sha256()
    arrays = state_arrays(state)
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def _staging_ledger(learner, resume: dict) -> dict:
    """One life's intake ledger, read while the object is still alive."""
    s = learner.staging.stats()
    return {
        "consumed": int(s["consumed"]),
        "dropped_stale": int(s["dropped_stale"]),
        "dropped_bad": int(s["dropped_bad"]),
        "rows_packed": int(s["rows_packed"]),
        "rows_replayed": int(s.get("rows_replayed", 0)),
        "replay_admitted": int(s.get("replay_admitted", 0)),
        "replay_evicted": int(s.get("replay_evicted", 0)),
        "replay_expired": int(s.get("replay_expired", 0)),
        "replay_retired": int(s.get("replay_retired", 0)),
        "reservoir_occupancy": int(s.get("replay_occupancy", 0)),
        "pending": int(s["pending_rollouts"]),
        "resume_pending": int(resume.get("resume_pending_frames", 0)),
        "resume_reservoir": int(resume.get("resume_reservoir_entries", 0)),
        "version": int(learner.version),
    }


def intake_balance(led: dict, pending_key: str = "pending") -> int:
    """consumed + restored pending - every counted fate: zero or bust."""
    fresh_rows = led["rows_packed"] - led["rows_replayed"]
    return (led["consumed"] + led["resume_pending"] - led["dropped_stale"] - led["dropped_bad"] - fresh_rows
            - led[pending_key] - led["replay_admitted"])


def _reservoir_balance(led: dict) -> int:
    """admitted + restored == resident + evicted + expired + retired."""
    return (led["replay_admitted"] + led["resume_reservoir"] - led["reservoir_occupancy"] - led["replay_evicted"]
            - led["replay_expired"] - led["replay_retired"])


# ---------------------------------------------------------------- part A


def _make_cfg_a(args, policy, ckpt_dir):
    from dotaclient_tpu_torch.config import LearnerConfig, ObsConfig, PPOConfig, ReplayConfig, WatchdogConfig

    cfg = LearnerConfig(
        batch_size=args.batch_size,
        seq_len=args.seq_len,
        policy=policy,
        ppo=PPOConfig(max_staleness=4),
        replay=ReplayConfig(
            enabled=True,
            ratio=REPLAY_TARGET / args.batch_size,
            max_staleness=100_000,  # the soak's stale seeds must never expire
            max_replays=0,  # entries stay resident: occupancy (and k) constant
        ),
        checkpoint_dir=ckpt_dir,
        checkpoint_every=args.checkpoint_every,
        publish_every=1,
        metrics_every=1,
        platform=args.platform,
        obs=ObsConfig(
            enabled=True,
            install_handlers=False,  # the soak owns its signal handling
            step_phases=False,
            watchdog=WatchdogConfig(enabled=True, interval_s=2.0, stall_s=60.0),
        ),
    )
    cfg.ckpt.full_state = True
    cfg.ckpt.async_save = True
    return cfg


class _Feeder:
    """Deterministic lockstep publisher: a frame's content is a function of
    its pool index, stamped with the learner's current version, so the
    reference run and the kill run see the same stream."""

    def __init__(self, broker, frames):
        self.broker = broker
        self.frames = frames
        self.cursor = 0
        self.attempted = 0
        self.acked = 0

    def publish(self, n: int, version: int, stamp_version=None):
        for _ in range(n):
            fr = bytearray(self.frames[self.cursor % len(self.frames)])
            self.cursor += 1
            struct.pack_into("<I", fr, _VERSION_AT, version if stamp_version is None else stamp_version)
            self.attempted += 1
            self.broker.publish_experience(bytes(fr))
            self.acked += 1


def _ingest_pending(learner, n: int, timeout: float = 20.0) -> None:
    """Run the staging consumer just long enough to pull exactly the n
    staged frames off the broker into its pending list, then stop it."""
    learner.staging.start()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if learner.staging.stats()["pending_rollouts"] >= n:
            break
        time.sleep(0.02)
    learner.staging.stop()
    got = learner.staging.stats()["pending_rollouts"]
    assert got == n, f"staged {got} != {n} pending frames"


def _run_part_a_once(args, policy, frames, kills: bool) -> dict:
    """One lockstep run over the frame schedule; kills=True drains with
    SIGTERM after step term_at and dies with SIGKILL after step kill_at.
    Each boot and each death records the state's hash."""
    from dotaclient_tpu_torch.runtime.checkpoint import Checkpointer
    from dotaclient_tpu_torch.runtime.learner import Learner
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.memory import MemoryBroker

    name = f"resume-{'kills' if kills else 'ref'}"
    mem.reset(name)
    ckpt_dir = tempfile.mkdtemp(prefix=f"resume_soak_{'k' if kills else 'r'}_")
    cfg = _make_cfg_a(args, policy, ckpt_dir)
    feeder = _Feeder(MemoryBroker(name, maxlen=65536), frames)
    out = {"hashes": {}, "losses": {}, "lives": [], "boots": [], "watchdog": None, "ckpt_dir": ckpt_dir, "steps": 0}

    def boot():
        t0 = time.monotonic()
        learner = Learner(cfg, MemoryBroker(name, maxlen=65536), device=_device(args.platform))
        out["boots"].append({"construct_s": round(time.monotonic() - t0, 3), "resume": learner.resume_info,
                             "version": int(learner.version), "state_hash": state_hash(learner.state)})
        return learner

    def train_one(learner):
        done = learner.run(num_steps=1, batch_timeout=60.0)
        assert done == 1, f"lockstep chunk trained {done} steps"
        out["steps"] += 1
        out["hashes"][learner.version] = state_hash(learner.state)
        out["losses"][learner.version] = float(learner.metrics.latest().get("loss", float("nan")))

    learner = boot()
    B = args.batch_size
    # Warm: the reservoir is empty, every batch is B fresh rows.
    for _ in range(args.warm_steps):
        feeder.publish(B, learner.version)
        train_one(learner)
    # Seed the reservoir: frames stamped version 1, `warm` versions behind,
    # go through the staleness filter into the reservoir, never into a
    # batch as fresh rows.
    feeder.publish(args.reservoir_seed, learner.version, stamp_version=1)
    # From here every batch is (B - REPLAY_TARGET) fresh rows and
    # REPLAY_TARGET reservoir rows (max_replays=0: occupancy is constant).
    fresh_n = B - REPLAY_TARGET
    for step in range(args.warm_steps + 1, args.steps + 1):
        if step == args.term_at + 1:
            # Stage (but do not train) a sub-batch, so the drain has pending
            # frames to keep; the reference run gets the same publishes and
            # the same ingest pause at the same point.
            feeder.publish(args.pending_extras, learner.version)
            _ingest_pending(learner, args.pending_extras)
            if kills:
                t_kill = time.monotonic()
                learner.drain_save()
                led = _staging_ledger(learner, out["boots"][-1]["resume"])
                led.update(sig="term", death_wall_s=round(time.monotonic() - t_kill, 3),
                           state_hash=state_hash(learner.state))
                out["lives"].append(led)
                learner.close()
                learner = boot()
            feeder.publish(fresh_n - args.pending_extras, learner.version)
            train_one(learner)
            continue
        if kills and step == args.kill_at + 1:
            # SIGKILL between chunks: the queued async and mirror work is
            # discarded; the next life restores the last periodic checkpoint
            # and the high-water file bumps its counter to the published
            # front.
            led = _staging_ledger(learner, out["boots"][-1]["resume"])
            led.update(sig="kill", death_wall_s=0.0, published_hwm=Checkpointer(ckpt_dir).published_hwm())
            out["lives"].append(led)
            learner.discard_unsaved()
            learner.close()
            learner = boot()
            assert learner.version == args.kill_at, (
                f"the hwm bump must land the restored counter at the published front: {learner.version} != "
                f"{args.kill_at}")
        feeder.publish(fresh_n, learner.version)
        train_one(learner)

    out["watchdog"] = learner.obs.watchdog.verdict() if learner.obs and learner.obs.watchdog else {}
    led = _staging_ledger(learner, out["boots"][-1]["resume"])
    led.update(sig="end", death_wall_s=0.0)
    out["lives"].append(led)
    out["feeder"] = {"attempted": feeder.attempted, "acked": feeder.acked}
    out["broker_depth_end"] = feeder.broker.experience_depth()
    learner.close()
    return out


def _part_a_conservation(run: dict) -> dict:
    lives = run["lives"]
    consumed = sum(l["consumed"] for l in lives)
    return {
        "acked": run["feeder"]["acked"],
        "consumed_all_incarnations": consumed,
        "broker_resident_end": run["broker_depth_end"],
        "unaccounted_frames": run["feeder"]["acked"] - consumed - run["broker_depth_end"],
        "intake_balances": [intake_balance(l) for l in lives],
        "reservoir_balances": [_reservoir_balance(l) for l in lives],
    }


def run_part_a(args, policy=None) -> dict:
    from dotaclient_tpu_torch.config import LearnerConfig

    policy = tiny_policy() if policy is None else policy
    frames = make_frames(LearnerConfig(batch_size=args.batch_size, seq_len=args.seq_len, policy=policy), 256)
    ref = _run_part_a_once(args, policy, frames, kills=False)
    kil = _run_part_a_once(args, policy, frames, kills=True)

    parity_versions = list(range(args.term_at + 1, args.term_at + 1 + args.parity_steps))
    bit_exact = all(ref["hashes"][v] == kil["hashes"][v] for v in parity_versions)
    loss_parity = all(ref["losses"][v] == kil["losses"][v] for v in parity_versions)
    post_kill = list(range(args.kill_at + 1, args.steps + 1))
    divergence = [abs(ref["losses"][v] - kil["losses"][v]) for v in post_kill]
    finite = all(d == d and d != float("inf") for d in divergence)
    term_life = next(l for l in kil["lives"] if l["sig"] == "term")
    kill_boot = kil["boots"][2]
    return {
        "frame_schedule": {
            "steps": args.steps,
            "warm": args.warm_steps,
            "batch": f"{args.batch_size}x{args.seq_len}",
            "replay_rows_per_batch": REPLAY_TARGET,
            "reservoir_seed_frames": args.reservoir_seed,
            "term_kill_after_step": args.term_at,
            "sigkill_after_step": args.kill_at,
            "checkpoint_every": args.checkpoint_every,
            "steps_trained": ref["steps"] + kil["steps"],
        },
        "sigterm": {
            "drain_wall_s": term_life["death_wall_s"],
            "pending_preserved": term_life["pending"],
            "resume": kil["boots"][1]["resume"],
            "restart_construct_s": kil["boots"][1]["construct_s"],
            "parity_versions": parity_versions,
            "bit_exact_param_opt_hashes": bit_exact,
            "loss_parity": loss_parity,
            "restore_bitwise": term_life["state_hash"] == kil["boots"][1]["state_hash"],
        },
        "sigkill": {
            "resume": kill_boot["resume"],
            "restart_construct_s": kill_boot["construct_s"],
            "restored_step": kill_boot["resume"].get("resume_restored_step"),
            "version_hwm_bump": kill_boot["resume"].get("resume_version_hwm_bump"),
            "steps_lost_to_kill": int(args.kill_at - kill_boot["resume"].get("resume_restored_step", args.kill_at)),
            "published_hwm": next(l for l in kil["lives"] if l["sig"] == "kill")["published_hwm"],
            "resumed_at_version": kill_boot["version"],
            "post_kill_loss_divergence_max": max(divergence) if divergence else 0.0,
            "divergence_finite": finite,
        },
        "reference": {"lives": ref["lives"], "feeder": ref["feeder"], "watchdog": ref["watchdog"]},
        "killed": {"lives": kil["lives"], "boots": kil["boots"], "feeder": kil["feeder"], "watchdog": kil["watchdog"]},
        "conservation_reference": _part_a_conservation(ref),
        "conservation_killed": _part_a_conservation(kil),
    }


# ---------------------------------------------------------------- part B


def run_part_b(args, policy=None) -> dict:
    from dotaclient_tpu_torch.chaos import FaultSchedule, LearnerIncarnations, ScheduleRunner
    from dotaclient_tpu_torch.config import (ActorConfig, LearnerConfig, ObsConfig, PPOConfig, ReplayConfig,
                                             WatchdogConfig)
    from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
    from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
    from dotaclient_tpu_torch.runtime.actor import Actor
    from dotaclient_tpu_torch.runtime.harness import ActorPool
    from dotaclient_tpu_torch.runtime.learner import Learner
    from dotaclient_tpu_torch.transport.base import RetryPolicy
    from dotaclient_tpu_torch.transport.tcp import BrokerServer, TcpBroker

    policy = tiny_policy() if policy is None else policy
    server = BrokerServer(port=0, maxlen=4096, shed_high=args.shed_high, shed_low=args.shed_low).start()
    ckpt_dir = tempfile.mkdtemp(prefix="resume_soak_b_")
    # The batch is sized to the fleet's offered rate: 2 actors fill an 8x4
    # batch in well under a second, so the recovery probe (restart to the
    # first trained step) measures the transport and the restore, not
    # data starvation.
    b_batch, b_seq = 8, 4

    def make_learner():
        cfg = LearnerConfig(
            batch_size=b_batch,
            seq_len=b_seq,
            policy=policy,
            ppo=PPOConfig(max_staleness=64),
            replay=ReplayConfig(enabled=True, ratio=0.25, max_staleness=100_000, byte_budget=16 << 20),
            checkpoint_dir=ckpt_dir,
            checkpoint_every=20,
            publish_every=1,
            metrics_every=5,
            platform=args.platform,
            obs=ObsConfig(enabled=True, install_handlers=False, step_phases=False,
                          watchdog=WatchdogConfig(enabled=True, interval_s=2.0, stall_s=60.0)),
        )
        cfg.ckpt.full_state = True
        cfg.ckpt.async_save = True
        return Learner(cfg, TcpBroker(port=server.port, retry=RetryPolicy(window_s=8.0)), device=_device(args.platform))

    inc = LearnerIncarnations(make_learner, run_kwargs={"batch_timeout": 1.0}).start()

    def make_actor(i):
        acfg = ActorConfig(env_addr="local", rollout_len=b_seq, max_dota_time=4.0, policy=policy, seed=300 + i,
                           max_weight_age_s=0.0,  # learner deaths pause the broadcasts
                           platform=args.platform)
        return Actor(acfg, TcpBroker(port=server.port, retry=RetryPolicy(window_s=8.0)), actor_id=300 + i,
                     stub=LocalDotaServiceStub(FakeDotaService()))

    pool = ActorPool(make_actor, args.actors).start()
    # Warm gate: the schedule's epoch starts once the first life has
    # trained (version >= 2), so its first-call set-up never eats the kill
    # offsets.
    warm_deadline = time.monotonic() + 180.0
    while inc.learner.version < 2 and time.monotonic() < warm_deadline:
        time.sleep(0.1)
    warm_version = int(inc.learner.version)
    t0 = time.monotonic()
    spec = f"kill@{args.b_term_at}:{args.b_down_s}@learner:term,kill@{args.b_kill_at}:{args.b_down_s}@learner:kill"
    runner = ScheduleRunner(FaultSchedule.parse(spec, seed=args.seed), None, t0, learner=inc).start()
    time.sleep(args.b_duration_s)
    # the runner finishes an in-flight kill and its recovery probe before
    # the teardown: a slow start slips the schedule, never cuts it
    if runner._thread is not None:
        runner._thread.join(timeout=150.0)
    runner.stop()
    pool.stop(timeout=30.0)
    actor_ledger = pool.publish_stats()
    actor_ledger["attempted"] = actor_ledger["published"] + actor_ledger["shed"] + actor_ledger["failed"]
    totals = inc.final_ledger()
    final_life = inc.lives[-1]
    server.stop()
    broker = server.ledger()
    return {
        "spec": spec,
        "duration_s": args.b_duration_s,
        "actors": args.actors,
        "batch": f"{b_batch}x{b_seq}",
        "warm_gate_version": warm_version,
        "watermarks": {"maxlen": 4096, "shed_high": args.shed_high, "shed_low": args.shed_low},
        "kills": runner.recovery,
        "lives": inc.lives,
        "boots": inc.boots,
        "actor_ledger": actor_ledger,
        "broker_ledger": broker,
        "conservation": {
            "unaccounted_frames": broker["popped"] - broker["reply_lost"] - totals["consumed"],
            "intake_balances": [intake_balance(l, "pending_at_death") for l in inc.lives],
            "broker_identity": broker["enqueued"] == broker["popped"] + broker["dropped_oldest"] + broker["resident"],
            "actor_ledger_balances": actor_ledger["attempted"]
            == actor_ledger["published"] + actor_ledger["shed"] + actor_ledger["failed"],
        },
        "watchdog_final": final_life.get("watchdog", {}),
    }


def part_b_steps(part_b: dict) -> int:
    """Learner steps trained over part B's lives (a life's versions past
    its boot's, the high-water bump excluded)."""
    return sum(life["version"] - boot["resume_version"] for life, boot in zip(part_b["lives"], part_b["boots"]))


# ---------------------------------------------------------------- part C


_INERTNESS_SCRIPT = r"""
import json, os, signal, sys, tempfile
from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig
from dotaclient_tpu_torch.runtime.learner import Learner
from dotaclient_tpu_torch.scripts.chaos_soak import make_frames
from dotaclient_tpu_torch.transport import memory as mem
from dotaclient_tpu_torch.transport.base import connect

platform = sys.argv[1]
policy = PolicyConfig(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32")
cfg = LearnerConfig(batch_size=8, seq_len=4, policy=policy, checkpoint_dir=tempfile.mkdtemp(), checkpoint_every=1,
                    metrics_every=1, platform=platform)
assert not cfg.ckpt.full_state and not cfg.ckpt.async_save and not cfg.ckpt.drain_on_sigterm
mem.reset("inert")
learner = Learner(cfg, connect("mem://inert"), device="cpu" if platform == "cpu" else None)
pub = connect("mem://inert")
for fr in make_frames(cfg, 16):
    pub.publish_experience(fr)
learner.run(num_steps=2, batch_timeout=30.0)
learner.checkpoint()
learner.close()
files = sorted(os.listdir(cfg.checkpoint_dir))
step_files = sorted({f for d in files if os.path.isdir(os.path.join(cfg.checkpoint_dir, d))
                     for f in os.listdir(os.path.join(cfg.checkpoint_dir, d))})
print(json.dumps({
    "chaos_imported": any(m.startswith("dotaclient_tpu_torch.chaos") for m in sys.modules),
    "ckpt_files": files,
    "aux_or_hwm_files": [f for f in files if f.startswith("aux_") or f == "version_hwm"] + [
        f for f in step_files if f != "arrays.npz"],
    "sigterm_handler_default": signal.getsignal(signal.SIGTERM) is signal.SIG_DFL,
    "async_worker_built": learner._ckpt_worker is not None,
    "state_copy_jit_built": learner._copier is not None,
    "publish_hook_wired": learner.publisher._on_published is not None,
    "version": learner.version,
}))
"""


def run_part_c(platform: str = "") -> dict:
    """The inertness subprocess; `platform` as the learner's (the device
    changes nothing of what it checks)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO_ROOT, env.get("PYTHONPATH", "")) if p)
    proc = subprocess.run([sys.executable, "-c", _INERTNESS_SCRIPT, platform], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=600, env=env)
    if proc.returncode != 0:
        return {"error": f"inertness subprocess failed: {proc.stderr[-2000:]}"}
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    report["ok"] = (
        not report["chaos_imported"]
        and not report["aux_or_hwm_files"]
        and report["sigterm_handler_default"]
        and not report["async_worker_built"]
        and not report["state_copy_jit_built"]
        and not report["publish_hook_wired"]
        and report["version"] == 2
    )
    return report


# ------------------------------------------------------------------ main


# A cut of --quick that keeps both deaths in both parts, run by the smoke's
# phase 21 and the CPU tests: 16 steps (--quick: 26), the term after step 8
# (12) with 2 parity steps (3), the kill after step 14 (22; off the 5-step
# checkpoint cadence, so the kill loses steps); part B 10 s (27) with the
# term at 2 s (4) and the kill at 6 s (12), each 1 s down (2).
SMOKE_CUT = dict(steps=16, term_at=8, kill_at=14, parity_steps=2, b_duration_s=10.0, b_term_at=2.0, b_kill_at=6.0,
                 b_down_s=1.0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="resume_soak_torch.json")
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--batch-size", dest="batch_size", type=int, default=16)
    p.add_argument("--seq-len", dest="seq_len", type=int, default=8)
    p.add_argument("--steps", type=int, default=46)
    p.add_argument("--warm-steps", dest="warm_steps", type=int, default=6)
    p.add_argument("--term-at", dest="term_at", type=int, default=20)
    p.add_argument("--kill-at", dest="kill_at", type=int, default=40)
    p.add_argument("--parity-steps", dest="parity_steps", type=int, default=5)
    p.add_argument("--checkpoint-every", dest="checkpoint_every", type=int, default=7)
    p.add_argument("--pending-extras", dest="pending_extras", type=int, default=5)
    p.add_argument("--reservoir-seed", dest="reservoir_seed", type=int, default=4)
    p.add_argument("--recovery-budget-s", dest="recovery_budget_s", type=float, default=30.0)
    p.add_argument("--drain-budget-s", dest="drain_budget_s", type=float, default=45.0)
    # part B
    p.add_argument("--actors", type=int, default=2)
    p.add_argument("--b-duration-s", dest="b_duration_s", type=float, default=34.0)
    p.add_argument("--b-term-at", dest="b_term_at", type=float, default=6.0)
    p.add_argument("--b-kill-at", dest="b_kill_at", type=float, default=16.0)
    p.add_argument("--b-down-s", dest="b_down_s", type=float, default=2.0)
    p.add_argument("--shed-high", dest="shed_high", type=int, default=48)
    p.add_argument("--shed-low", dest="shed_low", type=int, default=16)
    p.add_argument("--quick", action="store_true", help="short schedules, the same invariants")
    # "" = the CUDA device; "cpu" runs the learners and the actors on the host
    p.add_argument("--platform", default="", choices=("", "cpu"))
    args = p.parse_args(argv)
    if args.quick:
        args.steps, args.warm_steps = 26, 6
        # kill_at must not be a multiple of the checkpoint interval, or the
        # periodic save on the kill step makes steps_lost 0 and the hwm
        # bump's check vacuous.
        args.term_at, args.kill_at = 12, 22
        args.parity_steps = 3
        args.checkpoint_every = 5
        args.b_duration_s, args.b_term_at, args.b_kill_at = 27.0, 4.0, 12.0
    return args


def cut_args(argv=()) -> argparse.Namespace:
    """`--quick` and the flags in argv, with SMOKE_CUT applied."""
    args = parse_args(["--quick", *argv])
    for k, v in SMOKE_CUT.items():
        setattr(args, k, v)
    return args


def verdict_of(args, part_a: dict, part_b: dict, part_c: dict) -> dict:
    cons_k, cons_r = part_a["conservation_killed"], part_a["conservation_reference"]
    b_kills = part_b["kills"]
    restarts = [b["construct_s"] for b in part_a["killed"]["boots"][1:]]
    return {
        "sigterm_resume_bit_exact": bool(part_a["sigterm"]["bit_exact_param_opt_hashes"]),
        "sigterm_loss_parity": bool(part_a["sigterm"]["loss_parity"]),
        "sigterm_pending_preserved": part_a["sigterm"]["pending_preserved"] == args.pending_extras,
        "sigkill_hwm_bump_monotonic": part_a["sigkill"]["version_hwm_bump"] == part_a["sigkill"]["steps_lost_to_kill"]
        and part_a["sigkill"]["steps_lost_to_kill"] > 0,
        "sigkill_divergence_bounded": bool(part_a["sigkill"]["divergence_finite"])
        and part_a["sigkill"]["post_kill_loss_divergence_max"] < 10.0,
        "part_a_zero_unaccounted": cons_k["unaccounted_frames"] == 0 and cons_r["unaccounted_frames"] == 0,
        "part_a_intake_balanced": all(b == 0 for b in cons_k["intake_balances"] + cons_r["intake_balances"]),
        "part_a_reservoir_balanced": all(b == 0 for b in cons_k["reservoir_balances"] + cons_r["reservoir_balances"]),
        "part_a_recovery_in_budget": all(r < args.recovery_budget_s for r in restarts),
        "part_a_drain_in_budget": part_a["sigterm"]["drain_wall_s"] < args.drain_budget_s,
        "part_a_watchdog_clean": not part_a["killed"]["watchdog"].get("tripped", False)
        and not part_a["reference"]["watchdog"].get("tripped", False),
        "part_b_kills_executed": len(b_kills) == 2 and {k["sig"] for k in b_kills} == {"term", "kill"},
        "part_b_recovered_in_budget": all(k["recovery_s"] is not None and k["recovery_s"] < args.recovery_budget_s
                                          for k in b_kills),
        "part_b_term_exit_clean": any(l["sig"] == "term" and l["exit_clean"] for l in part_b["lives"]),
        "part_b_actors_rode_through": bool(part_b["conservation"]["actor_ledger_balances"]),
        "part_b_zero_unaccounted": part_b["conservation"]["unaccounted_frames"] == 0
        and all(b == 0 for b in part_b["conservation"]["intake_balances"]),
        "part_b_no_silent_drop_oldest": part_b["broker_ledger"]["dropped_oldest"] == 0,
        "part_b_broker_identity": bool(part_b["conservation"]["broker_identity"]),
        "part_b_watchdog_clean": not part_b["watchdog_final"].get("tripped", False),
        "inertness_chaos_off": bool(part_c.get("ok", False)),
    }


def run_soak(args, policy=None) -> dict:
    """The three parts; returns the artifact ("verdict" holds the bools)."""
    from dotaclient_tpu_torch.obs.preflight import check as preflight_check

    artifact = {
        "host": f"single host, learner on {args.platform or 'the CUDA device'}; part A mem transport, part B tcp",
        "host_preflight": preflight_check("resume_soak"),
        "seed": args.seed,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "budgets": {"recovery_s": args.recovery_budget_s, "drain_s": args.drain_budget_s},
    }
    part_a = run_part_a(args, policy)
    artifact["part_a_determinism"] = part_a
    print(json.dumps({"part_a": {"sigterm": part_a["sigterm"], "sigkill": part_a["sigkill"]}}), flush=True)
    part_b = run_part_b(args, policy)
    artifact["part_b_ride_through"] = part_b
    print(json.dumps({"part_b_kills": part_b["kills"]}), flush=True)
    artifact["part_c_inertness"] = run_part_c(args.platform)
    artifact["verdict"] = verdict_of(args, part_a, part_b, artifact["part_c_inertness"])
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
