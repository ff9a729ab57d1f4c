"""bf16 experience-wire soak (twin of scripts/soak_wire_bf16.py): the
sign-off that lets the actor manifests ship bf16 obs (MIGRATION item 9).

A closed loop (a real tcp BrokerServer, the real learner with staging,
the native packer and obs meters, real actors: featurize, policy and
chunking against the in-process fake env) driven through the three fleet
states a rolling upgrade traverses:

  phase 1  all-f32   (today's fleet; the control)
  phase 2  MIXED     (mid-rollout: half the actors flipped to bf16)
  phase 3  all-bf16  (the post-flip fleet, DTR3 frames)

Checks per phase (the sign-off bar):
  - zero staging quarantines and zero dropped_bad deltas: no frame of
    either wire dtype is filed as poison;
  - the wire meters walk as the fleet state says (the f32 phase ships no
    bf16 frames, the bf16 phase no f32 frames, the mixed phase both);
  - the learner trains through every phase (versions advance, loss
    finite);
and across phases the bf16 wire's bytes per frame lands in [0.4, 0.8] of
the f32 wire's (the obs dominate a frame).

The learner and the actors run on the CUDA device unless `--platform
cpu`. `run_soak` takes a PolicyConfig (None: the soak's tiny one).

Run: python -m dotaclient_tpu_torch.scripts.soak_wire_bf16 --out wire_soak_torch.json
     python -m dotaclient_tpu_torch.scripts.soak_wire_bf16 --quick --platform cpu --out /tmp/x.json
"""

from __future__ import annotations

import argparse
import json
import threading
import time

from dotaclient_tpu_torch.scripts.chaos_soak import tiny_policy

PHASES = (("phase_1_all_f32", ["f32"]), ("phase_2_mixed", ["f32", "bf16"]), ("phase_3_all_bf16", ["bf16"]))
RATIO_BAND = (0.4, 0.8)
SNAP_KEYS = ("consumed", "dropped_stale", "dropped_bad", "quarantined", "wire_bytes", "wire_frames_obs_bf16",
             "wire_frames_obs_f32")


def actor_config(args, policy, i: int, id_base: int, obs_dtypes):
    """Actor `id_base + i`'s config: its wire dtype by its place in the
    phase's list."""
    from dotaclient_tpu_torch.config import ActorConfig, WireConfig

    return ActorConfig(
        env_addr="local",
        rollout_len=args.seq_len,
        max_dota_time=4.0,
        policy=policy,
        seed=100 + id_base + i,
        max_weight_age_s=0.0,
        platform=args.platform,
        wire=WireConfig(obs_dtype=obs_dtypes[i % len(obs_dtypes)]),
    )


def _run_actor_phase(args, policy, port, duration, n_actors, id_base, obs_dtypes, min_published=0):
    """An ActorPool of genuine actors publishing with the given per-actor
    wire dtypes. `min_published` extends the phase until that many chunks
    were acked (the warm phase must outlast the first chunks)."""
    from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
    from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
    from dotaclient_tpu_torch.runtime.actor import Actor
    from dotaclient_tpu_torch.runtime.harness import ActorPool
    from dotaclient_tpu_torch.transport.base import RetryPolicy
    from dotaclient_tpu_torch.transport.tcp import TcpBroker

    def make_actor(i):
        return Actor(actor_config(args, policy, i, id_base, obs_dtypes),
                     TcpBroker(port=port, retry=RetryPolicy(window_s=8.0)), actor_id=id_base + i,
                     stub=LocalDotaServiceStub(FakeDotaService()))

    pool = ActorPool(make_actor, n_actors).start()
    time.sleep(duration)
    if min_published:
        deadline = time.time() + 120.0
        while time.time() < deadline:
            if pool.publish_stats()["published"] >= min_published:
                break
            time.sleep(0.25)
    pool.stop(timeout=30.0, raise_on_dead=True)
    ledger = pool.publish_stats()
    ledger["attempted"] = ledger["published"] + ledger["shed"] + ledger["failed"]
    return ledger


def learner_config(args, policy):
    """The soak's learner config: staging with obs meters, a wide
    staleness window (the small learner advances versions faster than any
    deployment; stale drops would be a config artifact)."""
    from dotaclient_tpu_torch.config import LearnerConfig, ObsConfig, PPOConfig

    return LearnerConfig(
        batch_size=args.batch_size,
        seq_len=args.seq_len,
        policy=policy,
        publish_every=1,
        metrics_every=5,
        platform=args.platform,
        ppo=PPOConfig(max_staleness=256),
        obs=ObsConfig(enabled=True, install_handlers=False, step_phases=False),
    )


def phase_checks(dtypes, d: dict, versions_advanced: int, loss) -> dict:
    """One phase's bar from its staging deltas `d`."""
    if dtypes == ["f32"]:
        meters = d["wire_frames_obs_bf16"] == 0
    elif dtypes == ["bf16"]:
        meters = d["wire_frames_obs_f32"] == 0
    else:
        meters = d["wire_frames_obs_bf16"] > 0 and d["wire_frames_obs_f32"] > 0
    return {
        "no_quarantine": d["quarantined"] == 0 and d["dropped_bad"] == 0,
        "trained": d["consumed"] > 0 and versions_advanced > 0,
        "loss_finite": loss is not None and bool(abs(float(loss)) < 1e9),
        "meters_match_fleet": meters,
    }


def bytes_ratio(bpf_f32, bpf_bf16):
    """(the bf16/f32 bytes-per-frame ratio, whether it is in the band)."""
    ratio = round(bpf_bf16 / bpf_f32, 3) if (bpf_f32 and bpf_bf16) else None
    return ratio, ratio is not None and RATIO_BAND[0] <= ratio <= RATIO_BAND[1]


def run_soak(args, policy=None) -> dict:
    """The three phases; returns the artifact ("verdict" is {"ok",
    "problems"}, "learner_steps" the learner's steps, "wall_s" the
    seconds)."""
    from dotaclient_tpu_torch.obs.preflight import check as preflight_check
    from dotaclient_tpu_torch.runtime.learner import Learner
    from dotaclient_tpu_torch.transport.base import RetryPolicy
    from dotaclient_tpu_torch.transport.tcp import BrokerServer, TcpBroker

    t_start = time.perf_counter()
    policy = tiny_policy() if policy is None else policy
    lcfg = learner_config(args, policy)
    host_preflight = preflight_check("soak_wire_bf16")
    srv = BrokerServer(port=0).start()
    port = srv.port
    artifact = {
        "generated_by": "dotaclient_tpu_torch/scripts/soak_wire_bf16.py",
        "host_preflight": host_preflight,
        "topology": f"real tcp broker, learner on {args.platform or 'the CUDA device'} (policy lstm_hidden "
                    f"{policy.lstm_hidden}, {policy.dtype}), genuine actors (fake env)",
        "batch": f"{lcfg.batch_size}x{lcfg.seq_len}",
        "phase_s": args.phase_s,
        "actors": args.actors,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    ok = True
    problems = []
    learner = None
    try:
        learner = Learner(lcfg, TcpBroker(port=port, retry=RetryPolicy()),
                          device="cpu" if args.platform == "cpu" else None)
        # warm the learner outside the measured phases (extends itself
        # until a full batch's worth of chunks is in the broker)
        _run_actor_phase(args, policy, port, 2.0, 1, 900, ["f32"], min_published=args.batch_size + 4)
        learner.run(num_steps=1, batch_timeout=120.0)
        print("learner warm", flush=True)

        def snap():
            s = learner.staging.stats()
            return {k: s[k] for k in SNAP_KEYS}

        for name, dtypes in PHASES:
            s0 = snap()
            v0 = learner.version
            ledger_box = {}

            def run_actors(box=ledger_box, dt=dtypes):
                box["ledger"] = _run_actor_phase(args, policy, port, args.phase_s, args.actors, 200, dt)

            th = threading.Thread(target=run_actors, name=f"wire-actors-{name}")
            th.start()
            learner.run(max_seconds=args.phase_s + 2.0, batch_timeout=2.0)
            th.join(timeout=60)
            # drain the phase's tail so its frames are counted under it
            learner.run(max_seconds=2.0, batch_timeout=0.5)
            s1 = snap()
            d = {k: s1[k] - s0[k] for k in s0}
            frames = d["wire_frames_obs_bf16"] + d["wire_frames_obs_f32"]
            loss = learner.metrics.latest().get("loss")
            phase = {
                "wire_dtypes": dtypes,
                "publish": ledger_box["ledger"],
                "consumed_delta": d["consumed"],
                "quarantined_delta": d["quarantined"],
                "dropped_bad_delta": d["dropped_bad"],
                "dropped_stale_delta": d["dropped_stale"],
                "frames_f32": d["wire_frames_obs_f32"],
                "frames_bf16": d["wire_frames_obs_bf16"],
                "bytes_per_frame": round(d["wire_bytes"] / frames, 1) if frames else None,
                "versions_advanced": learner.version - v0,
                "loss": None if loss is None else float(loss),
            }
            phase["checks"] = checks = phase_checks(dtypes, d, phase["versions_advanced"], loss)
            artifact[name] = phase
            if not all(checks.values()):
                ok = False
                problems.append(f"{name}: {[k for k, v in checks.items() if not v]}")
            print(json.dumps({name: phase}), flush=True)

        ratio, bandwidth_ok = bytes_ratio(artifact["phase_1_all_f32"]["bytes_per_frame"],
                                          artifact["phase_3_all_bf16"]["bytes_per_frame"])
        if not bandwidth_ok:
            ok = False
            problems.append(f"bf16/f32 bytes-per-frame ratio {ratio} outside [{RATIO_BAND[0]}, {RATIO_BAND[1]}]")
        artifact["wire_bytes_per_frame_ratio_bf16_vs_f32"] = ratio
    finally:
        if learner is not None:
            learner.close()
        srv.stop()
    artifact["verdict"] = {"ok": ok, "problems": problems}
    artifact["learner_steps"] = learner.version
    artifact["wall_s"] = round(time.perf_counter() - t_start, 2)
    return artifact


# A cut of the default that keeps --quick's 2 actors and stretches its 8 s
# phases to 12 s, run by the smoke's phase 23: there the flagship actors
# share a loaded host, and in 8 s the all-bf16 phase fed the learner 41
# frames and 3 steps (ROADMAP.md §C: a learner that steps in every phase is
# a bar of pace). More frames, never fewer; the bars are the reference's.
SMOKE_CUT = dict(phase_s=12.0)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="wire_soak_torch.json")
    p.add_argument("--actors", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seq-len", dest="seq_len", type=int, default=8)
    p.add_argument("--phase-s", dest="phase_s", type=float, default=25.0)
    p.add_argument("--quick", action="store_true", help="nightly scale, same invariants")
    # "" = the CUDA device; "cpu" runs the learner and the actors on the host
    p.add_argument("--platform", default="", choices=("", "cpu"))
    args = p.parse_args(argv)
    if args.quick:
        args.phase_s = 8.0
        args.actors = 2
    return args


def cut_args(argv=()) -> argparse.Namespace:
    """`--quick` and the flags in argv, with SMOKE_CUT applied."""
    args = parse_args(["--quick", *argv])
    for k, v in SMOKE_CUT.items():
        setattr(args, k, v)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    artifact = run_soak(args)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
        f.write("\n")
    ok = artifact["verdict"]["ok"]
    print(f"wrote {args.out}: {'ALL GREEN' if ok else artifact['verdict']['problems']}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
