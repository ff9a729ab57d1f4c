"""Many-actor aggregate soak (twin of scripts/aggregate_soak.py; BASELINE
ladder rungs 2/4): dozens of real OS processes offering >= 50k env
steps/s into one consumer over the real `tcp://` broker, plus a closed
loop under a live learner.

PHASE 0, the transport calibration: one in-process publisher and one
consumer through the broker for 5 s; the consumed rate is the transport's
headroom over the 50k bar, measured in the same run.

PHASE A, aggregate fan-in at the bar: `--replayers` replayer PROCESSES
(each publishing pre-serialized rollout frames over its own tcp
connection at `--rate` frames/s) into the broker process and a staging
consumer. No learner competes, so the measurement isolates transport,
staging and many-process fan-in: offered >= 50k env steps/s, the staged
rate, per-actor heartbeats (active actors == process count).

PHASE B, the closed loop under a live learner: `--replayers-b` replayers
plus `--real-actors` genuine actor processes (fake env → featurizer →
policy → rollout → weight hot-swap) against a LIVE learner: staleness
drops, drop-oldest backpressure, queue depth, heartbeats and the
learner's consumed rate (`closed_loop_consumed_ge_50k`: producers
saturating a learner that trains at the same time, the north-star
topology).

The learner runs on the CUDA device (`--platform ""`, asserted there) or
on the host (`--platform cpu`); the child processes stay on the CPU.
`--policy flagship` is the production policy (128-wide, bf16 compute).

Run: python -m dotaclient_tpu_torch.scripts.aggregate_soak [--replayers 64] [--real-actors 4]
     [--duration 180] [--out aggregate_soak_torch.json] [--phase all|a|b]
     [--platform ""|cpu] [--policy tiny|flagship] [--batch-size 256]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

from dotaclient_tpu_torch.bench import _make_frames as make_frames

PORT = 13971
SENTINEL_WARM_ID = 999_999
# Frame header offsets (transport/serialize.py DTR1/2/3): the version and
# the actor id.
_VERSION_AT, _ACTOR_AT = 4, 13
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# The verdicts that are bars of scale, not of correctness: at --rate 60 a
# replayer offers 960 env steps/s, so phase A offers 50k only with 53 or more
# (the default 64), and phase B consumes 50k only with that many producers
# (its default 16 replayers offer 15,360: the reference's own artifact reads
# false). The smoke's cut leaves both out by name; its counts stay exact.
SCALE_BOUND_VERDICTS = ("offered_50k_bar_no_learner", "closed_loop_consumed_ge_50k")


def policy_for(name: str):
    """ONE policy-config source for the parent's learner AND the genuine
    actors: a drifted copy on either side gets every actor frame
    quarantined and the hot-swap ignored."""
    from dotaclient_tpu_torch.config import PolicyConfig

    if name == "flagship":
        return PolicyConfig()  # the production config: 128-wide, bf16 compute
    return PolicyConfig(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32")


# --------------------------------------------------------------- replayer
def run_replayer(args) -> int:
    """One load-cohort process: publish pre-serialized frames at --rate
    frames/s, each stamped with the newest learner version from the weight
    fanout (so staleness filtering sees realistic versions). Prints
    'SENT <n>' at exit. Imports neither torch nor numpy."""
    from dotaclient_tpu_torch.transport.base import connect

    with open(args.frames_file, "rb") as f:
        blob = f.read()
    frames, off = [], 0
    while off < len(blob):
        (ln,) = struct.unpack_from("<I", blob, off)
        off += 4
        frames.append(bytearray(blob[off : off + ln]))
        off += ln
    for fr in frames:  # the actor id once, the version per publish
        struct.pack_into("<I", fr, _ACTOR_AT, args.actor_id)

    broker = connect(args.broker)
    # startup barrier: each child declares readiness, the parent releases
    # them together
    with open(f"{args.go_file}.ready.{args.actor_id}", "w") as f:
        f.write("ready")
    while not os.path.exists(args.go_file):
        time.sleep(0.2)
    version = 0
    sent = 0
    t0 = time.time()
    last_wpoll = 0.0
    interval = 1.0 / args.rate
    nxt = time.time()
    while time.time() - t0 < args.duration:
        now = time.time()
        if now - last_wpoll > 1.0:
            w = broker.poll_weights()
            if w and len(w) >= 12 and w[:4] in (b"DTW2", b"DTW1"):
                version = struct.unpack_from("<I", w, 4)[0]
            last_wpoll = now
        fr = frames[sent % len(frames)]
        struct.pack_into("<I", fr, _VERSION_AT, version)
        broker.publish_experience(bytes(fr))
        sent += 1
        nxt += interval
        delay = nxt - time.time()
        if delay > 0:
            time.sleep(delay)
    print(f"SENT {sent}", flush=True)
    return 0


# ------------------------------------------------------------- real actor
def real_actor_config(args):
    """A genuine actor's config: the learner's policy, on the CPU."""
    from dotaclient_tpu_torch.config import ActorConfig

    return ActorConfig(env_addr="local", rollout_len=16, max_dota_time=30.0, policy=policy_for(args.policy),
                       seed=args.actor_id, platform="cpu")


def run_real_actor(args) -> int:
    """A fully genuine actor on the CPU: fake env → featurize → policy
    step → rollout publish → weight hot-swap, over the tcp broker. Prints
    'EPISODES <n> STEPS <m>' at exit."""
    import asyncio

    from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
    from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
    from dotaclient_tpu_torch.runtime.actor import Actor
    from dotaclient_tpu_torch.transport.base import connect

    actor = Actor(real_actor_config(args), connect(args.broker), actor_id=args.actor_id,
                  stub=LocalDotaServiceStub(FakeDotaService()))
    with open(f"{args.go_file}.ready.{args.actor_id}", "w") as f:
        f.write("ready")
    while not os.path.exists(args.go_file):
        time.sleep(0.2)

    episodes = 0
    t0 = time.time()

    async def go():
        nonlocal episodes
        while time.time() - t0 < args.duration:
            await actor.run_episode()
            episodes += 1

    asyncio.run(go())
    print(f"EPISODES {episodes} STEPS {actor.steps_done}", flush=True)
    return 0


# ----------------------------------------------------------------- parent
def _wait_ready(go_file: str, n: int, timeout_s: float = 900.0) -> None:
    """Block until all n children have written `<go_file>.ready.<id>`."""
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        ready = len(glob.glob(f"{go_file}.ready.*"))
        if ready >= n:
            print(f"all {n} children ready after {time.time() - t0:.0f}s", flush=True)
            return
        time.sleep(1.0)
    raise RuntimeError(f"only {len(glob.glob(f'{go_file}.ready.*'))}/{n} children ready after {timeout_s:.0f}s")


def _spawn_children(broker_url, n_replayers, n_real, rate, duration, frames_file, go_file, first_id,
                    policy="tiny"):
    """The replayer and real-actor processes (modes of this module), on the
    CPU, importing the package from this checkout."""
    common = ["--broker", broker_url, "--go-file", go_file, "--duration", str(duration)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (_REPO, os.environ.get("PYTHONPATH", "")) if p))
    me = [sys.executable, "-m", "dotaclient_tpu_torch.scripts.aggregate_soak"]
    procs = []
    for i in range(n_replayers):
        procs.append(subprocess.Popen(
            me + ["--replayer", "--actor-id", str(first_id + i), "--frames-file", frames_file, "--rate", str(rate)]
            + common, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env))
    for i in range(n_real):
        procs.append(subprocess.Popen(
            me + ["--real-actor", "--actor-id", str(i), "--policy", policy] + common,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, env=env))
    return procs


def _collect_children(procs, seq_len):
    """(offered env steps, real episodes, real env steps, senders reporting)
    from the children's exit lines."""
    offered_steps = real_eps = real_steps = senders_reporting = 0
    for pr in procs:
        try:
            out = pr.communicate(timeout=120)[0].decode()
        except subprocess.TimeoutExpired:
            pr.kill()
            out = pr.communicate()[0].decode()
        for line in out.splitlines():
            if line.startswith("SENT "):
                offered_steps += int(line.split()[1]) * seq_len
                senders_reporting += 1
            elif line.startswith("EPISODES "):
                parts = line.split()
                real_eps += int(parts[1])
                real_steps += int(parts[3])
    return offered_steps, real_eps, real_steps, senders_reporting


def verdict_of(artifact: dict) -> dict:
    """The verdict keys, from the phases the run made."""
    verdict = {}
    if "phase_a_fan_in" in artifact:
        # fan-in at the bar with NO learner compute competing
        verdict["offered_50k_bar_no_learner"] = artifact["phase_a_fan_in"]["meets_50k_bar"]
    if "phase_b_closed_loop" in artifact:
        pb = artifact["phase_b_closed_loop"]
        verdict["closed_loop_live"] = bool(pb["genuine_actor_liveness"]["episodes_completed"] > 0
                                           and pb["learner_versions_published"] > 1)
        verdict["closed_loop_live_rate_env_steps_per_sec"] = pb["consumed_env_steps_per_sec"]
        verdict["closed_loop_consumed_ge_50k"] = bool(pb["consumed_env_steps_per_sec"] >= 50_000)
    return verdict


def verdict_ok(verdict: dict) -> bool:
    """The exit code's rule: phase A's bar and the live closed loop."""
    return all(v for k, v in verdict.items() if k in ("offered_50k_bar_no_learner", "closed_loop_live"))


def learner_device(platform: str):
    """The learner's device: the host for "cpu", else the CUDA device
    (raises when there is none; a CPU run is never labelled as the card's)."""
    import torch

    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--platform '' (the CUDA device) but torch.cuda.is_available() is false")
    return torch.device("cuda", torch.cuda.current_device())


def learner_config(args):
    """The phase-B learner's (and phase A's staging consumer's) config."""
    from dotaclient_tpu_torch.config import LearnerConfig

    return LearnerConfig(batch_size=args.batch_size, seq_len=16, policy=policy_for(args.policy), publish_every=1,
                         platform=args.platform)


def run_soak(args, port: int = PORT) -> dict:
    """Phases 0, A and B (as `--phase` picks) with the broker on `port`;
    returns the artifact ("verdict", plus "learner_steps" and "wall_s")."""
    from dotaclient_tpu_torch.obs.preflight import check as preflight_check
    from dotaclient_tpu_torch.scripts.train_north_star import hardware_line
    from dotaclient_tpu_torch.transport.base import connect

    t_start = time.perf_counter()
    device = learner_device(args.platform)
    # this soak binds a FIXED broker port: a stray listener there would
    # swallow the spawn below and the soak would measure a foreign process
    host_preflight = preflight_check("aggregate_soak", ports=[port])
    lcfg = learner_config(args)
    broker_url = f"tcp://127.0.0.1:{port}"
    tmp = tempfile.mkdtemp(prefix="aggregate_soak_")
    frames_file = os.path.join(tmp, "frames.bin")
    frames = make_frames(lcfg, 64)
    with open(frames_file, "wb") as f:
        for fr in frames:
            f.write(struct.pack("<I", len(fr)))
            f.write(fr)
    frame_bytes = sum(len(f) for f in frames) / len(frames)

    server = subprocess.Popen(
        [sys.executable, "-m", "dotaclient_tpu_torch.transport.tcp_server", "--port", str(port), "--maxlen", "4096"],
        start_new_session=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        env=dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (_REPO, os.environ.get("PYTHONPATH", "")) if p)),
    )
    all_procs = []
    artifact = {
        "host": f"{os.cpu_count()} CPU cores; the learner on {hardware_line(args.platform)}; phases A (fan-in at "
                f"the bar, no competing learner compute) and B (closed loop under a live learner)",
        "host_preflight": host_preflight,
        "learner_platform": args.platform or "cuda",
        "policy": args.policy,
        "batch": f"{lcfg.batch_size}x{lcfg.seq_len}",
        "phases_run": args.phase,
        "frame_bytes_mean": round(frame_bytes),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    try:
        for _ in range(240):
            try:
                socket.create_connection(("127.0.0.1", port), timeout=0.5).close()
                break
            except OSError:
                time.sleep(0.5)
        else:
            raise RuntimeError("broker server never listened")
        artifact["phase_0_transport_calibration"] = _calibrate(connect, broker_url, frames[0], lcfg.seq_len)
        print(json.dumps(artifact["phase_0_transport_calibration"]), flush=True)
        if args.phase in ("all", "a"):
            _run_phase_a(args, artifact, lcfg, frames_file, all_procs, broker_url, tmp)
        steps = 0
        if args.phase in ("all", "b"):
            steps = _run_phase_b(args, artifact, lcfg, frames, frames_file, all_procs, broker_url, tmp, device)
        artifact["verdict"] = verdict_of(artifact)
        artifact["learner_steps"] = steps
    finally:
        for pr in all_procs:
            if pr.poll() is None:
                pr.kill()
            pr.wait()
        try:
            os.killpg(server.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        server.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    artifact["wall_s"] = round(time.perf_counter() - t_start, 2)
    return artifact


def _calibrate(connect, broker_url, frame, seq_len) -> dict:
    """Phase 0: one in-process publisher and one consumer through the real
    broker for 5 s; the consumed rate is the deliverable throughput. The
    backlog is drained after, so phase A starts from an empty queue."""
    cal_pub = connect(broker_url)
    cal_sub = connect(broker_url)
    cal_recv = [0]
    cal_stop = threading.Event()

    def cal_consumer():
        while not cal_stop.is_set():
            cal_recv[0] += len(cal_sub.consume_experience(64, timeout=0.2))

    t_cal = threading.Thread(target=cal_consumer, daemon=True, name="calibration-consumer")
    t_cal.start()
    sent = 0
    t0 = time.time()
    while time.time() - t0 < 5.0:
        cal_pub.publish_experience(frame)
        sent += 1
    cal_dt = time.time() - t0
    cal_stop.set()
    t_cal.join(timeout=2)
    consumed_rate = cal_recv[0] / cal_dt
    while cal_sub.consume_experience(256, timeout=0.2):
        pass
    return {
        "topology": "1 publisher + 1 consumer through the tcp broker, this host, this run",
        "published_frames_per_sec": round(sent / cal_dt, 1),
        "consumed_frames_per_sec": round(consumed_rate, 1),
        "env_steps_per_sec_equiv_consumed": round(consumed_rate * seq_len, 1),
        "headroom_over_50k_bar": round(consumed_rate * seq_len / 50_000.0, 2),
    }


def _run_phase_a(args, artifact, lcfg, frames_file, all_procs, broker_url, tmp):
    import numpy as np

    from dotaclient_tpu_torch.runtime.staging import StagingBuffer
    from dotaclient_tpu_torch.transport.base import connect

    go_a = os.path.join(tmp, "goA")
    procs = _spawn_children(broker_url, args.replayers, 0, args.rate, args.phase_a_duration, frames_file, go_a, 1000)
    all_procs += procs
    # a staging consumer only: drain into packed batches and discard
    # (version pinned at 0: staleness belongs to phase B)
    staging = StagingBuffer(lcfg, connect(broker_url), version_fn=lambda: 0).start()
    drained = [0]
    stop_drain = threading.Event()

    def drain():
        while not stop_drain.is_set():
            b = staging.get_batch(timeout=0.5)
            if b is not None:
                drained[0] += int(b.mask.sum())

    drainer = threading.Thread(target=drain, daemon=True, name="phase-a-drain")
    drainer.start()
    print(f"phase A: waiting for {len(procs)} replayers' READY files...", flush=True)
    _wait_ready(go_a, len(procs))
    with open(go_a, "w") as f:
        f.write("go")
    t0 = time.time()
    active_peak = 0
    depth_a = []
    mon = connect(broker_url)
    while time.time() - t0 < args.phase_a_duration + 5:
        time.sleep(5.0)
        try:
            depth_a.append(mon.experience_depth())
        except (ConnectionError, OSError):
            pass
        st = staging.stats()
        active_peak = max(active_peak, st["active_actors"])
        print(f"  phaseA t={time.time() - t0:5.1f}s consumed={st['consumed']} active={st['active_actors']} "
              f"depth={depth_a[-1] if depth_a else '?'}", flush=True)
    offered_a, _, _, senders = _collect_children(procs, lcfg.seq_len)
    stop_drain.set()
    drainer.join(timeout=5)
    st_a = staging.stats()
    staging.stop()
    wall_a = args.phase_a_duration  # each child sends for exactly this long
    artifact["phase_a_fan_in"] = {
        "topology": f"{args.replayers} replayer procs -> tcp broker proc -> staging consumer (no learner compute)",
        "senders_reporting": senders,
        "duration_s": wall_a,
        "offered_env_steps_per_sec": round(offered_a / wall_a, 1),
        "meets_50k_bar": bool(offered_a / wall_a >= 50_000),
        "staged_env_steps_per_sec": round(drained[0] / wall_a, 1),
        "frames_consumed": st_a["consumed"],
        "dropped_bad": st_a["dropped_bad"],
        "active_actors_peak": int(active_peak),
        "broker_depth_mean": round(float(np.mean(depth_a)), 1) if depth_a else None,
        "broker_depth_max": int(np.max(depth_a)) if depth_a else None,
    }
    print(json.dumps(artifact["phase_a_fan_in"], indent=2), flush=True)


def _run_phase_b(args, artifact, lcfg, frames, frames_file, all_procs, broker_url, tmp, device) -> int:
    """Phase B; returns the learner's steps (the warm step included)."""
    import numpy as np

    from dotaclient_tpu_torch.runtime.learner import Learner
    from dotaclient_tpu_torch.transport.base import connect

    go_b = os.path.join(tmp, "goB")
    n_rep_b = args.replayers_b or max(args.replayers // 4, 8)
    procs = _spawn_children(broker_url, n_rep_b, args.real_actors, args.rate, args.duration, frames_file, go_b, 2000,
                            policy=args.policy)
    all_procs += procs
    mon = connect(broker_url)
    learner = Learner(lcfg, connect(broker_url), device=device)
    try:
        # warm before the measured window: one batch of frames fed directly
        # and one step; the warm frames carry a sentinel actor id so they
        # cannot inflate the heartbeat gauge
        warm_pub = connect(broker_url)
        for i in range(lcfg.batch_size + 8):
            fr = bytearray(frames[i % len(frames)])
            struct.pack_into("<I", fr, _ACTOR_AT, SENTINEL_WARM_ID)
            warm_pub.publish_experience(bytes(fr))
        steps = learner.run(num_steps=1, batch_timeout=120.0)
        print("phase B: learner warm; releasing cohort", flush=True)

        depth_b = []
        active_b = 0
        sampler_stop = threading.Event()

        def sampler_b():
            nonlocal active_b
            while not sampler_stop.is_set():
                time.sleep(5.0)
                try:
                    depth_b.append(mon.experience_depth())
                except (ConnectionError, OSError):
                    continue
                # heartbeats counted directly, without the warm sentinel
                cutoff = time.monotonic() - learner.staging.heartbeat_window_s
                seen = dict(learner.staging._actor_seen)
                live = sum(1 for a, t in seen.items() if t >= cutoff and a != SENTINEL_WARM_ID)
                active_b = max(active_b, live)

        sampler = threading.Thread(target=sampler_b, daemon=True, name="phase-b-sampler")
        sampler.start()
        _wait_ready(go_b, len(procs))
        with open(go_b, "w") as f:
            f.write("go")
        steps_before = learner.env_steps_done
        t0 = time.time()
        steps += learner.run(max_seconds=args.duration, batch_timeout=30.0)
        wall_b = time.time() - t0
        sampler_stop.set()
        sampler.join(timeout=10)
        st_b = learner.staging.stats()
        offered_b, real_eps, real_steps, senders = _collect_children(procs, lcfg.seq_len)
        offered_b += real_steps
        artifact["phase_b_closed_loop"] = {
            "topology": f"{n_rep_b} replayer + {args.real_actors} genuine actor procs -> tcp broker -> LIVE learner "
                        f"(batch {lcfg.batch_size}x{lcfg.seq_len}, publish_every=1, device={device})",
            "duration_s": round(wall_b, 1),
            "offered_env_steps_per_sec": round(offered_b / max(wall_b, 1), 1),
            "consumed_env_steps_per_sec": round((learner.env_steps_done - steps_before) / max(wall_b, 1), 1),
            "learner_versions_published": learner.version,
            "staleness": {
                "frames_consumed": st_b["consumed"],
                "dropped_stale": st_b["dropped_stale"],
                "dropped_bad": st_b["dropped_bad"],
                "stale_drop_rate": round(st_b["dropped_stale"] / max(st_b["consumed"], 1), 5),
            },
            "active_actors_peak": int(active_b),
            "broker_depth": {
                "bound": 4096,
                "mean": round(float(np.mean(depth_b)), 1) if depth_b else None,
                "max": int(np.max(depth_b)) if depth_b else None,
            },
            "genuine_actor_liveness": {
                "processes": args.real_actors,
                "episodes_completed": real_eps,
                "env_steps": real_steps,
            },
            "replayers_reporting": senders,
        }
    finally:
        learner.close()
    print(json.dumps(artifact["phase_b_closed_loop"], indent=2), flush=True)
    return steps


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--replayers", type=int, default=64)
    p.add_argument("--real-actors", type=int, default=4)
    p.add_argument("--duration", type=float, default=180.0, help="phase B window")
    p.add_argument("--phase-a-duration", type=float, default=75.0)
    p.add_argument("--rate", type=float, default=60.0, help="frames/s per phase-A replayer")
    p.add_argument("--out", default="aggregate_soak_torch.json")
    p.add_argument("--phase", choices=["all", "a", "b"], default="all")
    # "" = the learner on the CUDA device (asserted there); "cpu" on the host.
    # The child processes stay on the CPU either way.
    p.add_argument("--platform", default="", choices=("", "cpu"))
    p.add_argument("--policy", choices=["tiny", "flagship"], default="tiny",
                   help="flagship = the production policy (128-wide, bf16 compute)")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--replayers-b", type=int, default=0,
                   help="phase-B replayer count (0 = replayers//4, min 8)")
    # subprocess modes
    p.add_argument("--replayer", action="store_true")
    p.add_argument("--real-actor", dest="real_actor", action="store_true")
    p.add_argument("--actor-id", type=int, default=0)
    p.add_argument("--broker", default="")
    p.add_argument("--frames-file", default="")
    p.add_argument("--go-file", default="")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.replayer:
        return run_replayer(args)
    if args.real_actor:
        return run_real_actor(args)
    artifact = run_soak(args)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(json.dumps(artifact, indent=2))
    return 0 if verdict_ok(artifact["verdict"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
