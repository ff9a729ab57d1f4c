"""A/B: the multi-worker sharded pack and the transfer-buffer ring vs the
single-thread host feed (twin of scripts/ab_pack_scale.py).

Sections, at matched seeds (the SAME frames feed every arm):

1. packer_scale - the native packer's steps/s at workers 1, 2 and 4 for
   the flagship 256 x 16 batch, on both wires (f32: the rounding loop;
   bf16: the cast-free copy). workers=1 is the single pack call; the
   sharded arms run N concurrent row-shard pack calls into the same
   group buffers through staging's _PackPool, each shard call what
   staging's ring path runs per batch. Interleaved rounds: every arm
   sees the same host weather, the scaling is a median of per-round
   ratios.
2. parity - the sharded transfer buffers are bitwise the single-thread
   pack for workers 2, 3 (an uneven split) and 4, through the port's
   StagingBuffer on the native and the Python packer, over mixed DTR1 +
   DTR3 frames with partial (L < T) rows; and the pack_workers=1 staged
   batch equals a direct single pack (the inertness half).
3. e2e - a 32-wide fused learner (obs step phases on) on the CUDA device,
   fed by producer threads, pack_workers 1 vs 4: env steps/s, the phase
   split, e2e over device-only, and the staging_pack_* scoreboard. Ring
   overlap shows as pack_ring_wait_s > 0 or an observed occupancy >= 1.

Host honesty: the pack is copy-bound, so its scaling is bounded by the
host's parallel copy bandwidth, which `host_copy_scaling` measures apart
from this repo's code (raw libc memcpy, 1 vs 2 vs 4 threads). The 2x bar
is judged only where that probe shows the host can copy in parallel
(copy_scaling_4t >= 1.5); below it the raw ratio is recorded and the bar
is excused by the probe.

The learner runs on the CUDA device unless `--platform cpu`; sections 1-2
are host work.

Run: python -m dotaclient_tpu_torch.scripts.ab_pack_scale [--quick] [--out pack_scale_ab_torch.json]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import threading
import time

import numpy as np

from dotaclient_tpu_torch.config import LearnerConfig, ObsConfig, PolicyConfig, PPOConfig
from dotaclient_tpu_torch.scripts.ab_wire_quant import best_quartile, make_rollouts
from dotaclient_tpu_torch.transport.serialize import cast_rollout_obs_bf16, serialize_rollout

FLAGSHIP_B, FLAGSHIP_T, FLAGSHIP_H = 256, 16, 128
WORKER_ARMS = (1, 2, 4)
PARITY_WORKERS = (2, 3, 4)
PARITY_POLICY = dict(unit_embed_dim=16, lstm_hidden=8, mlp_hidden=16)
E2E_POLICY = dict(unit_embed_dim=32, lstm_hidden=32, mlp_hidden=32)
E2E_BATCH = 64
# The smoke's cut is --quick: 15 rounds, a 6-step e2e per arm.
SMOKE_CUT = dict()


def memcpy_scaling(reps: int, nbytes: int, mb_digits: int = 1) -> dict:
    """Raw libc memcpy of `nbytes`, 1 thread vs 2 / 4 threads over disjoint
    halves / quarters, no repo code: the host's ceiling for any parallel
    copy-bound work. copy_scaling_kt < 1 means one core already saturates
    the memory path."""
    libc = ctypes.CDLL("libc.so.6")
    src = np.random.default_rng(0).integers(0, 255, nbytes, np.uint8)
    dst = np.zeros(nbytes, np.uint8)

    def cpy(off, cnt):
        libc.memcpy(ctypes.c_void_p(dst.ctypes.data + off), ctypes.c_void_p(src.ctypes.data + off), ctypes.c_size_t(cnt))

    def timed(fn):
        fn()
        xs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            xs.append(time.perf_counter() - t0)
        return best_quartile(xs)

    serial = timed(lambda: cpy(0, nbytes))
    out = {"buffer_mb": round(nbytes / 2**20, mb_digits), "serial_ms": round(serial * 1e3, 3)}
    for k in (2, 4):
        chunk = nbytes // k
        go = [threading.Event() for _ in range(k)]
        done = [threading.Event() for _ in range(k)]
        quit_ = threading.Event()

        def worker(i, go=go, done=done, quit_=quit_, chunk=chunk):
            while True:
                if not go[i].wait(timeout=0.2):
                    if quit_.is_set():
                        return
                    continue
                go[i].clear()
                cpy(i * chunk, chunk)
                done[i].set()

        ths = [threading.Thread(target=worker, args=(i,), daemon=True, name=f"memcpy-{i}") for i in range(k)]
        for th in ths:
            th.start()

        def par(go=go, done=done, k=k):
            for i in range(k):
                go[i].set()
            for i in range(k):
                done[i].wait()
                done[i].clear()

        t_k = timed(par)
        quit_.set()
        for th in ths:
            th.join(timeout=2)
        out[f"threads_{k}_ms"] = round(t_k * 1e3, 3)
        out[f"copy_scaling_{k}t"] = round(serial / t_k, 3)
    return out


def section_host_copy_scaling(reps: int) -> dict:
    """The memcpy probe at ~one flagship transfer buffer (6 MiB)."""
    return memcpy_scaling(reps, 6 << 20)


def device_of(platform: str):
    from dotaclient_tpu_torch import resolve_device

    return resolve_device("cpu" if platform == "cpu" else None)


def group_io(cfg: LearnerConfig, device, single: bool = False):
    """The FusedBatchIO of `cfg`'s staged template (group layout unless
    `single`): pinned host buffers when the device is the card."""
    from dotaclient_tpu_torch.parallel.fused_io import FusedBatchIO
    from dotaclient_tpu_torch.parallel.train_step import batch_template

    return FusedBatchIO(batch_template(cfg), device, single=single)


def payload_sha256(payload) -> str:
    """sha256 over a transfer payload's bytes: each group in sorted key
    order (or the one [B, row_bytes] buffer): exactly what crosses."""
    import torch

    h = hashlib.sha256()
    parts = [payload[k] for k in sorted(payload)] if isinstance(payload, dict) else [payload]
    for t in parts:
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def section_packer_scale(reps: int, device):
    """Packer steps/s at 1 / 2 / 4 workers, both wires, flagship shape. The
    timed region is what staging's pack pays per batch: the single pack
    call (w=1) or the pool dispatch, N concurrent row-shard calls and the
    join (w>1)."""
    from dotaclient_tpu_torch import native
    from dotaclient_tpu_torch.runtime.staging import _PackPool, shard_rows

    lib = native.load_packer()
    rollouts = make_rollouts(FLAGSHIP_B, FLAGSHIP_T, FLAGSHIP_H, seed=0)
    wires = {
        "f32_wire": [serialize_rollout(r) for r in rollouts],
        "bf16_wire": [serialize_rollout(cast_rollout_obs_bf16(r)) for r in rollouts],
    }
    io = group_io(LearnerConfig(batch_size=FLAGSHIP_B, seq_len=FLAGSHIP_T), device)
    _groups, out = io.alloc_views()  # one shared target; L = T frames fill every row
    pools = {w: _PackPool(w, name=f"abps-{w}") for w in WORKER_ARMS if w > 1}
    shards = {w: shard_rows(FLAGSHIP_B, w) for w in WORKER_ARMS}
    stop = threading.Event()

    def pack(w, frames):
        if w == 1:
            native.pack_frames(lib, frames, FLAGSHIP_T, FLAGSHIP_H, False, obs_bf16=True, out=out)
            return
        thunks = [(lambda o=o, c=c: native.pack_frames(lib, frames[o : o + c], FLAGSHIP_T, FLAGSHIP_H, False, True, out,
                                                       row_offset=o, total_rows=FLAGSHIP_B))
                  for o, c in shards[w]]
        err = pools[w].run_tasks(thunks, stop)
        if err is not None:
            raise err

    result = {}
    try:
        for wire, frames in wires.items():
            for w in WORKER_ARMS:
                pack(w, frames)  # warm: page faults, the pool's threads
            rounds = []
            for _ in range(reps):
                row = {}
                for w in WORKER_ARMS:
                    t0 = time.perf_counter()
                    pack(w, frames)
                    row[w] = time.perf_counter() - t0
                rounds.append(row)
            arm = {}
            steps = FLAGSHIP_B * FLAGSHIP_T
            for w in WORKER_ARMS:
                t = best_quartile([r[w] for r in rounds])
                arm[f"pack_ms_w{w}"] = round(t * 1e3, 4)
                arm[f"steps_per_sec_w{w}"] = round(steps / t, 1)
            for w in (2, 4):
                ratios = sorted(r[1] / r[w] for r in rounds)
                arm[f"scaling_1_to_{w}_x"] = round(ratios[len(ratios) // 2], 3)
            arm["method"] = ("median of per-round interleaved time ratios; rates are "
                             "best-quartile means (shared-host noise defense)")
            result[wire] = arm
    finally:
        stop.set()
        for p in pools.values():
            p.stop()
    result["batch"] = [FLAGSHIP_B, FLAGSHIP_T]
    return result


def parity_config(batch: int, workers: int, native_on: bool) -> LearnerConfig:
    cfg = LearnerConfig(batch_size=batch, seq_len=8, native_packer=native_on, policy=PolicyConfig(**PARITY_POLICY))
    cfg.staging.pack_workers = workers
    return cfg


def staged_payload(tag: str, frames, workers: int, native_on: bool, device):
    """One batch through the port's StagingBuffer at `workers` pack
    workers, in the group layout: the transfer payload (copied out), its
    ring lease released."""
    from dotaclient_tpu_torch.runtime.staging import StagingBuffer
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect

    cfg = parity_config(len(frames), workers, native_on)
    io = group_io(cfg, device)
    name = f"abps_{tag}"
    mem.reset(name)
    pub = connect(f"mem://{name}")
    for f in frames:
        pub.publish_experience(f)
    sb = StagingBuffer(cfg, connect(f"mem://{name}"), version_fn=lambda: 0, fused_io=io).start()
    try:
        batch, groups = sb.get_batch_groups(timeout=60.0)
        if batch is None:
            raise RuntimeError(f"{tag}: staging produced no batch")
        copy = {k: v.clone() for k, v in groups.items()}
        lease = sb.last_batch_lease
        if lease is not None:
            # graftlint: disable=LIF001(no device copy of this slot: the host clone above is complete before the release)
            lease.release()
        return copy
    finally:
        sb.stop()


def partial_frames():
    """8 seeded rollouts cut to 3..7 of T=8 steps (every row padded),
    alternating the DTR1 (f32) and DTR3 (bf16) wires in one batch."""
    base = make_rollouts(8, 8, 8, seed=3)
    frames = []
    for i, r in enumerate(base):
        L = 3 + (i % 5)
        r = r._replace(
            obs=type(r.obs)(*[np.ascontiguousarray(a[: L + 1]) for a in r.obs]),
            actions=type(r.actions)(*[np.ascontiguousarray(a[:L]) for a in r.actions]),
            behavior_logp=r.behavior_logp[:L],
            behavior_value=r.behavior_value[:L],
            rewards=r.rewards[:L],
            dones=r.dones[:L],
        )
        frames.append(serialize_rollout(cast_rollout_obs_bf16(r) if i % 2 else r))
    return frames


def section_parity(device):
    """Sharded vs single bitwise through the whole staging path, both
    packers, workers 2 / 3 / 4 over B=8 rows; the pack_workers=1 staged
    batch vs one direct native pack into fresh views."""
    from dotaclient_tpu_torch import native

    frames = partial_frames()
    lib = native.load_packer()
    io = group_io(parity_config(len(frames), 1, True), device)
    groups, views = io.alloc_views()
    native.pack_frames(lib, list(frames), 8, 8, False, obs_bf16=True, out=views)
    direct = payload_sha256(groups)
    out = {"direct_single_pack_sha256": direct}
    for packer, native_on in (("native", True), ("python", False)):
        ref = payload_sha256(staged_payload(f"{packer}_w1", list(frames), 1, native_on, device))
        arms = {f"w{w}": payload_sha256(staged_payload(f"{packer}_w{w}", list(frames), w, native_on, device))
                for w in PARITY_WORKERS}
        out[packer] = {
            "single_thread_sha256": ref,
            "sharded_sha256": arms,
            "bitwise_identical": all(h == ref for h in arms.values()),
        }
    out["all_identical"] = all(v["bitwise_identical"] for v in out.values() if isinstance(v, dict))
    out["w1_matches_direct_head_pack"] = out["native"]["single_thread_sha256"] == direct
    return out


def make_frames(cfg: LearnerConfig, n_frames: int):
    """Pre-serialized seeded rollout frames of length seq_len (the twin of
    bench.py's producer frames, byte for byte)."""
    from dotaclient_tpu_torch.env import featurizer as F
    from dotaclient_tpu_torch.ops.action_dist import Action
    from dotaclient_tpu_torch.transport.serialize import Rollout

    frames = []
    T = cfg.seq_len
    H = cfg.policy.lstm_hidden
    r = np.random.RandomState(0)
    for i in range(n_frames):
        T1 = T + 1
        obs = F.Observation(
            global_feats=r.randn(T1, F.GLOBAL_FEATURES).astype(np.float32),
            hero_feats=r.randn(T1, F.HERO_FEATURES).astype(np.float32),
            unit_feats=r.randn(T1, F.MAX_UNITS, F.UNIT_FEATURES).astype(np.float32),
            unit_mask=r.rand(T1, F.MAX_UNITS) < 0.6,
            target_mask=r.rand(T1, F.MAX_UNITS) < 0.3,
            action_mask=np.ones((T1, F.N_ACTION_TYPES), bool),
        )
        rollout = Rollout(
            obs=obs,
            actions=Action(
                type=r.randint(0, 2, T).astype(np.int32),
                move_x=r.randint(0, 9, T).astype(np.int32),
                move_y=r.randint(0, 9, T).astype(np.int32),
                target=np.zeros(T, np.int32),
            ),
            behavior_logp=(-1.5 + 0.1 * r.randn(T)).astype(np.float32),
            behavior_value=r.randn(T).astype(np.float32) * 0.1,
            rewards=(r.randn(T) * 0.1).astype(np.float32),
            dones=np.zeros(T, np.float32),
            initial_state=(np.zeros(H, np.float32), np.zeros(H, np.float32)),
            version=0,
            actor_id=i,
        )
        frames.append(serialize_rollout(rollout))
    return frames


def start_producers(cfg: LearnerConfig, broker_name: str, n_threads: int = 2) -> threading.Event:
    """Producer threads republishing 512 pre-serialized frames, throttled to
    keep about three batches queued (an unthrottled spin would model
    nothing real and burn the host's cores). Set the returned event to
    stop them."""
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect

    mem.reset(broker_name)
    producer_conn = connect(f"mem://{broker_name}", maxlen=cfg.batch_size * 4)
    frames = make_frames(cfg, 512)
    stop = threading.Event()
    high_water = cfg.batch_size * 3

    def producer():
        i = 0
        while not stop.is_set():
            if producer_conn.experience_depth() >= high_water:
                time.sleep(0.001)
                continue
            producer_conn.publish_experience(frames[i % len(frames)])
            i += 1

    for k in range(n_threads):
        threading.Thread(target=producer, daemon=True, name=f"abps-producer-{k}").start()
    return stop


def e2e_config(workers: int, seed: int, steps: int, platform: str = "") -> LearnerConfig:
    """The closed loop's learner: 64 x 16, 32-wide policy (bf16 compute),
    obs step phases on, a staleness window wide enough for republished
    version-0 frames."""
    cfg = LearnerConfig(
        batch_size=E2E_BATCH,
        seq_len=FLAGSHIP_T,
        policy=PolicyConfig(**E2E_POLICY),
        seed=seed,
        metrics_every=max(steps // 2, 1),
        ppo=PPOConfig(max_staleness=100_000),
        obs=ObsConfig(enabled=True, install_handlers=False, step_phases=True),
        platform=platform,
    )
    cfg.staging.pack_workers = workers
    return cfg


PHASES = ("compute_phase_fetch_s", "compute_phase_h2d_s", "compute_phase_device_step_s", "compute_phase_wall_s")


def section_e2e(seed: int, steps: int, platform: str = ""):
    """The port's Learner fed by producer threads, pack_workers 1 vs 4."""
    from dotaclient_tpu_torch.runtime.learner import Learner
    from dotaclient_tpu_torch.transport.base import connect

    out = {}
    for workers in (1, 4):
        cfg = e2e_config(workers, seed, steps, platform)
        name = f"abps_e2e_w{workers}"
        stop = start_producers(cfg, name, n_threads=2)
        learner = Learner(cfg, connect(f"mem://{name}"), device="cpu" if platform == "cpu" else None)
        occupancy_max = [0.0]
        sample_stop = threading.Event()

        def sampler(learner=learner):
            while not sample_stop.is_set():
                occupancy_max[0] = max(occupancy_max[0], learner.staging.stats().get("pack_ring_occupancy", 0.0))
                time.sleep(0.02)

        st = threading.Thread(target=sampler, daemon=True, name="abps-sampler")
        st.start()
        try:
            t0 = time.perf_counter()
            done = learner.run(num_steps=steps, batch_timeout=120.0, max_idle=3)
            wall = time.perf_counter() - t0
            latest = learner.metrics.latest()
            stats = learner.staging.stats()
        finally:
            sample_stop.set()
            st.join(timeout=5)
            stop.set()
            learner.close()
        arm = {
            "steps": done,
            "env_steps_per_sec": round(latest.get("env_steps_per_sec", 0.0), 1),
            "wall_s": round(wall, 2),
            "phase_split": {k: round(latest[k], 5) for k in PHASES if k in latest},
        }
        if workers > 1:
            arm["staging_pack"] = {k: round(float(v), 4) for k, v in stats.items() if k.startswith("pack_")}
            arm["ring_occupancy_max_observed"] = occupancy_max[0]
        out[f"workers_{workers}"] = arm
    w1, w4 = out["workers_1"], out["workers_4"]
    if w1["phase_split"].get("compute_phase_device_step_s", 0.0) > 0:
        for arm in (w1, w4):
            d = arm["phase_split"].get("compute_phase_device_step_s", 0.0)
            w = arm["phase_split"].get("compute_phase_wall_s", 0.0)
            arm["e2e_over_device_only"] = round(d / w, 3) if w > 0 else None
        if w1.get("e2e_over_device_only") and w4.get("e2e_over_device_only"):
            out["e2e_over_device_only_delta"] = round(w4["e2e_over_device_only"] - w1["e2e_over_device_only"], 3)
    out["note"] = ("the step and its host dispatch set the loop's rate, so both arms' e2e rates read about equal; the "
                   "host-feed win is the packer_scale section")
    return out


HOST_BOUND = ("scaling_ok",)


def verdict_of(result: dict) -> dict:
    """The reference's verdict: the 2x scaling bar judged only where the
    memcpy probe shows parallel copy (copy_scaling_4t >= 1.5)."""
    ps, probe, e2e = result["packer_scale"], result["host_copy_scaling"], result["e2e"]
    copy_4t = probe.get("copy_scaling_4t", 0.0)
    scaling = max(ps.get("f32_wire", {}).get("scaling_1_to_4_x", 0.0), ps.get("bf16_wire", {}).get("scaling_1_to_4_x", 0.0))
    host_parallel = copy_4t >= 1.5
    w4 = e2e.get("workers_4", {})
    ring_wait = w4.get("staging_pack", {}).get("pack_ring_wait_s", 0.0)
    v = {
        "bar_scaling_1_to_4_x": 2.0,
        "scaling_1_to_4_x": round(scaling, 3),
        "host_copy_scaling_4t": copy_4t,
        "host_can_express_parallel_copy": bool(host_parallel),
        "scaling_ok": bool(scaling >= 2.0 or not host_parallel),
        "scaling_caveat": (
            None if host_parallel else f"host memcpy probe: {copy_4t}x at 4 threads — parallel copy is a net loss on "
            f"this host, the sharded pack cannot express its win here"
        ),
        "transfer_buffers_bitwise_identical": result["parity"]["all_identical"],
        "ring_overlap_observed": bool(w4.get("ring_occupancy_max_observed", 0) >= 1 or ring_wait > 0),
        "pack_workers_1_inert": bool(result["parity"]["w1_matches_direct_head_pack"]),
    }
    v["all_green"] = all(v[k] for k in ("scaling_ok", "transfer_buffers_bitwise_identical", "ring_overlap_observed",
                                       "pack_workers_1_inert"))
    return v


def run(args) -> dict:
    from dotaclient_tpu_torch.obs.preflight import check as preflight_check
    from dotaclient_tpu_torch.scripts.train_north_star import hardware_line

    reps = args.reps or (15 if args.quick else 80)
    device = device_of(args.platform)
    host = preflight_check("ab_pack_scale")
    t_start = time.time()
    result = {
        "generated_by": "dotaclient_tpu_torch/scripts/ab_pack_scale.py",
        "hardware": hardware_line(args.platform),
        "config": {
            "flagship_batch": [FLAGSHIP_B, FLAGSHIP_T, FLAGSHIP_H],
            "worker_arms": list(WORKER_ARMS),
            "transfer_depth": 2,
            "seed": 0,
            "quick": bool(args.quick),
            "reps": reps,
        },
        "host_preflight": host,
        "host_copy_scaling": section_host_copy_scaling(max(reps // 2, 10)),
        "packer_scale": section_packer_scale(reps, device),
        "parity": section_parity(device),
        "e2e": section_e2e(seed=0, steps=6 if args.quick else 12, platform=args.platform),
    }
    result["verdict"] = verdict_of(result)
    result["wall_s"] = round(time.time() - t_start, 1)
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="fewer reps, shorter e2e")
    ap.add_argument("--reps", type=int, default=0, help="packer rounds (0 = auto)")
    ap.add_argument("--out", default="pack_scale_ab_torch.json")
    # "" = the CUDA device; "cpu" runs the learner (and its pinned-buffer layouts) on the host
    ap.add_argument("--platform", default="", choices=("", "cpu"))
    return ap.parse_args(argv)


def cut_args(argv=()) -> argparse.Namespace:
    """`--quick` and the flags in argv, with SMOKE_CUT applied."""
    args = parse_args(["--quick", *argv])
    for k, v in SMOKE_CUT.items():
        setattr(args, k, v)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    result = run(args)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    print(json.dumps(result["verdict"]), flush=True)
    return 0 if result["verdict"]["all_green"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
