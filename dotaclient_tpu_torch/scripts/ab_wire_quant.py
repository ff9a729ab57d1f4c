"""A/B: the quantized experience wire (DTR3 bf16) vs the f32 wire (twin of
scripts/ab_wire_quant.py).

At matched seeds (the SAME seeded rollouts feed every arm) it measures the
four claims that make the bf16 wire a pure win rather than a numerics
trade:

1. wire_bytes  - serialized bytes per env step, f32 vs bf16 frames: the
                 obs share (the only part the cast touches) must drop ~2x.
2. packer_only - the native packer's throughput into the bf16 batch
                 staging builds: the f32 wire pays the rounding loop, the
                 bf16 wire is the cast-free strided copy over half the
                 read bytes. Bar: >= 1.5x steps/s on the bf16 wire.
3. h2d_bytes   - per-step host-to-device bytes from the port's fused
                 transfer layout (parallel/fused_io.py FusedBatchIO) for
                 an f32-staged vs a bf16-staged learner: the obs share
                 drops ~2x when obs rest in bf16.
4. parity      - the TrainBatch staged from cast-at-actor (DTR3) frames is
                 bitwise the one staged from f32 frames with the cast at
                 staging (sha256 over every leaf), through the port's
                 StagingBuffer, on the native packer and the Python one.

Plus a closed loop (`--e2e_iters`, skipped under `--quick`): a 32-wide
fused learner on the CUDA device fed by republishing producer threads,
f32-wire vs bf16-wire arms; informational (the wire's win is the bytes
and packer effect sections 1-3 measure).

The loop's learner runs on the CUDA device unless `--platform cpu`;
sections 1-4 are host work.

Run: python -m dotaclient_tpu_torch.scripts.ab_wire_quant [--quick] [--out wire_quant_ab_torch.json]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import threading
import time

import numpy as np

from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.ops.action_dist import Action
from dotaclient_tpu_torch.transport.serialize import Rollout, cast_rollout_obs_bf16, serialize_rollout

FLAGSHIP_B, FLAGSHIP_T, FLAGSHIP_H = 256, 16, 128
PARITY_FRAMES = 32  # one batch is proof
E2E_BATCH = 64
E2E_POLICY = dict(unit_embed_dim=32, lstm_hidden=32, mlp_hidden=32)
# The smoke's cut: --quick plus a 4-iteration closed loop, so the loop's
# learner (64 x 16, 32-wide bf16) runs on the card in every smoke.
SMOKE_CUT = dict(e2e_iters=4)


def make_rollouts(n: int, T: int, H: int, seed: int = 0):
    """Seeded synthetic rollouts at learner shapes; their DTR1 / DTR3
    frames are byte for byte the reference generator's for the same seed.
    The same list feeds both arms of every section."""
    r = np.random.RandomState(seed)
    out = []
    T1 = T + 1
    for i in range(n):
        obs = F.Observation(
            global_feats=r.randn(T1, F.GLOBAL_FEATURES).astype(np.float32),
            hero_feats=r.randn(T1, F.HERO_FEATURES).astype(np.float32),
            unit_feats=r.randn(T1, F.MAX_UNITS, F.UNIT_FEATURES).astype(np.float32),
            unit_mask=r.rand(T1, F.MAX_UNITS) < 0.6,
            target_mask=r.rand(T1, F.MAX_UNITS) < 0.3,
            action_mask=np.ones((T1, F.N_ACTION_TYPES), bool),
        )
        out.append(
            Rollout(
                obs=obs,
                actions=Action(
                    type=r.randint(0, 2, T).astype(np.int32),
                    move_x=r.randint(0, 9, T).astype(np.int32),
                    move_y=r.randint(0, 9, T).astype(np.int32),
                    target=np.zeros(T, np.int32),
                ),
                behavior_logp=(-1.5 + 0.1 * r.randn(T)).astype(np.float32),
                behavior_value=(r.randn(T) * 0.1).astype(np.float32),
                rewards=(r.randn(T) * 0.1).astype(np.float32),
                dones=np.zeros(T, np.float32),
                initial_state=(np.zeros(H, np.float32), np.zeros(H, np.float32)),
                version=0,
                actor_id=i,
            )
        )
    return out


def leaf_bytes(leaf) -> bytes:
    """A leaf's raw bytes: a numpy array's, or a tensor's (bf16 as its
    2-byte words, the bytes ml_dtypes holds in the reference)."""
    import torch

    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(leaf)).tobytes()


def leaf_nbytes(leaf) -> int:
    import torch

    if isinstance(leaf, torch.Tensor):
        return leaf.element_size() * leaf.numel()
    return int(np.asarray(leaf).nbytes)


def obs_float_bytes(r: Rollout) -> int:
    return sum(leaf_nbytes(a) for a in (r.obs.global_feats, r.obs.hero_feats, r.obs.unit_feats))


def best_quartile(ts) -> float:
    """Mean of the fastest quarter (at least one): the shared-host noise
    defense of every timed section."""
    ts = sorted(ts)
    q = max(len(ts) // 4, 1)
    return sum(ts[:q]) / q


def section_wire_bytes(rollouts):
    f32 = serialize_rollout(rollouts[0])
    bf = serialize_rollout(cast_rollout_obs_bf16(rollouts[0]))
    T = rollouts[0].length
    obs_f32 = obs_float_bytes(rollouts[0])
    obs_bf16 = obs_float_bytes(cast_rollout_obs_bf16(rollouts[0]))
    return {
        "frame_bytes_f32": len(f32),
        "frame_bytes_bf16": len(bf),
        "wire_bytes_per_env_step_f32": round(len(f32) / T, 1),
        "wire_bytes_per_env_step_bf16": round(len(bf) / T, 1),
        "obs_share_bytes_f32": obs_f32,
        "obs_share_bytes_bf16": obs_bf16,
        "obs_share_reduction_x": round(obs_f32 / obs_bf16, 3),
        "total_reduction_x": round(len(f32) / len(bf), 3),
    }


def bf16_out_batch(B: int, T: int, H: int):
    """A zeroed dense batch whose float obs leaves are bf16 words (uint16):
    what the native packer writes when staging holds obs in bf16."""
    from dotaclient_tpu_torch.ops.batch import zeros_train_batch

    out = zeros_train_batch(B, T, H, False)
    return out._replace(obs=out.obs._replace(**{
        f: np.zeros(v.shape, np.uint16) for f, v in out.obs._asdict().items() if v.dtype == np.float32
    }))


def section_packer_only(rollouts, reps: int):
    """The native pack into the bf16 batch, f32 wire (rounding) vs bf16
    wire (cast-free copy), timed as the dt_pack_batch call alone over
    prebuilt argument vectors (the ctypes glue does not depend on the wire
    dtype and is reported apart, pack_call_*). Interleaved pairs: both
    arms see the same host weather; the speedup is the median of the
    per-pair ratios, the rates best-quartile means."""
    from dotaclient_tpu_torch import native

    lib = native.load_packer()
    f32 = [serialize_rollout(r) for r in rollouts]
    bf = [serialize_rollout(cast_rollout_obs_bf16(r)) for r in rollouts]
    B, T, H = len(rollouts), rollouts[0].length, rollouts[0].initial_state[0].shape[-1]
    out = bf16_out_batch(B, T, H)
    strides = native._validate_out_strides(out, True, B)
    args_f32, keep1 = native._pack_batch_args(f32, out, T, H, False, True, strides)
    args_bf, keep2 = native._pack_batch_args(bf, out, T, H, False, True, strides)
    if lib.dt_pack_batch(*args_f32) != 0 or lib.dt_pack_batch(*args_bf) != 0:
        raise RuntimeError("native packer rejected the A/B's frames")

    def one(args):
        t0 = time.perf_counter()
        lib.dt_pack_batch(*args)
        return time.perf_counter() - t0

    pairs = [(one(args_f32), one(args_bf)) for _ in range(reps)]
    ratios = sorted(a / b for a, b in pairs)
    speedup = ratios[len(ratios) // 2]
    ms_f32 = best_quartile([a for a, _ in pairs])
    ms_bf = best_quartile([b for _, b in pairs])

    def one_call(frames):
        t0 = time.perf_counter()
        native.pack_frames(lib, frames, T, H, False, obs_bf16=True, out=out)
        return time.perf_counter() - t0

    one_call(f32), one_call(bf)
    call_pairs = [(one_call(f32), one_call(bf)) for _ in range(max(reps // 4, 5))]
    call_f32 = best_quartile([a for a, _ in call_pairs])
    call_bf = best_quartile([b for _, b in call_pairs])
    del keep1, keep2
    return {
        "batch": [B, T],
        "pack_ms_f32_wire": round(ms_f32 * 1e3, 4),
        "pack_ms_bf16_wire": round(ms_bf * 1e3, 4),
        "packer_only_steps_per_sec_f32_wire": round(B * T / ms_f32, 1),
        "packer_only_steps_per_sec_bf16_wire": round(B * T / ms_bf, 1),
        "speedup_x": round(speedup, 3),
        "speedup_method": (
            "median of per-pair (interleaved) dt_pack_batch time ratios; "
            "ctypes glue excluded (wire-dtype-independent, see pack_call_*)"
        ),
        "pack_call_ms_f32_wire": round(call_f32 * 1e3, 4),
        "pack_call_ms_bf16_wire": round(call_bf * 1e3, 4),
        "pack_call_speedup_x": round(call_f32 / call_bf, 3),
    }


def section_h2d():
    """Per-step host-to-device bytes of the port's group layout for an
    f32-staged vs a bf16-staged flagship learner. The layout alone fixes
    the bytes, so no device is needed."""
    from dotaclient_tpu_torch.parallel.fused_io import _GROUP_DTYPES, FusedBatchIO, _dtype_name
    from dotaclient_tpu_torch.parallel.train_step import batch_template

    out = {}
    for tag, stage in (("f32_staged", False), ("bf16_staged", True)):
        cfg = LearnerConfig(batch_size=FLAGSHIP_B, seq_len=FLAGSHIP_T)
        cfg.stage_obs_compute_dtype = stage
        template = batch_template(cfg)
        io = FusedBatchIO(template, "cpu", single=False)
        total = sum(cfg.batch_size * cols * np.dtype(_GROUP_DTYPES[k]).itemsize for k, cols in io.layout.group_cols.items())
        obs_leaves = (template.obs.global_feats, template.obs.hero_feats, template.obs.unit_feats)
        out[tag] = {
            "h2d_bytes_per_iter": int(total),
            "h2d_obs_bytes_per_iter": int(sum(leaf_nbytes(leaf) for leaf in obs_leaves)),
            "pack_path_obs_dtype": _dtype_name(obs_leaves[0].dtype),
        }
    out["obs_share_reduction_x"] = round(
        out["f32_staged"]["h2d_obs_bytes_per_iter"] / out["bf16_staged"]["h2d_obs_bytes_per_iter"], 3
    )
    return out


def batch_sha256(batch) -> str:
    """sha256 over every leaf's bytes, in the tree's flattened order."""
    from dotaclient_tpu_torch.ops.batch import tree_flatten

    h = hashlib.sha256()
    for leaf in tree_flatten(batch)[0]:
        h.update(leaf_bytes(leaf))
    return h.hexdigest()


def staged_batch(tag: str, frames, native_packer: bool):
    """One batch through the port's StagingBuffer (consume, ingest, pack;
    the default bf16 staging of the flagship learner): the dense
    TrainBatch."""
    from dotaclient_tpu_torch.runtime.staging import StagingBuffer
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect

    name = f"abwq_{tag}"
    mem.reset(name)
    cfg = LearnerConfig(batch_size=len(frames), seq_len=FLAGSHIP_T, native_packer=native_packer)
    pub = connect(f"mem://{name}")
    for f in frames:
        pub.publish_experience(f)
    sb = StagingBuffer(cfg, connect(f"mem://{name}"), version_fn=lambda: 0).start()
    try:
        batch = sb.get_batch(timeout=60.0)
        if batch is None:
            raise RuntimeError(f"{tag}: staging produced no batch")
        return batch
    finally:
        sb.stop()


def section_parity(rollouts):
    """Cast at the actor (DTR3 wire) vs at staging (f32 wire): the staged
    batches' hashes must be equal, per packer."""
    rollouts = rollouts[:PARITY_FRAMES]
    f32_frames = [serialize_rollout(r) for r in rollouts]
    bf_frames = [serialize_rollout(cast_rollout_obs_bf16(r)) for r in rollouts]
    out = {}
    for packer, use_native in (("native", True), ("python", False)):
        h_staging = batch_sha256(staged_batch(f"{packer}_f32", list(f32_frames), use_native))
        h_actor = batch_sha256(staged_batch(f"{packer}_bf16", list(bf_frames), use_native))
        out[packer] = {
            "cast_at_staging_sha256": h_staging,
            "cast_at_actor_sha256": h_actor,
            "bitwise_identical": h_staging == h_actor,
        }
    out["all_identical"] = all(v["bitwise_identical"] for v in out.values() if isinstance(v, dict))
    return out


def e2e_config(seed: int, platform: str = "") -> LearnerConfig:
    """The closed loop's learner: 64 x 16, a 32-wide policy (bf16 compute)."""
    return LearnerConfig(batch_size=E2E_BATCH, seq_len=FLAGSHIP_T, policy=PolicyConfig(**E2E_POLICY), seed=seed,
                         platform=platform)


def sync_device(device) -> None:
    """Wait for the card's queued work (nothing on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def section_e2e(n_iters: int, seed: int, platform: str = ""):
    """Closed loop: republishing producer threads, staging, the fused
    (four group buffers) train step on the device, one arm per wire dtype
    at matched seeds; a fresh train state per arm."""
    import torch

    from dotaclient_tpu_torch import resolve_device
    from dotaclient_tpu_torch.parallel.train_step import build_fused_train_step, init_train_state
    from dotaclient_tpu_torch.runtime.staging import StagingBuffer
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect

    device = resolve_device("cpu" if platform == "cpu" else None)
    cfg = e2e_config(seed, platform)
    train_step, io = build_fused_train_step(cfg, device)
    small = make_rollouts(256, FLAGSHIP_T, cfg.policy.lstm_hidden, seed=seed + 1)
    arms = {
        "f32_wire": [serialize_rollout(r) for r in small],
        "bf16_wire": [serialize_rollout(cast_rollout_obs_bf16(r)) for r in small],
    }
    out = {}
    for tag, frames in arms.items():
        name = f"abwq_e2e_{tag}"
        mem.reset(name)
        pub = connect(f"mem://{name}", maxlen=cfg.batch_size * 4)
        stop = threading.Event()

        def producer(pub=pub, frames=frames, stop=stop):
            i = 0
            while not stop.is_set():
                if pub.experience_depth() >= cfg.batch_size * 3:
                    time.sleep(0.001)
                    continue
                pub.publish_experience(frames[i % len(frames)])
                i += 1

        thread = threading.Thread(target=producer, daemon=True, name=f"abwq-producer-{tag}")
        thread.start()
        sb = StagingBuffer(cfg, connect(f"mem://{name}"), version_fn=lambda: 0, fused_io=io).start()
        state = init_train_state(cfg, device)

        def fetch():
            b, groups = sb.get_batch_groups(timeout=120.0)
            if b is None:
                raise RuntimeError("staging starved")
            n = int(np.sum(b.mask))  # before the buffer is handed to the copy
            return io.transfer(groups), n

        try:
            dev, _ = fetch()
            state, metrics = train_step(state, io.consume(*dev))
            sync_device(device)
            env_steps = 0
            nxt, n_next = fetch()
            t0 = time.perf_counter()
            for _ in range(n_iters):
                dev, n_now = nxt, n_next
                state, metrics = train_step(state, io.consume(*dev))
                env_steps += n_now
                nxt, n_next = fetch()
            sync_device(device)
            dt = time.perf_counter() - t0
            out[tag] = {"env_steps_per_sec": round(env_steps / dt, 1), "loss": float(metrics["loss"].item())}
        finally:
            stop.set()
            thread.join(timeout=5)
            sb.stop()
        del state
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out["steps"] = n_iters + 1
    out["note"] = ("the loop's rate is set by the device step and its host dispatch, so the arms read about equal; "
                   "the wire's win is the bytes and packer effect sections 1-3 measure")
    return out


def verdict_of(result: dict) -> dict:
    """The reference's four bars and all_green."""
    pk = result["packer_only"]
    v = {
        "obs_wire_bytes_halved": result["wire_bytes"]["obs_share_reduction_x"] >= 1.9,
        "h2d_obs_bytes_halved": result["h2d"]["obs_share_reduction_x"] >= 1.9,
        "packer_speedup_ge_1p5x": bool(pk.get("speedup_x", 0) >= 1.5),
        "trainbatch_bitwise_identical": result["parity"]["all_identical"],
    }
    v["all_green"] = all(v.values())
    return v


def run(args) -> dict:
    """Every section; returns the artifact."""
    from dotaclient_tpu_torch.scripts.train_north_star import hardware_line

    reps = args.reps or (20 if args.quick else 120)
    rollouts = make_rollouts(FLAGSHIP_B, FLAGSHIP_T, FLAGSHIP_H, seed=0)
    t_start = time.time()
    result = {
        "generated_by": "dotaclient_tpu_torch/scripts/ab_wire_quant.py",
        "hardware": hardware_line(args.platform),
        "config": {
            "flagship_batch": [FLAGSHIP_B, FLAGSHIP_T, FLAGSHIP_H],
            "seed": 0,
            "quick": bool(args.quick),
            "reps": reps,
            "e2e_iters": args.e2e_iters,
        },
        "wire_bytes": section_wire_bytes(rollouts),
        "packer_only": section_packer_only(rollouts, reps),
        "h2d": section_h2d(),
        "parity": section_parity(rollouts),
    }
    if args.e2e_iters:
        result["e2e"] = section_e2e(args.e2e_iters, seed=0, platform=args.platform)
    result["verdict"] = verdict_of(result)
    result["wall_s"] = round(time.time() - t_start, 1)
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="fewer reps, skip the e2e loop")
    ap.add_argument("--reps", type=int, default=0, help="packer timing reps (0 = auto)")
    ap.add_argument("--out", default="wire_quant_ab_torch.json")
    # the closed loop's timed iterations (default: 12, none under --quick)
    ap.add_argument("--e2e_iters", type=int, default=None)
    # "" = the CUDA device; "cpu" runs the closed loop's learner on the host
    ap.add_argument("--platform", default="", choices=("", "cpu"))
    args = ap.parse_args(argv)
    if args.e2e_iters is None:
        args.e2e_iters = 0 if args.quick else 12
    return args


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
