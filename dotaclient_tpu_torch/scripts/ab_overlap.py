"""A/B: the overlapped learner pipeline (--learner.prefetch) vs the serial
fetch-after-step loop (twin of scripts/ab_overlap.py).

Sections, at matched seeds (the SAME frame schedule feeds paired arms):

1. parity - a pipelined run's params AND Adam state are bitwise a serial
   run's after K steps over the same pre-published frame schedule (the
   PrefetchLane is the one FIFO staging consumer, so the batch order is
   the serial loop's), and the loss histories equal; on the single-buffer
   transfer layout (the default) and on the four group buffers.
2. throughput - serial vs pipelined env steps/s through the port's
   Learner on the CUDA device over a pre-published schedule, in turns
   (serial, pipelined, pipelined, serial; each arm the mean of its two
   runs, where the reference runs each arm once), against the
   device-only rate of the same train step on a batch already on the
   device: e2e_over_device_only per arm, the pipelined arm's overlap ratio
   and device-idle scoreboard, the serial arm's exposed fetch for
   contrast.
3. transfer_layout - the same batch bytes host to device as a tree of
   leaves (TreeBatchIO, one copy per leaf), as four dtype-group buffers
   and as one u8 buffer (FusedBatchIO), timed on this device.
4. schedcheck - the port's PrefetchModel (analysis/schedcheck.py)
   explores exhausted and clean, and each of its three mutants fails.

Host honesty: hiding host work behind the device step needs the host to
run two lanes at once. `host_concurrency` measures that apart from this
repo's code (GIL-released numpy matmuls alone vs beside a memcpy helper
thread, the lane's shape): the 0.98 bar on the pipelined arm's
e2e_over_device_only is judged only where compute keeps >= 0.97 of its
rate beside the helper; below that the raw ratios are recorded and the
bar is excused by the probe. The no-regression bar (pipelined >= 0.9x
serial) applies on every host.

The learners run on the CUDA device unless `--platform cpu`.

Run: python -m dotaclient_tpu_torch.scripts.ab_overlap [--quick] [--out overlap_ab_torch.json]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import tempfile
import threading
import time

import numpy as np

from dotaclient_tpu_torch.config import LearnerConfig, ObsConfig, PolicyConfig, PPOConfig
from dotaclient_tpu_torch.scripts.ab_wire_quant import make_rollouts, sync_device
from dotaclient_tpu_torch.transport.serialize import serialize_rollout

B, T, H = 16, 8, 16
POLICY = dict(unit_embed_dim=16, lstm_hidden=H, mlp_hidden=16, dtype="float32")
# Throughput shape: big enough that the device step dominates the loop
# (the regime the pipeline targets), small enough to build in seconds.
TP_B, TP_T = 32, 16
TP_POLICY = dict(unit_embed_dim=32, lstm_hidden=64, mlp_hidden=64, dtype="float32")
PREFETCH_MUTANTS = ("release_before_retire", "train_consumes_inflight", "drain_ignores_prefetch")
# The smoke's cut is --quick: 6 parity steps per arm, 12 throughput steps.
SMOKE_CUT = dict()


def parity_config(name: str, prefetch: bool, single: bool, log_dir: str = "", obs: bool = False,
                  platform: str = "") -> LearnerConfig:
    """A parity arm's learner: 16 x 8, a 16-wide f32 policy, metrics every
    4 steps, a staleness window wide enough for republished version-0
    frames."""
    cfg = LearnerConfig(
        batch_size=B,
        seq_len=T,
        policy=PolicyConfig(**POLICY),
        broker_url=f"mem://{name}",
        log_dir=log_dir,
        metrics_every=4,
        seed=0,
        fused_single_h2d=single,
        ppo=PPOConfig(max_staleness=1_000_000),
        obs=ObsConfig(enabled=obs, install_handlers=False, step_phases=obs),
        platform=platform,
    )
    cfg.learner.prefetch = prefetch
    return cfg


def throughput_config(name: str, prefetch: bool, log_dir: str = "", platform: str = "") -> LearnerConfig:
    """A throughput arm's learner: 32 x 16, a 64-wide f32 policy, one
    metrics window over the whole run, the weight publish kept out (it
    adds the same work to both arms and is not the fetch's overlap)."""
    cfg = LearnerConfig(
        batch_size=TP_B,
        seq_len=TP_T,
        policy=PolicyConfig(**TP_POLICY),
        broker_url=f"mem://{name}",
        log_dir=log_dir,
        metrics_every=1_000_000,
        seed=0,
        publish_every=1_000_000_000,
        ppo=PPOConfig(max_staleness=1_000_000),
        obs=ObsConfig(enabled=False, install_handlers=False),
        platform=platform,
    )
    cfg.learner.prefetch = prefetch
    return cfg


def state_sha256(state) -> str:
    """sha256 over the params and the Adam state (count, mu, nu), each in
    flax-name order."""
    import torch

    from dotaclient_tpu_torch.transport.params import named_tensors

    h = hashlib.sha256()
    opt = state.opt_state
    parts = [named_tensors(state.net), {"count": opt.count}, opt.mu, opt.nu]
    for d in parts:
        for k in sorted(d):
            h.update(d[k].detach().cpu().reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def section_host_concurrency(reps: int):
    """How much compute rate this host keeps while a helper thread (the
    prefetch lane's copy work) runs beside it: GIL-released numpy matmuls
    on this thread, a memcpy loop on the helper, no repo code."""
    n = 384
    a = np.random.default_rng(0).standard_normal((n, n)).astype(np.float32)
    b = np.random.default_rng(1).standard_normal((n, n)).astype(np.float32)
    buf_src = np.random.default_rng(2).integers(0, 255, 4 << 20, np.uint8)
    buf_dst = np.zeros_like(buf_src)

    def matmuls(k):
        for _ in range(k):
            np.dot(a, b)

    iters = max(reps, 10)
    matmuls(3)
    t0 = time.perf_counter()
    matmuls(iters)
    alone_rate = iters / (time.perf_counter() - t0)
    stop = threading.Event()

    def helper():
        while not stop.is_set():
            np.copyto(buf_dst, buf_src)

    th = threading.Thread(target=helper, daemon=True, name="abov-helper")
    th.start()
    try:
        t0 = time.perf_counter()
        matmuls(iters)
        with_helper_rate = iters / (time.perf_counter() - t0)
    finally:
        stop.set()
        th.join(timeout=5)
    return {
        "matmul_n": n,
        "alone_matmuls_per_s": round(alone_rate, 1),
        "with_helper_matmuls_per_s": round(with_helper_rate, 1),
        "compute_retention_with_helper": round(with_helper_rate / alone_rate, 3),
        "note": ("GIL-released numpy matmuls on the main thread vs the same loop with a concurrent memcpy helper "
                 "thread: the host's ceiling for hiding a prefetch lane behind compute; no repo code involved"),
    }


def _publish(name: str, frames) -> None:
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect

    mem.reset(name)
    pub = connect(f"mem://{name}", maxlen=len(frames) + 8)
    for f in frames:
        pub.publish_experience(f)


def _learner(cfg: LearnerConfig, name: str, platform: str):
    from dotaclient_tpu_torch.runtime.learner import Learner
    from dotaclient_tpu_torch.transport.base import connect

    return Learner(cfg, connect(f"mem://{name}"), device="cpu" if platform == "cpu" else None)


def run_parity_arm(name: str, prefetch: bool, single: bool, frames, steps: int, log_dir: str, platform: str = ""):
    """One parity arm: a fresh broker holding the exact frame schedule, a
    fresh Learner, K steps. Returns the state hash, the loss history and
    the lane's evidence."""
    _publish(name, frames)
    arm_dir = os.path.join(log_dir, name)
    learner = _learner(parity_config(name, prefetch, single, log_dir=arm_dir, platform=platform), name, platform)
    try:
        done = learner.run(num_steps=steps, batch_timeout=60.0, max_idle=3)
        if done != steps:
            raise RuntimeError(f"{name}: trained {done} of {steps} steps")
        state_hash = state_sha256(learner.state)
        lane = learner._prefetch_lane  # None after the run either way
        consumed = learner.staging.stats()["consumed"]
    finally:
        learner.close()
    losses = []
    mpath = os.path.join(arm_dir, "metrics.jsonl")
    if os.path.exists(mpath):
        for line in open(mpath):
            rec = json.loads(line)
            if "loss" in rec:
                losses.append(round(float(rec["loss"]), 10))
    return {"state_sha256": state_hash, "loss_history": losses, "frames_consumed": int(consumed),
            "lane_alive_after_run": lane is not None}


def section_parity(steps: int, log_dir: str, platform: str = ""):
    """Serial vs pipelined over the same pre-published schedule, both
    transfer layouts: state bitwise, losses equal, no lane left behind."""
    frames = [serialize_rollout(r) for r in make_rollouts(B * steps, T, H, seed=7)]
    out = {}
    for layout, single in (("single_buffer", True), ("groups_4_buffers", False)):
        serial = run_parity_arm(f"abov_ser_{layout}", False, single, frames, steps, log_dir, platform)
        pipe = run_parity_arm(f"abov_pipe_{layout}", True, single, frames, steps, log_dir, platform)
        out[layout] = {
            "serial": serial,
            "pipelined": pipe,
            "state_bitwise_identical": serial["state_sha256"] == pipe["state_sha256"],
            "loss_history_identical": serial["loss_history"] == pipe["loss_history"],
        }
    out["all_identical"] = all(v["state_bitwise_identical"] and v["loss_history_identical"] for v in out.values()
                               if isinstance(v, dict))
    return out


THROUGHPUT_KEYS = ("pipeline_overlap_ratio", "pipeline_prefetch_s", "pipeline_device_idle_s", "time_wait_batch_s",
                   "time_device_put_s", "time_step_s")


def device_only_rate(steps: int, platform: str = "") -> tuple:
    """(env steps/s, train steps taken) of the throughput arms' train step
    (single-buffer layout) on one batch already on the device: no fetch,
    no copy; one warm step, then the timed ones."""
    from dotaclient_tpu_torch import resolve_device
    from dotaclient_tpu_torch.ops.batch import make_train_batch
    from dotaclient_tpu_torch.parallel.train_step import build_single_train_step, init_train_state
    from dotaclient_tpu_torch.runtime.staging import cast_obs_to_compute_dtype

    device = resolve_device("cpu" if platform == "cpu" else None)
    cfg0 = throughput_config("abov_dev", True, platform=platform)
    step, io = build_single_train_step(cfg0, device)
    state = init_train_state(cfg0, device)
    batch = io.consume(*io.transfer(io.pack_transfer(cast_obs_to_compute_dtype(cfg0, make_train_batch(cfg0, 0)))))
    state, metrics = step(state, batch)
    sync_device(device)
    reps = max(steps, 8)
    t0 = time.perf_counter()
    for _ in range(reps):
        state, metrics = step(state, batch)
    sync_device(device)
    return TP_B * TP_T * reps / (time.perf_counter() - t0), reps + 1


# The throughput arms run in turns, each turn a fresh Learner over the same
# pre-published schedule: serial, pipelined, pipelined, serial. On a shared
# host one run of each read 0.70-1.14 of serial across runs of one
# configuration (NVIDIA H100 80GB HBM3, 700 W); the ABBA
# order cancels a linear drift and each arm's rate is the mean of its turns.
TP_TURNS = ("serial", "pipelined", "pipelined", "serial")


def _throughput_turn(name: str, prefetch: bool, frames, steps: int, log_dir: str, platform: str) -> dict:
    _publish(name, frames)
    learner = _learner(throughput_config(name, prefetch, log_dir=os.path.join(log_dir, name), platform=platform), name,
                       platform)
    try:
        t0 = time.perf_counter()
        done = learner.run(num_steps=steps, batch_timeout=60.0, max_idle=3)
        wall = time.perf_counter() - t0
        latest = learner.metrics.latest()
    finally:
        learner.close()
    rec = {"steps": done, "wall_s": round(wall, 2), "env_steps_per_sec": round(latest.get("env_steps_per_sec", 0.0), 1)}
    rec.update({k: round(float(latest[k]), 5) for k in THROUGHPUT_KEYS if k in latest})
    return rec


def section_throughput(steps: int, log_dir: str, platform: str = ""):
    """Serial vs pipelined e2e rate over a pre-published schedule (every turn
    eats the same queue, no producer threads mid-run) against the
    device-only rate of the same step; the arms in TP_TURNS' order, each
    arm's numbers the mean of its turns."""
    device_rate, device_steps = device_only_rate(steps, platform)
    frames = [serialize_rollout(r) for r in make_rollouts(TP_B * (steps + 1), TP_T, TP_POLICY["lstm_hidden"], seed=11)]
    out = {"device_only_steps_per_sec": round(device_rate, 1), "device_only_steps": device_steps,
           "turns": list(TP_TURNS)}
    runs = {"serial": [], "pipelined": []}
    for i, arm in enumerate(TP_TURNS):
        runs[arm].append(_throughput_turn(f"abov_tp_{arm}_{i}", arm == "pipelined", frames, steps, log_dir, platform))
    for arm, recs in runs.items():
        rate = float(np.mean([r["env_steps_per_sec"] for r in recs]))
        # the mean of two rates of one decimal has two: rounding it to one
        # would move it by half the last digit
        rec = {"steps": sum(r["steps"] for r in recs) // len(recs), "wall_s": round(sum(r["wall_s"] for r in recs), 2),
               "env_steps_per_sec": round(rate, 2), "e2e_over_device_only": round(rate / device_rate, 3)}
        rec.update({k: round(float(np.mean([r[k] for r in recs])), 5) for k in THROUGHPUT_KEYS if k in recs[0]})
        rec["runs"] = recs
        out[arm] = rec
    s, p = out["serial"], out["pipelined"]
    if s["env_steps_per_sec"] > 0:
        out["pipelined_over_serial"] = round(p["env_steps_per_sec"] / s["env_steps_per_sec"], 3)
    out["note"] = ("the weight publish is kept out of both arms (the same work either way); on the CPU the 'device' "
                   "step runs on the host cores the lane uses, bounded by the host_concurrency probe")
    return out


def section_transfer_layout(reps: int, platform: str = ""):
    """The same batch bytes host to device as a tree of 17 leaves, as four
    group buffers and as one u8 buffer, each copy waited for: ms per
    transfer on this device."""
    from dotaclient_tpu_torch import resolve_device
    from dotaclient_tpu_torch.parallel.fused_io import FusedBatchIO, TreeBatchIO
    from dotaclient_tpu_torch.parallel.train_step import batch_template

    device = resolve_device("cpu" if platform == "cpu" else None)
    cfg = parity_config("abov_layout", True, True, platform=platform)
    template = batch_template(cfg)
    groups_io = FusedBatchIO(template, device, single=False)
    single_io = FusedBatchIO(template, device, single=True)
    arms = {
        "tree_leaves_ms": (TreeBatchIO(device), template),
        "groups_4_buffers_ms": (groups_io, groups_io.pack_transfer(template)),
        "single_buffer_ms": (single_io, single_io.pack_transfer(template)),
    }

    def timed(io, payload):
        io.transfer(payload)
        sync_device(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            io.transfer(payload)
            sync_device(device)
        return (time.perf_counter() - t0) / reps * 1e3

    out = {k: round(timed(io, payload), 4) for k, (io, payload) in arms.items()}
    out["copies"] = {"tree_leaves_ms": 17, "groups_4_buffers_ms": len(groups_io.layout.group_cols),
                     "single_buffer_ms": 1}
    out["note"] = ("each transfer waited for to completion; the tree's leaves are pageable numpy memory, the group "
                   "and single buffers pinned on the card")
    return out


def section_schedcheck():
    """The port's PrefetchModel: the protocol explores exhausted and clean,
    every mutant fails exploration."""
    from dotaclient_tpu_torch.analysis.schedcheck import PrefetchModel, explore

    head = explore(PrefetchModel(depth=2, batches=3))
    out = {"head_exhausted": head.exhausted, "head_violations": len(head.violations), "head_states": head.states,
           "mutants": {}}
    for m in PREFETCH_MUTANTS:
        r = explore(PrefetchModel(depth=2, batches=3, mutant=m))
        out["mutants"][m] = {"violations": len(r.violations), "caught": bool(r.violations)}
    out["ok"] = bool(head.exhausted and not head.violations and all(v["caught"] for v in out["mutants"].values()))
    return out


HOST_BOUND = ("overlap_ok",)


def verdict_of(result: dict, cfg_defaults: LearnerConfig) -> dict:
    """The reference's verdict: the 0.98 bar judged only where the host
    concurrency probe keeps >= 0.97 of compute; the no-regression bar and
    every bitwise and default check on every host."""
    probe = result["host_concurrency"]["compute_retention_with_helper"]
    host_can_overlap = probe >= 0.97
    tp = result["throughput"]
    ratio = tp["pipelined"]["e2e_over_device_only"]
    pipe_over_serial = tp.get("pipelined_over_serial", 0.0)
    v = {
        "bar_e2e_over_device_only": 0.98,
        "e2e_over_device_only_pipelined": ratio,
        "e2e_over_device_only_serial": tp["serial"]["e2e_over_device_only"],
        "host_compute_retention_with_helper": probe,
        "host_can_express_overlap": bool(host_can_overlap),
        "overlap_ok": bool(ratio >= 0.98 or not host_can_overlap),
        "overlap_caveat": (
            None if host_can_overlap else f"host concurrency probe: compute retains {probe}x of its rate beside a "
            f"helper thread, so hiding the lane behind the step is physically bounded here"
        ),
        "bar_pipelined_over_serial": 0.9,
        "pipelined_over_serial": pipe_over_serial,
        "no_regression_ok": bool(pipe_over_serial >= 0.9),
        "params_bitwise_identical": bool(result["parity"]["all_identical"]),
        "pipeline_overlap_ratio": tp["pipelined"].get("pipeline_overlap_ratio"),
        "fused_single_h2d_default_on": bool(cfg_defaults.fused_single_h2d),
        "prefetch_default_on": bool(cfg_defaults.learner.prefetch),
        "schedcheck_ok": bool(result["schedcheck_prefetch"]["ok"]),
    }
    v["all_green"] = all(v[k] for k in ("overlap_ok", "no_regression_ok", "params_bitwise_identical",
                                       "fused_single_h2d_default_on", "prefetch_default_on", "schedcheck_ok"))
    return v


def run(args) -> dict:
    from dotaclient_tpu_torch.obs.preflight import check as preflight_check
    from dotaclient_tpu_torch.scripts.train_north_star import hardware_line

    steps = 6 if args.quick else 12
    reps = 10 if args.quick else 40
    host = preflight_check("ab_overlap")
    log_dir = tempfile.mkdtemp(prefix="abov_logs_")
    t_start = time.time()
    cfg_defaults = LearnerConfig()
    try:
        result = {
            "generated_by": "dotaclient_tpu_torch/scripts/ab_overlap.py",
            "hardware": hardware_line(args.platform),
            "config": {
                "batch": [B, T, H],
                "parity_steps": steps,
                "throughput_steps": steps * 2,
                "quick": bool(args.quick),
                "seed": 0,
                "prefetch_default_on": bool(cfg_defaults.learner.prefetch),
                "prefetch_depth_default": int(cfg_defaults.learner.prefetch_depth),
                "fused_single_h2d_default_on": bool(cfg_defaults.fused_single_h2d),
            },
            "host_preflight": host,
            "host_concurrency": section_host_concurrency(reps),
            "parity": section_parity(steps, log_dir, args.platform),
            "throughput": section_throughput(steps * 2, log_dir, args.platform),
            "transfer_layout": section_transfer_layout(reps, args.platform),
            "schedcheck_prefetch": section_schedcheck(),
        }
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    result["verdict"] = verdict_of(result, cfg_defaults)
    result["wall_s"] = round(time.time() - t_start, 1)
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="fewer steps/reps")
    ap.add_argument("--out", default="overlap_ab_torch.json")
    # "" = the CUDA device; "cpu" runs the learners on the host
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
