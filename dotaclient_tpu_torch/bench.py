"""Benchmark: end-to-end PPO learner throughput, host pipeline and train
step on the CUDA device (twin of the root bench.py).

Prints ONE JSON line (and writes it to `--out`):
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": null, ...}

The metric: learner env steps per second over the FULL learner path
(broker consume -> deserialize -> staleness filter -> pack/pad -> the
side-stream H2D of one [B, row_bytes] buffer -> the train step), fed by
producer threads republishing pre-serialized rollout frames, at the
flagship configuration (128-hidden LSTM policy, bf16 compute, batch
256 x 16), through the learner's pipelined loop (its PrefetchLane) with
a weight publish every step. Beside it, the sections of the reference's
main: the device-only rate, the host-pipeline-only rate, the classic pack
against the concat landing of shard-assembled rows, the traced stage
breakdown, the fenced compute breakdown and the transfer-layout A/B.

What does not carry over from the reference:
- `vs_baseline` is null: the reference divides by a per-chip share of an
  accelerator rate this card has none of (`vs_baseline_reason`);
- `flops_per_step_xla` is null: there is no compiler cost analysis;
- `compute_breakdown.recompiles` counts new batch signatures and
  `first_call_s` is 0 (eager PyTorch compiles nothing);
- the accelerator probe and its CPU fallback: `--platform ""` is the card
  (asserted: it raises without one), `--platform cpu` the host.

`DOTACLIENT_TPU_BENCH_PACK_WORKERS=N` runs staging with N pack workers (the
ring path), `DOTACLIENT_TPU_BENCH_SINGLE=1` adds an e2e run of the group
(4-buffer) transfer layout, as in the reference.

Run: python -m dotaclient_tpu_torch.bench [--platform cpu] [--out bench_torch.json]
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import threading
import time

# The reference's repetition counts; SMOKE_CUT is the chip smoke's cut.
DEPTHS = dict(device_iters=20, pack_window_s=3.0, asm_reps=7, e2e_iters=12, trace_batches=6, compute_steps=4,
              put_reps=8)
SMOKE_CUT = dict(device_iters=5, pack_window_s=1.0, asm_reps=3, e2e_iters=6, trace_batches=3, compute_steps=2,
                 put_reps=3)
VS_BASELINE_REASON = ("the reference's baseline is a per-chip share of an accelerator rate of another kind of chip; "
                      "this port states no such rate")


def _make_frames(cfg, n_frames: int):
    """Pre-serialized rollout frames of length seq_len from one
    RandomState(0) stream: the reference bench's producer frames, byte for
    byte."""
    import numpy as np

    from dotaclient_tpu_torch.env import featurizer as F
    from dotaclient_tpu_torch.ops.action_dist import Action
    from dotaclient_tpu_torch.transport.serialize import Rollout, serialize_rollout

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


def _start_producers(cfg, broker_name: str, n_threads: int = 2, name: str = "bench-producer",
                     stamp=None) -> threading.Event:
    """Producer threads republishing 512 pre-serialized frames (256 when
    `stamp` is given), depth-throttled to keep about three batches queued:
    an unthrottled spin into a bounded drop-oldest queue models no real
    fleet and burns the cores the loop runs on. `stamp(frame, i)` rewrites
    each frame as it is published (the traced section's fresh trace id and
    birth time). Set the returned event to stop them."""
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect

    mem.reset(broker_name)
    producer_conn = connect(f"mem://{broker_name}", maxlen=cfg.batch_size * 4)
    frames = _make_frames(cfg, 512 if stamp is None else 256)
    stop = threading.Event()
    high_water = cfg.batch_size * 3

    def producer():
        i = 0
        while not stop.is_set():
            if producer_conn.experience_depth() >= high_water:
                time.sleep(0.001)
                continue
            frame = frames[i % len(frames)]
            producer_conn.publish_experience(frame if stamp is None else stamp(frame, i))
            i += 1

    for k in range(n_threads):
        threading.Thread(target=producer, daemon=True, name=f"{name}-{k}").start()
    return stop


def bench_config(pack_workers: int = 1, single: bool = True):
    """The flagship LearnerConfig: 256 x 16, the default policy, the
    single-buffer transfer (`single`) or the group layout."""
    from dotaclient_tpu_torch.config import LearnerConfig

    cfg = LearnerConfig(batch_size=256, seq_len=16, fused_single_h2d=single)
    cfg.staging.pack_workers = pack_workers
    return cfg


def _device_of(platform: str):
    from dotaclient_tpu_torch import resolve_device

    return resolve_device("cpu" if platform == "cpu" else None)


def _median_s(fn, reps: int) -> float:
    import numpy as np

    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t)
    return float(np.median(walls))


def _host_batch(cfg):
    from dotaclient_tpu_torch.ops.batch import make_train_batch
    from dotaclient_tpu_torch.runtime.staging import cast_obs_to_compute_dtype

    return cast_obs_to_compute_dtype(cfg, make_train_batch(cfg, 0))


def section_device_only(cfg, step, io, state, device, iters: int):
    """(steps/s, state, the device payload): the train step over one
    pre-packed device batch, no host pipeline."""
    from dotaclient_tpu_torch.obs.compute import fence

    payload = io.consume(*io.transfer(io.pack_transfer(_host_batch(cfg))))
    state, metrics = step(state, payload)
    fence(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = step(state, payload)
    metrics["loss"].item()
    fence(device)
    return cfg.batch_size * cfg.seq_len * iters / (time.perf_counter() - t0), state, payload


def section_packer_only(cfg, io, window_s: float) -> float:
    """Env steps/s of broker -> staging -> packed transfer buffers, no
    device work."""
    import numpy as np

    from dotaclient_tpu_torch.runtime.staging import StagingBuffer
    from dotaclient_tpu_torch.transport.base import connect

    stop = _start_producers(cfg, "bench_pack")
    staging = StagingBuffer(cfg, connect("mem://bench_pack"), version_fn=lambda: 0, fused_io=io).start()

    def release():
        # ring mode: the slot goes back to the packers (no copy reads it here)
        lease = staging.last_batch_lease
        if lease is not None:
            # graftlint: disable=LIF001(no device copy of this slot: its rows were read on the host before the release)
            lease.release()

    try:
        staging.get_batch(timeout=120.0)  # the pipe warm
        release()
        steps = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < window_s:
            b = staging.get_batch(timeout=120.0)
            if b is None:
                raise RuntimeError("packer-only staging starved (timeout)")
            steps += int(np.sum(b.mask))  # read before the release: b's leaves view the slot
            release()
        return steps / (time.perf_counter() - t0)
    finally:
        stop.set()
        staging.stop()


def section_assembly_pair(cfg, io, reps: int):
    """(classic pack s, concat landing s) per batch, median of `reps`: the
    production pack of 256 frames into fresh transfer views against the
    landing of the same frames' shard-assembled rows."""
    import numpy as np
    import torch

    from dotaclient_tpu_torch.runtime.staging import fill_rollouts
    from dotaclient_tpu_torch.transport.assemble import RowAssembler
    from dotaclient_tpu_torch.transport.serialize import deserialize_rollout

    frames = _make_frames(cfg, cfg.batch_size)
    obs_bf16 = cfg.stage_obs_compute_dtype and cfg.policy.dtype == "bfloat16"
    asm = RowAssembler(cfg.seq_len, cfg.policy.lstm_hidden, cfg.policy.aux_heads, obs_bf16)
    payloads = [bytes(asm.assemble(f).payload) for f in frames]
    lib = None
    if cfg.native_packer:
        from dotaclient_tpu_torch import native

        lib = native.load_packer()
    items = frames if lib is not None else [deserialize_rollout(f) for f in frames]

    def classic_pack():
        _payload, outb = io.alloc_transfer()
        if lib is not None:
            native.pack_frames(lib, items, cfg.seq_len, cfg.policy.lstm_hidden, cfg.policy.aux_heads, obs_bf16, outb)
        else:
            fill_rollouts(outb, items, cfg.seq_len)

    def concat_land():
        payload, _outb = io.alloc_transfer()
        raw = np.frombuffer(b"".join(payloads), np.uint8).reshape(len(payloads), io.row_bytes)
        if isinstance(payload, dict):
            for key, t in payload.items():
                u8 = t.view(torch.uint8).numpy()
                off = io.layout.seg_off[key]
                u8[: len(payloads)] = raw[:, off : off + u8.shape[1]]
        else:
            payload.numpy()[: len(payloads)] = raw

    return _median_s(classic_pack, reps), _median_s(concat_land, reps)


def section_e2e(cfg, step, io, state, device, iters: int):
    """The pipelined loop over producer-fed staging: the learner's
    PrefetchLane stages batch N+1 (staging pop, the side-stream H2D, the
    ring lease released once the copy is done) while step N runs, and the
    loop publishes the weights every step as Learner.run does. Returns
    (env steps/s, the accumulators, state)."""
    from dotaclient_tpu_torch.obs.compute import fence
    from dotaclient_tpu_torch.parallel.train_step import whole_params
    from dotaclient_tpu_torch.runtime.learner import ParamFlattener, PrefetchLane, WeightPublisher
    from dotaclient_tpu_torch.runtime.staging import StagingBuffer
    from dotaclient_tpu_torch.transport.base import connect

    import numpy as np

    stop = _start_producers(cfg, "bench")
    staging = StagingBuffer(cfg, connect("mem://bench"), version_fn=lambda: 0, fused_io=io).start()
    flattener = ParamFlattener(state.net)
    publisher = WeightPublisher(connect("mem://bench"), materialize=flattener.to_named).start()
    lane = None

    def fetch():
        # wait = the staging queue wait; put = the H2D alone (the learner's _fetch_next)
        t0 = time.perf_counter()
        b, payload = staging.get_batch_groups(timeout=120.0)
        if b is None:
            raise RuntimeError("staging starved (timeout)")
        steps = int(np.sum(b.mask))
        lease = staging.last_batch_lease
        t1 = time.perf_counter()
        dev = io.transfer(payload)
        if lease is not None:
            # ring mode: the slot may be repacked once released, so its copy completes first
            if dev[1] is not None:
                dev[1].synchronize()
            lease.release()
        return dev, steps, t1 - t0, time.perf_counter() - t1, None

    try:
        warm, _, _, _, _ = fetch()
        state, metrics = step(state, io.consume(*warm))
        flattener.to_named(flattener.flatten_on_device(whole_params(state)))  # the first publish outside the window
        fence(device)
        env_steps = 0
        t_wait = t_put = t_take = 0.0
        # t0 before the lane starts: its first fetch lands in the accumulators
        t0 = time.perf_counter()
        lane = PrefetchLane(fetch, depth=1, limit=iters).start()
        for i in range(iters):
            tb = time.perf_counter()
            item = lane.get(timeout=150.0)  # the lane's own fetch gives up at 120 s
            t_take += time.perf_counter() - tb
            if item.kind == "error":
                raise item.error
            state, metrics = step(state, io.consume(*item.batch))
            publisher.submit(flattener.flatten_on_device(whole_params(state)), i + 1)
            env_steps += item.env_steps
            t_wait += item.wait_s
            t_put += item.put_s
        metrics["loss"].item()
        fence(device)
        dt = time.perf_counter() - t0
    finally:
        if lane is not None:
            lane.stop()
        publisher.stop()
        stop.set()
        staging.stop()
    return env_steps / dt, dict(dt=dt, wait=t_wait, put=t_put, take=t_take), state


def section_alt_layout(cfg, device, iters: int):
    """The e2e rate of the other transfer layout (DOTACLIENT_TPU_BENCH_SINGLE=1),
    a serial fetch-then-step loop over its own build and staging."""
    import numpy as np

    from dotaclient_tpu_torch.obs.compute import fence
    from dotaclient_tpu_torch.parallel.train_step import (build_fused_train_step, build_single_train_step,
                                                          init_train_state)
    from dotaclient_tpu_torch.runtime.staging import StagingBuffer
    from dotaclient_tpu_torch.transport.base import connect

    scfg = dataclasses.replace(cfg, fused_single_h2d=not cfg.fused_single_h2d)
    build = build_single_train_step if scfg.fused_single_h2d else build_fused_train_step
    step, io = build(scfg, device)
    state = init_train_state(scfg, device)
    stop = _start_producers(scfg, "bench_alt")
    staging = StagingBuffer(scfg, connect("mem://bench_alt"), version_fn=lambda: 0, fused_io=io).start()

    def fetch():
        b, payload = staging.get_batch_groups(timeout=120.0)
        if b is None:
            raise RuntimeError("alt-layout staging starved (timeout)")
        steps = int(np.sum(b.mask))
        lease = staging.last_batch_lease
        dev = io.transfer(payload)
        if lease is not None:
            if dev[1] is not None:
                dev[1].synchronize()
            lease.release()
        return dev, steps

    try:
        warm, _ = fetch()
        state, metrics = step(state, io.consume(*warm))
        fence(device)
        nxt, nxt_steps = fetch()
        done = 0
        t0 = time.perf_counter()
        for _ in range(iters):
            dev, n = nxt, nxt_steps
            state, metrics = step(state, io.consume(*dev))
            done += n
            nxt, nxt_steps = fetch()
        metrics["loss"].item()
        fence(device)
        return done / (time.perf_counter() - t0)
    finally:
        stop.set()
        staging.stop()


def section_trace(cfg, step, io, state, batches: int):
    """Mean ms per pipeline hop (consume -> staging_admit -> pack -> h2d ->
    apply) and the actor-to-apply e2e, over DTR2 frames stamped with a
    fresh trace id and birth time at each publish. Returns (breakdown,
    state)."""
    from dotaclient_tpu_torch.obs.trace import PipelineTracer
    from dotaclient_tpu_torch.runtime.staging import StagingBuffer
    from dotaclient_tpu_torch.transport.base import connect
    from dotaclient_tpu_torch.transport.serialize import stamp_rollout_trace

    tracer = PipelineTracer()
    stop = _start_producers(cfg, "bench_trace", stamp=lambda f, i: stamp_rollout_trace(f, i + 1, time.time()))
    staging = StagingBuffer(cfg, connect("mem://bench_trace"), version_fn=lambda: 0, fused_io=io,
                            tracer=tracer).start()
    try:
        for _ in range(batches):
            b, payload = staging.get_batch_groups(timeout=120.0)
            if b is None:
                raise RuntimeError("traced staging starved (timeout)")
            trace, lease = staging.last_batch_trace, staging.last_batch_lease
            dev = io.transfer(payload)
            if lease is not None:
                if dev[1] is not None:
                    dev[1].synchronize()
                lease.release()
            if trace is not None:
                tracer.hop_batch("h2d", trace)
            state, metrics = step(state, io.consume(*dev))
            if trace is not None:
                tracer.hop_batch("apply", trace)
                tracer.e2e(trace)
        metrics["loss"].item()
    finally:
        stop.set()
        staging.stop()
    sc = tracer.scalars()
    out = {k.replace("trace_", "").replace("_mean_ms", "_ms"): round(v, 3) for k, v in sc.items()
           if k.endswith("_mean_ms")}
    if "trace_e2e_actor_apply_s" in sc:
        out["e2e_actor_apply_s"] = round(sc["trace_e2e_actor_apply_s"], 4)
    return out, state


def section_compute(cfg, step, io, state, device, steps: int):
    """The fenced pack / h2d / device-step split of the same step over one
    host batch, and the signature sentinel's count. Returns (section,
    state)."""
    from dotaclient_tpu_torch.obs.compute import RecompileSentinel, StepPhaseTimer, fence

    host_batch = _host_batch(cfg)
    sentinel = RecompileSentinel(step, label="bench_train_step")
    ph = StepPhaseTimer()
    for _ in range(steps):
        t0 = time.perf_counter()
        payload = io.pack_transfer(host_batch)
        t1 = time.perf_counter()
        ph.add("pack", t1 - t0)
        dev, ready = io.transfer(payload)
        if ready is not None:
            ready.synchronize()
        t2 = time.perf_counter()
        ph.add("h2d", t2 - t1)
        state, metrics = sentinel(state, io.consume(dev, ready))
        metrics["loss"].item()
        fence(device)
        t3 = time.perf_counter()
        ph.add("device_step", t3 - t2)
        ph.step(t3 - t0)
    sc = ph.window_scalars()
    return {
        "phase_pack_s": round(sc["compute_phase_pack_s"], 5),
        "phase_h2d_s": round(sc["compute_phase_h2d_s"], 5),
        "phase_device_step_s": round(sc["compute_phase_device_step_s"], 5),
        "phase_wall_s": round(sc["compute_phase_wall_s"], 5),
        "recompiles": sentinel.recompiles,
        "first_call_s": round(sentinel.last_compile_s, 4),
        "note": "fenced per-phase split outside the headline window; fetch/host are learner-loop phases a "
                "pre-packed bench batch does not exercise; eager PyTorch compiles nothing, so first_call_s is 0 "
                "and recompiles counts new batch signatures",
    }, state


def section_transfer_layout(cfg, io, device, reps: int):
    """Blocked H2D of the same batch bytes as 17 leaves, 4 dtype groups and
    one byte buffer, each copy on its io's side stream."""
    from dotaclient_tpu_torch.obs.compute import fence
    from dotaclient_tpu_torch.parallel.fused_io import FusedBatchIO, TreeBatchIO
    from dotaclient_tpu_torch.parallel.train_step import batch_template

    host_batch = _host_batch(cfg)
    arms = {
        "tree_17_leaves_ms": (TreeBatchIO(device), host_batch),
        "groups_4_buffers_ms": None,
        "single_buffer_ms": None,
    }
    groups_io = FusedBatchIO(batch_template(cfg), device, single=False)
    single_io = FusedBatchIO(batch_template(cfg), device, single=True)
    arms["groups_4_buffers_ms"] = (groups_io, groups_io.pack_transfer(host_batch))
    single = single_io.pack_transfer(host_batch)
    arms["single_buffer_ms"] = (single_io, single)

    def put(arm):
        arm_io, payload = arm
        _dev, ready = arm_io.transfer(payload)
        if ready is not None:
            ready.synchronize()
        fence(device)

    out = {}
    for key, arm in arms.items():
        put(arm)  # warm
        t0 = time.perf_counter()
        for _ in range(reps):
            put(arm)
        out[key] = round((time.perf_counter() - t0) / reps * 1e3, 3)
    out["bytes"] = int(single.numel())
    out["note"] = ("blocked H2D of the same batch bytes, each layout on its io's side stream (from pinned buffers "
                   "but the 17 leaves, which are pageable)")
    return out


def run(platform: str = "", depths=None, base=None) -> dict:
    """Every section at `depths` (DEPTHS, or SMOKE_CUT's cut) for the
    flagship config (or `base`, a smaller LearnerConfig for the CPU
    tests); the one result dict."""
    import numpy as np

    from dotaclient_tpu_torch.ops import flops as flops_mod
    from dotaclient_tpu_torch.parallel.train_step import (build_fused_train_step, build_single_train_step,
                                                          init_train_state, whole_params)
    from dotaclient_tpu_torch.scripts.train_north_star import hardware_line
    from dotaclient_tpu_torch.transport.serialize import cast_rollout_obs_bf16, deserialize_rollout, serialize_rollout

    d = dict(DEPTHS, **(depths or {}))
    device = _device_of(platform)
    card = hardware_line("cpu" if device.type == "cpu" else "")
    pack_workers = int(os.environ.get("DOTACLIENT_TPU_BENCH_PACK_WORKERS", "1") or 1)
    cfg = bench_config(pack_workers) if base is None else copy.deepcopy(base)
    cfg.staging.pack_workers = pack_workers
    build = build_single_train_step if cfg.fused_single_h2d else build_fused_train_step
    step, io = build(cfg, device)
    state = init_train_state(cfg, device)

    device_rate, state, batch = section_device_only(cfg, step, io, state, device, d["device_iters"])
    packer_rate = section_packer_only(cfg, io, d["pack_window_s"])
    host_pack_cpu_s, host_concat_s = section_assembly_pair(cfg, io, d["asm_reps"])
    e2e_rate, acc, state = section_e2e(cfg, step, io, state, device, d["e2e_iters"])
    n_iters, dt = d["e2e_iters"], acc["dt"]
    lane_work_s = acc["wait"] + acc["put"]
    overlap = max(0.0, min(1.0, 1.0 - acc["take"] / lane_work_s)) if lane_work_s > 0 else 1.0
    device_s_per_iter = cfg.batch_size * cfg.seq_len / device_rate
    device_idle_s_per_iter = max(dt / n_iters - device_s_per_iter, 0.0)

    e2e_alt = e2e_alt_err = None
    alt_layout = "groups_4_buffers" if cfg.fused_single_h2d else "single_buffer"
    if os.environ.get("DOTACLIENT_TPU_BENCH_SINGLE") == "1":
        try:
            e2e_alt = section_alt_layout(cfg, device, n_iters)
        except Exception as e:
            e2e_alt_err = f"{type(e).__name__}: {e}"[:300]
    try:
        trace_breakdown, state = section_trace(cfg, step, io, state, d["trace_batches"])
    except Exception as e:
        trace_breakdown = {"error": f"{type(e).__name__}: {e}"[:200]}
    try:
        compute_section, state = section_compute(cfg, step, io, state, device, d["compute_steps"])
    except Exception as e:
        compute_section = {"error": f"{type(e).__name__}: {e}"[:200]}
    try:
        transfer_ab = section_transfer_layout(cfg, io, device, d["put_reps"])
    except Exception:
        transfer_ab = None

    frame = _make_frames(cfg, 1)[0]
    wire_step_bytes = len(frame) / cfg.seq_len
    wire_step_bytes_bf16 = len(serialize_rollout(cast_rollout_obs_bf16(deserialize_rollout(frame)))) / cfg.seq_len
    model_flops = flops_mod.train_step_flops(cfg)
    achieved_flops = model_flops * n_iters / dt  # the consumed update rate: padding is computed too
    peak = flops_mod.device_peak_flops(device)
    host_batch = _host_batch(cfg)
    h2d_bytes = sum(t.numel() * t.element_size() for t in (batch.values() if isinstance(batch, dict) else [batch]))
    obs_leaves = (host_batch.obs.global_feats, host_batch.obs.hero_feats, host_batch.obs.unit_feats)
    h2d_obs_bytes = sum(int(leaf.nbytes) for leaf in obs_leaves)
    pack_obs_dtype = str(obs_leaves[0].dtype).replace("torch.", "")
    d2h_bytes = 4 * sum(p.numel() for p in whole_params(state).values())  # the fused f32 publish buffer

    on_card = device.type == "cuda"
    return {
        "metric": "ppo_learner_env_steps_per_sec",
        "platform": "gpu" if on_card else "cpu",
        "value": round(e2e_rate, 1),
        "unit": (f"env-steps/sec end-to-end (1 {'chip(s)' if on_card else 'CPU device(s)'}: {card}, batch "
                 f"{cfg.batch_size}x{cfg.seq_len}; device-step-only rate {round(device_rate, 1)}; host-packer-only "
                 f"rate {round(packer_rate, 1)})"),
        "vs_baseline": None,
        "vs_baseline_reason": VS_BASELINE_REASON,
        "split": {
            "wait_batch_s": round(acc["wait"] / n_iters, 5),
            "device_put_s": round(acc["put"] / n_iters, 5),
            "take_wait_s": round(acc["take"] / n_iters, 5),
            "residual_step_s": round(max(dt - acc["take"], 0.0) / n_iters, 5),
        },
        "device_only_steps_per_sec": round(device_rate, 1),
        "packer_only_steps_per_sec": round(packer_rate, 1),
        "pack_workers": pack_workers,
        "host_pack_cpu_s_per_batch": round(host_pack_cpu_s, 6),
        "host_concat_s_per_batch": round(host_concat_s, 6),
        "e2e_over_device_only": round(e2e_rate / device_rate, 3),
        "pipeline_overlap_ratio": round(overlap, 3),
        "pipeline": {
            "prefetch_s_per_iter": round(lane_work_s / n_iters, 5),
            "take_wait_s_per_iter": round(acc["take"] / n_iters, 5),
            "device_idle_s_per_iter": round(device_idle_s_per_iter, 5),
            "prefetch_depth": 1,
            "transfer_layout": "single_buffer" if cfg.fused_single_h2d else "groups_4_buffers",
        },
        "flops_per_step_model": round(model_flops),
        "flops_per_step_xla": None,
        "achieved_flops_per_sec": round(achieved_flops),
        "mfu_pct": round(100.0 * achieved_flops / peak, 3) if peak else None,
        "h2d_bytes_per_iter": int(h2d_bytes),
        "h2d_obs_bytes_per_iter": int(h2d_obs_bytes),
        "pack_path_obs_dtype": pack_obs_dtype,
        "wire_bytes_per_env_step": round(wire_step_bytes, 1),
        "wire_bytes_per_env_step_bf16": round(wire_step_bytes_bf16, 1),
        "d2h_bytes_per_iter": int(d2h_bytes),
        "transfer_layout_ab": transfer_ab,
        "trace_stage_breakdown": trace_breakdown,
        "compute_breakdown": compute_section,
        **({"e2e_alt_layout_steps_per_sec": round(e2e_alt, 1), "e2e_alt_layout": alt_layout}
           if e2e_alt is not None else {}),
        **({"e2e_alt_layout_error": e2e_alt_err} if e2e_alt_err is not None else {}),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # "" = the CUDA device (raises without one); "cpu" the host
    ap.add_argument("--platform", default="", choices=("", "cpu"))
    ap.add_argument("--out", default="bench_torch.json")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    """The one JSON line, on stdout and in `--out`; a failure prints the
    reference's error line (value 0, `error`) and still exits 0."""
    args = parse_args(argv)
    try:
        out = run(args.platform)
    except Exception as e:  # never a traceback: the one-JSON-line contract
        out = {"metric": "ppo_learner_env_steps_per_sec", "value": 0.0, "unit": "env-steps/sec end-to-end",
               "vs_baseline": None, "error": f"{type(e).__name__}: {e}"[:500]}
    line = json.dumps(out)
    with open(args.out, "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
