"""Transformer-family train-step micro-bench: device-only fwd+bwd rates
across context lengths, dense vs blockwise attention, remat on/off (twin
of scripts/bench_tf.py).

Prices the long-context family next to the LSTM flagship: env steps/s,
ms per step and the analytic MFU at each shape (ops/flops.py's
transformer model over the card's bf16 peak). The ladder is the
reference's: contexts 64 / 128 / 256 at batch 64, dense at every length,
blockwise (64) and blockwise + remat from 128 up. Each row builds
`build_train_step` over one batch of tensors on the device and times
`--iters` steps after a first one (`compile_s`: its wall; eager PyTorch
compiles nothing, so it is the first step's time).

A CPU run (`--platform cpu`) writes the artifact too, labeled by backend:
a relative shape study, never a claim about the card.

Run: python -m dotaclient_tpu_torch.scripts.bench_tf [--out tf_bench_torch.json] [--iters 10] [--batch 64]
"""

from __future__ import annotations

import argparse
import json
import time

# (tf_context, attn_block, remat): dense rows at every length; blockwise and
# blockwise + remat from 128 up (the reference's loop, as a list)
LADDER = ((64, 0, False), (128, 0, False), (128, 64, False), (128, 64, True),
          (256, 0, False), (256, 64, False), (256, 64, True))
# The smoke's cut: 3 timed steps per shape (the reference's 10).
SMOKE_CUT = dict(iters=3)


def ladder_config(tf_context: int, attn_block: int, remat: bool, batch: int):
    """The reference's LearnerConfig for one shape: the chunk fills the
    context (the bootstrap frame included), 2 layers, 4 heads."""
    from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig

    return LearnerConfig(batch_size=batch, seq_len=tf_context - 1, policy=PolicyConfig(
        arch="transformer", tf_layers=2, tf_heads=4, tf_context=tf_context, tf_attn_block=attn_block,
        tf_remat=remat))


def bench_config(tf_context: int, attn_block: int, remat: bool, batch: int, iters: int, device=None,
                 measure=None) -> dict:
    """One row of the ladder. `measure(run, state, metrics)`, if given, is
    called before the timed steps with `run` (one more step), the state
    after the first step (read it before calling `run`, which updates it
    in place) and that step's metrics; its dict joins the row (the chip
    smoke's device time, busy share and parity reads)."""
    from dotaclient_tpu_torch import resolve_device
    from dotaclient_tpu_torch.obs.compute import fence
    from dotaclient_tpu_torch.ops import flops as flops_mod
    from dotaclient_tpu_torch.ops.batch import make_train_batch
    from dotaclient_tpu_torch.parallel.fused_io import TreeBatchIO
    from dotaclient_tpu_torch.parallel.train_step import build_train_step, init_train_state
    from dotaclient_tpu_torch.runtime.staging import cast_obs_to_compute_dtype

    device = resolve_device(device)
    cfg = ladder_config(tf_context, attn_block, remat, batch)
    train_step = build_train_step(cfg, device)
    state = init_train_state(cfg, device)
    io = TreeBatchIO(device)  # the batch as a tree of device tensors, obs staged in the compute dtype
    batch_dev = io.consume(*io.transfer(cast_obs_to_compute_dtype(cfg, make_train_batch(cfg, 0))))
    t_compile = time.perf_counter()
    state, metrics = train_step(state, batch_dev)
    metrics["loss"].item()
    fence(device)
    compile_s = time.perf_counter() - t_compile
    first = {k: v.item() for k, v in metrics.items()}
    holder = [state]

    def run():
        holder[0], m = train_step(holder[0], batch_dev)
        return m

    extra = measure(run, state, first) if measure is not None else {}
    t0 = time.perf_counter()
    for _ in range(iters):
        metrics = run()
    metrics["loss"].item()
    fence(device)
    dt = (time.perf_counter() - t0) / iters
    model_flops = flops_mod.train_step_flops(cfg)
    peak = flops_mod.device_peak_flops(device)
    row = {
        "tf_context": tf_context,
        "seq_len": cfg.seq_len,
        "batch": batch,
        "attn_block": attn_block,
        "remat": remat,
        "step_ms": round(dt * 1e3, 2),
        "env_steps_per_sec": round(batch * cfg.seq_len / dt, 1),
        "flops_per_step_model": round(model_flops),
        "mfu_pct": round(100.0 * model_flops / dt / peak, 3) if peak else None,
        "compile_s": round(compile_s, 1),
    }
    row.update(extra)
    return row


def run(args, ladder=LADDER) -> dict:
    from dotaclient_tpu_torch import resolve_device
    from dotaclient_tpu_torch.scripts.train_north_star import hardware_line

    device = resolve_device("cpu" if args.platform == "cpu" else None)
    rows = []
    for ctx, attn_block, remat in ladder:
        try:
            rows.append(bench_config(ctx, attn_block, remat, args.batch, args.iters, device))
            print(json.dumps(rows[-1]), flush=True)
        except Exception as e:  # one failed shape must not void the rest
            rows.append({"tf_context": ctx, "attn_block": attn_block, "remat": remat,
                         "error": f"{type(e).__name__}: {e}"[:300]})
    return {
        "backend": device.type,
        "device": hardware_line(args.platform),
        "valid_as_silicon_evidence": device.type == "cuda",
        "config": "transformer d_model=128 L=2 H=4, device-only train step, 1 device",
        "rows": rows,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="tf_bench_torch.json")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--batch", type=int, default=64)
    # "" = the CUDA device (raises without one); "cpu" the host
    p.add_argument("--platform", default="", choices=("", "cpu"))
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    artifact = run(args)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(json.dumps(artifact, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
