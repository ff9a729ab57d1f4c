#!/usr/bin/env python3
"""GPU smoke of the PyTorch port (`dotaclient_tpu_torch`).

Run from the repository root on a machine with one NVIDIA GPU and the
CUDA toolkit:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. device   — the card's name and power limit (nvidia-smi), torch/CUDA versions;
2. build    — compiles every hand-written kernel from csrc/ (nvcc, in parallel);
3. kernels  — each kernel against its plain PyTorch version on the card at
              the main path's shapes, with stated tolerances, and timed
              (CUDA events) beside its bound and a library yardstick;
4. serving  — the flagship policy's batched actor step over 64 rows for 12
              ticks with resident carries and one episode reset;
5. learner  — the PPO loss forward (teacher-forced unroll through the LSTM
              kernel, GAE, clipped surrogate) at batch 256 x seq_len 16,
              held against the same forward through the plain recurrence.
The kernels' launch counters are zeroed before phase 4 and read right
after the main path's learner forward. The last lines are one JSON object
per kernel, the card line, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM rate and the
# per-type arithmetic peaks used for each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Kernel vs plain version, both on the card. f32: the kernel's serial FMA
# chain and cuBLAS's blocked sums round differently (~1e-6 per step),
# and 17 dependent steps carry that forward. bf16: h is rounded to bf16
# before every product, so a last-bit difference in z can move one h by a
# bf16 ulp (2^-8 relative) and the next steps carry it.
TOL_KERNEL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Learner forward through the kernel vs through the plain scan: the same
# bf16 ulp flips of h, averaged by every masked mean into the metrics.
TOL_LEARNER = 5e-3
# Batched serving row vs its B=1 forward: the bf16 trunk matmuls run as
# GEMMs of another shape (M=64 vs M=1), so a bf16 activation may round
# one ulp differently before the f32 heads.
TOL_ROW = 5e-2


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, samples: int = 25, calls: int = 10) -> float:
    """Median over `samples` of the mean per-call time of `calls` back-to-back
    calls, by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / calls)
    return statistics.median(per_call)


def lstm_inputs(B, T, H, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    x_proj = torch.randn(B, T, 4 * H, generator=g).to(device, dtype)
    w_h = (torch.randn(H, 4 * H, generator=g) / H**0.5).to(device, dtype)
    c0 = (0.5 * torch.randn(B, H, generator=g)).to(device)
    h0 = (0.5 * torch.randn(B, H, generator=g)).to(device)
    return x_proj, w_h, c0, h0


def lstm_bound_ms(B, T, H, dtype):
    """(bound ms, "bytes"|"operations"): each input read once, each output
    written once, vs the hidden products' 2·B·T·H·4H operations (+ ~10
    per gate element) at the dtype's peak."""
    e = torch.finfo(dtype).bits // 8
    nbytes = B * T * 4 * H * e + H * 4 * H * e + 2 * B * H * 4 + 2 * B * T * H * 4 + 2 * B * H * 4
    ops = 2 * B * T * H * 4 * H + 10 * B * T * 4 * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cudnn_lstm_ms(x_proj, w_h, c0, h0):
    """Yardstick only: cuDNN's nn.LSTM set up to compute the same
    recurrence (identity input weights, W_hh = W_hᵀ, forget-gate bias +1;
    PyTorch's gate order is i, f, g, o as here). The port never calls it."""
    B, T, H4 = x_proj.shape
    H = H4 // 4
    lstm = torch.nn.LSTM(H4, H, batch_first=True, device=x_proj.device, dtype=x_proj.dtype)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(H4))
        lstm.weight_hh_l0.copy_(w_h.t())
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
        lstm.bias_hh_l0[H : 2 * H] = 1.0
    lstm.flatten_parameters()
    hx = (h0.to(x_proj.dtype)[None], c0.to(x_proj.dtype)[None])
    with torch.no_grad():
        return cuda_ms(lambda: lstm(x_proj, hx))


def phase_kernels(device):
    from dotaclient_tpu_torch.ops import lstm as L

    cases = [
        ("flagship_bf16", 256, 17, 128, torch.bfloat16),
        ("flagship_f32", 256, 17, 128, torch.float32),
        ("ragged_bf16", 37, 17, 128, torch.bfloat16),
        ("ragged_f32", 37, 17, 128, torch.float32),
    ]
    results = []
    with torch.no_grad():
        for i, (name, B, T, H, dt) in enumerate(cases):
            ins = lstm_inputs(B, T, H, dt, device, seed=i)
            got = L.lstm_kernel(*ins)
            ref = L.lstm_scan(*ins)
            torch.cuda.synchronize()
            errs = {k: (a - b).abs().max().item() for k, a, b in zip(("h_seq", "c_seq", "c_T", "h_T"), got, ref)}
            for k, a in zip(("h_seq", "c_seq", "c_T", "h_T"), got):
                if not torch.isfinite(a).all():
                    raise SystemExit(f"kernel {name}: non-finite {k}")
            max_err = max(errs.values())
            tol = TOL_KERNEL[dt]
            ms = cuda_ms(lambda: L.lstm_kernel(*ins))
            plain_ms = cuda_ms(lambda: L.lstm_scan(*ins), samples=20, calls=2)
            bound, by = lstm_bound_ms(B, T, H, dt)
            lib_ms = cudnn_lstm_ms(*ins)
            row = dict(case=name, B=B, T=T, H=H, dtype=str(dt).split(".")[-1], max_abs_err=max_err, tol=tol,
                       errs=errs, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib_ms)
            print("kernel lstm_recurrence", json.dumps(row), flush=True)
            if not max_err <= tol:
                raise SystemExit(f"kernel {name}: max abs err {max_err} > tol {tol}")
            results.append(row)
    return results


def phase_serving(device, ticks: int = 12, rows: int = 64):
    from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig
    from dotaclient_tpu_torch.env import featurizer as F
    from dotaclient_tpu_torch.models import policy as P
    from dotaclient_tpu_torch.ops import action_dist as ad
    from dotaclient_tpu_torch.ops.batch import as_tensors, make_train_batch
    from dotaclient_tpu_torch.runtime.actor import make_actor_step, make_batched_actor_step

    cfg = PolicyConfig()
    net = P.init_params(cfg, torch.Generator().manual_seed(0), device)
    # valid observation streams: one [rows, ticks+1] slab of the random batch
    obs_seq = as_tensors(make_train_batch(LearnerConfig(batch_size=rows, seq_len=ticks, policy=cfg), 1).obs, device)
    step = make_batched_actor_step(cfg)
    single = make_actor_step(cfg)
    gen = torch.Generator(device=device).manual_seed(2)
    state = P.initial_state(cfg, (rows,), device)
    reset_at, reset_rows = ticks // 2, torch.arange(rows, device=device) % 3 == 0
    row_err, t_start = 0.0, None
    for t in range(ticks):
        if t == 2:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        if t == reset_at:  # these envs start a new episode: fresh carries
            state = tuple(torch.where(reset_rows[:, None], torch.zeros_like(s), s) for s in state)
        obs = F.Observation(*(x[:, t] for x in obs_seq))
        prev = state
        state, action, logp, value = step(net, state, obs, gen)
        if t == ticks - 1:
            torch.cuda.synchronize()
            ticks_per_s = (ticks - 2) / (time.perf_counter() - t_start)
        for x in (*state, logp, value):
            if not torch.isfinite(x).all():
                raise SystemExit(f"serving tick {t}: non-finite output")
        if not (logp <= 1e-6).all():
            raise SystemExit(f"serving tick {t}: logp > 0")
        ar = torch.arange(rows, device=device)
        if not obs.action_mask[ar, action.type].all():
            raise SystemExit(f"serving tick {t}: a masked action type was sampled")
        targeted = (action.type == F.ACT_ATTACK) | (action.type == F.ACT_CAST)
        if not obs.target_mask[ar, action.target][targeted].all():
            raise SystemExit(f"serving tick {t}: a masked target was sampled")
        # one row against its own B=1 forward on the same carry
        i = (7 * t) % rows
        one = lambda x: x[i : i + 1]
        obs1, prev1 = F.Observation(*(one(x) for x in obs)), tuple(one(s) for s in prev)
        with torch.no_grad():
            (c1, h1), out1 = net(prev1, obs1)
        act1 = ad.Action(*(one(a) for a in action))
        errs = [
            (c1 - one(state[0])).abs().max(),
            (h1 - one(state[1])).abs().max(),
            (out1.value - one(value)).abs().max(),
            (ad.log_prob(out1.dist, act1) - one(logp)).abs().max(),
        ]
        row_err = max(row_err, max(e.item() for e in errs))
        s1 = single(net, prev1, obs1, gen)  # the B=1 entry point itself
        if s1[2].shape != (1,) or not torch.isfinite(s1[2]).all():
            raise SystemExit("serving: B=1 step returned a bad logp")
    print(f"serving: {rows} rows x {ticks} ticks, {ticks_per_s:.1f} ticks/s ({ticks_per_s * rows:.0f} row-steps/s), "
          f"row-vs-B=1 max abs err {row_err:.3g} (tol {TOL_ROW})", flush=True)
    if not row_err <= TOL_ROW:
        raise SystemExit(f"serving: batched row differs from its B=1 step by {row_err} > {TOL_ROW}")
    return net, cfg, ticks_per_s


def phase_learner(device, net, cfg):
    from dotaclient_tpu_torch.config import LearnerConfig, PPOConfig
    from dotaclient_tpu_torch.models import policy as P
    from dotaclient_tpu_torch.ops import lstm as L
    from dotaclient_tpu_torch.ops.batch import as_tensors, make_train_batch
    from dotaclient_tpu_torch.ops.ppo import ppo_loss
    from dotaclient_tpu_torch.transport.params import load_named, named_params

    lcfg = LearnerConfig(policy=cfg)
    batch = as_tensors(make_train_batch(lcfg, 0), device)
    ppo = PPOConfig()
    net_plain = load_named(P.PolicyNet(dataclasses.replace(cfg, lstm_impl="torch"), device), named_params(net))
    with torch.no_grad():
        loss_k, m_k = ppo_loss(net, batch, ppo)  # cfg.lstm_impl "auto" on CUDA: the kernel
        torch.cuda.synchronize()
        launches = L.LAUNCHES
        _, out = net(batch.initial_state, batch.obs, unroll=True)
        loss_t, m_t = ppo_loss(net_plain, batch, ppo)
    B, T = lcfg.batch_size, lcfg.seq_len
    if tuple(out.value.shape) != (B, T + 1) or not torch.isfinite(out.value).all():
        raise SystemExit(f"learner: value {tuple(out.value.shape)} not finite [{B}, {T + 1}]")
    if set(m_k) != set(m_t):
        raise SystemExit("learner: metric keys differ")
    diffs = {k: abs(m_k[k].item() - m_t[k].item()) for k in m_k}
    for k, d in diffs.items():
        if not np.isfinite(m_k[k].item()) or not d <= TOL_LEARNER * (1 + abs(m_t[k].item())):
            raise SystemExit(f"learner: metric {k} kernel {m_k[k].item()} vs plain {m_t[k].item()}")
    if launches < 1:
        raise SystemExit("learner: the LSTM kernel was not launched on the main path")
    with torch.no_grad():
        ms_k = cuda_ms(lambda: ppo_loss(net, batch, ppo), samples=10, calls=3)
        ms_t = cuda_ms(lambda: ppo_loss(net_plain, batch, ppo), samples=10, calls=3)
    print(f"learner: ppo_loss forward B={B} T={T}: loss kernel {loss_k.item():.6f} plain {loss_t.item():.6f}; "
          f"max metric diff {max(diffs.values()):.3g}; {ms_k:.3f} ms/forward (kernel) vs {ms_t:.3f} (plain scan); "
          f"lstm kernel launches on the main path: {launches}", flush=True)
    with torch.no_grad():
        profile_forward(lambda: ppo_loss(net, batch, ppo))
    return launches, ms_k, ms_t


def profile_forward(fn, top: int = 8):
    """One forward under torch.profiler: device kernels by self time and
    the device's busy share of the (profiled) wall time."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)
    print(f"learner profile: {launches} device kernels, device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
          f"({100 * busy_ms / wall_ms:.1f}%; wall includes profiler overhead)", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:8.4f} ms  x{e.count:<4d} {e.key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from dotaclient_tpu_torch.ops import _kernels
    from dotaclient_tpu_torch.ops import lstm as L

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = _kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  {name}: {line.strip()}")

    cases = phase_kernels(device)

    L.LAUNCHES = 0  # the main path starts here
    net, cfg, ticks_per_s = phase_serving(device)
    launches, ms_k, ms_t = phase_learner(device, net, cfg)

    main_case = cases[0]
    kernels = [
        {
            "name": "lstm_recurrence",
            "route": "cuda",
            "source": "dotaclient_tpu_torch/csrc/lstm_recurrence.cu",
            "replaces": "dotaclient_tpu/ops/lstm.py:138",
            "launches": launches,
            "max_abs_err": main_case["max_abs_err"],
            "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "cases": [{k: c[k] for k in ("case", "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")} for c in cases],
        }
    ]
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
