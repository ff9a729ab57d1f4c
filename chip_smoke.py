#!/usr/bin/env python3
"""GPU smoke of the PyTorch port (`dotaclient_tpu_torch`).

Run from the repository root on a machine with one NVIDIA GPU and the
CUDA toolkit:  python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. device   — the card's name and power limit (nvidia-smi), torch/CUDA versions;
2. build    — compiles every hand-written kernel from csrc/ (nvcc, in parallel);
3. kernels  — each kernel against its plain PyTorch version on the card at
              the main path's shapes, with stated tolerances, and timed
              (CUDA events: host-paced, and device-only with the stream
              held by a spin kernel) beside its bound and a library
              yardstick; the
              design each case ran; bitwise row invariance (a row of a
              B=256 launch vs the same row alone and inside B=37); the
              T=1 vs T=17 split into fixed prologue and per-step cost;
4. serving  — the flagship policy's batched actor step over 64 rows for 12
              ticks with resident carries, one episode reset and a last
              tick with the rows reversed; every checked row bitwise its
              B=1 step; ticks/s beside the one-forward tick it replaced;
5. learner  — the PPO loss forward (teacher-forced unroll through the LSTM
              kernel, GAE, clipped surrogate) at batch 256 x seq_len 16,
              held against the same forward through the plain recurrence;
6. train    — the learner's default path, build_single_train_step at the
              flagship shape: one [B, row_bytes] u8 buffer from pinned
              memory, 3 PPO updates (kernel forward, recompute backward,
              clip + Adam) each ending in a DTW2 frame, held against 3
              updates through the plain forward (metrics, Adam moments
              leaf by leaf, params); ms per step, its split, the device's
              busy share and the backward recurrence's time; one
              sample-reuse step (2 epochs x 2 minibatches of 128), held
              against its plain arm in the same way.
Each path of the main path (serving, learner forward, each train step,
the reuse step) is driven with the kernels' launch counters zeroed just
before it and read just after. The last lines are one JSON object per kernel, the card line, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM rate and the
# per-type arithmetic peaks used for each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Kernel vs plain version, both on the card. f32: the kernel's split k
# sums and cuBLAS's blocked sums round differently (~1e-6 per step), and
# 17 dependent steps carry that forward. bf16: h is rounded to bf16
# before every product, so a last-bit difference in z can move one h by a
# bf16 ulp (2^-8 relative) and the next steps carry it.
TOL_KERNEL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Learner forward through the kernel vs through the plain scan: the same
# bf16 ulp flips of h, averaged by every masked mean into the metrics.
# The train steps' loss metrics get the same tolerance.
TOL_LEARNER = 5e-3
# Train steps, kernel arm vs plain arm from the same start. The gradients
# inherit the forward's ulp flips through the recompute backward. The
# global gradient norm averages them over every element (read 7.3e-5
# relative, 1.0e-6 in the reuse step). Adam's first and second moments
# (mu ~ g, nu ~ g²) are compared leaf by leaf, relative to each leaf's
# largest value: they read 2.3e-3 / 4.4e-3 after 3 single updates and
# 2.1e-3 / 3.0e-3 after the reuse step's 4, while a wrong backward misses
# by O(1); nu gets twice mu's limit. Params: Adam moves an element by
# about ±lr per update whatever its gradient's size, so params cannot see
# a gradient wrong by a positive factor (the moments do); an element whose
# update took the other sign differs by 2·lr. The arms read 2.74e-5 =
# 0.09·lr·3 after 3 updates, 3.3e-6 after the reuse step's 4; the limit
# is lr/2 per update. (Readings: H100 80GB HBM3, 700 W.)
TOL_GRAD_NORM = 1e-3
TOL_MOMENT = 2e-2
PARAM_LR_PER_UPDATE = 0.5


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


_SPIN_CYCLES_PER_MS = []


def _spin_cycles_per_ms() -> float:
    """Cycles of torch.cuda._sleep per millisecond on this card, measured once."""
    if not _SPIN_CYCLES_PER_MS:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        cycles = 5_000_000
        torch.cuda._sleep(cycles)  # warm
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        end.synchronize()
        _SPIN_CYCLES_PER_MS.append(cycles / start.elapsed_time(end))
    return _SPIN_CYCLES_PER_MS[0]


def cuda_ms(fn, samples: int = 25, calls: int = 10, ahead: bool = False) -> float:
    """Median over `samples` of the mean per-call time of `calls` back-to-back
    calls, by CUDA events, after a warm-up. By default the host's dispatch
    may pace the calls, as it does for a caller that launches them back to
    back (the `ms` of the kernels line). With `ahead`, a spin kernel holds
    the stream while the host enqueues the calls, so the events time the
    device alone (`device_ms`)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    spin = int(min(2.0 * (time.perf_counter() - t0) * 1e3 + 0.2, 200.0) * _spin_cycles_per_ms()) if ahead else 0
    per_call = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(spin)
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
    PyTorch's gate order is i, f, g, o as here). The port never calls it.
    Returns (host-paced ms, device ms)."""
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
        return cuda_ms(lambda: lstm(x_proj, hx)), cuda_ms(lambda: lstm(x_proj, hx), ahead=True)


def phase_kernels(device):
    from dotaclient_tpu_torch.ops import lstm as L

    cases = [
        ("flagship_bf16", 256, 17, 128, torch.bfloat16),
        ("flagship_f32", 256, 17, 128, torch.float32),
        ("minibatch_bf16", 128, 17, 128, torch.bfloat16),  # the reuse step's 2 minibatches of 128
        ("ragged_bf16", 37, 17, 128, torch.bfloat16),
        ("ragged_f32", 37, 17, 128, torch.float32),
        ("wide_bf16", 256, 17, 256, torch.bfloat16),
    ]
    results = []
    with torch.no_grad():
        for i, (name, B, T, H, dt) in enumerate(cases):
            geo = L.kernel_geometry(B, H, dt, device)
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
            device_ms = cuda_ms(lambda: L.lstm_kernel(*ins), ahead=True)
            plain_ms = cuda_ms(lambda: L.lstm_scan(*ins), samples=20, calls=2)
            bound, by = lstm_bound_ms(B, T, H, dt)
            lib_ms, lib_device_ms = cudnn_lstm_ms(*ins)
            row = dict(case=name, B=B, T=T, H=H, dtype=str(dt).split(".")[-1], design=geo.design,
                       cluster=geo.cluster, rows=geo.rows, grid=geo.grid, threads=geo.threads, smem=geo.smem_bytes,
                       max_abs_err=max_err, tol=tol, errs=errs, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                       bound_ms=bound, bound_by=by, library_ms=lib_ms, library_device_ms=lib_device_ms)
            print("kernel lstm_recurrence", json.dumps(row), flush=True)
            if not max_err <= tol:
                raise SystemExit(f"kernel {name}: max abs err {max_err} > tol {tol}")
            if H == 128 and not geo.design.startswith("cluster"):
                raise SystemExit(f"kernel {name}: ran the {geo.design} design, not the cluster design")
            results.append(row)
    return results


def phase_row_invariance(device, rows=(0, 17, 255)):
    """Rows of a B=256 launch against the same rows run alone (B=1) and
    placed among other rows of a B=37 launch: bitwise, every output."""
    from dotaclient_tpu_torch.ops import lstm as L

    with torch.no_grad():
        for dt in (torch.bfloat16, torch.float32):
            x_proj, w_h, c0, h0 = lstm_inputs(256, 17, 128, dt, device, seed=11)
            full = L.lstm_kernel(x_proj, w_h, c0, h0)
            # B=37: row 255 first, row 0 at 17, row 17 last, others between
            idx = list(range(100, 137))
            idx[0], idx[17], idx[36] = rows[2], rows[0], rows[1]
            pos = {rows[2]: 0, rows[0]: 17, rows[1]: 36}
            sel = torch.tensor(idx, device=device)
            mixed = L.lstm_kernel(x_proj.index_select(0, sel), w_h, c0.index_select(0, sel), h0.index_select(0, sel))
            for r in rows:
                alone = L.lstm_kernel(x_proj[r : r + 1], w_h, c0[r : r + 1], h0[r : r + 1])
                for k, f, a, m in zip(("h_seq", "c_seq", "c_T", "h_T"), full, alone, mixed):
                    if not torch.equal(f[r], a[0]) or not torch.equal(f[r], m[pos[r]]):
                        raise SystemExit(f"row invariance: {k} of row {r} ({dt}) differs between B=256, B=1 and B=37")
    print(f"row invariance: rows {list(rows)} of B=256 bitwise equal at B=1 and inside B=37 (bf16, f32), "
          f"designs {L.kernel_geometry(256, 128, torch.bfloat16, device).design}/"
          f"{L.kernel_geometry(256, 128, torch.float32, device).design}", flush=True)


def phase_step_split(device, B=256, H=128, T=17):
    """Kernel device time at T=1 and T=17: the per-step cost (ms17 - ms1) / 16
    and the fixed part (prologue, launch) ms1 - per step."""
    from dotaclient_tpu_torch.ops import lstm as L

    split = {}
    with torch.no_grad():
        for dt in (torch.bfloat16, torch.float32):
            ms = {}
            for steps in (1, T):
                ins = lstm_inputs(B, steps, H, dt, device, seed=3)
                ms[steps] = cuda_ms(lambda: L.lstm_kernel(*ins), ahead=True)
            per_step_us = (ms[T] - ms[1]) / (T - 1) * 1e3
            name = str(dt).split(".")[-1]
            split[name] = dict(ms_T1=ms[1], ms_T17=ms[T], per_step_us=per_step_us,
                               fixed_us=ms[1] * 1e3 - per_step_us)
            print(f"step split {name} B={B} H={H}, device time: T=1 {ms[1]:.5f} ms, T={T} {ms[T]:.5f} ms -> "
                  f"{per_step_us:.3f} us per step, {split[name]['fixed_us']:.3f} us fixed", flush=True)
    return split


def _copy_generator(gen):
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g


def _one_forward_tick(net, state, obs, gen):
    """The batched tick before each row became its own B=1 step (all rows
    in one forward, one generator): timed here beside its replacement,
    used nowhere else."""
    from dotaclient_tpu_torch.ops import action_dist as ad

    with torch.no_grad():
        new_state, out = net(state, obs)
        action = ad.sample(gen, out.dist)
        return new_state, action, ad.log_prob(out.dist, action), out.value


def phase_serving(device, ticks: int = 12, rows: int = 64):
    from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig
    from dotaclient_tpu_torch.env import featurizer as F
    from dotaclient_tpu_torch.models import policy as P
    from dotaclient_tpu_torch.ops.batch import as_tensors, make_train_batch
    from dotaclient_tpu_torch.runtime.actor import make_actor_step, make_batched_actor_step

    cfg = PolicyConfig()
    net = P.init_params(cfg, torch.Generator().manual_seed(0), device)
    # valid observation streams: one [rows, ticks+1] slab of the random batch
    obs_seq = as_tensors(make_train_batch(LearnerConfig(batch_size=rows, seq_len=ticks, policy=cfg), 1).obs, device)
    step = make_batched_actor_step(cfg)
    single = make_actor_step(cfg)
    gens = [torch.Generator(device=device).manual_seed(1000 + i) for i in range(rows)]
    state = P.initial_state(cfg, (rows,), device)
    reset_at, reset_rows = ticks // 2, torch.arange(rows, device=device) % 3 == 0
    step_s, checked = 0.0, 0
    for t in range(ticks):
        if t == reset_at:  # these envs start a new episode: fresh carries
            state = tuple(torch.where(reset_rows[:, None], torch.zeros_like(s), s) for s in state)
        # the last tick reverses the rows: every env gets other neighbours and another slot
        order = torch.arange(rows - 1, -1, -1, device=device) if t == ticks - 1 else torch.arange(rows, device=device)
        obs = F.Observation(*(x[:, t][order] for x in obs_seq))
        prev = tuple(s[order] for s in state)
        tick_gens = [gens[i] for i in order.tolist()]
        i = (7 * t) % rows  # one row per tick against its own B=1 step
        before = _copy_generator(tick_gens[i])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, action, logp, value = step(net, prev, obs, tick_gens)
        torch.cuda.synchronize()
        if t >= 2:
            step_s += time.perf_counter() - t0
        for x in (*new, logp, value):
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
        one = lambda tree: tuple(x[i : i + 1].clone() for x in tree)
        (c1, h1), a1, lp1, v1 = single(net, one(prev), F.Observation(*one(obs)), before)
        for name, x1, xb in zip(("c", "h", "type", "move_x", "move_y", "target", "logp", "value"),
                                (c1, h1, *a1, lp1, v1), (*new, *action, logp, value)):
            if not torch.equal(x1, xb[i : i + 1]):
                raise SystemExit(f"serving tick {t}: row {i} {name} is not bitwise its B=1 step")
        checked += 1
        state = tuple(s[order] for s in new)  # reversing twice restores env order
    ticks_per_s = (ticks - 2) / step_s
    # the one-forward tick on the same streams, for the rate only
    gen = torch.Generator(device=device).manual_seed(2)
    state = P.initial_state(cfg, (rows,), device)
    for t in range(ticks):
        if t == 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state = _one_forward_tick(net, state, F.Observation(*(x[:, t] for x in obs_seq)), gen)[0]
    torch.cuda.synchronize()
    before_per_s = (ticks - 2) / (time.perf_counter() - t0)
    print(f"serving: {rows} rows x {ticks} ticks, {ticks_per_s:.2f} ticks/s ({ticks_per_s * rows:.0f} row-steps/s) "
          f"with every row its own B=1 step; {checked} rows (one per tick, the last among reversed neighbours) "
          f"bitwise their B=1 step; the one-forward tick it replaced: {before_per_s:.1f} ticks/s "
          f"({before_per_s * rows:.0f} row-steps/s)", flush=True)
    return net, cfg, ticks_per_s, before_per_s


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
        profile_device(lambda: ppo_loss(net, batch, ppo), "learner forward")
    return launches, ms_k, ms_t


def profile_device(fn, label: str, top: int = 8):
    """One call of `fn` under torch.profiler: device kernels by self time
    and the device's busy share of the (profiled) wall time. Returns
    (busy ms, wall ms, device kernel launches)."""
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
    print(f"{label} profile: {launches} device kernels, device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
          f"({100 * busy_ms / wall_ms:.1f}%; wall includes profiler overhead)", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:8.4f} ms  x{e.count:<4d} {e.key[:100]}")
    return busy_ms, wall_ms, launches


def compare_arms(label, state_k, state_p, metrics_k, metrics_p, updates, lr):
    """Kernel arm against plain arm: every metric finite and within its
    tolerance, Adam's mu and nu leaf by leaf, params within
    PARAM_LR_PER_UPDATE·lr·updates. Returns the worst readings."""
    from dotaclient_tpu_torch.transport.params import named_params

    worst = {}
    for i, (mk, mp) in enumerate(zip(metrics_k, metrics_p)):
        if set(mk) != set(mp):
            raise SystemExit(f"{label}: metric keys differ between the arms")
        for k in mk:
            a, b = mk[k].item(), mp[k].item()
            tol = TOL_GRAD_NORM if k == "grad_norm" else TOL_LEARNER
            if not (np.isfinite(a) and np.isfinite(b)):
                raise SystemExit(f"{label} step {i + 1}: metric {k} not finite (kernel {a}, plain {b})")
            d = abs(a - b) / (1 + abs(b))
            worst[k] = max(worst.get(k, 0.0), d)
            if not d <= tol:
                raise SystemExit(f"{label} step {i + 1}: metric {k} kernel {a} vs plain {b} (tol {tol})")
    ok, op = state_k.opt_state, state_p.opt_state
    if int(ok.count) != updates or int(op.count) != updates:
        raise SystemExit(f"{label}: Adam counts {int(ok.count)} / {int(op.count)}, expected {updates}")
    for name, tol in (("mu", TOL_MOMENT), ("nu", 2 * TOL_MOMENT)):
        mk, mp = getattr(ok, name), getattr(op, name)
        rel = {n: ((mk[n] - mp[n]).abs().max() / mp[n].abs().max().clamp_min(1e-30)).item() for n in mp}
        n_worst = max(rel, key=rel.get)
        worst[name] = rel[n_worst]
        if not (all(torch.isfinite(x).all() for x in mk.values()) and rel[n_worst] <= tol):
            raise SystemExit(f"{label}: Adam {name} of {n_worst} differs by {rel[n_worst]:.3g} of its largest value "
                             f"(tol {tol})")
    worst["params"] = max(float(np.abs(a - b).max()) for (_, a), (_, b) in zip(named_params(state_k.net),
                                                                               named_params(state_p.net)))
    param_tol = PARAM_LR_PER_UPDATE * lr * updates
    if not worst["params"] <= param_tol:
        raise SystemExit(f"{label}: params differ by {worst['params']} > {PARAM_LR_PER_UPDATE}·lr·updates = {param_tol}")
    return worst


def phase_train(device, steps: int = 3, lcfg=None):
    """The learner's default path at the flagship shape (`lcfg` default:
    LearnerConfig()), kernel arm (the main path) and plain arm (the same
    Function with the lstm_scan forward) from the same start."""
    from dotaclient_tpu_torch.config import LearnerConfig
    from dotaclient_tpu_torch.models import policy as P
    from dotaclient_tpu_torch.ops import lstm as L
    from dotaclient_tpu_torch.ops.batch import make_train_batch
    from dotaclient_tpu_torch.ops.ppo import ppo_loss
    from dotaclient_tpu_torch.parallel import train_step as ts
    from dotaclient_tpu_torch.runtime.staging import cast_obs_to_compute_dtype
    from dotaclient_tpu_torch.transport.params import load_named, named_params, named_tensors
    from dotaclient_tpu_torch.transport.serialize import deserialize_weights

    lcfg = LearnerConfig() if lcfg is None else lcfg
    plain_cfg = dataclasses.replace(lcfg, policy=dataclasses.replace(lcfg.policy, lstm_impl="scan_recompute"))
    step_k, io = ts.build_single_train_step(lcfg, device)
    step_p, io_p = ts.build_single_train_step(plain_cfg, device)
    if io_p.layout.layout_crc != io.layout.layout_crc:
        raise SystemExit("train: the two arms built different row layouts")
    buf = io.pack_transfer(cast_obs_to_compute_dtype(lcfg, make_train_batch(lcfg, 0)))
    if not buf.is_pinned():
        raise SystemExit("train: the transfer buffer is not in pinned memory")
    state_k, state_p = ts.init_train_state(lcfg, device), ts.init_train_state(plain_cfg, device)
    frames = [ts.weights_frame(state_k)]  # version 0: the fresh params, published before consuming

    per_step, metrics_k = [], []
    for _ in range(steps):
        L.LAUNCHES = 0  # each train step of the main path runs with the counter zeroed just before it
        state_k, m = step_k(state_k, io.to_device(buf))
        per_step.append(L.LAUNCHES)
        metrics_k.append(m)
        frames.append(ts.weights_frame(state_k))  # waits for the step: its params go to the host

    L.LAUNCHES = 0
    metrics_p = []
    for _ in range(steps):
        state_p, m = step_p(state_p, io.to_device(buf))
        metrics_p.append(m)
    torch.cuda.synchronize()
    if L.LAUNCHES:
        raise SystemExit("train: the plain arm launched the kernel")
    worst = compare_arms("train", state_k, state_p, metrics_k, metrics_p, steps, lcfg.ppo.lr)
    if min(per_step) < 1:
        raise SystemExit(f"train: the LSTM kernel was not launched in every step ({per_step})")
    named, version, _ = deserialize_weights(frames[-1])
    fresh = load_named(P.PolicyNet(lcfg.policy, device), named)
    if version != steps or deserialize_weights(frames[0])[1] != 0:
        raise SystemExit("train: DTW2 versions are not 0 then the step count")
    if not all(np.array_equal(a, b) for (_, a), (_, b) in zip(named_params(fresh), named_params(state_k.net))):
        raise SystemExit("train: the DTW2 frame did not round-trip into a fresh net")
    print(f"train: {steps} steps B={lcfg.batch_size} T={lcfg.seq_len}, loss kernel "
          f"{[round(m['loss'].item(), 6) for m in metrics_k]} plain {[round(m['loss'].item(), 6) for m in metrics_p]}; "
          f"worst diffs: {json.dumps(worst)}; lstm kernel launches per step {per_step}; DTW2 frame "
          f"{len(frames[-1])} bytes, version {version}, round-trips", flush=True)

    # Times, by CUDA events, host-paced (eager dispatch is part of a step).
    def runner(step, state):
        holder = [state]

        def fn():
            holder[0], _ = step(holder[0], io.to_device(buf))

        return fn

    run_k, run_p = runner(step_k, state_k), runner(step_p, state_p)
    # a step never waits for the device (what lets the host run ahead, and
    # what the spin-held device time below needs): any synchronising call
    # inside one step raises here
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run_k()
    except RuntimeError:
        raise SystemExit(f"train: a step synchronises with the device:\n{traceback.format_exc()}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # in turns (kernel, plain, plain, kernel): host-paced times drift within a call
    turns = [("kernel", run_k), ("plain", run_p), ("plain", run_p), ("kernel", run_k)]
    timed = [(arm, cuda_ms(fn, samples=7, calls=3)) for arm, fn in turns]
    ms_k = statistics.mean(t for arm, t in timed if arm == "kernel")
    ms_p = statistics.mean(t for arm, t in timed if arm == "plain")
    # one step at a time with a spin kernel holding the stream while the
    # host enqueues it: device time per step with no host gaps. One step
    # (~700 launches) fits the device's queue of pending launches; three
    # would not, and the host would block on the full queue mid-sample.
    device_k = cuda_ms(run_k, samples=7, calls=1, ahead=True)
    device_p = cuda_ms(run_p, samples=7, calls=1, ahead=True)
    payload = io.to_device(buf)
    batch = io.unpack_single(payload)
    net, ppo = state_k.net, lcfg.ppo
    params = named_tensors(net)
    opt = ts.make_optimizer(lcfg)

    def fwd():
        return ppo_loss(net, batch, ppo)[0]

    def fwd_bwd():
        return torch.autograd.grad(fwd(), list(params.values()))

    grads = dict(zip(params, fwd_bwd()))
    split = {
        "h2d": cuda_ms(lambda: io.to_device(buf), samples=10, calls=5),
        "unpack": cuda_ms(lambda: io.unpack_single(payload), samples=10, calls=5),
        "forward": cuda_ms(fwd, samples=7, calls=3),
        "forward_backward": cuda_ms(fwd_bwd, samples=7, calls=3),
        "optimizer": cuda_ms(lambda: opt.update(grads, state_k.opt_state), samples=10, calls=5),
    }
    split["backward"] = split["forward_backward"] - split["forward"]
    # the recurrence's backward alone, at the train step's shape
    x_proj, w_h, c0, h0 = lstm_inputs(lcfg.batch_size, lcfg.seq_len + 1, lcfg.policy.lstm_hidden, torch.bfloat16, device, seed=21)
    with torch.no_grad():
        h_seq, c_seq, c_T, h_T = L.lstm_kernel(x_proj, w_h, c0, h0)
    res = (x_proj, w_h, c0, h0, h_seq, c_seq)
    g = torch.Generator(device=device).manual_seed(22)
    cot = (torch.randn(h_seq.shape, generator=g, device=device),
           (torch.randn(c_T.shape, generator=g, device=device), torch.randn(h_T.shape, generator=g, device=device)))
    bwd_ms = cuda_ms(lambda: L.recompute_backward(res, cot), samples=10, calls=5)
    bwd_device_ms = cuda_ms(lambda: L.recompute_backward(res, cot), samples=10, calls=5, ahead=True)
    fwd_device_ms = cuda_ms(lambda: L.lstm_kernel(x_proj, w_h, c0, h0), ahead=True)
    print(f"train: ms per step (host-paced, H2D included), in turns "
          + " ".join(f"{arm} {t:.3f}" for arm, t in timed) + f" -> kernel {ms_k:.3f} plain {ms_p:.3f}; split ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f"; device ms per step kernel {device_k:.4f} plain {device_p:.4f}"
          + f"; LSTM recurrence backward {bwd_ms:.4f} ms host-paced, {bwd_device_ms:.4f} ms device "
          f"(its kernel forward {fwd_device_ms:.4f} ms device)", flush=True)
    busy_ms, wall_ms, n_kernels = profile_device(run_k, "train step", top=12)
    print(f"train: device busy {device_k:.3f} ms per step (profiled: {busy_ms:.3f}) = {100 * device_k / ms_k:.1f}% "
          f"of the host-paced {ms_k:.3f} ms step", flush=True)

    # the sample-reuse step (2 epochs x 2 minibatches of 128), kernel arm
    # and plain arm from the same start with the same (seed, step) shuffles
    reuse_ppo = dataclasses.replace(lcfg.ppo, epochs=2, minibatches=2)
    reuse_k, reuse_io = ts.build_single_train_step(dataclasses.replace(lcfg, ppo=reuse_ppo), device)
    reuse_p, _ = ts.build_single_train_step(dataclasses.replace(plain_cfg, ppo=reuse_ppo), device)
    rstate_k = ts.init_train_state(dataclasses.replace(lcfg, ppo=reuse_ppo), device)
    rstate_p = ts.init_train_state(dataclasses.replace(plain_cfg, ppo=reuse_ppo), device)
    torch.cuda.synchronize()
    L.LAUNCHES = 0  # the reuse step's main path starts here
    t0 = time.perf_counter()
    rstate_k, rm_k = reuse_k(rstate_k, reuse_io.to_device(buf))
    torch.cuda.synchronize()
    reuse_ms = (time.perf_counter() - t0) * 1e3
    reuse_launches = L.LAUNCHES
    L.LAUNCHES = 0
    rstate_p, rm_p = reuse_p(rstate_p, reuse_io.to_device(buf))
    torch.cuda.synchronize()
    if L.LAUNCHES:
        raise SystemExit("train: the plain arm of the reuse step launched the kernel")
    for arm, rm in (("kernel", rm_k), ("plain", rm_p)):
        if (rm["ppo_updates_done"].item(), rm["ppo_kl_stopped"].item()) != (4.0, 0.0):
            raise SystemExit(f"train: the reuse step's {arm} arm ran {rm['ppo_updates_done'].item()} updates")
    if reuse_launches != 5:
        raise SystemExit(f"train: the reuse step launched the LSTM kernel {reuse_launches} times, not 5")
    reuse_worst = compare_arms("reuse", rstate_k, rstate_p, [rm_k], [rm_p], 4, lcfg.ppo.lr)
    reuse_step_ms = cuda_ms(lambda: reuse_k(rstate_k, reuse_io.to_device(buf)), samples=5, calls=1)
    print(f"train: reuse step (2 epochs x 2 minibatches) loss kernel {rm_k['loss'].item():.6f} plain "
          f"{rm_p['loss'].item():.6f}; worst diffs: {json.dumps(reuse_worst)}; lstm kernel launches {reuse_launches} "
          f"(precompute forward + 4 updates); {reuse_ms:.2f} ms first call, {reuse_step_ms:.3f} ms per step "
          f"host-paced", flush=True)
    return dict(launches=per_step[0], per_step=per_step, ms=ms_k, plain_ms=ms_p, turns=timed, device_ms=device_k,
                plain_device_ms=device_p, split=split, bwd_ms=bwd_ms,
                bwd_device_ms=bwd_device_ms, busy_ms=busy_ms, wall_ms=wall_ms, device_kernels=n_kernels,
                reuse_ms=reuse_ms, reuse_step_ms=reuse_step_ms, reuse_launches=reuse_launches, worst=worst,
                reuse_worst=reuse_worst)


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
            if any(w in line for w in ("Compiling entry", "registers", "spill", "smem")):
                print(f"  {name}: {line.strip()}")

    cases = phase_kernels(device)
    phase_row_invariance(device)
    split = phase_step_split(device)

    L.LAUNCHES = 0  # the serving path starts here
    net, cfg, ticks_per_s, before_per_s = phase_serving(device)
    serving_launches = L.LAUNCHES  # 0: the single step does not run the recurrence
    L.LAUNCHES = 0  # the learner forward starts here
    forward_launches, ms_k, ms_t = phase_learner(device, net, cfg)
    train = phase_train(device)  # zeroes the counters itself before its main path

    main_case = cases[0]
    kernels = [
        {
            "name": "lstm_recurrence",
            "route": "cuda",
            "source": "dotaclient_tpu_torch/csrc/lstm_recurrence.cu",
            "replaces": "dotaclient_tpu/ops/lstm.py:138",
            "launches": train["launches"],  # one train step, the counter zeroed just before it
            "launches_per_train_step": train["per_step"],
            "launches_train_3_steps": sum(train["per_step"]),
            "launches_reuse_step": train["reuse_launches"],
            "launches_learner_forward": forward_launches,
            "launches_serving": serving_launches,
            "max_abs_err": main_case["max_abs_err"],
            "ms": main_case["ms"],
            "device_ms": main_case["device_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "cases": [{k: c[k] for k in ("case", "design", "cluster", "rows", "max_abs_err", "ms", "device_ms",
                                         "plain_ms", "bound_ms", "library_ms", "library_device_ms")} for c in cases],
            "step_split": split,
            "train": {k: train[k] for k in ("ms", "plain_ms", "turns", "device_ms", "plain_device_ms", "split", "bwd_ms",
                                            "bwd_device_ms", "busy_ms", "wall_ms", "device_kernels", "reuse_ms",
                                            "reuse_step_ms", "worst", "reuse_worst")},
            "serving_ticks_per_s": ticks_per_s,
            "serving_ticks_per_s_one_forward": before_per_s,
        }
    ]
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
