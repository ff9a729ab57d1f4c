"""LSTM recurrence micro-bench: the plain torch scan against the CUDA
kernel (twin of scripts/bench_lstm.py; the dispatcher's choice backed by
an artifact, not prose).

Writes one JSON artifact (default lstm_bench_torch.json) with per-config
timings for H in {128, 256, 512} at the flagship B=256, T=16: forward
only and forward + backward (the train step's path), `impl="torch"` (the
reference's "scan") against `impl="kernel"` (its "pallas"; the artifact
keeps the reference's key names), and the implied crossover. Kernel rows
are written ONLY on the card: the CPU has no kernel to time (the
reference refuses interpret-mode timings the same way), so a CPU run
writes scan rows and says why. On the card the dtype is bf16 (the
reference's accelerator dtype), on the CPU f32. The port's dispatcher
(`impl="auto"`: the kernel on CUDA tensors) is not changed by this
script; it reports the crossover.

`kernel_vs_scan` holds the kernel's forward and its forward + backward
gradients against the plain arms on the same inputs (the chip smoke's
check; it times nothing).

Run: python -m dotaclient_tpu_torch.scripts.bench_lstm [--out lstm_bench_torch.json] [--iters 50] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import time

# (B, T, H) of the reference's rows: the flagship batch at three widths
SHAPES = tuple((256, 16, H) for H in (128, 256, 512))
# The smoke's cut: 5 calls per timing run (the reference's 50).
SMOKE_CUT = dict(iters=5)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, device, iters: int = 50) -> float:
    """Median of 3 timing runs of `iters` calls, seconds per call."""
    fn()
    _sync(device)
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync(device)
        runs.append((time.perf_counter() - t0) / iters)
    return sorted(runs)[1]


def inputs(B: int, T: int, H: int, dtype, device):
    """x_proj [B, T, 4H] and w_h [H, 4H] in `dtype` from one
    RandomState(0) stream (the reference's draws), c0 / h0 f32 zeros."""
    import numpy as np
    import torch

    r = np.random.RandomState(0)
    x_proj = torch.from_numpy(r.randn(B, T, 4 * H)).to(device=device, dtype=dtype)
    w_h = torch.from_numpy(r.randn(H, 4 * H) / np.sqrt(H)).to(device=device, dtype=dtype)
    c0 = torch.zeros((B, H), dtype=torch.float32, device=device)
    h0 = torch.zeros((B, H), dtype=torch.float32, device=device)
    return x_proj, w_h, c0, h0


def fwd(ins, impl: str):
    """h_seq of one recurrence, no autograd."""
    import torch

    from dotaclient_tpu_torch.ops import lstm as L

    with torch.no_grad():
        return L.lstm_recurrence(*ins, impl)[0]


def fwdbwd(ins, impl: str):
    """(d x_proj, d w_h) of sum(h_seq) + sum(c_T) + sum(h_T): the
    reference's loss."""
    import torch

    from dotaclient_tpu_torch.ops import lstm as L

    xp, w = ins[0].detach().requires_grad_(), ins[1].detach().requires_grad_()
    h_seq, (c_T, h_T) = L.lstm_recurrence(xp, w, ins[2], ins[3], impl)
    return torch.autograd.grad(h_seq.sum() + c_T.sum() + h_T.sum(), (xp, w))


def bench_config(B: int, T: int, H: int, dtype, on_card: bool, device, iters: int = 50) -> dict:
    """One row: scan (and, on the card, kernel) forward and forward +
    backward microseconds per call."""
    ins = inputs(B, T, H, dtype, device)
    row = {
        "B": B,
        "T": T,
        "H": H,
        "dtype": str(dtype).replace("torch.", ""),
        "scan_fwd_us": round(_time(lambda: fwd(ins, "torch"), device, iters) * 1e6, 1),
        "scan_fwdbwd_us": round(_time(lambda: fwdbwd(ins, "torch"), device, iters) * 1e6, 1),
    }
    if on_card:
        row["pallas_fwd_us"] = round(_time(lambda: fwd(ins, "kernel"), device, iters) * 1e6, 1)
        row["pallas_fwdbwd_us"] = round(_time(lambda: fwdbwd(ins, "kernel"), device, iters) * 1e6, 1)
        row["pallas_wins_fwdbwd"] = row["pallas_fwdbwd_us"] < row["scan_fwdbwd_us"]
    return row


def kernel_vs_scan(B: int, T: int, H: int, dtype, device, forward: str = "kernel") -> dict:
    """Max abs differences at one shape: the forward's four outputs
    against `lstm_scan`, and the forward + backward gradients of x_proj
    and w_h against the same backward over the plain scan
    (`impl="scan_recompute"`), each also relative to the plain
    gradient's largest value. `forward` = "kernel" on the card;
    "scan_recompute" runs the same comparison with no kernel (the CPU
    tests)."""
    import torch

    from dotaclient_tpu_torch.ops import lstm as L

    ins = inputs(B, T, H, dtype, device)
    with torch.no_grad():
        mine = (L.lstm_kernel if forward == "kernel" else L.lstm_scan)(*ins)
        plain = L.lstm_scan(*ins)
    fwd_err = max((a - b).abs().max().item() for a, b in zip(mine, plain))
    g_mine, g_plain = fwdbwd(ins, forward), fwdbwd(ins, "scan_recompute")
    out = {"shape": [B, T, H], "dtype": str(dtype).replace("torch.", ""), "fwd_max_abs": fwd_err}
    for name, a, b in zip(("x_proj", "w_h"), g_mine, g_plain):
        err = (a.float() - b.float()).abs().max().item()
        out[f"grad_{name}_max_abs"] = err
        out[f"grad_{name}_rel"] = err / max(b.float().abs().max().item(), 1e-30)
    return out


def run(args) -> dict:
    import torch

    from dotaclient_tpu_torch import resolve_device
    from dotaclient_tpu_torch.scripts.train_north_star import hardware_line

    device = resolve_device("cpu" if args.platform == "cpu" else None)
    on_card = device.type == "cuda"
    dtype = torch.bfloat16 if on_card else torch.float32
    rows = [bench_config(B, T, H, dtype, on_card, device, args.iters) for B, T, H in SHAPES]
    crossover = None
    if on_card:
        for row in rows:
            if row.get("pallas_wins_fwdbwd"):
                crossover = row["H"]
                break
    return {
        "backend": device.type,
        "device": hardware_line(args.platform),
        "valid_for_dispatcher": on_card,
        "note": (
            "kernel rows omitted: no CUDA device (the CPU has no kernel to time; see the module docstring)"
            if not on_card else
            f"the kernel wins fwd+bwd from H={crossover}" if crossover else "the kernel never wins at these shapes"
        ),
        "rows": rows,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="lstm_bench_torch.json")
    p.add_argument("--iters", type=int, default=50)
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
