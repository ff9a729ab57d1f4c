"""Learner compute observability (torch twin of dotaclient_tpu/obs/compute.py):
step-phase timing, recompile sentinel, MFU accounting, on-demand profiler
capture.

- StepPhaseTimer    every learner iteration split into fetch / pack /
                    h2d / device_step / host wall time. In the SERIAL loop
                    each step is fenced by a CUDA event recorded on the
                    loop's stream (`fence`), never torch.cuda.synchronize,
                    which would also wait on the side-stream copy of the
                    next batch. Under the pipelined loop it runs in OVERLAP
                    mode: the prefetch lane records its own fetch/pack/h2d
                    and the pipeline_* family carries the overlap, with no
                    per-step fence.
- RecompileSentinel keeps the reference's contract under eager PyTorch:
                    each new batch signature after the first is counted in
                    compute_recompiles_total (a batch-shape bug upstream).
- MfuAccountant     model-FLOPs utilization from ops/flops.py against the
                    device's peak.
- ProfileCapture    on-demand trace windows for POST /profile: on the card
                    CUPTI's records straight (obs/cupti.py), on the CPU
                    torch.profiler's.

Everything logs through the MetricsLogger stream under the compute_* names
of obs/registry.py.
"""

from __future__ import annotations

import gzip
import json
import logging
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from dotaclient_tpu_torch.obs.http import CaptureBusyError  # noqa: F401 (raised here; http answers it 409)

_log = logging.getLogger(__name__)


def fence(device) -> None:
    """Wait for the work queued so far on `device`'s current stream: a
    CUDA event recorded there and synchronized (other streams, such as
    the prefetch copy's, are not waited for). A no-op on the CPU, where
    every op has finished when it returns."""
    if torch.device(device).type == "cuda":
        done = torch.cuda.Event()
        done.record()
        done.synchronize()


# --------------------------------------------------------------- phases


class StepPhaseTimer:
    """Per-iteration wall-time decomposition of the learner loop.

    Phases (the loop's stations, in order):
      fetch        host wait for a packed batch off staging
      pack         the loop's host read of the packed batch (≈0: staging
                   packs on its own threads, charged to fetch's wait)
      h2d          host→device transfer, FENCED (the copy's CUDA event
                   synchronized) so it is the real transfer time, not
                   the dispatch time
      device_step  train-step dispatch + device execution, FENCED by a
                   CUDA event recorded on the loop's stream after the step
      host         publish dispatch / checkpoint / metrics-window work

    Single-writer contract: only the learner loop thread calls add() and
    step(); window_scalars() is called from that same thread at each
    metrics window. The scrape thread reads the RESULT via
    MetricsLogger.latest(), never this object.

    The warm-up fetch and empty-wait retries record fetch time with no
    closing step(), so a STARVED window's fetch mean can exceed its wall
    mean — starvation is exactly when that should read loud. In a fed
    window the phases tile the wall (the acceptance property).

    OVERLAP mode (``overlap=True`` — the pipelined loop,
    ``--learner.prefetch``): the host side of batch N+1 runs on a
    dedicated prefetch lane WHILE the device executes step N, so
    fencing the loop per step would destroy exactly what it measures.
    Instead the accounting splits into two lanes:

    - the LOOP lane keeps the single-writer add()/step() contract, but
      ``fetch`` now means the loop's wait for a prefetched batch (the
      exposed, un-hidden host time — the device-idle upper bound),
      ``pack``/``h2d`` stay 0 there, ``device_step`` is the UNFENCED
      residual (the in-flight device window from the loop's clock), and
      ``host`` is publish/checkpoint work as before — phases still tile
      the wall, by construction rather than by fencing;
    - the PREFETCH lane records its own fetch/pack/h2d wall via
      add_overlap() — called from the lane thread, so those sums live
      under a lock (``overlap_s`` accounting) — and window_scalars()
      reports them as the ``pipeline_*`` family: per-lane means,
      ``pipeline_prefetch_s`` (lane busy per step),
      ``pipeline_device_idle_s`` (the exposed loop wait), and
      ``pipeline_overlap_ratio`` (share of lane work hidden behind the
      device step).
    """

    PHASES = ("fetch", "pack", "h2d", "device_step", "host")
    LANE_PHASES = ("fetch", "pack", "h2d")

    def __init__(self, overlap: bool = False):
        self.overlap = overlap
        self._sums: Dict[str, float] = dict.fromkeys(self.PHASES, 0.0)
        self._wall = 0.0
        self._steps = 0
        # Prefetch-lane sums (overlap mode only): written by the lane
        # thread, read by the loop thread at window close — the one
        # cross-thread surface, so it gets its own lock (a handful of
        # acquisitions per step against a multi-ms step).
        self._lane_lock = threading.Lock()
        self._lane_sums: Dict[str, float] = dict.fromkeys(self.LANE_PHASES, 0.0)

    def add(self, phase: str, seconds: float) -> None:
        self._sums[phase] += max(float(seconds), 0.0)

    def add_overlap(self, phase: str, seconds: float) -> None:
        """Prefetch-lane attribution (overlap mode): fetch/pack/h2d time
        the lane paid for a batch, hidden behind the device step. Called
        from the lane thread — the only writer of these sums."""
        with self._lane_lock:
            self._lane_sums[phase] += max(float(seconds), 0.0)

    def step(self, wall_seconds: float) -> None:
        """Close one loop iteration: its total wall time."""
        self._wall += max(float(wall_seconds), 0.0)
        self._steps += 1

    def window_scalars(self, reset: bool = True) -> Dict[str, float]:
        """Mean seconds per step for each phase over the window, the
        mean iteration wall, and the fetch fraction (the watchdog's
        starvation signal). Overlap mode adds the pipeline_* lane
        scalars. Resets the window by default (the learner logs once
        per metrics window, like its win_* accumulators)."""
        n = max(self._steps, 1)
        out = {f"compute_phase_{p}_s": self._sums[p] / n for p in self.PHASES}
        out["compute_phase_wall_s"] = self._wall / n
        if self._wall > 0:
            out["compute_phase_fetch_frac"] = self._sums["fetch"] / self._wall
        if self.overlap:
            with self._lane_lock:
                lane = dict(self._lane_sums)
                if reset:
                    self._lane_sums = dict.fromkeys(self.LANE_PHASES, 0.0)
            lane_total = sum(lane.values())
            exposed = self._sums["fetch"]  # loop wait for a prefetched batch
            for p in self.LANE_PHASES:
                out[f"pipeline_prefetch_{p}_s"] = lane[p] / n
            out["pipeline_prefetch_s"] = lane_total / n
            out["pipeline_device_idle_s"] = exposed / n
            out["pipeline_overlap_ratio"] = (
                max(0.0, min(1.0, 1.0 - exposed / lane_total)) if lane_total > 0 else 1.0
            )
        if reset:
            self._sums = dict.fromkeys(self.PHASES, 0.0)
            self._wall = 0.0
            self._steps = 0
        return out


# ------------------------------------------------------------- sentinel


def _leaves(tree, path: str = ""):
    """(path, tensor-or-value) leaves of nested tuples/lists/NamedTuples."""
    if isinstance(tree, (tuple, list)):
        fields = getattr(tree, "_fields", None)
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{path}.{fields[i]}" if fields else f"{path}[{i}]")
    else:
        yield path, tree


def abstract_signature(batch) -> Tuple:
    """Hashable per-leaf (shape, dtype) summary of a batch."""
    return tuple(
        (p, tuple(getattr(x, "shape", ())), str(getattr(x, "dtype", type(x).__name__))) for p, x in _leaves(batch)
    )


def signature_diff(old: List[Tuple], new: List[Tuple], limit: int = 12) -> List[str]:
    """Human-readable shape-diff between two signatures (bounded: the
    flight-recorder ring must not bloat)."""
    old_map = {p: (s, d) for p, s, d in old}
    new_map = {p: (s, d) for p, s, d in new}
    diffs = []
    for p, (s, d) in new_map.items():
        if p not in old_map:
            diffs.append(f"+{p}: {s} {d}")
        elif old_map[p] != (s, d):
            os_, od = old_map[p]
            diffs.append(f"{p}: {os_} {od} -> {s} {d}")
    for p, (s, d) in old_map.items():
        if p not in new_map:
            diffs.append(f"-{p}: {s} {d}")
    if len(diffs) > limit:
        diffs = diffs[:limit] + [f"... {len(diffs) - limit} more"]
    return diffs


class RecompileSentinel:
    """Wraps the train step `fn(state, batch, ...)`; every call whose batch
    signature (leaf shapes and dtypes) was never seen is counted as a
    compile, and beyond the first as a RECOMPILE, with the shape-diff sent
    to the flight recorder. Steady-state training holds
    compute_recompiles_total at 0; an increment is a batch-shape bug
    upstream.

    Eager PyTorch compiles nothing: a new signature costs no compile, so
    compute_compile_s and compute_last_compile_s stay 0. The counters keep
    the reference's meaning (signatures seen), so its alert on
    compute_recompiles_total resolves unchanged."""

    def __init__(self, fn, label: str = "train_step", recorder=None):
        self._fn = fn
        self._label = label
        self._recorder = recorder
        self._seen = set()
        self._last: Optional[Tuple] = None
        self.compiles = 0
        self.recompiles = 0
        self.compile_s = 0.0
        self.last_compile_s = 0.0

    def __call__(self, state, *batch):
        sig = abstract_signature(batch)
        if sig not in self._seen:
            self.compiles += 1
            if self._last is not None:
                self.recompiles += 1
                diff = signature_diff(list(self._last), list(sig))
                _log.warning("%s saw a new batch signature (#%d): %s", self._label, self.recompiles,
                             "; ".join(diff) or "<structure-only change>")
                if self._recorder is not None:
                    self._recorder.record("recompile", label=self._label, n=self.recompiles, compile_s=0.0, diff=diff)
            elif self._recorder is not None:
                self._recorder.record("compile", label=self._label, compile_s=0.0)
            self._seen.add(sig)
            self._last = sig
        return self._fn(state, *batch)

    def scalars(self) -> Dict[str, float]:
        return {
            "compute_recompiles_total": float(self.recompiles),
            "compute_compiles_total": float(self.compiles),
            "compute_compile_s": self.compile_s,
            "compute_last_compile_s": self.last_compile_s,
        }


# ------------------------------------------------------------------ MFU


class MfuAccountant:
    """Cumulative model-FLOPs utilization. `flops_per_step` comes from
    ops/flops.py's analytic matmul model (fwd+bwd, reuse-aware);
    `peak_flops` is the device's peak from ops/flops.py's table (None, on
    the CPU or a card not in the table, suppresses compute_mfu; achieved
    FLOP/s is still reported)."""

    def __init__(self, flops_per_step: float, peak_flops: Optional[float]):
        self.flops_per_step = float(flops_per_step)
        self.peak_flops = peak_flops
        self._steps = 0
        self._seconds = 0.0

    def add_window(self, steps: int, seconds: float) -> None:
        self._steps += int(steps)
        self._seconds += max(float(seconds), 0.0)

    def scalars(self) -> Dict[str, float]:
        if self._seconds <= 0 or self._steps == 0:
            return {}
        achieved = self.flops_per_step * self._steps / self._seconds
        out = {"compute_flops_per_sec": achieved}
        if self.peak_flops:
            out["compute_mfu"] = achieved / self.peak_flops
        return out


# ------------------------------------------------------------- profiler


def _trace_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def trace_kernel_names(path: str) -> List[str]:
    """Names of the device kernels in a Chrome trace (events of category
    "kernel", as torch.profiler and obs/cupti.py write them)."""
    return [e.get("name", "") for e in _trace_events(path) if e.get("cat") == "kernel"]


# The runtime and driver calls that enqueue one device kernel each (CUPTI
# may add a version suffix, `_v7000`).
KERNEL_LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel",
                                 "cuLaunchKernel", "cuLaunchKernelEx"})
# Launches this close to the window's first or last launch call are not
# checked: at the start CUPTI can record a launch call before it traces the
# kernel, and at the end a kernel may run after the profiler stopped.
LAUNCH_EDGE_MS = 50.0


def lost_kernel_launches(path: str, edge_ms: float = LAUNCH_EDGE_MS) -> Dict[str, int]:
    """The kernel launches of a Chrome trace (torch.profiler's or
    obs/cupti.py's) whose kernel the trace lacks (matched by the `correlation` arg), counted by the name
    of the launching thread; launches in the first and last `edge_ms` of
    the window are left out. Empty for a whole trace."""
    events = _trace_events(path)
    names = {e.get("tid"): e.get("args", {}).get("name") for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    kernels = {e.get("args", {}).get("correlation") for e in events if e.get("cat") == "kernel"}
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("name", "").split("_v")[0] in KERNEL_LAUNCH_CALLS]
    if not launches:
        return {}
    first = min(e["ts"] for e in launches) + 1e3 * edge_ms
    last = max(e["ts"] for e in launches) - 1e3 * edge_ms
    lost: Dict[str, int] = {}
    for e in launches:
        if first <= e["ts"] <= last and e.get("args", {}).get("correlation") not in kernels:
            thread = str(names.get(e.get("tid")) or e.get("tid"))
            lost[thread] = lost.get(thread, 0) + 1
    return lost


class ProfileCapture:
    """On-demand trace windows for POST /profile?seconds=N. One capture at
    a time; each lands as a Chrome trace (`trace.json`) in its own
    `profile_<stamp>/` directory under `out_dir`. The HTTP handler's
    thread runs the window while the learner loop runs on its own thread.
    On the card the trace is CUPTI's kernel and runtime / driver call
    records of every thread, taken through its activity API without kineto
    (obs/cupti.py: kineto windows lost launching threads' kernel records);
    on the CPU it is torch.profiler's.

    On the card a window is whole or an error, never a partial success:
    the device is synchronized before the recording stops, and a trace
    with no device kernel, with kernel launches whose kernel it lacks (a
    launching thread's records lost), or with records CUPTI dropped,
    raises.

    On the card a window opens only once `warm()` (the owner's predicate,
    None: always) holds: CUPTI's activity enable / disable deadlocked
    against a thread creating its cuBLAS handle (a learner's first forward
    on the loop thread, its first backward on autograd's device thread),
    so a capture asked for during that start waits, at most WARM_WAIT_S,
    and then raises."""

    WARM_WAIT_S = 60.0

    def __init__(self, out_dir: str, max_seconds: float = 60.0, *, device,
                 warm: Optional[Callable[[], bool]] = None):
        self.out_dir = out_dir or os.getcwd()
        self.max_seconds = max_seconds
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.warm = warm
        self._lock = threading.Lock()
        self.captures_done = 0
        self.last_path: Optional[str] = None

    def capture(self, seconds: float) -> Tuple[str, float]:
        """Trace for `seconds` (clamped to [0.1, max_seconds]) and return
        (trace dir, window traced). Raises ValueError on a non-finite
        request, CaptureBusyError when a capture is in flight and
        RuntimeError when a card's window traced no kernel or lost the
        kernels of some launches."""
        seconds = float(seconds)
        if not math.isfinite(seconds):
            raise ValueError(f"seconds must be finite, got {seconds!r}")
        seconds = min(max(seconds, 0.1), self.max_seconds)
        if not self._lock.acquire(blocking=False):
            raise CaptureBusyError("a profiler capture is already running")
        try:
            if self.cuda and self.warm is not None:
                deadline = time.monotonic() + self.WARM_WAIT_S
                while not self.warm():
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"profiler capture: the process did not warm within {self.WARM_WAIT_S:.0f}s "
                                           "(CUPTI's enable / disable can deadlock against a thread's first cuBLAS "
                                           "call)")
                    time.sleep(0.01)
            stamp = time.strftime("%Y%m%dT%H%M%S")
            path = os.path.join(self.out_dir, f"profile_{stamp}")
            n = 1
            while os.path.exists(path):
                path = os.path.join(self.out_dir, f"profile_{stamp}_{n}")
                n += 1
            os.makedirs(path)
            trace = os.path.join(path, "trace.json")
            if self.cuda:
                from dotaclient_tpu_torch.obs import cupti

                # the window's kernels have run before the recording stops
                kernels, calls, dropped = cupti.activity_trace().window(
                    seconds, lambda: torch.cuda.synchronize(self.device))
                cupti.write_chrome_trace(trace, kernels, calls)
                if dropped:
                    raise RuntimeError(f"profiler capture of {seconds:.1f}s is partial: CUPTI dropped {dropped} "
                                       f"records ({trace})")
                if not trace_kernel_names(trace):
                    raise RuntimeError(f"profiler capture of {seconds:.1f}s traced no device kernel ({trace})")
                lost = lost_kernel_launches(trace)
                if lost:
                    raise RuntimeError(f"profiler capture of {seconds:.1f}s is partial: {sum(lost.values())} kernel "
                                       f"launches have no kernel in the trace, by launching thread "
                                       f"{json.dumps(lost, sort_keys=True)} ({trace})")
            else:
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                    time.sleep(seconds)
                prof.export_chrome_trace(trace)
            self.captures_done += 1
            self.last_path = path
            _log.info("profiler capture (%.1fs) written to %s", seconds, path)
            return path, seconds
        finally:
            self._lock.release()


# ----------------------------------------------------------- the bundle


class ComputeObserver:
    """One learner's compute-observability bundle: phase timer (optional),
    recompile sentinel, MFU accounting. Built by
    ObsRuntime.attach_compute(); everything funnels into window_scalars()
    on the learner's metrics cadence."""

    def __init__(self, flops_per_step: float, peak_flops: Optional[float], recorder=None, step_phases: bool = True,
                 overlap: bool = False):
        self.timer = StepPhaseTimer(overlap=overlap) if step_phases else None
        self.mfu = MfuAccountant(flops_per_step, peak_flops)
        self.sentinel: Optional[RecompileSentinel] = None
        self._recorder = recorder

    def wrap_train_step(self, fn, label: str = "train_step"):
        """The sentinel-wrapped step; the learner swaps its train_step for it."""
        self.sentinel = RecompileSentinel(fn, label=label, recorder=self._recorder)
        return self.sentinel

    def window_scalars(self, steps: int, seconds: float) -> Dict[str, float]:
        """Everything compute_* for one metrics window: phase means (and
        reset), cumulative signature counters, cumulative MFU/FLOP rate."""
        self.mfu.add_window(steps, seconds)
        out: Dict[str, float] = {}
        if self.timer is not None:
            out.update(self.timer.window_scalars())
        if self.sentinel is not None:
            out.update(self.sentinel.scalars())
        out.update(self.mfu.scalars())
        return out
