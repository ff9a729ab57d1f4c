"""The learner loop (torch twin of dotaclient_tpu/runtime/learner.py).

    staging.get_batch_groups → H2D on a side stream → train step
    → every publish_every steps: one device flatten of the params, read to
      the host and fanned out as a DTW2 frame by a publisher thread
    → every checkpoint_every steps: a checkpoint
    → every metrics_every steps: one metrics window (the reference's names)

The Python-side `version` counter mirrors state.step without a device
sync; it is the version actors stamp on their rollouts and the staging
staleness filter reads.

Pipelining (`learner.prefetch`, default on): a PrefetchLane thread runs
the whole host side of batch N+1 (staging pop, H2D dispatch) while the
device runs step N, so the loop thread pays one queue pop and the step's
dispatch. The lane is the same single FIFO staging consumer, so the params
come out bitwise equal to the serial loop's (`learner.prefetch false`)
over the same frames.

The batch crosses host-to-device on one of three paths, chosen as the
reference chooses: the single [B, row_bytes] u8 buffer (the default), the
four dtype-grouped buffers (`fused_single_h2d` off), or the per-leaf tree
of a dense batch (`fused_h2d` off, or `replay.enabled`, whose per-row
staleness stamp is not in the fused layouts). Every path ends in the same
train step.

Stream ordering in place of JAX's donation semantics:
- a batch's host-to-device copies run on the io's side stream;
  the loop thread's stream waits on the copy's event before the step
  (`FusedBatchIO.consume`), so the copy of N+1 overlaps step N;
- Adam updates the params in place, so a publish enqueues the flatten and
  a non-blocking copy into fresh pinned memory on the loop thread's
  stream BEFORE the next step, and records an event there; the publisher
  thread waits on that event and never touches a device tensor.
Outside a metrics window (and a checkpoint, which reads the state) the
loop thread makes no synchronising device call.

Checkpoints (`ckpt.*`): the plain save is synchronous on the loop
thread. With `ckpt.async_save` the loop thread enqueues one on-device
clone of the state (StateCopier) on its own stream, so the next in-place
Adam update is ordered after it, and a CheckpointWorker thread copies the
clone to pinned host memory on a stream of its own and writes it. With
`ckpt.full_state` each step gets an aux manifest (pending frames in order,
the replay reservoir, publish high-water, env steps) and every publish
refreshes the
`version_hwm` file; a restore re-injects the frames and bumps the version
counter to the high-water mark. `ckpt.drain_on_sigterm` (main only): SIGTERM
stops fetching, trains out what staging and the lane hold, saves full
state and exits 0 inside `ckpt.drain_budget_s`.

Observability (`obs.enabled`): trace hops, a flight recorder, compute
phases (the serial loop fences each step with a CUDA event), MFU, /metrics,
/healthz, POST /profile and the watchdog, under the reference's meter
names (obs/registry.py).

Multi-process (`--multihost`, parallel/dist.py): one learner process per
card, `batch_size` global, `--mesh_shape` laid over the ranks. Each rank's
staging packs B / N rows from the shared broker; the train step gathers
them over the ranks of one dp index, all-reduces its gradients and runs
tensor and sequence parallelism over their groups
(parallel/train_step.py), and every rank ends each step with the same
params (under tp, the same whole params: each rank keeps its slices, and
publishes and checkpoints gather them, so every rank takes part in those
at the same versions). Rank 0 alone publishes weights and pushes the
checkpoint mirror; every rank can pull it. A rank other than 0 that
restored from the mirror takes the manifest's version high-water mark and
env steps but not its pending frames: they were rank 0's, which
re-injects them itself (the reference re-injects on every rank, training
them twice). After the restore the ranks must agree on the resume step,
and the version counter takes the global published high-water mark.
Before each step the ranks agree over the host group whether to take it
(`_agree`): a rank whose drain has trained out all it held takes its part
of the others' steps with a batch of padding rows (no real step, so it
adds nothing to any sum), and every rank stops together.

Modes the port does not have yet are refused at construction with
NotImplementedError naming their ROADMAP item (config.UNPORTED), never
substituted.
"""

from __future__ import annotations

import json
import logging
import math
import os
import queue
import signal
import struct
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from dotaclient_tpu_torch import resolve_device
from dotaclient_tpu_torch.config import LearnerConfig, refuse_unported
from dotaclient_tpu_torch.obs import ObsRuntime
from dotaclient_tpu_torch.obs.compute import fence
from dotaclient_tpu_torch.ops.flops import aggregate_peak_flops, device_peak_flops, train_step_flops
from dotaclient_tpu_torch.parallel.dist import Dist, init_distributed
from dotaclient_tpu_torch.parallel.fused_io import TreeBatchIO
from dotaclient_tpu_torch.parallel.mesh import local_config, resolve_mesh
from dotaclient_tpu_torch.parallel.train_step import (
    TrainState,
    batch_template,
    build_fused_train_step,
    build_single_train_step,
    build_train_step,
    init_train_state,
    is_sequence_parallel,
    shard_state,
    whole_params,
)
from dotaclient_tpu_torch.runtime.checkpoint import Checkpointer, state_arrays
from dotaclient_tpu_torch.runtime.metrics import MetricsLogger
from dotaclient_tpu_torch.runtime.staging import StagingBuffer
from dotaclient_tpu_torch.transport.base import Broker
from dotaclient_tpu_torch.transport.params import host_named, named_tensors, state_tensors
from dotaclient_tpu_torch.transport.serialize import serialize_weights

_log = logging.getLogger(__name__)


class ParamFlattener:
    """ONE device-to-host copy per weight publish. `flatten_on_device`
    runs on the loop thread: it enqueues the concatenation of the params
    and a non-blocking copy into fresh pinned memory on the current
    stream, then records an event. Stream order puts both before the next
    train step's in-place Adam update. `to_named` runs on the publisher
    thread: it waits for that event and splits the host buffer into the
    reference's (flax name, f32 array) pairs."""

    def __init__(self, net: torch.nn.Module):
        self._slots = []  # (name, shape, start, size) in canonical order
        off = 0
        for name, p in named_tensors(net).items():
            self._slots.append((name, tuple(p.shape), off, p.numel()))
            off += p.numel()

    def flatten_on_device(self, params: Dict[str, torch.Tensor]):
        """(host f32 buffer, event or None) of the whole params by name
        (train_step.whole_params); returns without waiting."""
        with torch.no_grad():
            flat = torch.cat([p.detach().reshape(-1).float() for p in params.values()])
        if flat.device.type != "cuda":
            return flat, None  # a fresh tensor: the in-place update does not reach it
        host = torch.empty(flat.shape, dtype=torch.float32, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def to_named(self, payload) -> list:
        """Blocking host read + split, on the publisher thread."""
        host, done = payload
        if done is not None:
            done.synchronize()
        flat = host.numpy()
        return [(name, flat[start : start + size].reshape(shape)) for name, shape, start, size in self._slots]


class WeightPublisher:
    """Serialize + fan out weights off the train-loop thread.

    Latest-wins single slot: if the loop submits version v+1 while v is
    still serializing, v is superseded (actors only want the newest
    weights). `materialize(payload) -> [(name, f32 array)]` converts what
    the loop submitted, on this thread; the Learner passes
    ParamFlattener.to_named."""

    def __init__(self, broker: Broker, materialize, boot_epoch: int = 0, legacy_dtw1: bool = False, on_published=None):
        self._materialize = materialize
        self._broker = broker
        self._boot_epoch = boot_epoch
        self._legacy_dtw1 = legacy_dtw1
        # Called on this thread with each version sent; None = no hook.
        self._on_published = on_published
        self._cond = threading.Condition()
        self._slot = None  # (payload, version), latest pending
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.published = 0  # versions actually sent
        self.coalesced = 0  # versions superseded before sending

    def start(self) -> "WeightPublisher":
        """Restartable after stop(). A previous thread still draining stays
        the active one (two publishers could deliver versions out of
        order); the handle is published and started under the lock."""
        with self._cond:
            self._stop = False
            if self._thread is not None and self._thread.is_alive():
                self._cond.notify()
                return self
            t = threading.Thread(target=self._run, daemon=True, name="weight-publisher")
            self._thread = t
            t.start()
        return self

    def submit(self, payload, version: int) -> None:
        with self._cond:
            if self._slot is not None:
                self.coalesced += 1
            self._slot = (payload, version)
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._slot is None and not self._stop:
                    self._cond.wait()
                if self._stop and self._slot is None:
                    self._thread = None
                    return
                payload, version = self._slot
                self._slot = None
            try:
                frame = serialize_weights(
                    self._materialize(payload), version=version, boot_epoch=self._boot_epoch, legacy_dtw1=self._legacy_dtw1
                )
                self._broker.publish_weights(frame)
                self.published += 1
                if self._on_published is not None:
                    self._on_published(version)
            except Exception:
                _log.exception("weight publish failed (version %d); continuing", version)

    def stop(self, flush: bool = True) -> None:
        """Stop the thread; by default drains a pending slot first."""
        with self._cond:
            if not flush:
                self._slot = None
            self._stop = True
            self._cond.notify()
            t = self._thread
        if t is not None:
            t.join(timeout=10)


class StateCopier:
    """The async checkpoint's device side. `clone_on_device` runs on the
    loop thread: one concatenation of the params and Adam moments (all
    f32) and a copy of the Adam count, enqueued on the loop's stream, so
    the next train step's in-place Adam update is ordered after the read;
    then an event. `to_host` runs on the CheckpointWorker thread: its own
    stream waits for that event (nothing else), copies into pinned host
    memory, and the thread waits for that copy alone, never behind queued
    train steps. The arrays equal checkpoint.state_arrays' bitwise."""

    def __init__(self, state: TrainState):
        self._slots = []  # (name, shape, start, size): params, then mu, then nu
        off = 0
        for name, t in self._tensors(state).items():
            self._slots.append((name, tuple(t.shape), off, t.numel()))
            off += t.numel()
        self._stream = None

    @staticmethod
    def _tensors(state: TrainState) -> Dict[str, torch.Tensor]:
        return state_tensors(state.net, state.opt_state, state.tp)

    def clone_on_device(self, state: TrainState):
        """(flat clone, count clone, step, event or None); no host wait."""
        with torch.no_grad():
            flat = torch.cat([t.detach().reshape(-1).float() for t in self._tensors(state).values()])
            count = state.opt_state.count.detach().clone()
        done = None
        if flat.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return flat, count, int(state.step), done

    def to_host(self, snap) -> Dict[str, np.ndarray]:
        """Blocking: the clone as state_arrays' name → array dict."""
        flat, count, step, done = snap
        if done is not None:
            if self._stream is None:
                self._stream = torch.cuda.Stream(flat.device)
            host = torch.empty(flat.shape, dtype=torch.float32, pin_memory=True)
            host_count = torch.empty(count.shape, dtype=count.dtype, pin_memory=True)
            self._stream.wait_event(done)
            with torch.cuda.stream(self._stream):
                host.copy_(flat, non_blocking=True)
                host_count.copy_(count, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(self._stream)
            copied.synchronize()
            flat, count = host, host_count
        values = flat.numpy()
        arrays = {name: values[start : start + size].reshape(shape) for name, shape, start, size in self._slots}
        arrays["count"] = np.asarray(int(count), np.int32)
        arrays["step"] = np.asarray(step, np.int64)
        return arrays


class CheckpointWorker:
    """Off-critical-path saver (`ckpt.async_save`): the loop thread submits
    a StateCopier clone; this thread copies it to the host and calls
    `save_fn(arrays, version)`. Latest wins: a clone submitted while an
    older one waits supersedes it (counted), since durability only needs
    the newest state."""

    def __init__(self, materialize, save_fn):
        self._materialize = materialize  # clone -> arrays, on this thread
        self._save_fn = save_fn  # (arrays, version) -> None
        self._cond = threading.Condition()
        self._slot = None  # (clone, version), latest pending
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.saved = 0  # checkpoints written
        self.coalesced = 0  # checkpoints superseded before writing
        self.last_save_s = 0.0  # seconds of the newest save: host copy + write

    def start(self) -> "CheckpointWorker":
        with self._cond:
            self._stop = False
            if self._thread is not None and self._thread.is_alive():
                self._cond.notify()
                return self
            t = threading.Thread(target=self._run, daemon=True, name="ckpt-saver")
            self._thread = t
            t.start()
        return self

    def submit(self, clone, version: int) -> None:
        with self._cond:
            if self._slot is not None:
                self.coalesced += 1
            self._slot = (clone, version)
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._slot is None and not self._stop:
                    self._cond.wait()
                if self._stop and self._slot is None:
                    self._thread = None
                    return
                clone, version = self._slot
                self._slot = None
            try:
                t0 = time.perf_counter()
                arrays = self._materialize(clone)
                del clone  # release the device copy before the slow write
                self._save_fn(arrays, version)
                self.last_save_s = time.perf_counter() - t0
                self.saved += 1
            except Exception:
                _log.exception("async checkpoint of step %d failed; continuing", version)

    def stop(self, flush: bool = True) -> None:
        """Stop the thread; by default a pending clone is saved first."""
        with self._cond:
            if not flush:
                self._slot = None
            self._stop = True
            self._cond.notify()
            t = self._thread
        if t is not None:
            t.join(timeout=60)


_AUX_MAGIC = b"DTA1"
# POST /profile's CUPTI window waits for this many steps of this process
# (obs/compute.py ProfileCapture): the first makes the loop thread's and
# autograd's device thread's cuBLAS handles; the second covers kernels that
# only a later step loads (a metrics window's, a publish's)
PROFILE_WARM_STEPS = 2


def encode_aux(manifest: dict) -> bytes:
    """The aux manifest on disk: magic, u32 header length, a JSON header
    (every field but the staging snapshot's byte strings, plus their
    lengths), then the byte strings back to back: the pending frames, then
    the replay reservoir's entry payloads. The reservoir's header part
    keeps each entry's priority, absolute behavior version, uses and spill
    state, and the sampling Generator's state. No pickle: a manifest is
    data."""
    staging = manifest.get("staging", {})
    blobs = [bytes(f) for f in staging.get("pending", [])]
    header = {k: v for k, v in manifest.items() if k != "staging"}
    header["pending_lens"] = [len(f) for f in blobs]
    reservoir = staging.get("reservoir")
    if reservoir is not None:
        entries = reservoir["entries"]
        header["reservoir"] = {
            "entries": [{k: v for k, v in e.items() if k != "payload"} for e in entries],
            "payload_lens": [len(e["payload"]) for e in entries],
            "rng_state": reservoir["rng_state"],
        }
        blobs += [bytes(e["payload"]) for e in entries]
    head = json.dumps(header, sort_keys=True).encode()
    return b"".join([_AUX_MAGIC, struct.pack("<I", len(head)), head, *blobs])


def decode_aux(data: bytes) -> dict:
    """encode_aux's inverse; ValueError on anything else."""
    if data[:4] != _AUX_MAGIC or len(data) < 8:
        raise ValueError("not an aux manifest")
    (n,) = struct.unpack_from("<I", data, 4)
    header = json.loads(data[8 : 8 + n])
    off = 8 + n

    def take(sizes) -> list:
        nonlocal off
        out = []
        for size in sizes:
            out.append(data[off : off + size])
            off += size
        return out

    staging = {"pending": take(header.pop("pending_lens"))}
    reservoir = header.pop("reservoir", None)
    if reservoir is not None:
        payloads = take(reservoir["payload_lens"])
        staging["reservoir"] = {
            "entries": [dict(e, payload=p) for e, p in zip(reservoir["entries"], payloads)],
            "rng_state": reservoir["rng_state"],
        }
    if off != len(data):
        raise ValueError("aux manifest length mismatch")
    header["staging"] = staging
    return header


class _LeaseReaper:
    """Ring leases of fetched batches, released to the packers only once
    their copy's event has completed. `reap` runs on the thread that
    fetches (the loop thread or the prefetch lane) before each fetch: it
    releases every lease whose event has completed and, when every ring
    slot is held here (no batch could be packed otherwise), waits for the
    oldest copy first. The loop thread never waits on a copy it could
    leave running, and never releases a slot whose copy may still read it."""

    def __init__(self):
        self._held: List = []  # (lease, ready event or None), oldest first

    def hold(self, lease, ready) -> None:
        self._held.append((lease, ready))

    def reap(self, depth: int) -> None:
        if len(self._held) >= depth:
            ready = self._held[0][1]
            if ready is not None:
                ready.synchronize()
        keep = []
        for lease, ready in self._held:
            if ready is None or ready.query():
                lease.release()
            else:
                keep.append((lease, ready))
        self._held = keep

    def release_all(self) -> None:
        """At run() teardown, after the device went idle: each copy's
        event has completed, so its synchronize() returns at once and
        fences the release locally all the same."""
        for lease, ready in self._held:
            if ready is not None:
                ready.synchronize()
            lease.release()
        self._held = []


class _LaneItem(NamedTuple):
    """One prefetch-lane handoff: kind ∈ {"batch", "idle", "exhausted",
    "error"}. `wait_s`/`put_s` are the lane's fetch wait and H2D dispatch
    time for the window accumulators."""

    kind: str
    batch: object
    env_steps: int
    wait_s: float
    put_s: float
    error: Optional[BaseException]
    trace: object = None  # the batch's obs trace refs, or None


class PrefetchLane:
    """The prefetch stage of the pipelined loop: runs the host side of
    batch N+1 (staging pop, H2D dispatch on the side stream) on its own
    thread while the loop keeps the device busy with step N, handing
    finished batches over a bounded queue (depth = learner.prefetch_depth).

    - The lane is the one staging consumer, popping FIFO: batch order is
      the serial loop's, so the params are bitwise the serial ones.
    - `holding()` makes a popped-but-untrained batch visible to
      staging.drained(), so a drain trains it out.
    - Budget (`limit` = the run's num_steps): the lane never fetches more
      batches than the loop will train. Empty waits ("idle") use none.
    - A fetch error surfaces on the loop thread as an "error" item.
    """

    def __init__(self, fetch_fn, depth: int = 1, limit: Optional[int] = None, drain: Optional[threading.Event] = None,
                 abort: Optional[threading.Event] = None, upstream_drained=None, stop_event: Optional[threading.Event] = None):
        self._fetch = fetch_fn  # () -> (batch, env_steps, wait_s, put_s, trace)
        self._out: "queue.Queue[_LaneItem]" = queue.Queue(maxsize=max(int(depth), 1))
        self._limit = limit
        self._drain = drain
        self._abort = abort
        self._upstream_drained = upstream_drained
        # Also the staging getter's cancel hook: a stopping lane aborts its
        # in-flight wait within one 0.2 s slice.
        self.stop_event = stop_event if stop_event is not None else threading.Event()
        # True from just before a fetch until its item is in the queue.
        self._inflight = False
        self._thread: Optional[threading.Thread] = None
        self.fetched = 0

    def start(self) -> "PrefetchLane":
        t = threading.Thread(target=self._run, daemon=True, name="learner-prefetch")
        self._thread = t
        t.start()
        return self

    def holding(self) -> bool:
        """True while the lane holds popped-but-untrained frames (in its
        thread mid-fetch or in the handoff queue)."""
        inflight = self._inflight
        return inflight or not self._out.empty()

    def get(self, timeout: float) -> _LaneItem:
        """Next handoff item; raises queue.Empty on timeout."""
        return self._out.get(timeout=timeout)

    def _put(self, item: _LaneItem) -> None:
        while not self.stop_event.is_set():
            try:
                self._out.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def _run(self) -> None:
        while not self.stop_event.is_set():
            if self._limit is not None and self.fetched >= self._limit:
                return  # every batch the loop will train is fetched
            self._inflight = True
            try:
                try:
                    batch, env_steps, wait_s, put_s, trace = self._fetch()
                except BaseException as e:  # re-raised on the loop thread
                    self._put(_LaneItem("error", None, 0, 0.0, 0.0, e))
                    return
                if batch is None:
                    if self._abort is not None and self._abort.is_set():
                        return
                    if (self._drain is not None and self._drain.is_set()
                            and (self._upstream_drained is None or self._upstream_drained())):
                        # nothing more can arrive; FIFO puts this after any queued batch
                        self._put(_LaneItem("exhausted", None, 0, wait_s, 0.0, None))
                        return
                    self._put(_LaneItem("idle", None, 0, wait_s, 0.0, None))
                    continue
                self.fetched += 1
                self._put(_LaneItem("batch", batch, env_steps, wait_s, put_s, None, trace))
            finally:
                # cleared after the put: from there the queue covers the item
                self._inflight = False

    def stop(self) -> None:
        self.stop_event.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)


# The ranks' votes before each step (Learner._agree): stop now (abort,
# deadline, a failing rank), trained out (drain complete), no batch yet,
# a batch in hand.
_STOP, _DONE, _IDLE, _BATCH = 0, 1, 2, 3


class Learner:
    def __init__(self, cfg: LearnerConfig, broker: Broker, device=None, dist: Optional[Dist] = None):
        """`dist`: this process's rank among the data-parallel learner
        processes (parallel/dist.py init_distributed); None is a single
        process."""
        refuse_unported(cfg)
        self.dist = dist if dist is not None else Dist()
        axes = resolve_mesh(cfg.mesh_shape, self.dist.world)
        wide = lambda a: {k: v for k, v in a.items() if v > 1}
        if wide(axes) != wide(self.dist.axes):
            raise ValueError(f"mesh_shape={cfg.mesh_shape!r} resolves to {axes}, but the ranks were laid over "
                             f"{self.dist.axes}")
        self.cfg = cfg
        self.broker = broker
        self.device = resolve_device(device)
        self._prefetch_enabled = bool(cfg.learner.prefetch)
        self._prefetch_depth = max(int(cfg.learner.prefetch_depth), 1)
        self._prefetch_lane: Optional[PrefetchLane] = None
        # The fused layouts when fused_h2d is on and replay off (its stamp is
        # not in them), else the per-leaf tree: one train step either way.
        # `fused_io` is what staging packs into (None: dense batches).
        self.fused_io = None
        if cfg.fused_h2d and not is_sequence_parallel(cfg, self.dist.axes) and not cfg.replay.enabled:
            build = build_single_train_step if cfg.fused_single_h2d else build_fused_train_step
            self.train_step, self.fused_io = build(cfg, self.device, self.dist)
            self.io = self.fused_io
        else:
            self.train_step, self.io = build_train_step(cfg, self.device, self.dist), TreeBatchIO(self.device)
        if self.dist.world > 1 and cfg.broker_url.startswith("mem://"):
            _log.warning("multihost with mem:// broker: in-process queues cannot span hosts — fine for tests, wrong "
                         "for production (use tcp:// shared by all hosts)")
        # this rank's share of the batch: what its staging packs
        self._local_cfg = local_config(cfg, self.dist.world)
        self._null_payload = None  # padding rows for a trained-out rank's part of a step
        self.version = 0
        # Drawn once per learner process and stamped into every weight
        # frame: subscribers detect a restart by the epoch changing.
        self.boot_epoch = (int(time.time()) << 8 ^ os.getpid()) & 0xFFFFFFFF
        self.state: TrainState = init_train_state(cfg, self.device)
        # None when obs is off: every obs touchpoint is one `is not None`.
        self.obs = ObsRuntime.create(cfg.obs, role="learner")
        self.staging = StagingBuffer(
            self._local_cfg, broker, version_fn=lambda: self.version, fused_io=self.fused_io,
            tracer=self.obs.tracer if self.obs is not None else None,
            recorder=self.obs.recorder if self.obs is not None else None,
        )
        if self._prefetch_enabled:
            self.staging.attach_prefetch_probe(self._prefetch_holding)
        self._leases = _LeaseReaper()
        self.flattener = ParamFlattener(self.state.net)
        on_pub = None
        if cfg.ckpt.full_state and cfg.checkpoint_dir:
            # every version fanned out raises the high-water file, so a
            # kill between checkpoints never rolls the counter below it
            def on_pub(version):
                ck = self.checkpointer
                if ck is not None:
                    ck.record_published_version(version)

        self.publisher = WeightPublisher(
            broker, materialize=self.flattener.to_named, boot_epoch=self.boot_epoch,
            legacy_dtw1=cfg.publish_legacy_dtw1, on_published=on_pub,
        )
        self.metrics = MetricsLogger(cfg.log_dir)
        self._boot_monotonic = time.monotonic()
        self._life_steps = 0  # steps this process trained (a restore does not count)
        if self.obs is not None:
            # the global step's FLOPs over the sum of every rank's peak
            peak = device_peak_flops(self.device)
            peaks = self.dist.host_all_gather(math.nan if peak is None else peak)
            compute = self.obs.attach_compute(train_step_flops(cfg), aggregate_peak_flops(peaks),
                                              overlap=self._prefetch_enabled)
            self.train_step = compute.wrap_train_step(self.train_step)
            self.obs.serve_metrics([self._surface_scalars], health_provider=self._health,
                                   device=self.device, warm=lambda: self._life_steps >= PROFILE_WARM_STEPS)
        self.env_steps_done = 0  # real (unmasked) env steps trained on
        # `_drain`: run() stops fetching, trains out what staging holds and
        # returns; `_abort`: run() returns at once, staged work dropped.
        self._drain = threading.Event()
        self._abort = threading.Event()
        self._drain_timer: Optional[threading.Timer] = None
        # resume_* scalars, merged into the first metrics window after a
        # restore, then cleared
        self._resume_scalars: Dict[str, float] = {}
        self._ckpt_worker: Optional[CheckpointWorker] = None
        self._copier: Optional[StateCopier] = None
        if cfg.ckpt.async_save and cfg.checkpoint_dir:
            self._copier = StateCopier(self.state)
            self._ckpt_worker = CheckpointWorker(self._copier.to_host, self._save_full)
        self.checkpointer = None
        self._pending_hwm: Optional[int] = None  # the full-state restore's high-water, bumped below
        if cfg.checkpoint_dir:
            # every rank pulls the mirror; rank 0 alone pushes it
            self.checkpointer = Checkpointer(cfg.checkpoint_dir, remote_dir=cfg.checkpoint_remote_dir,
                                             remote_push=self.dist.is_primary)
            t_restore = time.monotonic()
            restored = self.checkpointer.restore_latest(self.state)
            if restored is not None:
                self.state = restored
                self.version = int(restored.step)
                _log.info("restored checkpoint at step %d", self.version)
                if cfg.ckpt.full_state:
                    self._restore_full_state(t_restore)
        # after the restore, which reads whole leaves: this rank's tp slices
        self.state = shard_state(self.state, self.dist)
        if self.dist.world > 1:
            self._agree_on_resume()
        if self.obs is not None:
            # last: the restore's version write is the watchdog's baseline,
            # not its first heartbeat
            self.obs.attach_watchdog(self.metrics.latest, lambda: self.version, self.metrics.latest_step)

    # ---------------------------------------------------------------- ops

    def _prefetch_holding(self) -> bool:
        lane = self._prefetch_lane
        return lane is not None and lane.holding()

    def _surface_scalars(self) -> Dict[str, float]:
        """The /metrics scrape: the last metrics window's scalars, with
        each meter the live gauges also read (the fabric's fanin_* and
        broker_shard_<i>_*, the wire-frame counts) taken live, so every
        meter has one value. A live fleet audit (obs/fleet.py LEDGERS)
        that read the window's copy would count every frame popped since
        the last window as lost."""
        out = self.metrics.latest()
        out.update(self._obs_gauges())
        return out

    def _obs_gauges(self) -> Dict[str, float]:
        """Live gauges: the obs_ family, and the delivery ledger's learner
        terms (the fabric's fan-in ledger, the staging intake's held
        frames and its wire-frame counts). The fabric is read before
        staging, so a frame moving on between the two reads counts twice
        (over), never not at all (loss)."""
        fabric_stats = getattr(self.broker, "fabric_stats", None)
        fanin = fabric_stats() if fabric_stats is not None else {}
        out = {"obs_learner_version": float(self.version)}
        depth = self.broker.experience_depth()
        if depth >= 0:  # -1: this transport cannot know it cheaply
            out["obs_broker_experience_depth"] = float(depth)
        stats = self.staging.stats()
        for k, v in stats.items():
            out[f"obs_staging_{k}"] = float(v)
        out["wire_frames_obs_bf16_total"] = float(stats["wire_frames_obs_bf16"])
        out["wire_frames_obs_f32_total"] = float(stats["wire_frames_obs_f32"])
        out.update({k: float(v) for k, v in fanin.items()})
        return out

    def _health(self) -> dict:
        """The /healthz body: healthy by serving, or the watchdog's verdict."""
        obs = self.obs
        watchdog = obs.watchdog if obs is not None else None
        wd = watchdog.verdict() if watchdog is not None else {"enabled": False, "ok": True}
        return {"ok": bool(wd.get("ok", True)), "role": "learner", "version": int(self.version),
                "uptime_s": round(time.monotonic() - self._boot_monotonic, 1), "watchdog": wd}

    def publish_weights(self) -> None:
        """Publish the current params synchronously (version 0 before the
        first batch, so actors align at once). Rank 0 alone publishes: one
        fan-out per version (under tp every rank takes part in the gather)."""
        params = whole_params(self.state)
        if not self.dist.is_primary:
            return
        frame = serialize_weights(
            host_named(params), version=self.version, boot_epoch=self.boot_epoch,
            legacy_dtw1=self.cfg.publish_legacy_dtw1,
        )
        self.broker.publish_weights(frame)

    def checkpoint(self) -> None:
        """Save the state as step `version`: synchronously by default; with
        ckpt.async_save the loop thread only enqueues the device clone and
        the worker does the rest."""
        if self.checkpointer is None:
            return
        ck = self.cfg.ckpt
        if not ck.full_state and not ck.async_save:
            self.checkpointer.save(self.state, step=self.version)
            return
        if self._ckpt_worker is not None:
            self._ckpt_worker.start()
            self._ckpt_worker.submit(self._copier.clone_on_device(self.state), self.version)
            return
        self._save_full(state_arrays(self.state), self.version)

    def _save_full(self, arrays, version: int, wait: bool = False) -> None:
        """One step, with its aux manifest in full-state mode. Runs on the
        CheckpointWorker in async mode, on the caller otherwise."""
        aux = self._build_aux(version) if self.cfg.ckpt.full_state else None
        self.checkpointer.save_arrays(arrays, version, wait=wait, aux=aux)

    def _build_aux(self, version: int) -> bytes:
        """The aux manifest (encode_aux): the staging snapshot (pending
        frames in arrival order, and the replay reservoir's entries,
        priorities, absolute staleness stamps and Generator state), the
        publish high-water as of this step,
        and the metrics/env-step marks, so a restored learner continues
        them instead of rewinding."""
        staging_snap = self.staging.snapshot_state() or {}
        return encode_aux({
            "manifest_version": 1,
            "step": int(version),
            "version_hwm": int(version),
            "boot_epoch": int(self.boot_epoch),
            "staging": staging_snap,
            "metrics_last_step": int(self.metrics.latest_step()),
            "env_steps_done": int(self.env_steps_done),
        })

    def _restore_full_state(self, t_restore: float) -> None:
        """Re-inject the aux manifest's pending frames, rebuild the replay
        reservoir (so the next sample is the uninterrupted run's), and bump
        the version counter to the published high-water mark (max of the step, the
        manifest's and the side file's), so staleness stamps the fleet has
        seen never read as from the future."""
        step = self.checkpointer.latest_step()
        aux = None
        raw = self.checkpointer.load_aux(step)
        if raw is not None:
            try:
                aux = decode_aux(raw)
            except ValueError:
                _log.exception("aux manifest for step %s unreadable; state-only restore", step)
        counts = {"pending": 0}
        hwm = max(self.version, int(step))
        if aux is not None:
            snap = aux.get("staging", {})
            if self.checkpointer.restored_from_remote and not self.dist.is_primary:
                # the mirror's manifest is rank 0's: its frames are rank 0's to re-inject
                _log.info("restored from the mirror: %d pending frames of rank 0's manifest left to rank 0",
                          len(snap.get("pending", [])))
            else:
                counts = self.staging.restore_state(snap)
            hwm = max(hwm, int(aux.get("version_hwm", 0)))
            self.env_steps_done = int(aux.get("env_steps_done", 0))
        file_hwm = self.checkpointer.published_hwm()
        if file_hwm is not None:
            hwm = max(hwm, file_hwm)
        if self.dist.world > 1:
            # Ranks but 0 never publish, so they hold no high-water file:
            # the resume-step check compares the un-bumped steps, then every
            # rank takes the same global-maximum bump (_agree_on_resume).
            self._pending_hwm = hwm
            hwm = self.version
        bump = hwm - self.version
        if bump > 0:
            _log.info("resume: version counter %d -> %d (published high-water)", self.version, hwm)
            self.version = hwm
        self._resume_scalars = {
            "resume_restored_step": float(step),
            "resume_version_hwm_bump": float(bump),
            "resume_reservoir_entries": float(counts.get("reservoir", 0)),
            "resume_pending_frames": float(counts["pending"]),
            "resume_restore_wall_s": round(time.monotonic() - t_restore, 3),
        }

    def _agree_on_resume(self) -> None:
        """Every rank must resume at the same step (a rank restored from an
        older checkpoint would train other params in the same collectives);
        then every rank bumps its version counter to the global published
        high-water mark, since staleness filtering is per-rank host work."""
        steps = [int(s) for s in self.dist.host_all_gather(self.version)]
        if len(set(steps)) != 1:
            raise RuntimeError(
                f"multihost restore mismatch: per-process resume steps {steps} — restore every host from the same "
                f"checkpoint (shared checkpoint_dir or remote mirror) before starting"
            )
        if not self.cfg.ckpt.full_state:
            return
        pending = self.version if self._pending_hwm is None else self._pending_hwm
        hwm = int(max(self.dist.host_all_gather(pending)))
        if hwm > self.version:
            self._resume_scalars["resume_version_hwm_bump"] = float(hwm - self.version)
            _log.info("resume: version counter %d -> %d (global published high-water)", self.version, hwm)
            self.version = hwm

    @property
    def resume_info(self) -> dict:
        """This boot's resume_* scalars (empty for a fresh start, or once
        the first metrics window has carried them)."""
        return dict(self._resume_scalars)

    def discard_unsaved(self) -> None:
        """SIGKILL emulation (chaos/controller.py): stop the checkpoint
        worker without its pending save and drop the queued mirror work,
        as a real kill -9 would; the durable state is what already hit
        the disk."""
        if self._ckpt_worker is not None:
            self._ckpt_worker.stop(flush=False)
        if self.checkpointer is not None:
            self.checkpointer.discard_pending()

    @property
    def drain_requested(self) -> bool:
        return self._drain.is_set()

    @property
    def aborted(self) -> bool:
        return self._abort.is_set()

    def request_drain(self) -> None:
        """run() stops fetching new broker frames, trains out the batches
        staging and the lane already hold, and returns."""
        self._drain.set()
        self.staging.quiesce()

    def abort(self) -> None:
        """run() returns as soon as possible; staged work is dropped."""
        self._abort.set()
        self.staging.quiesce()

    def drain_save(self) -> None:
        """The drain's last act, after run() returned: a full-state save,
        with the leftover (< B) pending frames in its manifest, durable
        (mirror included) before this returns. Disarms the budget timer."""
        if self.checkpointer is None:
            return
        if self._ckpt_worker is not None:
            self._ckpt_worker.stop(flush=False)  # superseded by this save
        self._save_full(state_arrays(self.state), self.version, wait=True)
        timer = self._drain_timer
        if timer is not None:
            timer.cancel()

    def install_drain_handler(self, budget_s: Optional[float] = None) -> None:
        """Learner main with ckpt.drain_on_sigterm: SIGTERM → request_drain
        and a budget timer that exits 1 if the drain wedges. Installed after
        the obs runtime, it replaces the flight recorder's SIGTERM dump (a
        drain is a clean exit)."""
        budget = self.cfg.ckpt.drain_budget_s if budget_s is None else budget_s

        def _on_term(signum, frame):
            _log.warning("SIGTERM: draining (budget %.0fs)", budget)
            self.request_drain()
            if self._drain_timer is None:  # repeated SIGTERMs arm one timer
                t = threading.Timer(budget, self._drain_budget_blown)
                t.daemon = True
                t.start()
                self._drain_timer = t

        signal.signal(signal.SIGTERM, _on_term)

    def _drain_budget_blown(self) -> None:
        _log.critical("SIGTERM drain exceeded its budget; forcing exit(1)")
        if self.obs is not None:
            self.obs.recorder.record("drain_budget_blown")
            self.obs.recorder.dump("drain_budget_blown")
        os._exit(1)

    # --------------------------------------------------------------- loop

    def _fetch_next(self, batch_timeout: float, lane: bool = False, cancel=None):
        """Pull one packed batch off staging and dispatch its H2D copies on
        the side stream (the transfer payload, or each leaf of a dense
        batch on the tree path). Returns ((payload, ready), env_steps, wait_s,
        put_s, trace) or (None, 0, wait_s, 0.0, None). Called after the
        current step's dispatch (serial loop) or on the lane thread
        (`lane`: phases go to the timer's overlap sums). With the obs phase
        timer the copy is fenced on its own event (the real transfer time);
        ring leases of earlier batches are released once their copies have
        completed."""
        timer = self.obs.compute.timer if self.obs is not None and self.obs.compute else None
        add = None
        if timer is not None:
            add = timer.add_overlap if lane else timer.add
        ring = self.staging._ring
        if ring is not None:
            self._leases.reap(ring.depth)
        t0 = time.perf_counter()
        batch, buf = self.staging.get_batch_groups(timeout=batch_timeout, cancel=cancel)
        t1 = time.perf_counter()
        if add is not None:
            add("fetch", t1 - t0)
        if batch is None:
            return None, 0, t1 - t0, 0.0, None
        trace, lease = self.staging.last_batch_trace, self.staging.last_batch_lease
        env_steps = int(np.sum(batch.mask))  # before the lease can go back
        t2 = time.perf_counter()
        if add is not None:
            add("pack", t2 - t1)  # staging packed already: the host read above
        payload = self.io.transfer(batch if self.fused_io is None else buf)
        if add is not None:
            if payload[1] is not None:
                payload[1].synchronize()  # blocks only this thread
            add("h2d", time.perf_counter() - t2)
        if lease is not None:
            self._leases.hold(lease, payload[1])
        if self.obs is not None and trace is not None:
            self.obs.tracer.hop_batch("h2d", trace)
        return payload, env_steps, t2 - t0, time.perf_counter() - t2, trace

    def _step(self, payload) -> dict:
        """Dispatch one train step on the loop thread's stream."""
        self.state, metrics = self.train_step(self.state, self.io.consume(*payload))
        return metrics

    def _after_step(self) -> None:
        """Publish and checkpoint cadence, on the loop thread after the
        version counter advanced."""
        cfg = self.cfg
        self._life_steps += 1
        if self.version % cfg.publish_every == 0:
            params = whole_params(self.state)  # under tp a gather every rank takes part in
            if self.dist.is_primary:
                self.publisher.submit(self.flattener.flatten_on_device(params), self.version)
        if self.checkpointer is not None and self.version % cfg.checkpoint_every == 0:
            self.checkpoint()

    def _trace_apply(self, trace) -> None:
        """Terminal hops at dispatch: apply, and the e2e actor→apply time."""
        if self.obs is not None and trace is not None:
            self.obs.tracer.hop_batch("apply", trace)
            self.obs.tracer.e2e(trace)

    def run(self, num_steps: Optional[int] = None, batch_timeout: float = 60.0, max_idle: Optional[int] = None,
            max_seconds: Optional[float] = None) -> int:
        """Train until num_steps (None = forever); returns steps done.

        `max_idle`: raise TimeoutError after this many consecutive empty
        batch waits (None = wait forever). `max_seconds`: stop cleanly
        once this much wall clock has passed (checked between steps)."""
        self.staging.start()
        if self._drain.is_set() or self._abort.is_set():
            self.staging.quiesce()  # asked before this run started: start() cleared it
        self.publisher.start()
        done_steps = 0
        try:
            self.publish_weights()  # version 0, synchronous
            deadline = time.monotonic() + max_seconds if max_seconds is not None else None

            def _bt() -> float:
                # fetch waits respect the wall-clock budget and a drain
                if self._drain.is_set() or self._abort.is_set():
                    return 0.2
                if deadline is None:
                    return batch_timeout
                return max(0.05, min(batch_timeout, deadline - time.monotonic()))

            loop = self._run_pipelined if self._prefetch_enabled else self._run_serial
            done_steps = loop(num_steps, batch_timeout, max_idle, deadline, _bt)
        finally:
            if self.device.type == "cuda":
                # an exception mid-loop still lets the in-flight step finish
                # before teardown
                torch.cuda.synchronize(self.device)
            self._leases.release_all()
            self.staging.stop()
            self.publisher.stop()
            self.metrics.flush()
        return done_steps

    def _stopping(self, deadline) -> bool:
        return self._abort.is_set() or (deadline is not None and time.monotonic() >= deadline)

    def _agree(self, vote: int) -> int:
        """What every rank does next, from every rank's vote (_STOP, _DONE,
        _IDLE or _BATCH): _STOP when any rank must stop or all are trained
        out; _BATCH, take the step, when a rank holds a batch and none is
        still waiting for one; else _IDLE, wait. One host all-gather across
        ranks; a single process decides alone."""
        votes = [int(v) for v in self.dist.host_all_gather(vote)]
        if _STOP in votes or all(v == _DONE for v in votes):
            return _STOP
        if _IDLE in votes or _BATCH not in votes:
            return _IDLE
        return _BATCH

    def _give_up(self, error: BaseException):
        """Raise `error` on this rank after telling the others to stop."""
        if self.dist.world > 1:
            self._agree(_STOP)
        raise error

    def _padding_payload(self):
        """A transfer of this rank's B / N rows, all padding (no real step,
        so it adds nothing to any sum): a trained-out rank's part of a step
        the other ranks take."""
        if self._null_payload is None:
            rows = batch_template(self._local_cfg)
            self._null_payload = rows if self.fused_io is None else self.fused_io.pack_transfer(rows)
        return self.io.transfer(self._null_payload)

    def _run_serial(self, num_steps, batch_timeout, max_idle, deadline, _bt) -> int:
        """The serial fetch-after-step loop (learner.prefetch false). With
        the obs phase timer each step is fenced by a CUDA event on the
        loop's stream, so every phase is causally attributed."""
        cfg = self.cfg
        timer = self.obs.compute.timer if self.obs is not None else None
        done_steps = 0
        win_wait = win_put = 0.0
        win_env_steps = win_steps = 0
        t_win = time.perf_counter()
        idle = 0
        next_batch, next_env_steps, w, p, next_trace = self._fetch_next(_bt())
        win_wait += w
        win_put += p
        while num_steps is None or done_steps < num_steps:
            if self._stopping(deadline):
                vote = _STOP
            elif next_batch is not None:
                vote = _BATCH
            else:
                vote = _DONE if self._drain.is_set() and self.staging.drained() else _IDLE
            decision = self._agree(vote)
            if decision == _STOP:
                break
            if decision == _IDLE:
                if next_batch is None:  # a held batch waits for the other ranks' next votes
                    if not self._drain.is_set():
                        idle += 1
                        if max_idle is not None and idle >= max_idle:
                            self._give_up(TimeoutError(f"no batch for {idle} consecutive {batch_timeout:.0f}s waits — "
                                                       f"producers dead or stalled"))
                        _log.warning("no batch within %.0fs; waiting", batch_timeout)
                    next_batch, next_env_steps, w, p, next_trace = self._fetch_next(_bt())
                    win_wait += w
                    win_put += p
                continue
            idle = 0
            if next_batch is None:  # trained out: padding rows for this rank's part of the step
                next_batch, next_env_steps, next_trace = self._padding_payload(), 0, None
            t_pass = time.perf_counter()
            metrics = self._step(next_batch)
            if timer is not None:
                fence(self.device)
                timer.add("device_step", time.perf_counter() - t_pass)
            self._trace_apply(next_trace)
            self.version += 1
            done_steps += 1
            self.env_steps_done += next_env_steps
            win_env_steps += next_env_steps
            win_steps += 1
            last = num_steps is not None and done_steps >= num_steps
            if not last:
                # host work overlapping the in-flight device step; never a
                # trailing fetch that would eat a batch the run will not train
                next_batch, next_env_steps, w, p, next_trace = self._fetch_next(_bt())
                win_wait += w
                win_put += p
            else:
                next_batch, next_env_steps, next_trace = None, 0, None
            t_host = time.perf_counter()
            self._after_step()
            if timer is not None:
                # close the pass before a metrics window: a window only
                # aggregates whole passes
                t_end = time.perf_counter()
                timer.add("host", t_end - t_host)
                timer.step(t_end - t_pass)
            if self.version % cfg.metrics_every == 0 or last:
                now = time.perf_counter()
                self._log_window(metrics, now, t_win, win_steps, win_env_steps, win_wait, win_put)
                win_wait = win_put = 0.0
                win_env_steps = win_steps = 0
                t_win = now
        return done_steps

    def _run_pipelined(self, num_steps, batch_timeout, max_idle, deadline, _bt) -> int:
        """The overlapped loop (learner.prefetch, default): a PrefetchLane
        stages batch N+1 while the device runs step N. With the obs phase
        timer in overlap mode the lane records its own fetch/pack/h2d, and
        the loop's device_step is the unfenced residual."""
        cfg = self.cfg
        timer = self.obs.compute.timer if self.obs is not None else None
        cancel = threading.Event()
        lane = PrefetchLane(
            lambda: self._fetch_next(_bt(), lane=True, cancel=cancel),
            depth=self._prefetch_depth,
            limit=num_steps,
            drain=self._drain,
            abort=self._abort,
            upstream_drained=lambda: self.staging.drained(include_prefetch=False),
            stop_event=cancel,
        )
        self._prefetch_lane = lane
        lane.start()
        done_steps = 0
        win_wait = win_put = win_take = 0.0
        win_env_steps = win_steps = 0
        t_win = time.perf_counter()
        idle = 0
        held = None  # a batch (or the lane's last "exhausted") kept across the ranks' waits
        votes = {"batch": _BATCH, "idle": _IDLE, "exhausted": _DONE}
        try:
            while num_steps is None or done_steps < num_steps:
                item, held = held, None
                if item is None or item.kind == "exhausted":  # a held batch's wait runs on
                    t_take0 = time.perf_counter()
                while item is None and not self._stopping(deadline):
                    try:
                        item = lane.get(timeout=0.2)
                    except queue.Empty:
                        continue
                if item is not None and item.kind == "error":
                    self._give_up(item.error)
                vote = _STOP if item is None or self._stopping(deadline) else votes[item.kind]
                decision = self._agree(vote)
                take_s = time.perf_counter() - t_take0
                if decision == _STOP:
                    break  # abort / deadline, or drain complete: every batch the lane held is trained
                if decision == _IDLE and vote != _IDLE:
                    held = item  # a batch waits for the other ranks'; a trained-out lane stays so
                    continue
                if vote != _DONE:
                    win_take += take_s
                    win_wait += item.wait_s
                    if timer is not None:
                        # the exposed wait for a prefetched batch (starvation
                        # reads loud here, idle items included)
                        timer.add("fetch", take_s)
                if decision == _IDLE:
                    if self._drain.is_set():
                        continue
                    idle += 1
                    if max_idle is not None and idle >= max_idle:
                        self._give_up(TimeoutError(f"no batch for {idle} consecutive {batch_timeout:.0f}s waits — "
                                                   f"producers dead or stalled"))
                    _log.warning("no batch within %.0fs; waiting", batch_timeout)
                    continue
                idle = 0
                if vote == _DONE:  # trained out: padding rows for this rank's part of the step
                    held, payload, env_steps, trace = item, self._padding_payload(), 0, None
                else:
                    payload, env_steps, trace = item.batch, item.env_steps, item.trace
                    win_put += item.put_s
                metrics = self._step(payload)
                self._trace_apply(trace)
                self.version += 1
                done_steps += 1
                self.env_steps_done += env_steps
                win_env_steps += env_steps
                win_steps += 1
                last = num_steps is not None and done_steps >= num_steps
                t_host = time.perf_counter()
                self._after_step()
                if timer is not None:
                    t_end = time.perf_counter()
                    host_s = t_end - t_host
                    timer.add("host", host_s)
                    wall = t_end - t_take0
                    timer.add("device_step", max(wall - take_s - host_s, 0.0))
                    timer.step(wall)
                if self.version % cfg.metrics_every == 0 or last:
                    now = time.perf_counter()
                    self._log_window(metrics, now, t_win, win_steps, win_env_steps, win_wait, win_put, win_take=win_take)
                    win_wait = win_put = win_take = 0.0
                    win_env_steps = win_steps = 0
                    t_win = now
        finally:
            lane.stop()
            self._prefetch_lane = None
        return done_steps

    def _log_window(self, metrics, now, t_win, win_steps, win_env_steps, win_wait, win_put, win_take=None) -> None:
        """One metrics window: the loop's one routine device sync (one
        device-to-host copy of the stacked step metrics)."""
        values = torch.stack([v.float() for v in metrics.values()]).tolist()
        scalars = dict(zip(metrics, values))
        stats = self.staging.stats()
        dt = max(now - t_win, 1e-9)
        n = max(win_steps, 1)
        scalars["env_steps_per_sec"] = win_env_steps / dt
        scalars["time_wait_batch_s"] = win_wait / n
        scalars["time_device_put_s"] = win_put / n
        if win_take is None:
            scalars["time_step_s"] = max(dt - win_wait - win_put, 0.0) / n
        else:
            # pipelined: wait/put were paid on the lane beside the device
            # step; only the loop's take-wait is exposed (the obs overlap
            # timer refines the pipeline_* keys below with its lane sums)
            lane_s = win_wait + win_put
            scalars["time_step_s"] = max(dt - win_take, 0.0) / n
            scalars["pipeline_prefetch_s"] = lane_s / n
            scalars["pipeline_device_idle_s"] = win_take / n
            scalars["pipeline_overlap_ratio"] = max(0.0, min(1.0, 1.0 - win_take / lane_s)) if lane_s > 0 else 1.0
        scalars["active_actors"] = stats["active_actors"]
        scalars["staleness_dropped"] = stats["dropped_stale"]
        scalars["staging_quarantined"] = stats["quarantined"]
        scalars["queue_ready"] = stats["ready_batches"]
        scalars["episodes"] = stats["episodes"]
        scalars["wire_bytes_consumed_total"] = stats["wire_bytes"]
        scalars["wire_frames_obs_bf16_total"] = stats["wire_frames_obs_bf16"]
        scalars["wire_frames_obs_f32_total"] = stats["wire_frames_obs_f32"]
        # the fabric's fanin_* / broker_shard_<i>_* scalars: local counters
        # (no RPC), present only with a shard-list broker_url
        fabric_stats = getattr(self.broker, "fabric_stats", None)
        if fabric_stats is not None:
            for k, v in fabric_stats().items():
                scalars[k] = float(v)
        for k, v in stats.items():
            if k.startswith("pack_"):  # the parallel feed (pack_workers > 1) and assembled intake
                scalars[f"staging_{k}"] = float(v)
            elif k.startswith("replay_"):  # the reservoir's health (replay.enabled)
                scalars[k] = v
        scalars["weights_published"] = self.publisher.published
        scalars["weights_coalesced"] = self.publisher.coalesced
        if self.checkpointer is not None:
            for k, v in self.checkpointer.mirror_stats().items():
                if isinstance(v, (int, float)):
                    scalars[f"ckpt_mirror_{k}"] = v
            for k, v in self.checkpointer.save_stats().items():
                scalars[f"ckpt_{k}"] = float(v)
            if self._ckpt_worker is not None:
                scalars["ckpt_async_saves_total"] = float(self._ckpt_worker.saved)
                scalars["ckpt_async_coalesced_total"] = float(self._ckpt_worker.coalesced)
        if self._resume_scalars:
            scalars.update(self._resume_scalars)
            self._resume_scalars = {}
        if stats["episodes"] > 0:
            scalars["mean_episode_return"] = stats["episode_return_sum"] / stats["episodes"]
        if self.obs is not None:
            scalars.update(self.obs.tracer.scalars())
            if self.obs.compute is not None:
                scalars.update(self.obs.compute.window_scalars(win_steps, dt))
        self.metrics.log(self.version, scalars)

    def close(self) -> None:
        if self._ckpt_worker is not None:
            # drain, not discard: the newest submitted step ends durable
            self._ckpt_worker.stop(flush=True)
        if self.checkpointer is not None:
            self.checkpointer.close()
        if self.obs is not None:
            self.obs.close()
        self.metrics.close()


def main(argv=None, backend: Optional[str] = None):
    """The learner binary. With `--multihost` this process joins the
    data-parallel ranks first (parallel/dist.py; `backend` None picks NCCL
    on a card)."""
    from dotaclient_tpu_torch.config import parse_config
    from dotaclient_tpu_torch.transport.base import RetryPolicy
    from dotaclient_tpu_torch.transport.base import connect as broker_connect

    logging.basicConfig(level=logging.INFO)
    cfg = parse_config(LearnerConfig(), argv)
    device = "cpu" if cfg.platform == "cpu" else None
    dist = None
    if cfg.multihost:
        # before the broker and the Learner, as the reference initializes
        # jax.distributed before any backend touch
        dist = init_distributed(cfg, device, backend=backend)
        device = dist.device
    try:
        broker = broker_connect(cfg.broker_url, retry=RetryPolicy.from_config(cfg.retry))
        if cfg.broker_shards:
            # a learner of several consuming a disjoint shard subset: only a
            # shard-list broker_url has shards to pick
            restrict = getattr(broker, "restrict_consume_shards", None)
            if restrict is None:
                raise ValueError(f"--broker_shards={cfg.broker_shards!r} needs a broker fabric (comma-separated "
                                 f"--broker_url shard list); got {cfg.broker_url!r}")
            restrict([int(s) for s in cfg.broker_shards.split(",") if s.strip()])
        if cfg.chaos.enabled:
            # a gated import: with chaos off the package never loads and the
            # broker is the production object
            from dotaclient_tpu_torch.chaos import wrap_broker

            broker = wrap_broker(broker, cfg.chaos)
        learner = Learner(cfg, broker, device=device, dist=dist)
        if cfg.ckpt.drain_on_sigterm:
            # after the Learner (and its obs runtime's SIGTERM dump trigger)
            learner.install_drain_handler()
        _log.info("learner up: device=%s mesh=%s batch=%dx%d rank %d of %d", learner.device, cfg.mesh_shape,
                  cfg.batch_size, cfg.seq_len, learner.dist.rank, learner.dist.world)
        try:
            learner.run(num_steps=cfg.train_steps or None)
            if learner.drain_requested and not learner.aborted:
                learner.drain_save()
                _log.info("SIGTERM drain complete at version %d; exiting 0", learner.version)
        finally:
            learner.close()
    finally:
        if dist is not None:
            dist.close()
    return learner


if __name__ == "__main__":
    main()
