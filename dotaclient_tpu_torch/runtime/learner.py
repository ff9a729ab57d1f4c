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

Stream ordering in place of JAX's donation semantics:
- a batch's host-to-device copy runs on the FusedBatchIO's side stream;
  the loop thread's stream waits on the copy's event before the step
  (`FusedBatchIO.consume`), so the copy of N+1 overlaps step N;
- Adam updates the params in place, so a publish enqueues the flatten and
  a non-blocking copy into fresh pinned memory on the loop thread's
  stream BEFORE the next step, and records an event there; the publisher
  thread waits on that event and never touches a device tensor.
Outside a metrics window (and a checkpoint, which reads the state) the
loop thread makes no synchronising device call.

Modes the port does not have yet are refused at construction with
NotImplementedError naming their ROADMAP item (config.UNPORTED), never
substituted.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from dotaclient_tpu_torch import resolve_device
from dotaclient_tpu_torch.config import LearnerConfig, refuse_unported
from dotaclient_tpu_torch.parallel.train_step import TrainState, build_single_train_step, init_train_state
from dotaclient_tpu_torch.runtime.checkpoint import Checkpointer
from dotaclient_tpu_torch.runtime.metrics import MetricsLogger
from dotaclient_tpu_torch.runtime.staging import StagingBuffer
from dotaclient_tpu_torch.transport.base import Broker
from dotaclient_tpu_torch.transport.params import named_params, named_tensors
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

    def flatten_on_device(self, net: torch.nn.Module):
        """(host f32 buffer, event or None); returns without waiting."""
        with torch.no_grad():
            flat = torch.cat([p.detach().reshape(-1).float() for p in named_tensors(net).values()])
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
        self._fetch = fetch_fn  # () -> (batch, env_steps, wait_s, put_s)
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
                    batch, env_steps, wait_s, put_s = self._fetch()
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
                self._put(_LaneItem("batch", batch, env_steps, wait_s, put_s, None))
            finally:
                # cleared after the put: from there the queue covers the item
                self._inflight = False

    def stop(self) -> None:
        self.stop_event.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)


class Learner:
    def __init__(self, cfg: LearnerConfig, broker: Broker, device=None):
        refuse_unported(cfg)
        self.cfg = cfg
        self.broker = broker
        self.device = resolve_device(device)
        self._prefetch_enabled = bool(cfg.learner.prefetch)
        self._prefetch_depth = max(int(cfg.learner.prefetch_depth), 1)
        self._prefetch_lane: Optional[PrefetchLane] = None
        self.train_step, self.io = build_single_train_step(cfg, self.device)
        self.version = 0
        # Drawn once per learner process and stamped into every weight
        # frame: subscribers detect a restart by the epoch changing.
        self.boot_epoch = (int(time.time()) << 8 ^ os.getpid()) & 0xFFFFFFFF
        self.state: TrainState = init_train_state(cfg, self.device)
        self.staging = StagingBuffer(cfg, broker, version_fn=lambda: self.version, fused_io=self.io)
        if self._prefetch_enabled:
            self.staging.attach_prefetch_probe(self._prefetch_holding)
        self.flattener = ParamFlattener(self.state.net)
        self.publisher = WeightPublisher(
            broker, materialize=self.flattener.to_named, boot_epoch=self.boot_epoch, legacy_dtw1=cfg.publish_legacy_dtw1
        )
        self.metrics = MetricsLogger(cfg.log_dir)
        self.env_steps_done = 0  # real (unmasked) env steps trained on
        # `_drain`: run() stops fetching, trains out what staging holds and
        # returns; `_abort`: run() returns at once, staged work dropped.
        self._drain = threading.Event()
        self._abort = threading.Event()
        self.checkpointer = None
        if cfg.checkpoint_dir:
            self.checkpointer = Checkpointer(cfg.checkpoint_dir)
            restored = self.checkpointer.restore_latest(self.state)
            if restored is not None:
                self.state = restored
                self.version = int(restored.step)
                _log.info("restored checkpoint at step %d", self.version)

    # ---------------------------------------------------------------- ops

    def _prefetch_holding(self) -> bool:
        lane = self._prefetch_lane
        return lane is not None and lane.holding()

    def publish_weights(self) -> None:
        """Publish the current params synchronously (version 0 before the
        first batch, so actors align at once)."""
        frame = serialize_weights(
            named_params(self.state.net), version=self.version, boot_epoch=self.boot_epoch,
            legacy_dtw1=self.cfg.publish_legacy_dtw1,
        )
        self.broker.publish_weights(frame)

    def checkpoint(self) -> None:
        if self.checkpointer is not None:
            self.checkpointer.save(self.state, step=self.version)

    def request_drain(self) -> None:
        """run() stops fetching new broker frames, trains out the batches
        staging and the lane already hold, and returns."""
        self._drain.set()
        self.staging.quiesce()

    def abort(self) -> None:
        """run() returns as soon as possible; staged work is dropped."""
        self._abort.set()
        self.staging.quiesce()

    # --------------------------------------------------------------- loop

    def _fetch_next(self, batch_timeout: float, cancel=None):
        """Pull one packed batch off staging and dispatch its H2D copy on
        the side stream (no host wait). Returns ((payload, ready),
        env_steps, wait_s, put_s) or (None, 0, wait_s, 0.0). Called after
        the current step's dispatch (serial loop) or on the lane thread."""
        t0 = time.perf_counter()
        batch, buf = self.staging.get_batch_groups(timeout=batch_timeout, cancel=cancel)
        t1 = time.perf_counter()
        if batch is None:
            return None, 0, t1 - t0, 0.0
        env_steps = int(np.sum(batch.mask))
        payload = self.io.transfer(buf)
        return payload, env_steps, t1 - t0, time.perf_counter() - t1

    def _step(self, payload) -> dict:
        """Dispatch one train step on the loop thread's stream."""
        self.state, metrics = self.train_step(self.state, self.io.consume(*payload))
        return metrics

    def _after_step(self) -> None:
        """Publish and checkpoint cadence, on the loop thread after the
        version counter advanced."""
        cfg = self.cfg
        if self.version % cfg.publish_every == 0:
            self.publisher.submit(self.flattener.flatten_on_device(self.state.net), self.version)
        if self.checkpointer is not None and self.version % cfg.checkpoint_every == 0:
            self.checkpoint()

    def run(self, num_steps: Optional[int] = None, batch_timeout: float = 60.0, max_idle: Optional[int] = None,
            max_seconds: Optional[float] = None) -> int:
        """Train until num_steps (None = forever); returns steps done.

        `max_idle`: raise TimeoutError after this many consecutive empty
        batch waits (None = wait forever). `max_seconds`: stop cleanly
        once this much wall clock has passed (checked between steps)."""
        self.staging.start()
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
            self.staging.stop()
            self.publisher.stop()
            self.metrics.flush()
        return done_steps

    def _run_serial(self, num_steps, batch_timeout, max_idle, deadline, _bt) -> int:
        """The serial fetch-after-step loop (learner.prefetch false)."""
        cfg = self.cfg
        done_steps = 0
        win_wait = win_put = 0.0
        win_env_steps = win_steps = 0
        t_win = time.perf_counter()
        idle = 0
        next_batch, next_env_steps, w, p = self._fetch_next(_bt())
        win_wait += w
        win_put += p
        while num_steps is None or done_steps < num_steps:
            if self._abort.is_set():
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            if next_batch is None:
                if self._drain.is_set():
                    if self.staging.drained():
                        break
                else:
                    idle += 1
                    if max_idle is not None and idle >= max_idle:
                        raise TimeoutError(f"no batch for {idle} consecutive {batch_timeout:.0f}s waits — producers dead or stalled")
                    _log.warning("no batch within %.0fs; waiting", batch_timeout)
                next_batch, next_env_steps, w, p = self._fetch_next(_bt())
                win_wait += w
                win_put += p
                continue
            idle = 0
            metrics = self._step(next_batch)
            self.version += 1
            done_steps += 1
            self.env_steps_done += next_env_steps
            win_env_steps += next_env_steps
            win_steps += 1
            last = num_steps is not None and done_steps >= num_steps
            if not last:
                # host work overlapping the in-flight device step; never a
                # trailing fetch that would eat a batch the run will not train
                next_batch, next_env_steps, w, p = self._fetch_next(_bt())
                win_wait += w
                win_put += p
            else:
                next_batch, next_env_steps = None, 0
            self._after_step()
            if self.version % cfg.metrics_every == 0 or last:
                now = time.perf_counter()
                self._log_window(metrics, now, t_win, win_steps, win_env_steps, win_wait, win_put)
                win_wait = win_put = 0.0
                win_env_steps = win_steps = 0
                t_win = now
        return done_steps

    def _run_pipelined(self, num_steps, batch_timeout, max_idle, deadline, _bt) -> int:
        """The overlapped loop (learner.prefetch, default): a PrefetchLane
        stages batch N+1 while the device runs step N."""
        cfg = self.cfg
        cancel = threading.Event()
        lane = PrefetchLane(
            lambda: self._fetch_next(_bt(), cancel=cancel),
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
        try:
            while num_steps is None or done_steps < num_steps:
                item = None
                t_take0 = time.perf_counter()
                while item is None:
                    if self._abort.is_set():
                        break
                    if deadline is not None and time.monotonic() >= deadline:
                        break
                    try:
                        item = lane.get(timeout=0.2)
                    except queue.Empty:
                        continue
                if item is None:
                    break  # abort / deadline
                take_s = time.perf_counter() - t_take0
                if item.kind == "error":
                    raise item.error
                if item.kind == "exhausted":
                    break  # drain complete: every batch the lane held is trained
                win_take += take_s
                win_wait += item.wait_s
                if item.kind == "idle":
                    if self._drain.is_set():
                        continue
                    idle += 1
                    if max_idle is not None and idle >= max_idle:
                        raise TimeoutError(f"no batch for {idle} consecutive {batch_timeout:.0f}s waits — producers dead or stalled")
                    _log.warning("no batch within %.0fs; waiting", batch_timeout)
                    continue
                idle = 0
                win_put += item.put_s
                metrics = self._step(item.batch)
                self.version += 1
                done_steps += 1
                self.env_steps_done += item.env_steps
                win_env_steps += item.env_steps
                win_steps += 1
                last = num_steps is not None and done_steps >= num_steps
                self._after_step()
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
            # step; only the loop's take-wait is exposed
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
        scalars["weights_published"] = self.publisher.published
        scalars["weights_coalesced"] = self.publisher.coalesced
        if stats["episodes"] > 0:
            scalars["mean_episode_return"] = stats["episode_return_sum"] / stats["episodes"]
        self.metrics.log(self.version, scalars)

    def close(self) -> None:
        if self.checkpointer is not None:
            self.checkpointer.close()
        self.metrics.close()


def main(argv=None):
    from dotaclient_tpu_torch.config import parse_config
    from dotaclient_tpu_torch.transport.base import RetryPolicy
    from dotaclient_tpu_torch.transport.base import connect as broker_connect

    logging.basicConfig(level=logging.INFO)
    cfg = parse_config(LearnerConfig(), argv)
    broker = broker_connect(cfg.broker_url, retry=RetryPolicy.from_config(cfg.retry))
    learner = Learner(cfg, broker, device="cpu" if cfg.platform == "cpu" else None)
    _log.info("learner up: device=%s batch=%dx%d", learner.device, cfg.batch_size, cfg.seq_len)
    try:
        learner.run(num_steps=cfg.train_steps or None)
    finally:
        learner.close()


if __name__ == "__main__":
    main()
