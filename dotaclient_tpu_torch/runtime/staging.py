"""Host-side staging buffer: broker frames → packed transfer buffers (torch
twin of dotaclient_tpu/runtime/staging.py).

- One consumer thread drains the broker and parses frames: the native
  packer's batched header parse (`native_packer`, the default) or a full
  Python deserialize. With `staging.pack_workers` N > 1 the work splits:
  a pop thread drains the broker into a bounded intake queue, an
  assembler thread parses and forms batches, and N packer threads each
  fill a disjoint row shard of one pinned TransferRing slot (the native
  packer releases the GIL; the Python packer holds it, so with it the
  pool gives byte parity and no speed). Any N packs the same bytes.
- Rollouts older than `ppo.max_staleness` learner versions are dropped
  here, before they cost device time. With `replay.enabled` those within
  `replay.max_staleness` go to a ReplayReservoir instead, and each batch
  draws up to `replay.ratio` of its rows from it, every row stamped with
  its behavior-policy staleness (`behavior_staleness`).
- Frames that fail parse or the per-frame layout check are dropped and
  filed, with evidence, in a bounded quarantine ring.
- Each batch of B rollouts is packed straight into the views of the
  pinned transfer buffers of `fused_io` (parallel/fused_io.py: one
  [B, row_bytes] u8 buffer, or four dtype groups), fresh per batch on the
  classic path and a leased ring slot with the pool, so the learner ships
  it without a regroup copy. Without `fused_io` (the learner's tree path)
  a batch is a dense TrainBatch of numpy leaves, obs cast to the compute
  dtype inside the copy. A bounded ready queue (depth 2) lets packing
  overlap the device step.
- With `staging.assemble` the fabric shards pack each frame into this
  learner's row layout (transport/assemble.py) and the broker delivers
  AssembledRows: "packing" a batch is a row concat into a ring slot.
- Only the consumer (assembler) thread touches the pending list and the
  reservoir; only the learner's getters pop ready batches.
- `snapshot_state` / `restore_state` carry the pending frames and the
  reservoir through a full-state checkpoint, in order.

A malformed frame costs its own batch at worst (`dropped_bad`). A layout
or config mismatch (BatchLayoutError) would fail every batch: the consumer
thread dies, and the getters re-raise instead of starving the learner.

numpy has no bf16 here: bf16 obs are uint16 words in the transfer buffer,
rounded from f32 explicitly (`transport.serialize.f32_to_bf16_bits`),
bit for bit the reference's ml_dtypes cast.
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dotaclient_tpu_torch.config import LearnerConfig, refuse_unported
from dotaclient_tpu_torch.obs.trace import TraceRef
from dotaclient_tpu_torch.ops.batch import BatchLayoutError, TrainBatch, zeros_train_batch
from dotaclient_tpu_torch.transport.base import Broker
from dotaclient_tpu_torch.transport.serialize import (
    AssembledRow,
    BlockSpec,
    Rollout,
    WireDtypeError,
    bf16_bits,
    bf16_bits_to_f32,
    bf16_tensor,
    check_dtr3_dtype_map,
    deserialize_block,
    deserialize_rollout,
    f32_to_bf16_bits,
    is_bf16,
    peek_rollout_trace,
    rollout_obs_bf16,
    serialize_block,
    serialize_rollout,
    strip_rollout_trace,
    wire_obs_is_bf16,
)

_log = logging.getLogger(__name__)


def _assign(dst: np.ndarray, src) -> None:
    """dst[...] = src with the bf16 storage written out: a uint16 `dst`
    holds bf16 words (f32 sources rounded to nearest even, bf16 tensors
    copied), an f32 `dst` takes bf16 sources widened exactly."""
    if dst.dtype == np.uint16:
        dst[...] = bf16_bits(src) if is_bf16(src) else f32_to_bf16_bits(src)
    elif is_bf16(src):
        dst[...] = bf16_bits_to_f32(bf16_bits(src))
    else:
        dst[...] = src


def fill_rollouts(batch: TrainBatch, rollouts: List[Rollout], seq_len: int, row_offset: int = 0) -> None:
    """Fill a pre-zeroed TrainBatch (zeros_train_batch contract) with
    variable-length rollouts in place; rollout i lands at row
    row_offset + i. The leaves may be strided views of the transfer
    buffer, bf16 ones as uint16 words."""
    T = seq_len
    obs, actions, aux = batch.obs, batch.actions, batch.aux
    for i, r in enumerate(rollouts):
        b = row_offset + i
        L = r.length
        if L > T:
            raise ValueError(f"rollout length {L} exceeds learner seq_len {T}")
        for field in range(len(obs)):
            _assign(obs[field][b, : L + 1], r.obs[field][: L + 1])
        for field in range(len(actions)):
            actions[field][b, :L] = r.actions[field][:L]
        batch.behavior_logp[b, :L] = r.behavior_logp
        batch.behavior_value[b, :L] = r.behavior_value
        batch.rewards[b, :L] = r.rewards
        batch.dones[b, :L] = r.dones
        batch.mask[b, :L] = 1.0
        batch.initial_state[0][b] = r.initial_state[0]
        batch.initial_state[1][b] = r.initial_state[1]
        if aux is not None and r.aux is not None:
            aux.win[b, :L] = r.aux.win
            aux.last_hit[b, :L] = r.aux.last_hit
            aux.net_worth[b, :L] = r.aux.net_worth


def shard_rows(total: int, workers: int) -> List[tuple]:
    """Contiguous (offset, count) row shards, as even as possible: the
    first total % workers shards get one extra row; never an empty shard."""
    n = max(1, min(workers, total))
    base, rem = divmod(total, n)
    shards, off = [], 0
    for i in range(n):
        cnt = base + (1 if i < rem else 0)
        shards.append((off, cnt))
        off += cnt
    return shards


def pack_rollouts(rollouts: List[Rollout], seq_len: int, with_aux: bool) -> TrainBatch:
    """Pad B variable-length rollouts into one fixed [B, T] numpy
    TrainBatch with f32 obs (bf16 rollouts widened exactly)."""
    H = rollouts[0].initial_state[0].shape[-1]
    batch = zeros_train_batch(len(rollouts), seq_len, H, with_aux)
    fill_rollouts(batch, rollouts, seq_len)
    return batch


def cast_obs_to_compute_dtype(cfg: LearnerConfig, batch: TrainBatch) -> TrainBatch:
    """Cast the float32 obs leaves of a numpy batch to the policy compute
    dtype on the host. The policy's first op on every obs float is the
    same cast, so this changes no result and halves the bytes of the
    dominant host-to-device transfer; GAE/loss scalars stay f32.

    A bf16 leaf is a CPU `torch.bfloat16` tensor whose words are rounded
    by `f32_to_bf16_bits`, as ml_dtypes rounds in the reference. NaN and
    inf pass through (wire frames are untrusted; rows are masked or
    dropped downstream)."""
    if not cfg.stage_obs_compute_dtype or cfg.policy.dtype != "bfloat16":
        return batch
    obs = batch.obs._replace(
        **{
            f: bf16_tensor(f32_to_bf16_bits(v))
            for f, v in batch.obs._asdict().items()
            if getattr(v, "dtype", None) == np.float32
        }
    )
    return batch._replace(obs=obs)


class _StagingStopped(Exception):
    """A sharded pack abandoned because stop() landed mid-batch (ring
    acquire or pool wait interrupted); not a frame error."""


class _ShardJob:
    """Countdown latch for one sharded batch: the last of N tasks sets the
    event, so the dispatcher pays one wait."""

    __slots__ = ("event", "errors", "_remaining", "_lock")

    def __init__(self, n: int):
        self.event = threading.Event()
        self.errors: List[BaseException] = []
        self._remaining = n
        self._lock = threading.Lock()

    def done_one(self, error: Optional[BaseException]) -> None:
        with self._lock:
            if error is not None:
                self.errors.append(error)
            self._remaining -= 1
            last = self._remaining == 0
        if last:
            self.event.set()


class _PackPool:
    """`staging.pack_workers` packer threads running row-shard tasks, each
    packing a disjoint row range of one shared buffer. Meters (under one
    lock, touched twice per task): per-worker busy seconds (running a
    shard) and stall seconds (waiting for one)."""

    def __init__(self, workers: int, name: str = "staging-pack"):
        self.n = workers
        self._tasks: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._meters_lock = threading.Lock()
        self._busy_s = [0.0] * workers
        self._stall_s = [0.0] * workers
        self._threads = [threading.Thread(target=self._run, args=(i,), daemon=True, name=f"{name}-{i}")
                         for i in range(workers)]
        for t in self._threads:
            t.start()

    def _run(self, i: int) -> None:
        while True:
            t0 = time.perf_counter()
            try:
                fn, job = self._tasks.get(timeout=0.2)
            except queue.Empty:
                with self._meters_lock:
                    self._stall_s[i] += time.perf_counter() - t0
                if self._stop.is_set():
                    return
                continue
            t1 = time.perf_counter()
            with self._meters_lock:
                self._stall_s[i] += t1 - t0
            error = None
            try:
                fn()
            except BaseException as e:  # re-raised, typed, by the dispatcher
                error = e
            finally:
                with self._meters_lock:
                    self._busy_s[i] += time.perf_counter() - t1
                job.done_one(error)

    def run_tasks(self, thunks, stop: threading.Event):
        """Dispatch the thunks and wait for all. Returns None on success,
        else the most severe error (BatchLayoutError before any other), or
        _StagingStopped when teardown interrupted the batch."""
        job = _ShardJob(len(thunks))
        for fn in thunks:
            self._tasks.put((fn, job))
        while not job.event.wait(timeout=0.2):
            if stop.is_set() and not any(t.is_alive() for t in self._threads):
                return _StagingStopped()
        layout = other = None
        for e in job.errors:
            if isinstance(e, BatchLayoutError):
                layout = layout or e
            else:
                other = other or e
        return layout or other

    def meters(self):
        """(busy_s list, stall_s list), one locked snapshot."""
        with self._meters_lock:
            return list(self._busy_s), list(self._stall_s)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)


class StagingBuffer:
    """Consume → filter → pack pipeline feeding the train loop, into the
    transfer buffers of `fused_io` (the FusedBatchIO the train step was
    built with), or into dense TrainBatches when it is None. Two packing
    paths, identical bytes:
    - native (`cfg.native_packer`, default): frames are header-validated in
      C and kept as raw bytes; a batch (or a row shard of one) packs in one
      C call with the GIL released;
    - Python: full deserialize + per-field numpy copies.

    `tracer` / `recorder` (obs, both optional): per-hop latency of
    trace-stamped frames, and the flight recorder that gets the quarantine
    ring as a dump section and a dump on the fatal layout error. None keeps
    the plain path.
    """

    def __init__(self, cfg: LearnerConfig, broker: Broker, version_fn: Callable[[], int] = lambda: 0, fused_io=None,
                 tracer=None, recorder=None):
        if cfg.staging.pack_workers < 1:
            raise ValueError(f"staging.pack_workers must be >= 1, got {cfg.staging.pack_workers}")
        refuse_unported(cfg)
        self.cfg = cfg
        self.broker = broker
        self.version_fn = version_fn
        self._fused_io = fused_io
        self._tracer = tracer
        self._recorder = recorder
        self._obs_bf16 = cfg.stage_obs_compute_dtype and cfg.policy.dtype == "bfloat16"
        # native path: raw frame bytes; python path: Rollout objects
        self._pending: List = []
        # TraceRef (or None) per pending item; kept only with a tracer
        self._pending_traces: List = []
        # (TrainBatch, transfer payload or None, trace refs or None, ring lease or None)
        self._ready: "queue.Queue" = queue.Queue(maxsize=2)
        # Trace refs and ring lease of the batch a getter returned last
        # (only the learner's fetch pops batches, so these reads are its own).
        self.last_batch_trace = None
        self.last_batch_lease = None
        self._stop = threading.Event()
        # Drain: the consumer stops popping the broker and keeps packing
        # what is pending into full batches. Cleared by start().
        self._quiesce = threading.Event()
        # True while the consumer holds a popped-but-not-yet-queued batch
        # in its locals (set under _mutate_lock with the pop): drained()
        # must see that batch.
        self._packing = False
        # Pool mode: the pop thread's locals hold a drain between its pop
        # and the intake put (the _packing pattern, one station upstream).
        self._popping = False
        # The pipelined learner's prefetch lane holds batches it popped
        # until the loop trains them; drained() asks it last.
        self._prefetch_probe: Optional[Callable[[], bool]] = None
        # Held around the consumer's two mutation sites (ingest, take), and
        # by snapshot_state, so a snapshot is never a half-formed batch.
        self._mutate_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._assembler: Optional[threading.Thread] = None
        self._intake: Optional["queue.Queue"] = None
        self._pool: Optional[_PackPool] = None
        self._ring = None
        # ring slot index -> its native.PackPlan per shard (ring mode, native packer)
        self._slot_plans: Dict[int, List] = {}
        self._fatal: Optional[BaseException] = None
        self._lib = None
        if cfg.native_packer:
            from dotaclient_tpu_torch import native

            self._lib = native.load_packer()
        # Pending items as wire bytes for a snapshot, and back on restore:
        # the native path stages raw frames, the Python path Rollouts.
        if self._lib is not None:
            self._item_encode = self._item_decode = lambda item: item
        else:
            self._item_encode, self._item_decode = serialize_rollout, deserialize_rollout
        # In-network assembly: the shards pack rows in the layout of this
        # spec, taken from fused_io, so a shard whose template disagrees
        # fails the layout_crc check at its first GET_BLOCK, never mid-batch.
        self._assemble_spec: Optional[BlockSpec] = None
        if cfg.staging.assemble:
            self._assemble_spec = self._arm_assembly(broker, fused_io)
        # The replay reservoir: its payloads are pending items (raw frames
        # on the native path, Rollouts on the Python path), so a sampled
        # entry re-enters the same packer.
        self._reservoir = None
        self._replay_target = 0
        if cfg.replay.enabled:
            self._reservoir = self._build_reservoir(fused_io)
        # actor heartbeats: actor_id → monotonic time of its last frame
        # (written only by the consumer thread)
        self._actor_seen: Dict[int, float] = {}
        self.heartbeat_window_s = 60.0
        # Dead-letter ring of poison frames: reason + size + header hex.
        self._quarantine: collections.deque = collections.deque(maxlen=64)
        if recorder is not None:
            recorder.add_section("staging_quarantine", self.quarantine)
        self._stats_lock = threading.Lock()
        # Frames popped off the broker and not yet counted at the intake
        # (_ingest): in a consumer thread's hands, or in the pool mode's
        # intake queue. Raised once per non-empty pop, lowered by _ingest
        # in the same critical section as its counts, and by every path
        # that drops popped frames. A live gauge (stats() "intake_frames"):
        # the fleet audit's delivery ledger reads it beside the fabric's
        # fan-in queue, so frames dropped read as lost.
        self._intake_frames = 0
        self._stats = {
            "consumed": 0,
            "dropped_stale": 0,
            "dropped_bad": 0,
            "quarantined": 0,
            "batches": 0,
            "rows_packed": 0,
            "rows_replayed": 0,
            "episode_return_sum": 0.0,
            "episodes": 0,
            "consumer_errors": 0,
            # serialized bytes entering the intake, and frames by the wire
            # dtype of their float obs
            "wire_bytes": 0,
            "wire_frames_obs_bf16": 0,
            "wire_frames_obs_f32": 0,
        }
        if cfg.staging.pack_workers > 1 or self._assemble_spec is not None:
            # the parallel feed's meters exist only in pool and assembled
            # mode (there pack_wall_s is the concat landing)
            self._stats["pack_wall_s"] = 0.0
            self._stats["pack_ring_wait_s"] = 0.0

    def _arm_assembly(self, broker: Broker, fused_io) -> BlockSpec:
        """Check what assembled intake needs, hand the broker this
        learner's BlockSpec, and make pending rows checkpoint as one-row
        DTB1 blocks. Raises, never falls back to the classic pack."""
        cfg = self.cfg
        if fused_io is None:
            raise ValueError("staging.assemble requires the fused H2D path: the assembled rows are the transfer "
                             "layout (build the learner with fused staging)")
        if cfg.staging.pack_workers > 1:
            raise ValueError("staging.assemble replaces the host pack pool (the learner-side pack is a row "
                             "concat): set staging.pack_workers=1")
        enable = getattr(broker, "enable_assembled_consume", None)
        if enable is None:
            raise ValueError("staging.assemble needs a broker that serves DTB1 blocks (a FabricBroker over "
                             "tcp:// shards running --broker.assemble)")
        spec = BlockSpec(cfg.seq_len, cfg.policy.lstm_hidden, cfg.policy.aux_heads, self._obs_bf16,
                         fused_io.row_bytes, fused_io.layout.layout_crc)
        enable(spec)
        self._item_encode = lambda row: serialize_block(spec, [row])
        self._item_decode = lambda b: deserialize_block(b)[1][0]
        return spec

    def _build_reservoir(self, fused_io):
        cfg = self.cfg
        if fused_io is not None:
            raise ValueError("replay reservoir and fused H2D staging are mutually exclusive: the "
                             "behavior_staleness stamp is not part of the dtype-grouped transfer layout (the "
                             "Learner builds the tree-path train step when replay.enabled)")
        if cfg.replay.max_staleness <= cfg.ppo.max_staleness:
            raise ValueError(f"replay.max_staleness={cfg.replay.max_staleness} must exceed "
                             f"ppo.max_staleness={cfg.ppo.max_staleness}: a smaller window can never retain a "
                             f"frame the fresh filter would drop")
        from dotaclient_tpu_torch.replay import ReplayReservoir

        enc, dec = (None, None) if self._lib is not None else (serialize_rollout, deserialize_rollout)
        reservoir = ReplayReservoir(cfg.replay, encode=enc, decode=dec, seed=cfg.seed)
        # at most B-1: every batch keeps a fresh row, so batch formation
        # always drains the broker and never lives on the reservoir alone
        self._replay_target = min(int(round(cfg.batch_size * cfg.replay.ratio)), cfg.batch_size - 1)
        return reservoir

    @property
    def native(self) -> bool:
        return self._lib is not None

    # -- consumer threads ------------------------------------------------

    def start(self) -> "StagingBuffer":
        """Start the consumer; restartable after stop() (phased drivers
        call run() repeatedly on one learner). Pool mode builds a fresh
        intake, pool and ring each time: a finished loop may still hold a
        lease on an old slot."""
        self._stop.clear()
        self._quiesce.clear()
        workers = self.cfg.staging.pack_workers
        if workers > 1:
            self._intake = queue.Queue(maxsize=4)
            self._pool = _PackPool(workers)
            if self._fused_io is not None:
                self._ring = self._fused_io.make_ring(self.cfg.staging.transfer_depth)
                self._slot_plans = {}  # plans point into the OLD ring's buffers
            self._assembler = threading.Thread(target=self._run_assembler, daemon=True, name="staging-assembler")
            self._assembler.start()
            self._thread = threading.Thread(target=self._run_pop, daemon=True, name="staging-consumer")
        else:
            if self._assemble_spec is not None:
                # assembled rows land in ring slots on the one consumer too
                self._ring = self._fused_io.make_ring(self.cfg.staging.transfer_depth)
            self._thread = threading.Thread(target=self._run, daemon=True, name="staging-consumer")
        self._thread.start()
        return self

    def _die_on_layout(self, e: BaseException) -> None:
        """A builder/staging config disagreement fails every batch: the
        consumer dies loudly and the getters re-raise."""
        _log.critical("staging layout/config mismatch; consumer dying: %s", e)
        if self._recorder is not None:
            self._recorder.record("batch_layout_error", error=str(e))
            self._recorder.dump("batch_layout_error")
        self._fatal = e
        self._stop.set()

    def _drain_residual(self, max_items: int, sink) -> None:
        """The quiesced consumer's step (classic and pool mode): fetch the
        fabric fan-in's residual (frames already popped off the shards) and
        hand it to `sink`, pacing the loop when there is none. `_popping`
        covers only the non-blocking fetch and the sink, so drained() sees
        frames held in this thread's locals, and not the pacing sleep (or
        drained() would read not-drained nearly always)."""
        with self._mutate_lock:
            self._popping = True
        try:
            frames = self._residual_frames(max_items)
            if frames:
                sink(frames)
        finally:
            with self._mutate_lock:
                self._popping = False
        if frames is None:
            time.sleep(0.02)

    def _run(self) -> None:
        """The classic consumer (pack_workers=1): pop, parse and pack here."""
        B = self.cfg.batch_size

        def _ingest_sink(frames):
            self._hold(len(frames))
            self._ingest_held(frames)

        while not self._stop.is_set():
            try:
                if self._quiesce.is_set():
                    # draining: no new broker pops; ingest the fabric's
                    # residual and pack what is pending
                    self._drain_residual(B, _ingest_sink)
                    frames = None
                else:
                    frames = self._pop(B)
                if frames:
                    self._ingest_held(frames)
                self._pack_pending_loop(B)
            except BatchLayoutError as e:
                self._die_on_layout(e)
                return
            except Exception:
                # The consumer must never die silently: a dead consumer
                # hangs the learner in get_batch.
                _log.exception("staging consumer error; continuing")
                with self._stats_lock:
                    self._stats["consumer_errors"] += 1

    def _run_pop(self) -> None:
        """Pool mode: drain the broker into the intake queue and nothing
        else. The intake bound (4 drains) keeps an outrun learner from
        buffering the broker in its own memory."""
        B = self.cfg.batch_size

        def _intake_sink(frames):
            self._hold(len(frames))
            self._put_intake(frames)

        while not self._stop.is_set():
            try:
                if self._quiesce.is_set():
                    # the fabric's residual flows on to the intake as usual
                    self._drain_residual(B, _intake_sink)
                    continue
                with self._mutate_lock:
                    self._popping = True
                try:
                    self._put_intake(self._pop(B))
                finally:
                    with self._mutate_lock:
                        self._popping = False
            except Exception:
                _log.exception("staging pop error; continuing")
                with self._stats_lock:
                    self._stats["consumer_errors"] += 1

    def _run_assembler(self) -> None:
        """Pool mode: the single owner of the pending list, heartbeats and
        quarantine (the consumer's role less the broker pop). Parses each
        intake drain, forms batches and hands row shards to the pool."""
        B = self.cfg.batch_size
        while not self._stop.is_set():
            try:
                try:
                    frames = self._intake.get(timeout=0.2)
                except queue.Empty:
                    frames = None
                if frames is not None:
                    try:
                        self._ingest_held(frames)
                    finally:
                        # unfinished_tasks reaches 0 only once the frames
                        # are visible in _pending (drained() reads it)
                        self._intake.task_done()
                self._pack_pending_loop(B)
            except BatchLayoutError as e:
                self._die_on_layout(e)
                return
            except Exception:
                _log.exception("staging assembler error; continuing")
                with self._stats_lock:
                    self._stats["consumer_errors"] += 1

    def _pack_pending_loop(self, B: int) -> None:
        """Pack as many full batches as _pending affords into the ready
        queue, on the thread that owns _pending."""
        while not self._stop.is_set():
            with self._mutate_lock:
                # in the same hold as the take: between here and the ready
                # put the batch lives only in this thread's locals
                items, staleness, traces = self._next_batch_items(B)
                self._packing = items is not None
            if items is None:
                break
            t_pack = time.perf_counter()
            try:
                batch, buf, lease = self._pack(items)
            except BatchLayoutError:
                raise
            except _StagingStopped:
                self._packing = False
                break
            except ValueError:
                # a frame passed ingest validation but failed the packer:
                # drop the batch, never livelock on it
                _log.exception("packer rejected a batch; dropping %d frames", len(items))
                with self._stats_lock:
                    self._stats["dropped_bad"] += len(items)
                self._packing = False
                continue
            if staleness is not None:
                batch = batch._replace(behavior_staleness=np.asarray(staleness, np.float32))
            if self._tracer is not None:
                self._tracer.hop_batch("pack", traces)
            with self._stats_lock:
                self._stats["batches"] += 1
                self._stats["rows_packed"] += len(items)
                if "pack_wall_s" in self._stats:
                    self._stats["pack_wall_s"] += time.perf_counter() - t_pack
                if staleness is not None:
                    self._stats["rows_replayed"] += sum(1 for x in staleness if x > 0)
            while not self._stop.is_set():
                try:
                    self._ready.put((batch, buf, traces, lease), timeout=0.2)
                    break
                except queue.Full:
                    continue
            self._packing = False  # visible in _ready (or dead with _stop)

    def _take_pending(self, n: int):
        """(the first n pending items, their trace refs or None)."""
        items = self._pending[:n]
        del self._pending[:n]
        traces = None
        if self._tracer is not None:
            traces = self._pending_traces[:n]
            del self._pending_traces[:n]
        return items, traces

    def _next_batch_items(self, B: int):
        """(items, staleness list or None, trace refs or None) for one
        batch, or (None, None, None) while too little is pending. With
        replay, up to `replay.ratio` of the batch comes from the reservoir
        (never waited for: a short reservoir means more fresh rows), and
        every row is stamped with its behavior-policy staleness (fresh
        rows 0)."""
        if self._reservoir is None:
            if len(self._pending) < B:
                return None, None, None
            items, traces = self._take_pending(B)
            return items, None, traces
        now_v = self.version_fn()
        self._reservoir.expire(now_v)
        k = min(self._replay_target, self._reservoir.occupancy)
        if len(self._pending) < B - k:
            return None, None, None
        items, traces = self._take_pending(B - k)
        staleness = [0.0] * len(items)
        for payload, version, meta in self._reservoir.sample(k, now_v):
            items.append(payload)
            staleness.append(float(max(now_v - version, 0)))
            if self._tracer is not None:
                ref = None
                if meta is not None:
                    # a fresh copy per re-emit: one resident entry can sit
                    # in several batches the learner hops concurrently
                    ref = TraceRef(meta.trace_id, meta.birth, last_t=meta.last_t)
                    self._tracer.hop("replay_reemit", ref)
                traces.append(ref)
        return items, staleness, traces

    def _acquire_slot(self):
        """The next free ring slot (blocks: every slot out is the ring's
        backpressure); _StagingStopped once stop() lands."""
        t0 = time.perf_counter()
        slot = None
        while slot is None:
            if self._stop.is_set():
                raise _StagingStopped()
            slot = self._ring.acquire(timeout=0.2)
        with self._stats_lock:
            self._stats["pack_ring_wait_s"] += time.perf_counter() - t0
        return slot

    def _pack(self, items: List):
        """(TrainBatch, payload, lease): the items packed into the views of
        fresh pinned transfer buffers (lease None), row-sharded over the
        pool into a ring slot (the lease the learner releases once the
        slot's copy has completed), landed as assembled rows in a ring
        slot, or, without fused_io, into a dense TrainBatch (payload
        None)."""
        if self._assemble_spec is not None:
            return self._pack_assembled(items)
        if self._pool is not None:
            return self._pack_sharded(items)
        if self._fused_io is None:
            out = self._dense_out(len(items))
            self._pack_rows(out, items)
            return self._dense_finish(out), None, None
        buf, out = self._fused_io.alloc_transfer()
        self._pack_rows(out, items)
        return out, buf, None

    def _pack_rows(self, out: TrainBatch, items: List, row_offset: int = 0, total_rows: Optional[int] = None) -> None:
        """Pack `items` into rows [row_offset, row_offset + len(items)) of
        the pre-zeroed `out`: one native call, or fill_rollouts."""
        if self._lib is not None:
            from dotaclient_tpu_torch import native

            p = self.cfg.policy
            native.pack_frames(self._lib, items, self.cfg.seq_len, p.lstm_hidden, p.aux_heads, self._obs_bf16, out,
                               row_offset=row_offset, total_rows=total_rows)
        else:
            fill_rollouts(out, items, self.cfg.seq_len, row_offset=row_offset)

    def _dense_out(self, B: int) -> TrainBatch:
        """A zeroed dense batch for the tree path; the native packer casts
        obs to bf16 in its copy, so its float obs leaves are uint16 words."""
        p = self.cfg.policy
        out = zeros_train_batch(B, self.cfg.seq_len, p.lstm_hidden, p.aux_heads)
        if self._lib is not None and self._obs_bf16:
            out = out._replace(obs=out.obs._replace(**{
                f: np.zeros(v.shape, np.uint16) for f, v in out.obs._asdict().items() if v.dtype == np.float32
            }))
        return out

    def _dense_finish(self, out: TrainBatch) -> TrainBatch:
        """The packed dense batch with obs in the compute dtype: uint16 words
        as bf16 tensors (native), or cast_obs_to_compute_dtype (Python);
        bitwise the same either way."""
        if self._lib is not None and self._obs_bf16:
            return out._replace(obs=out.obs._replace(**{
                f: bf16_tensor(v) for f, v in out.obs._asdict().items() if v.dtype == np.uint16
            }))
        return cast_obs_to_compute_dtype(self.cfg, out)

    def _pack_sharded(self, items: List):
        """N workers each fill a disjoint contiguous row range of one
        re-zeroed ring slot (or, without fused_io, of one fresh dense
        batch); any split is bitwise the single-call pack. A ring slot
        lives as long as the ring, so with the native packer each (slot,
        shard) keeps one native.PackPlan, and a batch pays one marshal of
        its frame pointers before the workers' C calls."""
        B = len(items)
        if self._fused_io is None:
            out, slot = self._dense_out(B), None
        else:
            slot = self._acquire_slot()
            out = slot.batch
        if slot is not None and self._lib is not None:
            from dotaclient_tpu_torch import native

            plans = self._slot_plans.get(slot.index)
            if plans is None:
                p = self.cfg.policy
                plans = self._slot_plans[slot.index] = [
                    native.PackPlan(self._lib, out, cnt, self.cfg.seq_len, p.lstm_hidden, p.aux_heads, self._obs_bf16,
                                    off, B)
                    for off, cnt in shard_rows(B, self._pool.n)]
            # one marshal of the batch's frame pointers here; each worker's
            # share of the GIL is then its ctypes call alone
            ptrs, lens = native.marshal_frames(items)
            thunks = [(lambda p=p: p.pack_rows(ptrs, lens)) for p in plans]
        else:
            thunks = [(lambda o=off, c=cnt: self._pack_rows(out, items[o : o + c], row_offset=o, total_rows=B))
                      for off, cnt in shard_rows(B, self._pool.n)]
        err = self._pool.run_tasks(thunks, self._stop)
        if err is not None:
            if slot is not None:
                slot.release()  # nothing downstream will release a failed batch's slot
            raise err
        if slot is None:
            return self._dense_finish(out), None, None
        return out, slot.payload, slot

    def _pack_assembled(self, items: List):
        """Assembled intake: every item is an AssembledRow whose payload
        already holds the RowLayout bytes, so a batch is a ring-slot
        acquire, one concat of the rows and one bulk copy (one per dtype
        group in group mode): no parse, scatter or cast. Bitwise the
        classic pack of the same frames, since the shard ran the same row
        encoder over the same bytes."""
        slot = self._acquire_slot()
        n = len(items)
        raw = np.frombuffer(b"".join(row.payload for row in items), np.uint8).reshape(n, self._fused_io.row_bytes)
        payload = slot.payload
        if isinstance(payload, dict):
            # group mode: each group is a column range of the stacked rows
            for key, t in payload.items():
                u8 = t.view(torch.uint8).numpy()
                off = self._fused_io.layout.seg_off[key]
                u8[:n] = raw[:, off : off + u8.shape[1]]
        else:
            payload.numpy()[:n] = raw
        return slot.batch, payload, slot

    def _parse(self, frame: bytes):
        """Python-path parse → ((Rollout, version, L, H, actor_id,
        ep_return, last_done), None), or (None, reason) if malformed:
        "dtype_map" for a bad DTR3 dtype-map, "parse" otherwise."""
        try:
            r = deserialize_rollout(frame)
        except WireDtypeError:
            return None, "dtype_map"
        except (ValueError, KeyError):
            return None, "parse"
        last_done = float(r.dones[-1]) if r.length else 0.0
        return (r, r.version, r.length, r.initial_state[0].shape[-1], r.actor_id, r.episode_return, last_done), None

    def _quarantine_put(self, frame: bytes, reason: str) -> None:
        """Consumer-thread only: bounded evidence of one poison frame."""
        self._quarantine.append({"t": time.time(), "reason": reason, "bytes": len(frame), "head": bytes(frame[:64]).hex()})

    def quarantine(self) -> List[dict]:
        """Snapshot of the dead-letter ring (newest last)."""
        # graftlint: disable=THR001(one GIL-atomic deque-snapshot copy; appends live in _quarantine_put on the sole consumer thread)
        return list(self._quarantine)

    def _offer_replay(self, item, frame: bytes, version: int, current_version: int, ref=None) -> bool:
        """Admit one would-be-stale item into the reservoir, keyed by the
        |TD-error| of its actor-stamped values (the native path pays a
        deserialize here, only for frames that were waste before). `ref`
        rides the entry, so a re-emit continues the trace."""
        try:
            rollout = item if isinstance(item, Rollout) else deserialize_rollout(frame)
        except (ValueError, KeyError):
            return False
        from dotaclient_tpu_torch.replay import td_error_priority

        priority = td_error_priority(rollout.rewards, rollout.behavior_value, rollout.dones, self.cfg.ppo.gamma)
        admitted = self._reservoir.offer(item, version, priority, len(frame), current_version, meta=ref)
        if admitted and ref is not None and self._tracer is not None:
            self._tracer.hop("replay_admit", ref)
        return admitted

    def _ingest_assembled(self, rows: List[AssembledRow]) -> None:
        """_ingest for assembled intake: the rows were parsed, layout-checked
        (layout_crc) and fence-checked upstream, so admission is sidecar
        bookkeeping (staleness on the shard-stamped version, episodes from
        last_done, trace hops, heartbeats). A payload of the wrong length
        is quarantined under "layout"."""
        version_now = self.version_fn()
        min_version = version_now - self.cfg.ppo.max_staleness
        spec = self._assemble_spec
        consumed = len(rows)
        dropped_stale = dropped_bad = quarantined = episodes = 0
        ep_ret = 0.0
        now = time.monotonic()
        tr = self._tracer
        wire_bytes = wire_bf16 = wire_f32 = 0
        for row in rows:
            wire_bytes += len(row.payload)
            if len(row.payload) != spec.row_bytes:
                dropped_bad += 1
                quarantined += 1
                self._quarantine_put(row.payload, "layout")
                continue
            # the obs wire dtype is the block's negotiated layout
            if spec.obs_bf16:
                wire_bf16 += 1
            else:
                wire_f32 += 1
            self._actor_seen[row.actor_id] = now
            if len(self._actor_seen) > 4096:
                cutoff = now - self.heartbeat_window_s
                self._actor_seen = {a: t for a, t in self._actor_seen.items() if t >= cutoff}
            ref = None
            if tr is not None and (row.trace_id or row.birth_time):
                ref = TraceRef(row.trace_id, row.birth_time)
                tr.hop("consume", ref)  # from birth: serialize + shard assembly + block wire
            if row.version < min_version:
                dropped_stale += 1
                continue
            if row.last_done:
                episodes += 1
                ep_ret += row.episode_return
            self._pending.append(row)
            if tr is not None:
                if ref is not None:
                    tr.hop("staging_admit", ref)
                self._pending_traces.append(ref)
        self._count_ingest(consumed, dropped_stale, dropped_bad, quarantined, episodes, ep_ret, wire_bytes,
                           wire_bf16, wire_f32)

    def _count_ingest(self, consumed, dropped_stale, dropped_bad, quarantined, episodes, ep_ret, wire_bytes,
                      wire_bf16, wire_f32) -> None:
        with self._stats_lock:
            self._stats["consumed"] += consumed
            self._stats["dropped_stale"] += dropped_stale
            self._stats["dropped_bad"] += dropped_bad
            self._stats["quarantined"] += quarantined
            self._stats["episodes"] += episodes
            self._stats["episode_return_sum"] += ep_ret
            self._stats["wire_bytes"] += wire_bytes
            self._stats["wire_frames_obs_bf16"] += wire_bf16
            self._stats["wire_frames_obs_f32"] += wire_f32
            self._intake_frames -= consumed

    def _ingest(self, frames: List[bytes]) -> None:
        if self._assemble_spec is not None:
            return self._ingest_assembled(frames)
        version_now = self.version_fn()
        min_version = version_now - self.cfg.ppo.max_staleness
        H = self.cfg.policy.lstm_hidden
        consumed = len(frames)
        dropped_stale = dropped_bad = quarantined = episodes = 0
        ep_ret = 0.0
        now = time.monotonic()
        tr = self._tracer
        wire_bytes = sum(len(f) for f in frames)
        wire_bf16 = wire_f32 = 0
        bad_maps: Dict[int, bytes] = {}
        frame_traces: Optional[List] = None
        if self._lib is not None:
            from dotaclient_tpu_torch import native

            # The C packer speaks DTR1 and DTR3: traced DTR2 frames are
            # normalized to the byte-identical DTR1 here (their trace read
            # first when tracing); a DTR3 frame's dtype-map is pre-checked
            # so a bad one is quarantined under its own reason (its emptied
            # slot fails the native parse).
            for i, f in enumerate(frames):
                pfx = f[:4]
                if pfx not in (b"DTR2", b"DTR3"):
                    continue
                if pfx == b"DTR3" and check_dtr3_dtype_map(f) is not None:
                    bad_maps[i] = f
                    frames[i] = b""
                    continue
                if tr is not None:
                    tid, birth = peek_rollout_trace(f)
                    if tid or birth:
                        if frame_traces is None:
                            frame_traces = [None] * consumed
                        frame_traces[i] = TraceRef(tid, birth)
                if pfx == b"DTR2":
                    frames[i] = strip_rollout_trace(f)
            h = native.frame_headers(self._lib, frames)
            parsed_iter = (
                (
                    (frames[i], h.versions[i], h.Ls[i], h.Hs[i], h.actor_ids[i], h.ep_returns[i], h.last_dones[i])
                    if h.ok[i]
                    else None,
                    "dtype_map" if i in bad_maps else "parse",
                )
                for i in range(consumed)
            )
        else:
            parsed_iter = (self._parse(f) for f in frames)
        for i, (parsed, bad_reason) in enumerate(parsed_iter):
            if parsed is None:
                dropped_bad += 1
                quarantined += 1
                self._quarantine_put(bad_maps.get(i, frames[i]), bad_reason)
                continue
            item, version, L, frame_h, actor_id, frame_ret, last_done = parsed
            if rollout_obs_bf16(item) if isinstance(item, Rollout) else wire_obs_is_bf16(item):
                wire_bf16 += 1
            else:
                wire_f32 += 1
            self._actor_seen[actor_id] = now
            if len(self._actor_seen) > 4096:
                cutoff = now - self.heartbeat_window_s
                self._actor_seen = {a: t for a, t in self._actor_seen.items() if t >= cutoff}
            # per-frame config validation: one misconfigured actor costs
            # only its own frames, never the pack step
            if L > self.cfg.seq_len or frame_h != H:
                dropped_bad += 1
                quarantined += 1
                self._quarantine_put(frames[i], "layout")
                continue
            ref = None
            if tr is not None:
                if frame_traces is not None:
                    ref = frame_traces[i]
                elif isinstance(item, Rollout) and item.traced:
                    ref = TraceRef(item.trace_id, item.birth_time)
                if ref is not None:
                    tr.hop("consume", ref)  # from birth: serialize + broker + wire
            if version < min_version:
                # with replay, a frame within replay.max_staleness goes to
                # the reservoir; one past it is a stale drop all the same
                if self._reservoir is not None and self._offer_replay(item, frames[i], version, version_now, ref=ref):
                    continue
                dropped_stale += 1
                continue
            if L and last_done > 0:
                episodes += 1
                ep_ret += frame_ret
            self._pending.append(item)
            if tr is not None:
                if ref is not None:
                    tr.hop("staging_admit", ref)
                self._pending_traces.append(ref)
        self._count_ingest(consumed, dropped_stale, dropped_bad, quarantined, episodes, ep_ret, wire_bytes,
                           wire_bf16, wire_f32)

    # -- learner side ----------------------------------------------------

    def _check_fatal(self) -> None:
        fatal = self._fatal
        if fatal is not None:
            raise RuntimeError(
                "staging consumer died on a layout/config mismatch — every batch would fail; "
                "fix the builder/staging config disagreement"
            ) from fatal

    def _get_ready(self, timeout: Optional[float], cancel=None):
        """queue.get in 0.2 s slices, re-checking a consumer death, the
        `cancel` event (the prefetch lane's teardown) and a finished drain
        between them; raises queue.Empty on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            self._check_fatal()
            if cancel is not None and cancel.is_set():
                raise queue.Empty
            if self._quiesce.is_set() and self.drained(include_prefetch=False):
                raise queue.Empty
            step = 0.2 if deadline is None else min(0.2, deadline - time.monotonic())
            if step <= 0:
                raise queue.Empty
            try:
                return self._ready.get(timeout=step)
            except queue.Empty:
                continue

    def get_batch(self, timeout: Optional[float] = None, cancel=None) -> Optional[TrainBatch]:
        """One packed batch (views of its transfer buffers, or a dense
        batch without fused_io), or None on timeout (the lease contract of
        get_batch_groups holds)."""
        return self.get_batch_groups(timeout, cancel)[0]

    def get_batch_groups(self, timeout: Optional[float] = None, cancel=None):
        """(TrainBatch, payload): the packed batch and the pinned transfer
        payload its leaves view (the [B, row_bytes] u8 buffer or the group
        dict; None for a dense batch), ready to ship; (None, None) on
        timeout. `last_batch_trace` is set to the batch's trace refs and
        `last_batch_lease` to its ring slot (None where every batch has its
        own fresh buffers). The caller releases a lease only once the
        payload's copy has completed; holding leases is the ring's
        backpressure."""
        try:
            batch, buf, traces, lease = self._get_ready(timeout, cancel=cancel)
        except queue.Empty:
            self.last_batch_trace = self.last_batch_lease = None
            return None, None
        self.last_batch_trace, self.last_batch_lease = traces, lease
        return batch, buf

    # -- checkpoint / drain support ---------------------------------------

    def snapshot_state(self, timeout: float = 10.0) -> Optional[dict]:
        """A consistent image of the host state for the full-state aux
        manifest: the pending (popped, not yet packed) items as wire bytes
        (one-row DTB1 blocks in assembled mode), in order, and the
        reservoir's snapshot. The mutate lock excludes the consumer's
        mutation sites, so the cut is never a half-formed batch (the take
        and the reservoir sample share one hold). None when the lock is not
        had within `timeout` (the checkpoint then goes state-only). Pool
        mode: frames in the intake queue are not in the cut (at most 4
        drains); a SIGTERM drain trains them out before its final save."""
        if not self._mutate_lock.acquire(timeout=timeout):
            return None
        try:
            # graftlint: disable=THR001(held under _mutate_lock, the lock the consumer holds around its two mutation call sites)
            snap: dict = {"pending": [bytes(self._item_encode(it)) for it in self._pending]}
            if self._reservoir is not None:
                snap["reservoir"] = self._reservoir.snapshot()
            return snap
        finally:
            self._mutate_lock.release()

    def restore_state(self, snap: dict) -> Dict[str, int]:
        """Before start() only: re-inject checkpointed pending items ahead
        of anything the broker will deliver, so batches form in the
        pre-kill order, and rebuild the reservoir (its entries and its
        sampling stream). Returns counts for the resume_* scalars
        ("reservoir" with replay on)."""
        restored = [self._item_decode(b) for b in snap.get("pending", [])]
        self._pending = restored
        if self._tracer is not None:
            self._pending_traces = [None] * len(restored)  # trace refs are process-local
        counts = {"pending": len(restored)}
        if self._reservoir is not None:
            counts["reservoir"] = self._reservoir.restore(snap["reservoir"]) if "reservoir" in snap else 0
        return counts

    def _residual_frames(self, max_items: int):
        """Frames a fabric broker's pop threads took off the shards before
        the quiesce (FabricBroker.consume_residual): popped frames, so the
        drain ingests them. None on a broker without that station."""
        residual = getattr(self.broker, "consume_residual", None)
        if residual is None:
            return None
        return residual(max_items) or None

    def quiesce(self) -> None:
        """Stop popping the broker; keep packing already-pending frames. A
        fabric broker quiesces with it (its pop threads stop taking new
        frames off the shards) and its residual drains through
        _residual_frames."""
        broker_quiesce = getattr(self.broker, "quiesce", None)
        if broker_quiesce is not None:
            broker_quiesce()
        self._quiesce.set()

    def attach_prefetch_probe(self, probe: Callable[[], bool]) -> None:
        """Register the pipelined learner's lane station: a callable that
        is True while the lane holds popped-but-untrained batches."""
        self._prefetch_probe = probe

    def drained(self, include_prefetch: bool = True) -> bool:
        """True once a quiesced buffer can produce no further batch: no
        drain held by the pop thread or the intake queue, no batch mid-pack,
        fewer than B frames pending, the ready queue empty, and (by
        default) the prefetch lane holding nothing. Stations are checked
        upstream first, the direction frames move; a fabric broker's fan-in
        (frames popped off the shards, not yet ingested) is the first."""
        if not self._quiesce.is_set():
            return False
        fanin_residual = getattr(self.broker, "fanin_residual", None)
        if fanin_residual is not None and fanin_residual():
            return False
        with self._mutate_lock:
            if self._popping:
                return False
        if self._intake is not None and self._intake.unfinished_tasks:
            return False
        with self._mutate_lock:
            if self._packing:
                return False
            need = self.cfg.batch_size
            if self._reservoir is not None:
                need -= min(self._replay_target, self._reservoir.occupancy)
            # graftlint: disable=THR001(read under _mutate_lock; the consumer's mutation call sites (_ingest/_next_batch_items in _run) hold the same lock, lexically outside the helpers)
            if len(self._pending) >= need:
                return False
        if not self._ready.empty():
            return False
        if include_prefetch:
            probe = self._prefetch_probe
            if probe is not None and probe():
                return False
        return True

    def _hold(self, n: int) -> None:
        with self._stats_lock:
            self._intake_frames += n

    def _pop(self, max_items: int) -> List[bytes]:
        """One broker pop; its frames count in the intake gauge until
        _ingest counts them or a stop drops them."""
        frames = self.broker.consume_experience(max_items=max_items, timeout=0.2)
        if frames:
            self._hold(len(frames))
        return frames

    def _ingest_held(self, frames: List[bytes]) -> None:
        """_ingest frames the intake gauge holds: _ingest lowers it as it
        counts them; frames an error loses leave it here."""
        try:
            with self._mutate_lock:
                self._ingest(frames)
        except BaseException:
            self._hold(-len(frames))
            raise

    def _put_intake(self, frames: List[bytes]) -> None:
        """Pool mode: hand held frames to the assembler. A drain the stop
        catches here is dropped, and leaves the gauge."""
        while frames and not self._stop.is_set():
            try:
                self._intake.put(frames, timeout=0.2)
                return
            except queue.Full:
                continue
        if frames:
            self._hold(-len(frames))

    def _drop_intake(self) -> None:
        """After both pool threads have stopped: the drains the assembler
        never took are dropped (start() builds a fresh intake), and leave
        the gauge."""
        while True:
            try:
                frames = self._intake.get_nowait()
            except queue.Empty:
                return
            self._hold(-len(frames))
            self._intake.task_done()

    def stats(self) -> Dict[str, float]:
        with self._stats_lock:
            out = dict(self._stats)
            out["intake_frames"] = self._intake_frames
        out["ready_batches"] = self._ready.qsize()
        # graftlint: disable=THR001(one GIL-atomic len read; a gauge that may drift by one in-flight frame)
        out["pending_rollouts"] = len(self._pending)
        cutoff = time.monotonic() - self.heartbeat_window_s
        # graftlint: disable=THR001(one GIL-atomic dict-copy snapshot; pruning lives in _ingest on the sole writer thread)
        seen = dict(self._actor_seen)
        out["active_actors"] = sum(1 for t in seen.values() if t >= cutoff)
        if self._reservoir is not None:
            for k, v in self._reservoir.stats().items():
                out[f"replay_{k}"] = v
            # the share of packed rows served from the reservoir
            out["replay_hit_ratio"] = out["rows_replayed"] / max(out["rows_packed"], 1)
        if self._ring is not None:
            out["pack_ring_depth"] = float(self._ring.depth)
            out["pack_ring_occupancy"] = float(self._ring.occupancy)
        if self._pool is not None:
            # the parallel feed's scoreboard (staging_pack_* once the
            # learner logs them)
            busy, stall = self._pool.meters()
            out["pack_workers"] = float(self._pool.n)
            for i in range(self._pool.n):
                out[f"pack_worker_busy_s_{i}"] = round(busy[i], 4)
                out[f"pack_worker_stall_s_{i}"] = round(stall[i], 4)
            out["pack_rows_per_s"] = out["rows_packed"] / max(out["pack_wall_s"], 1e-9)
        return out

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        if self._assembler is not None:
            self._assembler.join(timeout=5)
            if not (self._assembler.is_alive() or self._thread.is_alive()):
                self._drop_intake()
            self._assembler = None
        if self._pool is not None:
            self._pool.stop()
