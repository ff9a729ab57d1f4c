"""Host-side staging buffer: broker frames → packed transfer buffers (torch
twin of dotaclient_tpu/runtime/staging.py, classic single-consumer path).

- One consumer thread drains the broker and parses frames: the native
  packer's batched header parse (`native_packer`, the default) or a full
  Python deserialize.
- Rollouts older than `ppo.max_staleness` learner versions are dropped
  here, before they cost device time.
- Frames that fail parse or the per-frame layout check are dropped and
  filed, with evidence, in a bounded quarantine ring.
- Each batch of B rollouts is packed straight into the views of a fresh
  pinned [B, row_bytes] u8 buffer (parallel/fused_io.py), so the learner
  ships it in one host-to-device copy; a bounded ready queue (depth 2)
  lets packing overlap the device step.
- Only the consumer thread touches the pending list; only the learner's
  getters pop ready batches.

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

from dotaclient_tpu_torch.config import LearnerConfig, refuse_unported
from dotaclient_tpu_torch.ops.batch import BatchLayoutError, TrainBatch, zeros_train_batch
from dotaclient_tpu_torch.transport.base import Broker
from dotaclient_tpu_torch.transport.serialize import (
    Rollout,
    WireDtypeError,
    bf16_bits,
    bf16_bits_to_f32,
    bf16_tensor,
    check_dtr3_dtype_map,
    deserialize_rollout,
    f32_to_bf16_bits,
    is_bf16,
    rollout_obs_bf16,
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


class StagingBuffer:
    """Consume → filter → pack pipeline feeding the train loop, into the
    single transfer buffer of `fused_io` (the FusedBatchIO the train step
    was built with). Two packing paths, identical bytes:
    - native (`cfg.native_packer`, default): frames are header-validated in
      C and kept as raw bytes; a whole batch packs in one C call with the
      GIL released;
    - Python: full deserialize + per-field numpy copies.
    """

    def __init__(self, cfg: LearnerConfig, broker: Broker, version_fn: Callable[[], int] = lambda: 0, fused_io=None):
        if fused_io is None:
            raise ValueError(
                "the port stages into the single transfer buffer only: pass the FusedBatchIO from "
                "build_single_train_step (a dense TrainBatch path is ROADMAP A.10b)"
            )
        if cfg.staging.pack_workers < 1:
            raise ValueError(f"staging.pack_workers must be >= 1, got {cfg.staging.pack_workers}")
        refuse_unported(cfg)
        self.cfg = cfg
        self.broker = broker
        self.version_fn = version_fn
        self._fused_io = fused_io
        self._obs_bf16 = cfg.stage_obs_compute_dtype and cfg.policy.dtype == "bfloat16"
        # native path: raw frame bytes; python path: Rollout objects
        self._pending: List = []
        self._ready: "queue.Queue" = queue.Queue(maxsize=2)  # (TrainBatch views, buf)
        self._stop = threading.Event()
        # Drain: the consumer stops popping the broker and keeps packing
        # what is pending into full batches. Cleared by start().
        self._quiesce = threading.Event()
        # True while the consumer holds a popped-but-not-yet-queued batch
        # in its locals (set under _mutate_lock with the pop): drained()
        # must see that batch.
        self._packing = False
        # The pipelined learner's prefetch lane holds batches it popped
        # until the loop trains them; drained() asks it last.
        self._prefetch_probe: Optional[Callable[[], bool]] = None
        self._mutate_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._fatal: Optional[BaseException] = None
        self._lib = None
        if cfg.native_packer:
            from dotaclient_tpu_torch import native

            self._lib = native.load_packer()
        # actor heartbeats: actor_id → monotonic time of its last frame
        # (written only by the consumer thread)
        self._actor_seen: Dict[int, float] = {}
        self.heartbeat_window_s = 60.0
        # Dead-letter ring of poison frames: reason + size + header hex.
        self._quarantine: collections.deque = collections.deque(maxlen=64)
        self._stats_lock = threading.Lock()
        self._stats = {
            "consumed": 0,
            "dropped_stale": 0,
            "dropped_bad": 0,
            "quarantined": 0,
            "batches": 0,
            "rows_packed": 0,
            "episode_return_sum": 0.0,
            "episodes": 0,
            "consumer_errors": 0,
            # serialized bytes entering the intake, and frames by the wire
            # dtype of their float obs
            "wire_bytes": 0,
            "wire_frames_obs_bf16": 0,
            "wire_frames_obs_f32": 0,
        }

    @property
    def native(self) -> bool:
        return self._lib is not None

    # -- consumer thread -------------------------------------------------

    def start(self) -> "StagingBuffer":
        """Start the consumer; restartable after stop() (phased drivers
        call run() repeatedly on one learner)."""
        self._stop.clear()
        self._quiesce.clear()
        self._thread = threading.Thread(target=self._run, daemon=True, name="staging-consumer")
        self._thread.start()
        return self

    def _run(self) -> None:
        B = self.cfg.batch_size
        while not self._stop.is_set():
            try:
                if self._quiesce.is_set():
                    frames = None  # draining: no new broker pops, pack what is pending
                    time.sleep(0.02)
                else:
                    frames = self.broker.consume_experience(max_items=B, timeout=0.2)
                if frames:
                    with self._mutate_lock:
                        self._ingest(frames)
                self._pack_pending_loop(B)
            except BatchLayoutError as e:
                _log.critical("staging layout/config mismatch; consumer dying: %s", e)
                self._fatal = e
                self._stop.set()
                return
            except Exception:
                # The consumer must never die silently: a dead consumer
                # hangs the learner in get_batch.
                _log.exception("staging consumer error; continuing")
                with self._stats_lock:
                    self._stats["consumer_errors"] += 1

    def _pack_pending_loop(self, B: int) -> None:
        """Pack as many full batches as _pending affords into the ready
        queue."""
        while not self._stop.is_set():
            with self._mutate_lock:
                items = self._take_pending(B) if len(self._pending) >= B else None
                self._packing = items is not None
            if items is None:
                break
            try:
                batch, buf = self._pack(items)
            except BatchLayoutError:
                raise
            except ValueError:
                # a frame passed ingest validation but failed the packer:
                # drop the batch, never livelock on it
                _log.exception("packer rejected a batch; dropping %d frames", len(items))
                with self._stats_lock:
                    self._stats["dropped_bad"] += len(items)
                self._packing = False
                continue
            with self._stats_lock:
                self._stats["batches"] += 1
                self._stats["rows_packed"] += len(items)
            while not self._stop.is_set():
                try:
                    self._ready.put((batch, buf), timeout=0.2)
                    break
                except queue.Full:
                    continue
            self._packing = False  # visible in _ready (or dead with _stop)

    def _take_pending(self, n: int) -> List:
        items = self._pending[:n]
        del self._pending[:n]
        return items

    def _pack(self, items: List):
        """(TrainBatch of views, buf): the items packed into a fresh pinned
        transfer buffer; the views write straight into it."""
        buf, out = self._fused_io.alloc_transfer()
        if self._lib is not None:
            from dotaclient_tpu_torch import native

            p = self.cfg.policy
            native.pack_frames(self._lib, items, self.cfg.seq_len, p.lstm_hidden, p.aux_heads, self._obs_bf16, out)
        else:
            fill_rollouts(out, items, self.cfg.seq_len)
        return out, buf

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
        return list(self._quarantine)

    def _ingest(self, frames: List[bytes]) -> None:
        version_now = self.version_fn()
        min_version = version_now - self.cfg.ppo.max_staleness
        H = self.cfg.policy.lstm_hidden
        consumed = len(frames)
        dropped_stale = dropped_bad = quarantined = episodes = 0
        ep_ret = 0.0
        now = time.monotonic()
        wire_bytes = sum(len(f) for f in frames)
        wire_bf16 = wire_f32 = 0
        bad_maps: Dict[int, bytes] = {}
        if self._lib is not None:
            from dotaclient_tpu_torch import native

            # The C packer speaks DTR1 and DTR3: traced DTR2 frames are
            # normalized to the byte-identical DTR1 here; a DTR3 frame's
            # dtype-map is pre-checked so a bad one is quarantined under
            # its own reason (its emptied slot fails the native parse).
            for i, f in enumerate(frames):
                pfx = f[:4]
                if pfx == b"DTR2":
                    frames[i] = strip_rollout_trace(f)
                elif pfx == b"DTR3" and check_dtr3_dtype_map(f) is not None:
                    bad_maps[i] = f
                    frames[i] = b""
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
            if version < min_version:
                dropped_stale += 1
                continue
            if L and last_done > 0:
                episodes += 1
                ep_ret += frame_ret
            self._pending.append(item)
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
        """One packed batch as numpy views of its transfer buffer, or None
        on timeout."""
        return self.get_batch_groups(timeout, cancel)[0]

    def get_batch_groups(self, timeout: Optional[float] = None, cancel=None):
        """(TrainBatch views, buf): the packed batch and the pinned
        [B, row_bytes] u8 buffer its leaves view, ready to ship; (None,
        None) on timeout. Every batch has its own fresh buffer."""
        try:
            return self._get_ready(timeout, cancel=cancel)
        except queue.Empty:
            return None, None

    # -- drain support ---------------------------------------------------

    def quiesce(self) -> None:
        """Stop popping the broker; keep packing already-pending frames."""
        self._quiesce.set()

    def attach_prefetch_probe(self, probe: Callable[[], bool]) -> None:
        """Register the pipelined learner's lane station: a callable that
        is True while the lane holds popped-but-untrained batches."""
        self._prefetch_probe = probe

    def drained(self, include_prefetch: bool = True) -> bool:
        """True once a quiesced buffer can produce no further batch: no
        batch mid-pack, fewer than B frames pending, the ready queue
        empty, and (by default) the prefetch lane holding nothing.
        Stations are checked upstream first, the direction frames move."""
        if not self._quiesce.is_set():
            return False
        with self._mutate_lock:
            if self._packing or len(self._pending) >= self.cfg.batch_size:
                return False
        if not self._ready.empty():
            return False
        if include_prefetch:
            probe = self._prefetch_probe
            if probe is not None and probe():
                return False
        return True

    def stats(self) -> Dict[str, float]:
        with self._stats_lock:
            out = dict(self._stats)
        out["ready_batches"] = self._ready.qsize()
        out["pending_rollouts"] = len(self._pending)  # a gauge: may drift by one in-flight frame
        cutoff = time.monotonic() - self.heartbeat_window_s
        seen = dict(self._actor_seen)
        out["active_actors"] = sum(1 for t in seen.values() if t >= cutoff)
        return out

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
