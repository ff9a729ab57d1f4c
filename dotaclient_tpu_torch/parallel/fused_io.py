"""Host-to-device batch transfer in dtype groups (torch twin of
dotaclient_tpu/parallel/fused_io.py).

Every TrainBatch leaf is batch-leading, so each flattens to [B, cols].
Leaves are grouped by dtype (f32 / i32 / bf16 / bool-as-u8), in one of
two layouts:
- group mode (`fused_single_h2d` off): each group is one [B, group_cols]
  buffer of its dtype, so the batch crosses as four copies (`alloc_views`,
  `unpack`);
- single mode (the default learner path): a batch row is the byte
  concatenation of its group segments in the fixed order ("f32", "i32",
  "bf16", "u8"), each segment padded to 4 bytes so that every segment
  starts aligned for its dtype, and the whole batch crosses as ONE
  [B, row_bytes] u8 buffer (`alloc_views_single`, `unpack_single`).
Either way the host buffers are pinned, every copy runs on this io's side
stream, and the device side takes the batch apart with column slices and
dtype views: no copy but the bool leaves' `!= 0`. bf16 leaves are uint16
words on the host (numpy has no bfloat16) and bf16 on the device.

`RowLayout` is byte for byte the reference's, `layout_crc` included, so
blocks assembled for the reference learner land here unchanged.

`TreeBatchIO` is the tree path's transfer: one copy per leaf of a dense
batch.

`TransferRing` (staging.pack_workers > 1, and assembled intake) replaces
the fresh buffers per batch with `transfer_depth` pinned buffer sets
allocated once, each leased to one host-to-device transfer and released
once that transfer's event has completed.
"""

from __future__ import annotations

import queue
import zlib
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dotaclient_tpu_torch import resolve_device
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.ops.batch import BatchLayoutError, tree_flatten, tree_map, tree_unflatten

_GROUPS = ("f32", "i32", "bf16", "u8")
_GROUP_OF = {"float32": "f32", "int32": "i32", "bfloat16": "bf16", "bool": "u8", "uint8": "u8"}
# Host-side element type of each group's views; bf16 is stored as raw
# 2-byte words (numpy has no bfloat16).
_GROUP_DTYPES = {"f32": np.float32, "i32": np.int32, "bf16": np.uint16, "u8": np.uint8}
_TORCH_GROUP_DTYPES = {"f32": torch.float32, "i32": torch.int32, "bf16": torch.bfloat16, "u8": torch.uint8}


def _dtype_name(dtype) -> str:
    """numpy's name for a numpy dtype, "bfloat16" for torch.bfloat16."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    return np.dtype(dtype).name


def _group_key(name: str) -> str:
    if name not in _GROUP_OF:
        raise TypeError(f"fused_io: unsupported batch leaf dtype {name}")
    return _GROUP_OF[name]


def _host_array(leaf) -> np.ndarray:
    """A leaf as a numpy array; a bf16 tensor as its raw 2-byte words."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().contiguous()
        return leaf.view(torch.int16).numpy().view(np.uint16) if leaf.dtype == torch.bfloat16 else leaf.numpy()
    return np.asarray(leaf)


class _LeafSlot(NamedTuple):
    index: int  # position in the flattened batch
    shape: Tuple[int, ...]  # full leaf shape (batch dim included)
    dtype: str  # the leaf's dtype name (bool is restored on unpack)
    start: int  # column offset inside the group
    cols: int


class RowLayout:
    """The single-buffer row layout, built from the flattened template's
    (shape, dtype) list: group segments in the fixed order, each padded
    to 4 bytes, leaves at their column offsets. `layout_crc` is the crc32
    of a canonical descriptor of every quantity a row copy depends on;
    two processes that agree on it agree on every byte position."""

    def __init__(self, specs: List[Tuple[Tuple[int, ...], Any]]):
        self.slots: Dict[str, List[_LeafSlot]] = {}
        cols: Dict[str, int] = {}
        for i, (shape, dtype) in enumerate(specs):
            name = _dtype_name(dtype)
            key = _group_key(name)
            n = int(np.prod(shape[1:], dtype=np.int64)) if len(shape) > 1 else 1
            self.slots.setdefault(key, []).append(_LeafSlot(i, tuple(shape), name, cols.get(key, 0), n))
            cols[key] = cols.get(key, 0) + n
        self.group_cols = cols
        self.n_leaves = len(specs)
        self.seg_off: Dict[str, int] = {}
        off = 0
        for key in _GROUPS:
            if key not in cols:
                continue
            self.seg_off[key] = off
            nbytes = cols[key] * np.dtype(_GROUP_DTYPES[key]).itemsize
            off += (nbytes + 3) & ~3
        self.row_bytes = off
        desc = ";".join(
            f"{s.index}:{','.join(map(str, s.shape[1:]))}:{s.dtype}:{key}:{s.start}"
            for key in _GROUPS
            if key in self.slots
            for s in self.slots[key]
        )
        desc += "|" + ",".join(f"{k}={self.seg_off[k]}" for k in sorted(self.seg_off))
        desc += f"|row_bytes={self.row_bytes}"
        self.layout_crc = zlib.crc32(desc.encode()) & 0xFFFFFFFF

    def views_into(self, buf: np.ndarray, rows: int) -> List[np.ndarray]:
        """Leaf views (flat order) into a [rows, row_bytes] u8 buffer: bool
        leaves as bool views, bf16 leaves as raw uint16 words. Every view
        must share memory with `buf` (a silent copy would ship zeros)."""
        leaves: List[Any] = [None] * self.n_leaves
        for key, slots in self.slots.items():
            gdt = np.dtype(_GROUP_DTYPES[key])
            for s in slots:
                dt = np.dtype(np.bool_) if s.dtype == "bool" else gdt
                rev, acc = [], dt.itemsize
                for d in reversed(s.shape[1:]):
                    rev.append(acc)
                    acc *= d
                v = np.ndarray(
                    shape=(rows,) + s.shape[1:],
                    dtype=dt,
                    buffer=buf,
                    offset=self.seg_off[key] + s.start * gdt.itemsize,
                    strides=(self.row_bytes,) + tuple(reversed(rev)),
                )
                if not np.may_share_memory(v, buf):
                    raise AssertionError("RowLayout.views_into: leaf view detached")
                leaves[s.index] = v
        return leaves


class FusedBatchIO:
    """Pack a host TrainBatch into dtype-grouped transfer buffers and unpack
    them on the device. Built once per config from a template batch (obs in
    the dtype staging emits); the layout is static. `single` picks the
    layout the train step was built for: ONE [B, row_bytes] u8 buffer
    (True, build_single_train_step) or a {group: [B, cols]} dict
    (False, build_fused_train_step). Staging and the learner go through
    alloc_transfer / pack_transfer / transfer / consume, which follow it."""

    def __init__(self, template, device=None, single: bool = True):
        leaves, self.structure = tree_flatten(template)
        B = leaves[0].shape[0]
        if any(leaf.shape[0] != B for leaf in leaves):
            raise ValueError("fused_io: every batch leaf must be batch-leading")
        self.batch = B
        self.single_mode = single
        self.dtypes = [_dtype_name(leaf.dtype) for leaf in leaves]
        self.layout = RowLayout([(tuple(leaf.shape), leaf.dtype) for leaf in leaves])
        self.row_bytes = self.layout.row_bytes
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        # Host-to-device copies run on their own stream, so a copy issued
        # by the learner's prefetch thread overlaps the train step's
        # kernels on the loop thread's stream.
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    # -- the layout the step was built for --------------------------------

    def alloc_transfer(self):
        """(payload, batch of numpy views into it), zeroed, in this io's
        layout: alloc_views_single or alloc_views."""
        return self.alloc_views_single() if self.single_mode else self.alloc_views()

    def pack_transfer(self, batch):
        """A host batch (numpy leaves; bf16 leaves as CPU tensors) → the
        transfer payload in this io's layout. A batch of another structure,
        leaf dtype or row count is refused here (BatchLayoutError), not
        truncated or broadcast."""
        leaves = self._check(batch)
        payload, views = self.alloc_transfer()
        for v, leaf in zip(tree_flatten(views)[0], leaves):
            v[...] = _host_array(leaf)
        return payload

    def _check(self, batch) -> list:
        leaves, structure = tree_flatten(batch)
        if structure != self.structure:
            raise BatchLayoutError(f"fused pack: batch structure {structure} != template {self.structure}")
        dtypes = [_dtype_name(leaf.dtype) for leaf in leaves]
        if dtypes != self.dtypes:
            raise BatchLayoutError(f"fused pack: leaf dtypes {dtypes} != template {self.dtypes}")
        rows = leaves[0].shape[0]
        if rows != self.batch:
            raise BatchLayoutError(f"fused pack: got {rows} rows, expected {self.batch}")
        return leaves

    def _zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, pin_memory=self._pin)

    # -- host side ---------------------------------------------------------

    def alloc_views(self):
        """(groups, batch): zeroed {group: [B, cols]} host tensors (pinned
        when the device is a GPU; the bf16 group as torch.bfloat16) and a
        TrainBatch of numpy views into them (bf16 leaves as uint16 words),
        all zero but the NOOP-legal action mask of padding rows
        (zeros_train_batch's contract). Staging packs straight into the
        views, so `groups` is already what crosses."""
        groups = {key: self._zeros((self.batch, cols), _TORCH_GROUP_DTYPES[key])
                  for key, cols in self.layout.group_cols.items()}
        leaves: List[Any] = [None] * self.layout.n_leaves
        for key, slots in self.layout.slots.items():
            host = _group_numpy(groups[key])
            for s in slots:
                v = host[:, s.start : s.start + s.cols].reshape((self.batch,) + s.shape[1:])
                if s.dtype == "bool":
                    v = v.view(np.bool_)
                # a silent copy here would ship zeros
                if not np.may_share_memory(v, host):
                    raise AssertionError("fused_io.alloc_views: leaf view detached")
                leaves[s.index] = v
        batch = tree_unflatten(self.structure, leaves)
        batch.obs.action_mask[:] = F.zeros_observation().action_mask
        return groups, batch

    def alloc_views_single(self):
        """(buf, batch): a zeroed [B, row_bytes] u8 host tensor (pinned when
        the device is a GPU) and a TrainBatch of numpy views into it, with
        alloc_views' contract."""
        buf = self._zeros((self.batch, self.row_bytes), torch.uint8)
        batch = tree_unflatten(self.structure, self.layout.views_into(buf.numpy(), self.batch))
        batch.obs.action_mask[:] = F.zeros_observation().action_mask
        return buf, batch

    def make_ring(self, depth: int) -> "TransferRing":
        """A TransferRing of `depth` buffer sets in this io's layout."""
        return TransferRing(self, depth)

    # -- the copy ----------------------------------------------------------

    def transfer(self, payload):
        """(device payload, ready): the host-to-device copy of a pinned
        payload (a tensor, or a dict of group tensors: one copy each)
        issued on this io's side stream, and the event recorded after it
        (None on the CPU, where the caller asked for no stream: the payload
        is then a copy made before this returns). The host does not wait;
        whoever uses the payload calls `consume` first. Fresh buffers go
        back to the caching host allocator only once the copy is done; a
        ring slot must not be released before `ready` has completed."""
        if self._stream is None:
            return _map_payload(payload, lambda t: t.to(self.device, copy=True)), None
        with torch.cuda.stream(self._stream):
            out = _map_payload(payload, lambda t: t.to(self.device, non_blocking=True))
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    @staticmethod
    def consume(payload, ready):
        """Order the current stream after the copy (a device-side wait, the
        host does not block) and mark each payload tensor as used there, so
        the allocator does not hand its memory to the side stream while the
        step still reads it."""
        _order_after(list(payload.values()) if isinstance(payload, dict) else [payload], ready)
        return payload

    # -- device side -------------------------------------------------------

    def unpack(self, groups: Dict[str, torch.Tensor]):
        """{group: [B, cols]} on the device → TrainBatch of views: per-leaf
        column slices reshaped to the leaf. Bool leaves come back as `!= 0`."""
        leaves: List[Any] = [None] * self.layout.n_leaves
        for key, slots in self.layout.slots.items():
            for s in slots:
                leaves[s.index] = self._leaf(groups[key], s)
        return tree_unflatten(self.structure, leaves)

    def unpack_single(self, buf: torch.Tensor):
        """[B, row_bytes] u8 on the device → TrainBatch of views: each
        group's byte segment viewed as its dtype (the 4-byte segment
        alignment makes the view legal), then unpack's per-leaf slices."""
        leaves: List[Any] = [None] * self.layout.n_leaves
        for key, slots in self.layout.slots.items():
            k = np.dtype(_GROUP_DTYPES[key]).itemsize
            off = self.layout.seg_off[key]
            seg = buf[:, off : off + self.layout.group_cols[key] * k]
            if k > 1:
                seg = seg.view(_TORCH_GROUP_DTYPES[key])
            for s in slots:
                leaves[s.index] = self._leaf(seg, s)
        return tree_unflatten(self.structure, leaves)

    @staticmethod
    def _leaf(group: torch.Tensor, s: _LeafSlot) -> torch.Tensor:
        x = group[:, s.start : s.start + s.cols].reshape((group.shape[0],) + s.shape[1:])
        return x != 0 if s.dtype == "bool" else x


class TreeBatchIO:
    """The tree path's transfer (`fused_h2d` off, or replay on): a dense
    host TrainBatch crosses as one copy per leaf, in the leaf's own dtype,
    on this io's side stream, with FusedBatchIO's event protocol. The
    leaves are pageable numpy memory (bf16 ones CPU tensors), so each copy
    returns once CUDA has staged its bytes: the host batch may be freed at
    once, and the copies overlap the step only from the staging on."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def transfer(self, batch):
        """(TrainBatch of device tensors, ready event or None on the CPU)."""
        if self._stream is None:
            return tree_map(lambda x: _leaf_tensor(x).to(self.device, copy=True), batch), None
        with torch.cuda.stream(self._stream):
            out = tree_map(lambda x: _leaf_tensor(x).to(self.device, non_blocking=True), batch)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    @staticmethod
    def consume(batch, ready):
        """FusedBatchIO.consume over every leaf of the tree."""
        _order_after(tree_flatten(batch)[0], ready)
        return batch


def _order_after(tensors, ready) -> None:
    """The current stream waits on the copies' event; the tensors are
    marked as used on it. Nothing on the CPU (ready is None)."""
    if ready is None:
        return
    stream = torch.cuda.current_stream(tensors[0].device)
    stream.wait_event(ready)
    for t in tensors:
        t.record_stream(stream)


def _leaf_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def _group_numpy(t: torch.Tensor) -> np.ndarray:
    """A host group tensor as numpy, sharing memory; bf16 as uint16 words."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _map_payload(payload, fn):
    return {k: fn(v) for k, v in payload.items()} if isinstance(payload, dict) else fn(payload)


class RingSlot:
    """One preallocated pinned transfer buffer set with explicit ownership
    (TransferRing). `acquire` hands it to the packer re-zeroed to
    alloc_transfer's contract (all zeros, NOOP-legal action-mask padding),
    so a reused slot never leaks the previous batch into padding rows.
    `release` is idempotent: a double release must not put the slot in the
    free queue twice (two packers would then write one buffer)."""

    __slots__ = ("_ring", "index", "payload", "batch", "_held")

    def __init__(self, ring: "TransferRing", index: int, payload: torch.Tensor, batch):
        self._ring = ring
        self.index = index
        self.payload = payload  # the [B, row_bytes] u8 host buffer, or the group dict
        self.batch = batch  # TrainBatch of numpy views into payload
        self._held = False

    def _reset(self) -> None:
        for t in self.payload.values() if isinstance(self.payload, dict) else (self.payload,):
            t.zero_()
        self.batch.obs.action_mask[:] = F.zeros_observation().action_mask

    def release(self) -> None:
        """Back to the free queue. Call only once the host-to-device copy
        of `payload` has completed (its `ready` event): the slot is
        re-zeroed and repacked at once, and a copy still reading it would
        ship the next batch's bytes, or zeros."""
        if self._held:
            self._held = False
            self._ring._free.put(self)


class TransferRing:
    """`depth` pinned transfer buffers with ownership handed along:
    free → packing (acquire, the staging assembler) → ready → in transfer
    (the learner's fetch) → free (release, once the copy's event has
    completed). Packing batch N+1 overlaps the copy of N and the step of
    N-1; an acquire with every slot out blocks, which is the ring's
    backpressure."""

    def __init__(self, io: FusedBatchIO, depth: int):
        if depth < 1:
            raise ValueError(f"transfer ring depth must be >= 1, got {depth}")
        self.io = io
        self.depth = depth
        self._free: "queue.Queue[RingSlot]" = queue.Queue()
        self.slots = []
        for i in range(depth):
            payload, batch = io.alloc_transfer()
            slot = RingSlot(self, i, payload, batch)
            self.slots.append(slot)
            self._free.put(slot)

    def acquire(self, timeout: Optional[float] = None) -> Optional[RingSlot]:
        """The next free slot, re-zeroed; None on timeout."""
        try:
            slot = self._free.get(timeout=timeout)
        except queue.Empty:
            return None
        slot._held = True
        slot._reset()
        return slot

    @property
    def occupancy(self) -> int:
        """Slots out of the free queue (packing, ready or in transfer): the
        staging_pack_ring_occupancy gauge."""
        return self.depth - self._free.qsize()
