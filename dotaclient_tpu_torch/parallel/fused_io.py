"""Single-buffer host-to-device batch transfer (torch twin of the
single-buffer part of dotaclient_tpu/parallel/fused_io.py).

Every TrainBatch leaf is batch-leading, so each flattens to [B, cols].
Leaves are grouped by dtype (f32 / i32 / bf16 / bool-as-u8), and a batch
row is the byte concatenation of its group segments in the fixed order
("f32", "i32", "bf16", "u8"), each segment padded to 4 bytes so that
every segment starts aligned for its dtype. The whole batch then crosses
to the device as ONE [B, row_bytes] u8 buffer from pinned host memory,
and `unpack_single` takes it apart on the device with column slices and
dtype views: no copy but the bool leaves' `!= 0`.

`RowLayout` is byte for byte the reference's, `layout_crc` included, so
blocks assembled for the reference learner land here unchanged. The
reference's four-buffer grouped mode is not ported.
"""

from __future__ import annotations

import zlib
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from dotaclient_tpu_torch import resolve_device
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.ops.batch import tree_flatten, tree_unflatten

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
    """Pack a host TrainBatch into one [B, row_bytes] u8 buffer and unpack
    it on the device. Built once per config from a template batch (obs in
    the dtype staging emits); the layout is static."""

    def __init__(self, template, device=None):
        leaves, self.structure = tree_flatten(template)
        B = leaves[0].shape[0]
        if any(leaf.shape[0] != B for leaf in leaves):
            raise ValueError("fused_io: every batch leaf must be batch-leading")
        self.batch = B
        self.dtypes = [_dtype_name(leaf.dtype) for leaf in leaves]
        self.layout = RowLayout([(tuple(leaf.shape), leaf.dtype) for leaf in leaves])
        self.row_bytes = self.layout.row_bytes
        self.device = resolve_device(device)

    def alloc_views_single(self):
        """(buf, batch): a zeroed [B, row_bytes] u8 host tensor (pinned when
        the device is a GPU) and a TrainBatch of numpy views into it, all
        zero but the NOOP-legal action mask of padding rows
        (zeros_train_batch's contract)."""
        buf = torch.zeros((self.batch, self.row_bytes), dtype=torch.uint8, pin_memory=self.device.type == "cuda")
        batch = tree_unflatten(self.structure, self.layout.views_into(buf.numpy(), self.batch))
        batch.obs.action_mask[:] = F.zeros_observation().action_mask
        return buf, batch

    def pack_transfer(self, batch) -> torch.Tensor:
        """A host batch (numpy leaves; bf16 leaves as CPU tensors) → the
        transfer buffer. A batch of another structure, leaf dtype or row
        count is refused here, not truncated or broadcast."""
        leaves, structure = tree_flatten(batch)
        if structure != self.structure:
            raise ValueError(f"single pack: batch structure {structure} != template {self.structure}")
        dtypes = [_dtype_name(leaf.dtype) for leaf in leaves]
        if dtypes != self.dtypes:
            raise ValueError(f"single pack: leaf dtypes {dtypes} != template {self.dtypes}")
        rows = leaves[0].shape[0]
        if rows != self.batch:
            raise ValueError(f"single pack: got {rows} rows, expected {self.batch}")
        buf, views = self.alloc_views_single()
        for v, leaf in zip(tree_flatten(views)[0], leaves):
            v[...] = _host_array(leaf)
        return buf

    def to_device(self, buf: torch.Tensor) -> torch.Tensor:
        """One host-to-device copy, asynchronous from pinned memory: `buf`
        must not be written again until the stream has passed the copy."""
        return buf.to(self.device, non_blocking=True)

    def unpack_single(self, buf: torch.Tensor):
        """[B, row_bytes] u8 on the device → TrainBatch of views: each
        group's byte segment viewed as its dtype (the 4-byte segment
        alignment makes the view legal), then per-leaf column slices.
        Bool leaves come back as `!= 0`."""
        B = buf.shape[0]
        leaves: List[Any] = [None] * self.layout.n_leaves
        for key, slots in self.layout.slots.items():
            k = np.dtype(_GROUP_DTYPES[key]).itemsize
            off = self.layout.seg_off[key]
            seg = buf[:, off : off + self.layout.group_cols[key] * k]
            if k > 1:
                seg = seg.view(_TORCH_GROUP_DTYPES[key])
            for s in slots:
                x = seg[:, s.start : s.start + s.cols].reshape((B,) + s.shape[1:])
                leaves[s.index] = x != 0 if s.dtype == "bool" else x
        return tree_unflatten(self.structure, leaves)
