"""The native (C++) rollout batch packer, loaded via ctypes (the port's
twin of dotaclient_tpu/native/__init__.py).

`csrc/packer.cc` is built with g++ at first use into the git-ignored
`build/torch_kernels/` (ops/_kernels.py) and loaded with ctypes, which
releases the GIL around each call. A failed build raises: there is no
silent fallback to the Python packer (`native_packer=False` selects that).

bf16 obs leaves are uint16 words on the Python side (numpy has no bf16
here), exactly the storage the C side writes.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.ops import _kernels
from dotaclient_tpu_torch.ops.batch import BatchLayoutError

_SCHEMA_DIMS = (F.GLOBAL_FEATURES, F.HERO_FEATURES, F.MAX_UNITS, F.UNIT_FEATURES, F.N_ACTION_TYPES)


def load_packer() -> ctypes.CDLL:
    """The compiled packer library (built on first use; raises if the
    build or the load fails)."""
    return _kernels.load("packer")


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def _frame_array(frames: List[bytes]):
    """(pointer array, keepalive): a char* per frame; the bytes objects
    stay referenced by the caller's list for the call."""
    arr = (ctypes.c_char_p * len(frames))(*frames)
    return ctypes.cast(arr, ctypes.c_void_p), arr


def frame_header(lib: ctypes.CDLL, frame: bytes) -> Optional[Tuple[int, int, int, int, int, float, float]]:
    """(version, L, H, flags, actor_id, episode_return, last_done) or None
    if the frame is malformed. Validates the full frame size."""
    ints = np.zeros(5, np.int64)
    floats = np.zeros(2, np.float32)
    rc = lib.dt_frame_header(
        ctypes.cast(ctypes.c_char_p(frame), ctypes.c_void_p),
        len(frame),
        *_SCHEMA_DIMS,
        *(ctypes.c_void_p(ints.ctypes.data + 8 * i) for i in range(5)),
        *(ctypes.c_void_p(floats.ctypes.data + 4 * i) for i in range(2)),
    )
    if rc != 0:
        return None
    version, L, H, flags, actor_id = ints.tolist()
    return version, L, H, flags, actor_id, float(floats[0]), float(floats[1])


class FrameHeaders(NamedTuple):
    """Parallel lists from a batched header parse; ok[i] falsy marks a
    malformed frame (its other slots are unspecified)."""

    ok: List[int]
    versions: List[int]
    Ls: List[int]
    Hs: List[int]
    flags: List[int]
    actor_ids: List[int]
    ep_returns: List[float]
    last_dones: List[float]


def frame_headers(lib: ctypes.CDLL, frames: List[bytes]) -> FrameHeaders:
    """Batched header parse: ONE ctypes call for a whole ingest drain."""
    n = len(frames)
    ptrs, keep = _frame_array(frames)
    lens = np.fromiter((len(f) for f in frames), np.int64, count=n)
    ints = [np.zeros(n, np.int64) for _ in range(5)]  # versions, Ls, Hs, flags, actor_ids
    ep_rets, last_dones = np.zeros(n, np.float32), np.zeros(n, np.float32)
    ok = np.zeros(n, np.uint8)
    lib.dt_frame_headers(ptrs, _ptr(lens), n, *_SCHEMA_DIMS, *map(_ptr, ints), _ptr(ep_rets), _ptr(last_dones), _ptr(ok))
    del keep
    return FrameHeaders(ok.tolist(), *(a.tolist() for a in ints), ep_rets.tolist(), last_dones.tolist())


def _ordered_out_leaves(batch):
    """The 20 output arrays in C-ABI order (aux slots None-padded)."""
    aux = (batch.aux.win, batch.aux.last_hit, batch.aux.net_worth) if batch.aux is not None else (None, None, None)
    return (
        batch.obs.global_feats, batch.obs.hero_feats, batch.obs.unit_feats,
        batch.obs.unit_mask, batch.obs.target_mask, batch.obs.action_mask,
        batch.actions.type, batch.actions.move_x, batch.actions.move_y, batch.actions.target,
        batch.behavior_logp, batch.behavior_value, batch.rewards, batch.dones, batch.mask,
        batch.initial_state[0], batch.initial_state[1],
    ) + aux


def _expect_dtypes(obs_bf16: bool):
    obs_dt = np.dtype(np.uint16) if obs_bf16 else np.dtype(np.float32)
    return [obs_dt] * 3 + [np.dtype(np.bool_)] * 3 + [np.dtype(np.int32)] * 4 + [np.dtype(np.float32)] * 10


def _validate_out_strides(batch, obs_bf16: bool, rows: int) -> np.ndarray:
    """Check an `out` batch of numpy views against the C writer's fixed
    widths and its `rows` rows; returns the 20 per-output row strides in
    elements. Raises BatchLayoutError (fatal to staging: a template/config
    mismatch fails every batch) on any disagreement."""
    strides = []
    for arr, want in zip(_ordered_out_leaves(batch), _expect_dtypes(obs_bf16)):
        if arr is None:
            strides.append(0)
            continue
        if arr.dtype != want:
            raise BatchLayoutError(f"out leaf dtype {arr.dtype} != {want} (obs_bf16={obs_bf16}; template/flag mismatch)")
        if arr.shape[0] != rows:
            raise BatchLayoutError(f"out batch rows {arr.shape[0]} != {rows}")
        stride, rem = divmod(arr.strides[0], arr.itemsize)
        if rem:
            raise BatchLayoutError("out leaf row stride not a multiple of itemsize")
        expect = arr.itemsize
        for dim, st in zip(arr.shape[:0:-1], arr.strides[:0:-1]):
            if st != expect:
                raise BatchLayoutError("out leaf rows must be internally contiguous")
            expect *= dim
        strides.append(stride)
    return np.asarray(strides, np.int64)


def _pack_batch_args(frames, batch, seq_len, lstm_hidden, with_aux, obs_bf16, strides, row_offset=0):
    """The dt_pack_batch argument vector for (frames, batch) → (args,
    keepalive); keepalive must outlive the call."""
    n = len(frames)
    ptrs, keep = _frame_array(frames)
    lens = np.fromiter((len(f) for f in frames), np.int64, count=n)
    meta = (np.empty(n, np.uint32), np.empty(n, np.uint32), np.empty(n, np.float32))  # versions, actor ids, returns
    outs = [None if a is None else _ptr(a) for a in _ordered_out_leaves(batch)]
    args = (
        ptrs, _ptr(lens), n, row_offset, seq_len, lstm_hidden, int(with_aux), int(obs_bf16), *_SCHEMA_DIMS,
        _ptr(strides), *outs, *map(_ptr, meta),
    )
    return args, (keep, lens, meta, strides, batch)


def pack_frames(lib: ctypes.CDLL, frames: List[bytes], seq_len: int, lstm_hidden: int, with_aux: bool,
                obs_bf16: bool, out, row_offset: int = 0, total_rows: Optional[int] = None) -> None:
    """Pack len(frames) wire frames into rows [row_offset, row_offset + n)
    of the pre-zeroed `out` batch of numpy views (FusedBatchIO's views:
    float obs as uint16 words when `obs_bf16`, then f32 wire frames are
    rounded to bf16 in the copy). `out` holds `total_rows` rows (default:
    exactly row_offset + n). Each row depends only on its own frame, so
    concurrent calls on disjoint row ranges of one `out` write the bytes
    one call would (the sharded pack). A malformed frame raises ValueError
    naming its row; an `out` layout mismatch raises BatchLayoutError."""
    n = len(frames)
    rows = n + row_offset if total_rows is None else total_rows
    if row_offset < 0 or row_offset + n > rows:
        raise BatchLayoutError(f"rows [{row_offset}, {row_offset + n}) do not fit an out batch of {rows}")
    strides = _validate_out_strides(out, obs_bf16, rows)
    args, keep = _pack_batch_args(frames, out, seq_len, lstm_hidden, with_aux, obs_bf16, strides, row_offset)
    rc = lib.dt_pack_batch(*args)
    del keep
    if rc != 0:
        raise ValueError(f"native packer rejected frame {row_offset - rc - 1}")
