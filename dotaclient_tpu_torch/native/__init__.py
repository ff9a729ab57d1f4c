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


def _bytes_data_offset() -> int:
    """Offset of a bytes object's data from its id() (CPython's
    PyBytesObject.ob_sval), read once through ctypes' own char* conversion."""
    probe = b"offset probe"
    return ctypes.cast(ctypes.c_char_p(probe), ctypes.c_void_p).value - id(probe)


_BYTES_DATA_AT = _bytes_data_offset()


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


class PackPlan:
    """A prebuilt dt_pack_batch call: packs exactly `n` frames into rows
    [row_offset, row_offset + n) of ONE long-lived `out` batch of
    `total_rows` rows, call after call (the twin of the reference's
    native.PackPlan).

    The sharded pack (`staging.pack_workers` > 1) packs every batch into
    reused ring slots, so the per-call glue (the 20-leaf stride and dtype
    check, the 20 output and 3 meta pointers) is the same every batch: a
    plan pays it once, and `pack` marshals only the frame pointers and
    lengths before the C call (which releases the GIL); `pack_rows` takes
    them marshalled already, once for the whole batch. Its bytes are
    `pack_frames`' with the same arguments. The plan keeps `out` alive;
    its leaves must not be replaced (a ring slot's live as long as the
    ring)."""

    def __init__(self, lib: ctypes.CDLL, out, n: int, seq_len: int, lstm_hidden: int, with_aux: bool,
                 obs_bf16: bool, row_offset: int = 0, total_rows: Optional[int] = None):
        rows = n + row_offset if total_rows is None else total_rows
        if row_offset < 0 or row_offset + n > rows:
            raise BatchLayoutError(f"rows [{row_offset}, {row_offset + n}) do not fit an out batch of {rows}")
        self._lib = lib
        self.n = n
        self.row_offset = row_offset
        strides = _validate_out_strides(out, obs_bf16, rows)
        meta = (np.empty(n, np.uint32), np.empty(n, np.uint32), np.empty(n, np.float32))  # versions, actor ids, returns
        outs = [None if a is None else _ptr(a) for a in _ordered_out_leaves(out)]
        ints = (n, row_offset, seq_len, lstm_hidden, int(with_aux), int(obs_bf16), *_SCHEMA_DIMS)
        self._tail = (*map(ctypes.c_int64, ints), _ptr(strides), *outs, *map(_ptr, meta))
        self._keep = (out, strides, meta)  # everything the prebuilt pointers reference

    def pack(self, frames: List[bytes]) -> None:
        """One C pack of the n frames into the planned rows: the per-call work
        is the frames' pointers and lengths. BatchLayoutError unless
        len(frames) == n; TypeError for a frame that is not bytes; a
        malformed frame raises ValueError naming its absolute batch row."""
        if len(frames) != self.n:
            raise BatchLayoutError(f"plan packs {self.n} frames, got {len(frames)}")
        ptrs, lens = marshal_frames(frames)  # the caller's list keeps the frames alive
        self._call((_ptr(ptrs), _ptr(lens), *self._tail))

    def pack_rows(self, ptrs: np.ndarray, lens: np.ndarray) -> None:
        """The planned rows packed from the whole batch's frames, marshalled
        once by `marshal_frames` and indexed by batch row: the shards of
        one batch share one marshal (the sharded pack's dispatcher makes
        it). The caller keeps the frames and both arrays alive for the
        call."""
        end = self.row_offset + self.n
        if len(ptrs) < end or len(lens) < end:
            raise BatchLayoutError(f"plan packs rows [{self.row_offset}, {end}) of a batch of {len(ptrs)} frames")
        at = 8 * self.row_offset
        self._call((ctypes.c_void_p(ptrs.ctypes.data + at), ctypes.c_void_p(lens.ctypes.data + at), *self._tail))

    def _call(self, args) -> None:
        rc = self._lib.dt_pack_batch(*args)
        if rc != 0:
            raise ValueError(f"native packer rejected frame {self.row_offset - rc - 1}")


def marshal_frames(frames: List[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """(data pointers u64, lengths i64) of the frames, for dt_pack_batch; the
    frames must stay alive while the pointers are used. TypeError for a
    frame that is not bytes."""
    if not all(type(f) is bytes for f in frames):
        raise TypeError("the native packer takes frames as bytes")
    n = len(frames)
    # vectorised: a bytes object's data sits at a fixed offset from its
    # address (measured once, _BYTES_DATA_AT)
    ptrs = np.fromiter(map(id, frames), np.uint64, count=n)
    ptrs += _BYTES_DATA_AT
    return ptrs, np.fromiter(map(len, frames), np.int64, count=n)


def pack_frames(lib: ctypes.CDLL, frames: List[bytes], seq_len: int, lstm_hidden: int, with_aux: bool,
                obs_bf16: bool, out, row_offset: int = 0, total_rows: Optional[int] = None) -> None:
    """Pack len(frames) wire frames into rows [row_offset, row_offset + n)
    of the pre-zeroed `out` batch of numpy views (FusedBatchIO's views:
    float obs as uint16 words when `obs_bf16`, then f32 wire frames are
    rounded to bf16 in the copy). `out` holds `total_rows` rows (default:
    exactly row_offset + n). Each row depends only on its own frame, so
    concurrent calls on disjoint row ranges of one `out` write the bytes
    one call would (the sharded pack). A malformed frame raises ValueError
    naming its row; an `out` layout mismatch raises BatchLayoutError. One
    call builds and uses a PackPlan; a caller that packs the same rows of
    the same `out` again keeps the plan instead."""
    PackPlan(lib, out, len(frames), seq_len, lstm_hidden, with_aux, obs_bf16, row_offset, total_rows).pack(frames)
