"""Wire formats (own copy of the rollout and weight halves of
dotaclient_tpu/transport/serialize.py): experience rollouts that actors
publish, and the weight frames the learner fans out. A frame the port
writes is byte for byte the reference's, so a JAX fleet and the torch
learner speak to each other. The single-observation frame of the serve
wire lives here too.

Rollout frame (little-endian):
  DTR1: magic b'DTR1' | u32 version | u16 L | u16 H | u8 flags (bit0: aux
        targets) | u32 actor_id | f32 episode_return | the arrays in fixed
        order, raw bytes (obs arrays carry L+1 rows).
  DTR2: the DTR1 header under b'DTR2' + u64 trace_id + f64 birth_time, then
        the same arrays (emitted only for trace-stamped rollouts).
  DTR3: the DTR2 header under b'DTR3' (trace fields zero when untraced) +
        u8 n_dtypes + u8[n] dtype-map (0=f32, 1=i32, 2=u8, 3=bf16), then the
        arrays in their wire dtypes: the three float obs leaves uniformly
        f32 or bf16, everything else canonical. Any other map is a
        WireDtypeError.

Weight frame: DTW2 <4s magic, u32 version, u32 boot_epoch, u32 n>, then per
array <u16 name length, name, u8 ndim, u32 × ndim shape, u8 dtype code,
raw bytes>. Legacy DTW1 has no boot_epoch (read as 0) and is emitted only
with `legacy_dtw1`.

DTB1 blocks carry rows a fabric shard pre-packed in the learner's row
layout (in-network assembly; the layout is written out above
`BLOCK_MAGIC`).

numpy has no bfloat16 here, so bf16 obs leaves are CPU `torch.bfloat16`
tensors, and the f32 → bf16 cast is written out on the uint32 view
(`f32_to_bf16_bits`): round to nearest even, NaN quieted to sign | 0x7fc0,
bit for bit the ml_dtypes cast the reference uses.
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.ops.action_dist import Action

_ROLLOUT_MAGIC = b"DTR1"
_ROLLOUT_MAGIC2 = b"DTR2"  # trace-extended: header + trace_id/birth
_ROLLOUT_MAGIC3 = b"DTR3"  # quantized wire: DTR2 header + per-array dtype-map
_WEIGHTS_MAGIC = b"DTW1"  # legacy: no boot_epoch
_WEIGHTS_MAGIC2 = b"DTW2"
_HDR = struct.Struct("<4sIHHBIf")
_HDR2 = struct.Struct("<4sIHHBIfQd")

_FLAG_AUX = 1
_WIRE_F32, _WIRE_I32, _WIRE_U8, _WIRE_BF16 = 0, 1, 2, 3


# ------------------------------------------------------------------- bf16


def f32_to_bf16_bits(x) -> np.ndarray:
    """f32 values → bf16 as uint16 words: round to nearest even on the
    uint32 view, NaN quieted to sign | 0x7fc0 (payload dropped), overflow
    to ±inf; bit for bit `x.astype(ml_dtypes.bfloat16)`."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    out = ((u + (np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))) >> 16).astype(np.uint16)
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    if nan.any():
        out[nan] = ((u[nan] >> 16) & 0x8000).astype(np.uint16) | np.uint16(0x7FC0)
    return out


def bf16_bits_to_f32(bits) -> np.ndarray:
    """uint16 bf16 words → the f32 values they hold (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    """uint16 words → a CPU torch.bfloat16 tensor holding them (sharing
    memory with a writable contiguous array, else a copy)."""
    a = np.ascontiguousarray(bits, np.uint16)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)


def bf16_bits(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's raw 2-byte words as a uint16 numpy array."""
    return t.detach().cpu().contiguous().view(torch.int16).numpy().view(np.uint16)


def is_bf16(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16


def _bf16_words(leaf) -> np.ndarray:
    return bf16_bits(leaf) if is_bf16(leaf) else f32_to_bf16_bits(leaf)


def _f32_values(leaf) -> np.ndarray:
    return bf16_bits_to_f32(bf16_bits(leaf)) if is_bf16(leaf) else np.ascontiguousarray(leaf, np.float32)


# ---------------------------------------------------------------- rollouts


class WireDtypeError(ValueError):
    """A DTR3 frame whose dtype-map is truncated, malformed, or names a
    wire layout this build does not speak (quarantined as "dtype_map")."""


def _canonical_codes(flags: int, obs_code: int) -> bytes:
    """The accepted dtype-map in serialization order: 3 float obs leaves
    (uniform f32 or bf16), 3 u8 masks, 4 i32 action heads, 6 f32
    scalars/state, +3 f32 aux when flagged."""
    codes = [obs_code] * 3 + [_WIRE_U8] * 3 + [_WIRE_I32] * 4 + [_WIRE_F32] * 6
    if flags & _FLAG_AUX:
        codes += [_WIRE_F32] * 3
    return bytes(codes)


def check_dtr3_dtype_map(data: bytes) -> Optional[str]:
    """None when `data` (magic known to be DTR3) carries a well-formed
    dtype-map this build speaks, else the quarantine reason."""
    if len(data) < _HDR2.size + 1:
        return "dtype_map"
    flags = data[12]
    n = data[_HDR2.size]
    if len(data) < _HDR2.size + 1 + n:
        return "dtype_map"
    m = data[_HDR2.size + 1 : _HDR2.size + 1 + n]
    if m != _canonical_codes(flags, _WIRE_F32) and m != _canonical_codes(flags, _WIRE_BF16):
        return "dtype_map"
    return None


def peek_rollout_actor_id(data: bytes) -> Optional[int]:
    """The actor_id a rollout frame was stamped with (None for short or
    foreign frames); the same offset in DTR1/2/3."""
    if len(data) < _HDR.size or data[:4] not in (_ROLLOUT_MAGIC, _ROLLOUT_MAGIC2, _ROLLOUT_MAGIC3):
        return None
    (actor_id,) = struct.unpack_from("<I", data, 13)
    return actor_id


def wire_obs_is_bf16(data: bytes) -> bool:
    """True iff `data` is a DTR3 frame shipping its float obs as bf16."""
    return len(data) > _HDR2.size + 1 and data[:4] == _ROLLOUT_MAGIC3 and data[_HDR2.size + 1] == _WIRE_BF16


class RolloutAux(NamedTuple):
    win: np.ndarray  # [L] f32 ±1 final result, 0 unknown
    last_hit: np.ndarray  # [L] f32
    net_worth: np.ndarray  # [L] f32


class Rollout(NamedTuple):
    """One variable-length trajectory chunk as shipped by an actor. `obs`
    leaves have L+1 rows (the last is the bootstrap observation); float
    obs leaves are f32 numpy arrays or, cast at the source, bf16 tensors."""

    obs: F.Observation  # leaves [L+1, ...]
    actions: Action  # leaves [L] i32
    behavior_logp: np.ndarray  # [L] f32
    behavior_value: np.ndarray  # [L] f32
    rewards: np.ndarray  # [L] f32
    dones: np.ndarray  # [L] f32
    initial_state: Tuple[np.ndarray, np.ndarray]  # (c, h) each [H] f32
    version: int
    actor_id: int = 0
    episode_return: float = 0.0
    aux: Optional[RolloutAux] = None
    # Both zero means untraced: serialize_rollout then emits DTR1.
    trace_id: int = 0
    birth_time: float = 0.0

    @property
    def length(self) -> int:
        return int(self.rewards.shape[0])

    @property
    def traced(self) -> bool:
        return bool(self.trace_id or self.birth_time)


def rollout_obs_bf16(r: Rollout) -> bool:
    """True when the rollout's float obs leaves are already bf16."""
    return is_bf16(r.obs.global_feats)


def cast_rollout_obs_bf16(r: Rollout) -> Rollout:
    """Cast the f32 obs leaves to bf16 at the source (the exact rounding
    staging applies to f32 frames); other leaves keep their types, and
    already-bf16 leaves pass through."""
    obs = r.obs._replace(
        **{f: bf16_tensor(f32_to_bf16_bits(v)) for f, v in r.obs._asdict().items() if getattr(v, "dtype", None) == np.float32}
    )
    return r._replace(obs=obs)


def wire_cast_fn(obs_dtype: str):
    """The publish-side cast for a --wire.obs_dtype value: the identity
    for "f32" (DTR1/DTR2 frames), cast_rollout_obs_bf16 for "bf16" (DTR3).
    A bad value raises here, at boot."""
    if obs_dtype in ("f32", "float32"):
        return lambda r: r
    if obs_dtype in ("bf16", "bfloat16"):
        return cast_rollout_obs_bf16
    raise ValueError(f"wire.obs_dtype must be 'f32' or 'bf16', got {obs_dtype!r}")


def _obs_arrays(obs: F.Observation, obs_bf16: bool = False) -> List[np.ndarray]:
    fl = _bf16_words if obs_bf16 else _f32_values
    return [
        fl(obs.global_feats),
        fl(obs.hero_feats),
        fl(obs.unit_feats),
        np.ascontiguousarray(obs.unit_mask, np.uint8),
        np.ascontiguousarray(obs.target_mask, np.uint8),
        np.ascontiguousarray(obs.action_mask, np.uint8),
    ]


def serialize_rollout(r: Rollout) -> bytes:
    L = r.length
    H = r.initial_state[0].shape[-1]
    flags = _FLAG_AUX if r.aux is not None else 0
    obs_bf16 = rollout_obs_bf16(r)
    if obs_bf16:
        hdr = _HDR2.pack(_ROLLOUT_MAGIC3, r.version, L, H, flags, r.actor_id, r.episode_return, r.trace_id, r.birth_time)
        codes = _canonical_codes(flags, _WIRE_BF16)
        parts = [hdr, struct.pack("<B", len(codes)), codes]
    elif r.traced:
        parts = [_HDR2.pack(_ROLLOUT_MAGIC2, r.version, L, H, flags, r.actor_id, r.episode_return, r.trace_id, r.birth_time)]
    else:
        parts = [_HDR.pack(_ROLLOUT_MAGIC, r.version, L, H, flags, r.actor_id, r.episode_return)]
    arrays = _obs_arrays(r.obs, obs_bf16)
    arrays += [np.ascontiguousarray(a, np.int32) for a in r.actions]
    arrays += [
        np.ascontiguousarray(r.behavior_logp, np.float32),
        np.ascontiguousarray(r.behavior_value, np.float32),
        np.ascontiguousarray(r.rewards, np.float32),
        np.ascontiguousarray(r.dones, np.float32),
        np.ascontiguousarray(r.initial_state[0], np.float32),
        np.ascontiguousarray(r.initial_state[1], np.float32),
    ]
    if r.aux is not None:
        arrays += [np.ascontiguousarray(a, np.float32) for a in r.aux]
    parts.extend(a.tobytes() for a in arrays)
    return b"".join(parts)


def _expected_layout(L: int, H: int, flags: int, obs_bf16: bool = False):
    """(shape, numpy dtype) per array, in serialization order; bf16 obs as
    uint16 words."""
    T1 = L + 1
    fdt = np.uint16 if obs_bf16 else np.float32
    layout = [
        ((T1, F.GLOBAL_FEATURES), fdt),
        ((T1, F.HERO_FEATURES), fdt),
        ((T1, F.MAX_UNITS, F.UNIT_FEATURES), fdt),
        ((T1, F.MAX_UNITS), np.uint8),
        ((T1, F.MAX_UNITS), np.uint8),
        ((T1, F.N_ACTION_TYPES), np.uint8),
    ]
    layout += [((L,), np.int32)] * 4
    layout += [((L,), np.float32)] * 4
    layout += [((H,), np.float32)] * 2
    if flags & _FLAG_AUX:
        layout += [((L,), np.float32)] * 3
    return layout


def peek_rollout_trace(data: bytes) -> Tuple[int, float]:
    """(trace_id, birth_time) of a DTR2/DTR3 frame, (0, 0.0) for DTR1 or a
    frame too short to carry the extension."""
    if len(data) >= _HDR2.size and data[:4] in (_ROLLOUT_MAGIC2, _ROLLOUT_MAGIC3):
        trace_id, birth = struct.unpack_from("<Qd", data, _HDR.size)
        return trace_id, birth
    return 0, 0.0


def strip_rollout_trace(data: bytes) -> bytes:
    """DTR2 frame → the byte-identical DTR1 frame. DTR1 and DTR3 frames
    pass through as the same object (DTR3 arrays are re-encoded, and the
    native packer parses DTR3 whole)."""
    if len(data) >= _HDR2.size and data[:4] == _ROLLOUT_MAGIC2:
        return _ROLLOUT_MAGIC + data[4 : _HDR.size] + data[_HDR2.size :]
    return data


def stamp_rollout_trace(data: bytes, trace_id: int, birth_time: float) -> bytes:
    """DTR1 frame → the DTR2 frame carrying the given trace extension."""
    if len(data) < _HDR.size or data[:4] != _ROLLOUT_MAGIC:
        raise ValueError("can only stamp a DTR1 rollout frame")
    return _ROLLOUT_MAGIC2 + data[4 : _HDR.size] + struct.pack("<Qd", trace_id, birth_time) + data[_HDR.size :]


def deserialize_rollout(data: bytes) -> Rollout:
    trace_id, birth_time = 0, 0.0
    obs_bf16 = False
    if data[:4] == _ROLLOUT_MAGIC3:
        if check_dtr3_dtype_map(data) is not None:
            raise WireDtypeError("bad DTR3 dtype-map")
        _, version, L, H, flags, actor_id, ep_ret, trace_id, birth_time = _HDR2.unpack_from(data)
        n_map = data[_HDR2.size]
        obs_bf16 = data[_HDR2.size + 1] == _WIRE_BF16
        off = _HDR2.size + 1 + n_map
    elif len(data) >= _HDR2.size and data[:4] == _ROLLOUT_MAGIC2:
        _, version, L, H, flags, actor_id, ep_ret, trace_id, birth_time = _HDR2.unpack_from(data)
        off = _HDR2.size
    elif len(data) >= _HDR.size and data[:4] == _ROLLOUT_MAGIC:
        _, version, L, H, flags, actor_id, ep_ret = _HDR.unpack_from(data)
        off = _HDR.size
    else:
        raise ValueError("bad rollout frame")
    arrays = []
    for shape, dtype in _expected_layout(L, H, flags, obs_bf16):
        count = int(np.prod(shape))
        n = count * np.dtype(dtype).itemsize
        if off + n > len(data):
            raise ValueError("truncated rollout frame")
        arrays.append(np.frombuffer(data, dtype, count=count, offset=off).reshape(shape))
        off += n
    if off != len(data):
        raise ValueError("trailing bytes in rollout frame")
    floats = [bf16_tensor(a) for a in arrays[:3]] if obs_bf16 else arrays[:3]
    obs = F.Observation(
        global_feats=floats[0],
        hero_feats=floats[1],
        unit_feats=floats[2],
        unit_mask=arrays[3].astype(bool),
        target_mask=arrays[4].astype(bool),
        action_mask=arrays[5].astype(bool),
    )
    aux = RolloutAux(*arrays[16:19]) if flags & _FLAG_AUX else None
    return Rollout(
        obs=obs,
        actions=Action(*arrays[6:10]),
        behavior_logp=arrays[10],
        behavior_value=arrays[11],
        rewards=arrays[12],
        dones=arrays[13],
        initial_state=(arrays[14], arrays[15]),
        version=version,
        actor_id=actor_id,
        episode_return=ep_ret,
        aux=aux,
        trace_id=trace_id,
        birth_time=birth_time,
    )


# ------------------------------------------------------ single observation
#
# The serve wire's request body (serve/wire.py): one unbatched Observation
# as raw arrays in the rollout obs block's order (minus the time axis), the
# float leaves uniformly f32 or bf16 (the DTR3 codes).


def obs_wire_layout(obs_bf16: bool = False):
    """(shape, numpy dtype) per array of a single-observation frame, in
    serialization order; bf16 leaves as uint16 words."""
    fdt = np.uint16 if obs_bf16 else np.float32
    return [
        ((F.GLOBAL_FEATURES,), fdt),
        ((F.HERO_FEATURES,), fdt),
        ((F.MAX_UNITS, F.UNIT_FEATURES), fdt),
        ((F.MAX_UNITS,), np.uint8),
        ((F.MAX_UNITS,), np.uint8),
        ((F.N_ACTION_TYPES,), np.uint8),
    ]


def obs_wire_nbytes(obs_bf16: bool = False) -> int:
    return sum(int(np.prod(shape)) * np.dtype(dt).itemsize for shape, dt in obs_wire_layout(obs_bf16))


def serialize_obs(obs: F.Observation, obs_bf16: bool = False) -> bytes:
    """One unbatched Observation → wire bytes; with `obs_bf16` the f32
    leaves are rounded as `f32_to_bf16_bits` rounds (the reference's RNE)."""
    return b"".join(a.tobytes() for a in _obs_arrays(obs, obs_bf16))


def deserialize_obs(data: bytes, offset: int = 0, obs_bf16: bool = False) -> Tuple[F.Observation, int]:
    """(Observation, next offset). Float leaves come back in their wire
    dtype: numpy f32, or CPU `torch.bfloat16` tensors for bf16."""
    arrays = []
    for shape, dtype in obs_wire_layout(obs_bf16):
        count = int(np.prod(shape))
        n = count * np.dtype(dtype).itemsize
        if offset + n > len(data):
            raise ValueError("truncated observation frame")
        arrays.append(np.frombuffer(data, dtype, count=count, offset=offset).reshape(shape))
        offset += n
    floats = [bf16_tensor(a) for a in arrays[:3]] if obs_bf16 else arrays[:3]
    obs = F.Observation(
        global_feats=floats[0],
        hero_feats=floats[1],
        unit_feats=floats[2],
        unit_mask=arrays[3].astype(bool),
        target_mask=arrays[4].astype(bool),
        action_mask=arrays[5].astype(bool),
    )
    return obs, offset


# ----------------------------------------------------------------- weights

# --- DTB1: blocks of pre-packed batch rows (in-network assembly) ---------
#
# A fabric shard running --broker.assemble packs each admitted frame once
# into the learner's single-buffer row layout (parallel/fused_io.py
# RowLayout) and serves consumers whole blocks of rows with a per-row
# sidecar, so the learner's host side is a row concat.
#
# Block layout (little-endian):
#   magic  b'DTB1'
#   u8     fmt        (1)
#   u16    n_rows
#   u16    seq_len    (T; rows are padded to T steps, obs carry T+1)
#   u16    lstm_hidden
#   u8     flags      (bit0: aux targets; bit1: obs staged in bf16)
#   u32    row_bytes  (RowLayout.row_bytes)
#   u32    layout_crc (RowLayout.layout_crc; a consumer refuses any other)
#   n_rows x 52-byte sidecar: model_version, actor_id, episode_return,
#          trace_id, birth_time, priority, the fabric fence stamp
#          (boot/epoch/seq; boot 0 marks an un-enveloped row, always
#          admitted) and row_flags (bit0: the row's last step ended an
#          episode)
#   n_rows x row_bytes packed row payload.

BLOCK_MAGIC = b"DTB1"
_BLK = struct.Struct("<4sBHHHBII")
_BLK_SIDE = struct.Struct("<IIfQdfQIII")
_BLK_FLAG_AUX = 1
_BLK_FLAG_OBS_BF16 = 2
_BLK_ROW_DONE = 1
_BLK_FMT = 1


class BlockSpec(NamedTuple):
    """What two processes must agree on for a packed row to be portable
    between them. The consumer sends its spec in GET_BLOCK; the shard
    writes its own into every block header."""

    seq_len: int
    lstm_hidden: int
    with_aux: bool
    obs_bf16: bool
    row_bytes: int
    layout_crc: int


class AssembledRow(NamedTuple):
    """One pre-packed batch row and its sidecar: a DTR frame after the
    shard's assembly. `payload` is RowLayout.row_bytes long; the fence
    stamp is the FAB1 envelope the frame arrived under (boot 0 = none)."""

    payload: bytes
    version: int
    actor_id: int = 0
    episode_return: float = 0.0
    trace_id: int = 0
    birth_time: float = 0.0
    priority: float = 0.0
    boot: int = 0
    epoch: int = 0
    seq: int = 0
    last_done: bool = False


def block_spec_flags(spec: BlockSpec) -> int:
    """The u8 flags a BlockSpec encodes to (block header and GET_BLOCK)."""
    return (_BLK_FLAG_AUX if spec.with_aux else 0) | (_BLK_FLAG_OBS_BF16 if spec.obs_bf16 else 0)


def serialize_block(spec: BlockSpec, rows: List[AssembledRow]) -> bytes:
    parts = [_BLK.pack(BLOCK_MAGIC, _BLK_FMT, len(rows), spec.seq_len, spec.lstm_hidden, block_spec_flags(spec),
                       spec.row_bytes, spec.layout_crc)]
    for r in rows:
        parts.append(_BLK_SIDE.pack(
            r.version & 0xFFFFFFFF, r.actor_id & 0xFFFFFFFF, float(r.episode_return), r.trace_id & 0xFFFFFFFFFFFFFFFF,
            float(r.birth_time), float(r.priority), r.boot & 0xFFFFFFFFFFFFFFFF, r.epoch & 0xFFFFFFFF,
            r.seq & 0xFFFFFFFF, _BLK_ROW_DONE if r.last_done else 0,
        ))
    for r in rows:
        if len(r.payload) != spec.row_bytes:
            raise ValueError(f"block row payload {len(r.payload)}B != row_bytes {spec.row_bytes}")
        parts.append(bytes(r.payload))
    return b"".join(parts)


def peek_block_spec(data: bytes) -> Optional[BlockSpec]:
    """The BlockSpec of a DTB1 header, or None if `data` is not a block."""
    if len(data) < _BLK.size or data[:4] != BLOCK_MAGIC:
        return None
    _, fmt, _, T, H, flags, row_bytes, crc = _BLK.unpack_from(data)
    if fmt != _BLK_FMT:
        return None
    return BlockSpec(T, H, bool(flags & _BLK_FLAG_AUX), bool(flags & _BLK_FLAG_OBS_BF16), row_bytes, crc)


def deserialize_block(data: bytes) -> Tuple[BlockSpec, List[AssembledRow]]:
    spec = peek_block_spec(data)
    if spec is None:
        raise ValueError("not a DTB1 block")
    n = _BLK.unpack_from(data)[2]
    need = _BLK.size + n * _BLK_SIDE.size + n * spec.row_bytes
    if len(data) != need:
        raise ValueError(f"block length {len(data)} != expected {need} ({n} rows)")
    rows: List[AssembledRow] = []
    pay0 = _BLK.size + n * _BLK_SIDE.size
    for i in range(n):
        version, actor_id, ep_ret, trace_id, birth, prio, boot, epoch, seq, rflags = _BLK_SIDE.unpack_from(
            data, _BLK.size + i * _BLK_SIDE.size)
        off = pay0 + i * spec.row_bytes
        rows.append(AssembledRow(data[off : off + spec.row_bytes], version, actor_id, ep_ret, trace_id, birth, prio,
                                 boot, epoch, seq, bool(rflags & _BLK_ROW_DONE)))
    return spec, rows


# --- weights --------------------------------------------------------------

_DTYPES = {0: np.float32, 1: np.int32, 2: np.uint8}
_CODES = {np.dtype(dt): code for code, dt in _DTYPES.items()}


def _dtype_code(dt) -> int:
    code = _CODES.get(np.dtype(dt))
    if code is None:
        raise ValueError(f"unsupported weight dtype {dt}")
    return code


def serialize_weights(
    named_arrays: List[Tuple[str, np.ndarray]], version: int, boot_epoch: int = 0, legacy_dtw1: bool = False
) -> bytes:
    """A DTW2 frame of (name, array) pairs. `boot_epoch` identifies the
    publishing learner process; subscribers resync when it changes.
    `legacy_dtw1` emits the epoch-less DTW1 header for old subscribers."""
    if legacy_dtw1:
        parts = [struct.pack("<4sII", _WEIGHTS_MAGIC, version, len(named_arrays))]
    else:
        parts = [struct.pack("<4sIII", _WEIGHTS_MAGIC2, version, boot_epoch & 0xFFFFFFFF, len(named_arrays))]
    for name, arr in named_arrays:
        arr = np.ascontiguousarray(arr)
        nb = name.encode()
        parts.append(struct.pack("<H", len(nb)))
        parts.append(nb)
        parts.append(struct.pack("<B", arr.ndim))
        parts.append(struct.pack(f"<{arr.ndim}I", *arr.shape) if arr.ndim else b"")
        parts.append(struct.pack("<B", _dtype_code(arr.dtype)))
        parts.append(arr.tobytes())
    return b"".join(parts)


def deserialize_weights(data: bytes) -> Tuple[List[Tuple[str, np.ndarray]], int, int]:
    """Returns (named_arrays, version, boot_epoch); the arrays are
    read-only views into `data`."""
    magic = data[:4]
    if magic == _WEIGHTS_MAGIC2:
        _, version, boot_epoch, n = struct.unpack_from("<4sIII", data)
        off = struct.calcsize("<4sIII")
    elif magic == _WEIGHTS_MAGIC:
        _, version, n = struct.unpack_from("<4sII", data)
        boot_epoch = 0
        off = struct.calcsize("<4sII")
    else:
        raise ValueError("bad weights frame")
    out = []
    for _ in range(n):
        (name_len,) = struct.unpack_from("<H", data, off)
        off += 2
        name = data[off : off + name_len].decode()
        off += name_len
        (ndim,) = struct.unpack_from("<B", data, off)
        off += 1
        shape = struct.unpack_from(f"<{ndim}I", data, off) if ndim else ()
        off += 4 * ndim
        (code,) = struct.unpack_from("<B", data, off)
        off += 1
        dtype = _DTYPES[code]
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(data, dtype, count=count, offset=off).reshape(shape)
        off += count * np.dtype(dtype).itemsize
        out.append((name, arr))
    return out, version, boot_epoch
