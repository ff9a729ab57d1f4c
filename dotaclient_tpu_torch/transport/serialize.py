"""DTW2 weight frames (own copy of the weights part of
dotaclient_tpu/transport/serialize.py): what the learner publishes to
actors and serve replicas after each update.

Frame: header <4s magic "DTW2", u32 version, u32 boot_epoch, u32 n>, then
per array <u16 name length, name, u8 ndim, u32 × ndim shape, u8 dtype
code, raw little-endian bytes>. Readers also accept the legacy DTW1
header (no boot_epoch, read as 0). A frame the port writes is byte for
byte the reference's, so a JAX fleet can load it.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

_WEIGHTS_MAGIC = b"DTW1"  # legacy: no boot_epoch (read-compat only)
_WEIGHTS_MAGIC2 = b"DTW2"

_DTYPES = {0: np.float32, 1: np.int32, 2: np.uint8}
_CODES = {np.dtype(dt): code for code, dt in _DTYPES.items()}


def _dtype_code(dt) -> int:
    code = _CODES.get(np.dtype(dt))
    if code is None:
        raise ValueError(f"unsupported weight dtype {dt}")
    return code


def serialize_weights(named_arrays: List[Tuple[str, np.ndarray]], version: int, boot_epoch: int = 0) -> bytes:
    """A DTW2 frame of (name, array) pairs. `boot_epoch` identifies the
    publishing learner process; subscribers resync when it changes."""
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
