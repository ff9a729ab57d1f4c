"""jax's default random stream, in numpy integer arithmetic: the
threefry2x32 hash, `jax.random.split`, 32-bit random bits and the f32
uniforms `jax.random.gumbel` draws, as jax computes them with
`jax_threefry_partitionable=True` (the default of the jax releases this
is held against).

The serve wire carries each client's jax PRNGKey (u32[2]); the server
advances it and samples with it exactly as the reference's jit step does,
so a client's stream stays in step whichever side served it. Keys and
bits are integers and come out bitwise jax's; uniforms are exact bit
manipulations of them. Everything here runs on the host: a serving row
needs a few hundred 32-bit words.

A key array has a trailing axis of 2 (the key's two words); leading axes
batch independent keys, so a whole tick's rows are hashed in one pass
and each row's words are those of its key alone.
"""

from __future__ import annotations

import numpy as np

# The jax_threefry_partitionable setting these functions implement.
PARTITIONABLE = True

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
TINY_F32 = np.finfo(np.float32).tiny


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counts (x1, x2) under key
    (k1, k2); uint32 arrays that broadcast together → (y1, y2)."""
    k1, k2, x1, x2 = (np.asarray(a, np.uint32) for a in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    with np.errstate(over="ignore"):
        a, b = x1 + ks[0], x2 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                a = a + b
                b = (b << np.uint32(r)) | (b >> np.uint32(32 - r))
                b = a ^ b
            a = a + ks[(i + 1) % 3]
            b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def _hash_iota(keys, n: int):
    """threefry of the 64-bit counts 0..n-1 (high word 0) under each key:
    (y1, y2), each [..., n]."""
    keys = np.asarray(keys, np.uint32)
    if n >= 2**32:
        raise ValueError("more than 2**32 counts")
    lo = np.arange(n, dtype=np.uint32)
    return threefry2x32(keys[..., 0:1], keys[..., 1:2], np.zeros(n, np.uint32), lo)


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` with 64-bit mode off (jax's default):
    the seed's low 32 bits in the second word, 0 in the first."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def split(keys, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)` for every key: [..., 2] → [..., num, 2]."""
    y1, y2 = _hash_iota(keys, num)
    return np.stack([y1, y2], axis=-1)


def random_bits(keys, shape) -> np.ndarray:
    """32-bit `jax.random.bits(key, shape)` for every key: [..., 2] →
    [..., *shape] uint32 (the two hash words xor-ed, over the row-major
    index of `shape`)."""
    shape = tuple(int(d) for d in shape)
    y1, y2 = _hash_iota(keys, int(np.prod(shape, dtype=np.int64)))
    bits = y1 ^ y2
    return bits.reshape(bits.shape[:-1] + shape)


def uniform(keys, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """f32 `jax.random.uniform(key, shape, minval=, maxval=)` for every
    key: the top 23 bits as the mantissa of a float in [1, 2), minus 1,
    scaled and shifted in f32, floored at minval."""
    bits = random_bits(keys, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def gumbel_uniform(keys, shape) -> np.ndarray:
    """The uniforms `jax.random.gumbel(key, shape)` (mode "low") draws:
    uniform on [tiny, 1). Its noise is -log(-log(u))."""
    return uniform(keys, shape, TINY_F32, 1.0)
