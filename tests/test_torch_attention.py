"""The port's causal attention (ops/attention.py, ops/ring_attention.py)
against the JAX reference on the same numpy inputs: RoPE, dense and
blockwise attention with KV-cache positions (empty slots, a fully masked
row, a ragged last key block), and the local dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.ops import attention as JA
from dotaclient_tpu.ops import ring_attention as JRA
from dotaclient_tpu_torch.ops import attention as A
from dotaclient_tpu_torch.ops import ring_attention as RA
from dotaclient_tpu_torch.parallel.dist import Group

B, N, DH = 2, 2, 8
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: the same f32 arithmetic, sums in another order (a few ulp). bf16:
# inputs are bf16 on both sides, scores and the softmax f32 on both
# sides, so the outputs differ by the f32 sums' last bits, which can flip
# one bf16 rounding of an output (2^-8 relative, values here below 4).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv(seed, tq, tk, dtype):
    r = np.random.RandomState(seed)
    arrs = [r.randn(B, t, N, DH).astype(np.float32) for t in (tq, tk, tk)]
    jdt, tdt = DTYPES[dtype]
    # round through the dtype once, so both sides start from the same values
    arrs = [np.array(jnp.asarray(a).astype(jdt).astype(jnp.float32)) for a in arrs]
    return [jnp.asarray(a).astype(jdt) for a in arrs], [torch.from_numpy(a).to(tdt) for a in arrs]


def _close(ref, out, tol):
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jnp.asarray(ref).astype(jnp.float32)), rtol=0, atol=tol)


def _cache_positions():
    """Queries at positions 5 and 6 over an 8-slot cache: row 0 holds
    0..5 and two empty slots, row 1 holds a wrapped window; query row 1's
    first position (1) sees no key at all (a fully masked row)."""
    q_pos = np.array([[5, 6], [1, 9]], np.int32)
    k_pos = np.array([[0, 1, 2, 3, 4, 5, JA.EMPTY_POS, JA.EMPTY_POS], [8, 9, 2, 3, 4, 5, 6, 7]], np.int32)
    return q_pos, k_pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype):
    (jx, _, _), (tx, _, _) = _qkv(0, 5, 1, dtype)
    pos = np.array([[0, 3, 17, 400, JA.EMPTY_POS], [7, 1, 2, 9, 1000]], np.int32)
    ref = JA.rope(jx, jnp.asarray(pos))
    out = A.rope(tx, torch.from_numpy(pos))
    assert out.dtype == tx.dtype and out.shape == tx.shape
    _close(ref, out, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_attention_matches_jax_on_cache_positions(dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 2, 8, dtype)
    q_pos, k_pos = _cache_positions()
    ref = JA.causal_attention(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(k_pos))
    out = A.causal_attention(tq, tk, tv, torch.from_numpy(q_pos), torch.from_numpy(k_pos))
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _close(ref, out, TOL[dtype])
    assert torch.isfinite(out.float()).all() and not out[1, 0].any()  # the fully masked row is zeros


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kv_block", [3, 4, 7])
def test_blockwise_matches_jax_and_dense(dtype, kv_block):
    """T=7 keys in blocks of 3 (ragged last block of 1), 4 (of 3) and 7
    (one block)."""
    T = 7
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, T, T, dtype)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    ref = JA.blockwise_causal_attention(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos), kv_block)
    tpos = torch.from_numpy(pos)
    out = A.blockwise_causal_attention(tq, tk, tv, tpos, tpos, kv_block)
    _close(ref, out, TOL[dtype])
    _close(JA.causal_attention(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos)), A.causal_attention(tq, tk, tv, tpos, tpos),
           TOL[dtype])
    if dtype == "float32":
        # the streaming softmax equals the one-block softmax up to f32 sums
        torch.testing.assert_close(out, A.causal_attention(tq, tk, tv, tpos, tpos), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kv_block", [0, 3, 8])
def test_attend_dispatch_matches_jax(kv_block):
    """kv_block 0: dense; 3 < Tk=8: blockwise; 8 = Tk: dense."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(3, 8, 8, "float32")
    pos = np.tile(np.arange(8, dtype=np.int32), (B, 1))
    ref = JRA.attend(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos), kv_block=kv_block)
    tpos = torch.from_numpy(pos)
    _close(ref, RA.attend(tq, tk, tv, tpos, tpos, kv_block=kv_block), TOL["float32"])


def test_attend_refuses_sequence_parallelism():
    """Over a group the dispatch takes the reference's modes and raises its
    ValueError for any other (the collectives: tests/test_torch_model_parallel.py).
    A group of one runs the pattern with no collective: local attention."""
    (_, (tq, tk, tv)) = _qkv(4, 6, 6, "float32")
    pos = torch.arange(6, dtype=torch.int32).expand(B, 6)
    one = Group((0,), 0)
    with pytest.raises(ValueError, match="unknown sp_mode 'bogus'"):
        RA.attend(tq, tk, tv, pos, pos, one, "bogus")
    dense = A.causal_attention(tq, tk, tv, pos, pos)
    for mode in RA.SP_MODES:
        assert torch.allclose(RA.attend(tq, tk, tv, pos, pos, one, mode, kv_block=4), dense, rtol=1e-6, atol=1e-6)


def test_attention_gradients_match_between_dense_and_blockwise():
    """The blockwise loop differentiates like the dense block (autograd
    through the carries)."""
    (_, (tq, tk, tv)) = _qkv(5, 6, 6, "float32")
    pos = torch.arange(6, dtype=torch.int32).expand(B, 6)
    grads = []
    for fn in (lambda *a: A.causal_attention(*a, pos, pos), lambda *a: A.blockwise_causal_attention(*a, pos, pos, 4)):
        leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
        (fn(*leaves) ** 2).sum().backward()
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_scores_run_without_tf32_and_the_flag_is_restored():
    """The score products run with TF32 off; a process that turned it on
    finds it on again after the call."""
    (_, (tq, tk, tv)) = _qkv(6, 3, 3, "float32")
    pos = torch.arange(3, dtype=torch.int32).expand(B, 3)
    seen = []
    einsum = torch.einsum

    def spy(*a, **kw):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return einsum(*a, **kw)

    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            torch.einsum = spy
            try:
                A.causal_attention(tq, tk, tv, pos, pos)
            finally:
                torch.einsum = einsum
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [False] * 4
