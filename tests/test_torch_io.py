"""The port's byte formats against the reference: the host-side bf16 obs
cast, the single-buffer row layout (`layout_crc`, `row_bytes`, packed
bytes) and its device-side unpack, the single-buffer train step, and DTW2
weight frames."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dotaclient_tpu.config import LearnerConfig as JLearnerConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.models import policy as JP
from dotaclient_tpu.parallel import mesh as jmesh
from dotaclient_tpu.parallel import train_step as jts
from dotaclient_tpu.parallel.fused_io import FusedBatchIO as JFusedBatchIO
from dotaclient_tpu.parallel.fused_io import RowLayout as JRowLayout
from dotaclient_tpu.runtime.staging import cast_obs_to_compute_dtype as j_cast
from dotaclient_tpu.transport import serialize as jser
from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig
from dotaclient_tpu_torch.models import policy as P
from dotaclient_tpu_torch.ops import batch as tbatch
from dotaclient_tpu_torch.parallel import train_step as ts
from dotaclient_tpu_torch.parallel.fused_io import FusedBatchIO
from dotaclient_tpu_torch.runtime.staging import cast_obs_to_compute_dtype
from dotaclient_tpu_torch.transport import serialize as tser
from dotaclient_tpu_torch.transport.params import load_named, named_params

SMALL = dict(unit_embed_dim=32, lstm_hidden=32, mlp_hidden=32)


def _cfgs(B=6, T=5, stage_bf16=True, aux=False, **policy):
    kw = dict(policy, aux_heads=aux)
    jcfg = JLearnerConfig(batch_size=B, seq_len=T, stage_obs_compute_dtype=stage_bf16, policy=JPolicyConfig(**kw))
    tcfg = LearnerConfig(batch_size=B, seq_len=T, stage_obs_compute_dtype=stage_bf16, policy=PolicyConfig(**kw))
    return jcfg, tcfg


def _templates(jcfg, tcfg):
    p = tcfg.policy
    jt = j_cast(jcfg, jax.tree.map(np.asarray, jts._batch_template(jcfg)))
    tt = cast_obs_to_compute_dtype(tcfg, tbatch.zeros_train_batch(tcfg.batch_size, tcfg.seq_len, p.lstm_hidden, p.aux_heads))
    return jt, tt


def test_obs_cast_bytes_equal_ml_dtypes():
    """torch's f32 → bf16 cast rounds to nearest even like ml_dtypes,
    ties, subnormals, overflow to inf and NaN included."""
    r = np.random.RandomState(0)
    x = (r.randn(4096) * np.exp(r.uniform(-90, 90, 4096))).astype(np.float32)
    ties = np.array([0x3F808000, 0x3F818000, 0x00008000, 0x7F7FFFFF], np.uint32).view(np.float32)
    x = np.concatenate([x, ties, np.float32([np.nan, np.inf, -np.inf, -0.0, 3.4e38])])
    jcfg, tcfg = _cfgs(B=1, T=0)
    jb, tb = (jax.tree.map(np.asarray, jts._batch_template(jcfg)), tbatch.zeros_train_batch(1, 0, 128, False))
    jb = jb._replace(obs=jb.obs._replace(unit_feats=np.resize(x, jb.obs.unit_feats.shape)))
    tb = tb._replace(obs=tb.obs._replace(unit_feats=np.resize(x, tb.obs.unit_feats.shape)))
    with np.errstate(invalid="ignore", over="ignore"):
        want = j_cast(jcfg, jb).obs.unit_feats
    got = cast_obs_to_compute_dtype(tcfg, tb).obs.unit_feats
    assert want.dtype == ml_dtypes.bfloat16 and got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), want.view(np.uint16))
    # the bool/int leaves and the f32 scalars stay as they were
    assert cast_obs_to_compute_dtype(tcfg, tb).obs.unit_mask is tb.obs.unit_mask
    assert cast_obs_to_compute_dtype(dataclasses.replace(tcfg, stage_obs_compute_dtype=False), tb) is tb


@pytest.mark.parametrize("stage_bf16", [True, False], ids=["obs_bf16", "obs_f32"])
@pytest.mark.parametrize("aux", [False, True])
def test_row_layout_crc_and_row_bytes_equal_the_reference_at_flagship_shape(stage_bf16, aux):
    jcfg, tcfg = _cfgs(B=256, T=16, stage_bf16=stage_bf16, aux=aux)
    jt, tt = _templates(jcfg, tcfg)
    want = JRowLayout([(tuple(x.shape), x.dtype) for x in jax.tree.leaves(jt)])
    got = FusedBatchIO(tt, "cpu").layout
    assert (got.layout_crc, got.row_bytes, got.seg_off, got.group_cols) == (
        want.layout_crc, want.row_bytes, want.seg_off, want.group_cols)


@pytest.mark.parametrize("stage_bf16", [True, False], ids=["obs_bf16", "obs_f32"])
def test_pack_transfer_bytes_equal_the_reference_and_unpack_returns_the_batch(stage_bf16):
    jcfg, tcfg = _cfgs(stage_bf16=stage_bf16, aux=True, **SMALL)
    jt, tt = _templates(jcfg, tcfg)
    jio = JFusedBatchIO(jt, jmesh.make_mesh("dp=1", devices=jax.devices()[:1]))
    jio.single_mode = True
    io = FusedBatchIO(tt, "cpu")
    jb = jts.make_train_batch(jcfg, 5)
    tb = tbatch.make_train_batch(tcfg, 5)
    want = jio.pack_transfer(j_cast(jcfg, jb))
    buf = io.pack_transfer(cast_obs_to_compute_dtype(tcfg, tb))
    assert buf.dtype == torch.uint8 and tuple(buf.shape) == want.shape == (6, io.row_bytes)
    assert np.array_equal(buf.numpy(), want)
    # device side (here the CPU): views, leaf for leaf
    out = io.unpack_single(io.to_device(buf))
    cast = cast_obs_to_compute_dtype(tcfg, tb)
    got_leaves, want_leaves = tbatch.tree_flatten(out)[0], tbatch.tree_flatten(cast)[0]
    assert len(got_leaves) == len(want_leaves) == len(jax.tree.leaves(jb))
    for g, w in zip(got_leaves, want_leaves):
        w = w if isinstance(w, torch.Tensor) else torch.from_numpy(np.asarray(w))
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
    assert out.obs.unit_mask.dtype == torch.bool and out.actions.type.dtype == torch.int32


def test_pack_transfer_refuses_another_layout():
    _, tcfg = _cfgs(**SMALL)
    io = FusedBatchIO(_templates(*_cfgs(**SMALL))[1], "cpu")
    tb = cast_obs_to_compute_dtype(tcfg, tbatch.make_train_batch(tcfg, 0))
    with pytest.raises(ValueError, match="rows"):
        io.pack_transfer(tbatch.tree_map(lambda x: x[:5], tb))
    with pytest.raises(ValueError, match="dtypes"):
        io.pack_transfer(tbatch.make_train_batch(tcfg, 0))  # obs still f32
    with pytest.raises(ValueError, match="structure"):
        io.pack_transfer(tb._replace(behavior_staleness=np.zeros(6, np.float32)))
    buf, views = io.alloc_views_single()
    assert not buf.is_pinned() and not buf.numpy()[:, : io.layout.seg_off["u8"]].any()
    assert views.obs.action_mask.all(-1).sum() == 0 and views.obs.action_mask[..., 0].all()  # NOOP-legal padding


def test_single_buffer_step_equals_the_tree_step():
    """Same start, same batch: through the u8 buffer (obs staged in bf16,
    int32 actions) and through as_tensors (f32 obs, int64 actions) the step
    computes the same bits, since the policy's first op is the bf16 cast."""
    _, tcfg = _cfgs(**SMALL)
    step, io = ts.build_single_train_step(tcfg, "cpu")
    tree_step = ts.build_train_step(tcfg, "cpu")
    tb = tbatch.make_train_batch(tcfg, 9)
    s1, s2 = ts.init_train_state(tcfg, "cpu"), ts.init_train_state(tcfg, "cpu")
    s1, m1 = step(s1, io.to_device(io.pack_transfer(cast_obs_to_compute_dtype(tcfg, tb))))
    s2, m2 = tree_step(s2, tbatch.as_tensors(tb, "cpu"))
    assert s1.step == s2.step == 1 and set(m1) == set(m2)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(named_params(s1.net), named_params(s2.net)))


def test_dtw2_frame_is_byte_identical_and_loads_into_the_reference_net():
    jcfg, tcfg = _cfgs(**SMALL, dtype="float32")
    state = ts.init_train_state(tcfg, "cpu")
    state = state._replace(step=7)
    frame = ts.weights_frame(state, boot_epoch=0xDEADBEEF)
    named = named_params(state.net)
    assert frame == jser.serialize_weights(named, version=7, boot_epoch=0xDEADBEEF)
    got, version, epoch = jser.deserialize_weights(frame)
    assert (version, epoch) == (7, 0xDEADBEEF)
    template = JP.init_params(jcfg.policy, jax.random.PRNGKey(0))
    params = jser.unflatten_params(got, template)
    obs = jts.make_train_batch(dataclasses.replace(jcfg, batch_size=3, seq_len=2), 1).obs
    carry = (np.zeros((3, 32), np.float32), np.zeros((3, 32), np.float32))
    _, jout = JP.PolicyNet(jcfg.policy).apply(params, tuple(map(jnp.asarray, carry)), jax.tree.map(jnp.asarray, obs), unroll=True)
    with torch.no_grad():
        _, tout = state.net(tbatch.as_tensors(carry, "cpu"), tbatch.as_tensors(obs, "cpu"), unroll=True)
    np.testing.assert_allclose(tout.value.numpy(), np.asarray(jout.value), rtol=1e-6, atol=1e-5)
    # and the port reads the reference's frames, DTW1 included
    back, v, e = tser.deserialize_weights(jser.serialize_weights(named, version=3, legacy_dtw1=True))
    assert (v, e) == (3, 0) and all(n == m and np.array_equal(a, b) for (n, a), (m, b) in zip(back, named))
    fresh = load_named(P.PolicyNet(tcfg.policy, device="cpu"), tser.deserialize_weights(frame)[0])
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(named_params(fresh), named))
    with pytest.raises(ValueError, match="bad weights frame"):
        tser.deserialize_weights(b"XXXX" + frame[4:])
