"""The grouped four-buffer transfer and the per-leaf tree path against the
JAX package: group buffers byte for byte the reference's
`FusedBatchIO.pack`, the alloc_views → fill → unpack round trip bitwise,
and `build_fused_train_step` / the tree step against the reference's fused
and tree steps on a one-device CPU mesh (f32 metrics 1e-5, bf16 2e-3;
params and Adam moments within test_torch_train's bounds)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.parallel import mesh as jmesh
from dotaclient_tpu.parallel import train_step as jts
from dotaclient_tpu.parallel.fused_io import FusedBatchIO as JFusedBatchIO
from dotaclient_tpu.runtime.staging import cast_obs_to_compute_dtype as j_cast
from dotaclient_tpu_torch.ops import batch as tbatch
from dotaclient_tpu_torch.ops.batch import BatchLayoutError, tree_flatten
from dotaclient_tpu_torch.parallel import train_step as ts
from dotaclient_tpu_torch.parallel.fused_io import FusedBatchIO, TreeBatchIO
from dotaclient_tpu_torch.runtime.staging import cast_obs_to_compute_dtype
from test_torch_io import _cfgs, _templates
from test_torch_train import METRIC_TOL, _carry_state, _compare_metrics, _compare_states
from test_torch_train import _configs as _train_configs

SMALL = dict(unit_embed_dim=32, lstm_hidden=32, mlp_hidden=32)


def _jio(jcfg, jt):
    return JFusedBatchIO(jt, jmesh.make_mesh("dp=1", devices=jax.devices()[:1]))


def _as_bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


@pytest.mark.parametrize("stage_bf16,aux", [(True, False), (True, True), (False, True)])
def test_group_buffers_bytes_equal_the_reference_pack(stage_bf16, aux):
    jcfg, tcfg = _cfgs(stage_bf16=stage_bf16, aux=aux, **SMALL)
    jt, tt = _templates(jcfg, tcfg)
    jio, io = _jio(jcfg, jt), FusedBatchIO(tt, "cpu", single=False)
    assert io.layout.group_cols == jio.group_cols and not io.single_mode
    jb = jts.make_train_batch(jcfg, 3)
    want = jio.pack(j_cast(jcfg, jb))
    # pack_transfer follows the mode: the group dict here
    got = io.pack_transfer(cast_obs_to_compute_dtype(tcfg, tbatch.make_train_batch(tcfg, 3)))
    assert sorted(got) == sorted(want)
    for key in want:
        assert np.array_equal(_as_bytes(got[key]), _as_bytes(want[key])), key


@pytest.mark.parametrize("stage_bf16,aux", [(True, True), (False, False)])
def test_alloc_fill_unpack_roundtrip_bitwise(stage_bf16, aux):
    """Staging packs into the views of alloc_views; the device unpack of
    those buffers is the batch, leaf for leaf and bit for bit, with bool
    leaves back as bool and the reference's int32 actions."""
    jcfg, tcfg = _cfgs(stage_bf16=stage_bf16, aux=aux, **SMALL)
    jt, tt = _templates(jcfg, tcfg)
    io = FusedBatchIO(tt, "cpu", single=False)
    groups, views = io.alloc_views()
    assert all(not t.any() for k, t in groups.items() if k != "u8")
    assert views.obs.action_mask[..., 0].all()  # NOOP-legal padding rows
    tb = cast_obs_to_compute_dtype(tcfg, tbatch.make_train_batch(tcfg, 7))
    for v, leaf in zip(tree_flatten(views)[0], tree_flatten(tb)[0]):
        v[...] = leaf.view(torch.int16).numpy().view(np.uint16) if isinstance(leaf, torch.Tensor) else leaf
    payload, ready = io.transfer(groups)
    out = io.unpack(io.consume(payload, ready))
    for g, w in zip(tree_flatten(out)[0], tree_flatten(tb)[0]):
        w = w if isinstance(w, torch.Tensor) else torch.from_numpy(np.asarray(w))
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
    # the same batch through the single buffer unpacks to the same leaves
    single = FusedBatchIO(tt, "cpu")
    for a, b in zip(tree_flatten(single.unpack_single(single.pack_transfer(tb)))[0], tree_flatten(out)[0]):
        assert torch.equal(a, b)
    # the reference's segment alignment: every group's bytes start at a multiple of 4
    assert all(off % 4 == 0 for off in io.layout.seg_off.values())


def test_group_ring_slot_reset_and_pack_refusals():
    jcfg, tcfg = _cfgs(**SMALL)
    io = FusedBatchIO(_templates(jcfg, tcfg)[1], "cpu", single=False)
    ring = io.make_ring(2)
    slot = ring.acquire(timeout=1)
    assert isinstance(slot.payload, dict) and ring.occupancy == 1
    slot.payload["f32"].fill_(3.0)
    slot.batch.obs.action_mask[:] = True
    slot.release()
    slot.release()  # idempotent
    again = [ring.acquire(timeout=1) for _ in range(2)]
    assert ring.acquire(timeout=0.05) is None
    for s in again:
        assert not s.payload["f32"].any() and not s.batch.obs.action_mask[..., 1:].any()
    tb = cast_obs_to_compute_dtype(tcfg, tbatch.make_train_batch(tcfg, 0))
    with pytest.raises(BatchLayoutError, match="rows"):
        io.pack_transfer(tbatch.tree_map(lambda x: x[:5], tb))
    with pytest.raises(BatchLayoutError, match="structure"):
        io.pack_transfer(tb._replace(behavior_staleness=np.zeros(6, np.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_and_tree_steps_match_the_reference_s(dtype):
    """Three updates through build_fused_train_step (group buffers) and
    through the tree step (TreeBatchIO: one copy per leaf) from one
    carried state, against the reference's fused step on the same batches;
    the port's two paths compute the same bits."""
    jcfg, tcfg = _train_configs(dtype)
    mesh = jmesh.make_mesh("dp=1", devices=jax.devices()[:1])
    jstep, _, jio = jts.build_fused_train_step(jcfg, mesh)
    jstate = jts.init_train_state(jcfg, jax.random.PRNGKey(2))
    fused, io = ts.build_fused_train_step(tcfg, "cpu")
    tree, tio = ts.build_train_step(tcfg, "cpu"), TreeBatchIO("cpu")
    s_fused, s_tree = _carry_state(jstate, tcfg), _carry_state(jstate, tcfg)
    assert not io.single_mode
    for i in range(3):
        jb = jts.make_train_batch(jcfg, 20 + i)
        jstate, jm = jstep(jstate, jax.device_put(jio.pack(j_cast(jcfg, jb)), jio.shardings))
        host = cast_obs_to_compute_dtype(tcfg, tbatch.make_train_batch(tcfg, 20 + i))
        s_fused, m_fused = fused(s_fused, io.consume(*io.transfer(io.pack_transfer(host))))
        s_tree, m_tree = tree(s_tree, tio.consume(*tio.transfer(host)))
        _compare_metrics(m_fused, jm, METRIC_TOL[dtype])
        assert all(torch.equal(m_fused[k], m_tree[k]) for k in m_fused)
    _compare_states(s_fused, jstate, dtype, 3, "fused after 3 steps:")
    for a, b in zip(s_fused.net.parameters(), s_tree.net.parameters()):
        assert torch.equal(a, b)


def test_tree_transfer_keeps_each_leaf_s_dtype():
    jcfg, tcfg = _cfgs(aux=True, **SMALL)
    tcfg = dataclasses.replace(tcfg, replay=dataclasses.replace(tcfg.replay, enabled=True))
    host = ts.batch_template(tcfg)._replace(behavior_staleness=np.arange(6, dtype=np.float32))
    out = TreeBatchIO("cpu").consume(*TreeBatchIO("cpu").transfer(host))
    assert out.obs.global_feats.dtype == torch.bfloat16 and out.obs.unit_mask.dtype == torch.bool
    assert out.actions.type.dtype == torch.int32 and torch.equal(out.behavior_staleness, torch.arange(6.0))
    assert len(tree_flatten(out)[0]) == len(tree_flatten(jts._batch_template(
        dataclasses.replace(jcfg, replay=dataclasses.replace(jcfg.replay, enabled=True))))[0])
