"""native.PackPlan in the port against the reference's: a prebuilt plan's
bytes (packing its own frames, or its rows from one marshal of the whole
batch) equal the port's per-call pack_frames and the reference's PackPlan
at 1 / 2 / 4 row shards, on the f32 and bf16 wires (the obs staged f32 or
bf16), with aux on and off; its errors (a malformed frame names its
absolute batch row, a wrong frame count is a layout error) are the
reference's; the staging ring's sharded pack (one plan per slot and
shard) stages the per-call pack's bytes; and RowAssembler's one-row plan
assembles the reference's row bytes."""

import dataclasses
import time

import ml_dtypes
import numpy as np
import pytest

from dotaclient_tpu import native as jnative
from dotaclient_tpu.ops.batch import BatchLayoutError as JBatchLayoutError
from dotaclient_tpu.ops.batch import zeros_train_batch as jzeros
from dotaclient_tpu.transport import serialize as jser
from dotaclient_tpu.transport.assemble import RowAssembler as JRowAssembler
from dotaclient_tpu_torch import native
from dotaclient_tpu_torch.ops.batch import BatchLayoutError, zeros_train_batch
from dotaclient_tpu_torch.runtime import staging as tstaging
from dotaclient_tpu_torch.runtime.staging import shard_rows
from dotaclient_tpu_torch.transport import memory as tmem
from dotaclient_tpu_torch.transport.assemble import RowAssembler
from test_torch_staging import B, POL, T, _cfgs, _io_pair
from test_transport import make_rollout

H = POL["lstm_hidden"]


def _frames(aux: bool, wire: str, n: int = B, seed: int = 500):
    """n frames of lengths T, 2, 1, T-1 (padded rows), every third one
    with the other aux setting, on the f32 (DTR1) or bf16 (DTR3) wire or
    both in turn ("mixed")."""
    out = []
    for i in range(n):
        r = make_rollout(L=(T, 2, 1, T - 1)[i % 4], H=H, version=3, actor_id=i, aux=aux if i % 3 else not aux,
                         seed=seed + i)
        bf16 = wire == "bf16" or (wire == "mixed" and i % 2)
        out.append(jser.serialize_rollout(jser.cast_rollout_obs_bf16(r) if bf16 else r))
    return out


def _port_out(aux: bool, obs_bf16: bool):
    out = zeros_train_batch(B, T, H, aux)
    if obs_bf16:  # the packer writes bf16 obs as uint16 words
        out = out._replace(obs=out.obs._replace(**{
            f: np.zeros(v.shape, np.uint16) for f, v in out.obs._asdict().items() if v.dtype == np.float32}))
    return out


def _bytes(batch, mod):
    """The bytes of the packer's 20 outputs (C-ABI order; aux slots
    absent without aux)."""
    return [np.ascontiguousarray(a).view(np.uint8).tobytes() for a in mod._ordered_out_leaves(batch) if a is not None]


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("obs_bf16", [False, True], ids=["obs_f32", "obs_bf16"])
@pytest.mark.parametrize("aux", [False, True], ids=["no_aux", "aux"])
def test_plan_bytes_are_pack_frames_and_the_references(shards, wire, obs_bf16, aux):
    frames = _frames(aux, wire)
    lib, jlib = native.load_packer(), jnative.load_packer()
    per_call, planned, rows = _port_out(aux, obs_bf16), _port_out(aux, obs_bf16), _port_out(aux, obs_bf16)
    ref = jzeros(B, T, H, aux, obs_dtype=ml_dtypes.bfloat16 if obs_bf16 else None)
    ptrs, lens = native.marshal_frames(frames)  # the whole batch's, once
    for off, cnt in shard_rows(B, shards):
        part = frames[off : off + cnt]
        native.pack_frames(lib, part, T, H, aux, obs_bf16, per_call, row_offset=off, total_rows=B)
        plan = native.PackPlan(lib, planned, cnt, T, H, aux, obs_bf16, off, B)
        plan.pack(part)
        plan.pack(part)  # a plan packs again into the same rows: the same bytes
        native.PackPlan(lib, rows, cnt, T, H, aux, obs_bf16, off, B).pack_rows(ptrs, lens)
        jnative.PackPlan(jlib, ref, cnt, T, H, aux, obs_bf16, off, B).pack(part)
    assert _bytes(planned, native) == _bytes(per_call, native) == _bytes(rows, native)
    assert _bytes(planned, native) == _bytes(ref, jnative)


def test_a_malformed_frame_names_its_absolute_row_as_the_references():
    frames = _frames(False, "f32")
    frames[6] = frames[6][:100]  # truncated: row 6 of the batch, 2 of the plan's shard
    lib, jlib = native.load_packer(), jnative.load_packer()
    with pytest.raises(ValueError) as mine:
        native.PackPlan(lib, _port_out(False, True), 4, T, H, False, True, 4, B).pack(frames[4:8])
    with pytest.raises(ValueError) as theirs:
        jnative.PackPlan(jlib, jzeros(B, T, H, False, obs_dtype=ml_dtypes.bfloat16), 4, T, H, False, True, 4,
                         B).pack(frames[4:8])
    with pytest.raises(ValueError) as rows:
        native.PackPlan(lib, _port_out(False, True), 4, T, H, False, True, 4, B).pack_rows(*native.marshal_frames(frames))
    assert str(mine.value) == str(theirs.value) == str(rows.value) == "native packer rejected frame 6"


@pytest.mark.parametrize("n", [3, 5])
def test_a_wrong_frame_count_is_a_layout_error_as_the_references(n):
    frames = _frames(False, "f32")
    lib, jlib = native.load_packer(), jnative.load_packer()
    with pytest.raises(BatchLayoutError, match="plan packs 4 frames"):
        native.PackPlan(lib, _port_out(False, True), 4, T, H, False, True, 0, B).pack(frames[:n])
    with pytest.raises(JBatchLayoutError, match="plan packs 4 frames"):
        jnative.PackPlan(jlib, jzeros(B, T, H, False, obs_dtype=ml_dtypes.bfloat16), 4, T, H, False, True, 0,
                         B).pack(frames[:n])


def test_a_plan_refuses_rows_outside_its_batch_and_a_mismatched_out():
    lib = native.load_packer()
    with pytest.raises(BatchLayoutError, match="do not fit"):
        native.PackPlan(lib, _port_out(False, True), 4, T, H, False, True, 6, B)
    with pytest.raises(BatchLayoutError, match="dtype"):  # an f32 obs out under obs_bf16
        native.PackPlan(lib, _port_out(False, False), 4, T, H, False, True, 0, B)
    with pytest.raises(TypeError):
        native.PackPlan(lib, _port_out(False, True), 1, T, H, False, True, 0, B).pack([bytearray(_frames(False, "f32")[0])])
    with pytest.raises(BatchLayoutError, match=r"rows \[4, 8\) of a batch of 6"):
        native.PackPlan(lib, _port_out(False, True), 4, T, H, False, True, 4, B).pack_rows(
            *native.marshal_frames(_frames(False, "f32")[:6]))


def _ring_buffers(tcfg, tio, frames, workers: int, name: str, runs: int = 1):
    """Three packed ring-slot buffers of the port's staging at `workers` per
    run, the frames published anew before each (a restart after stop()
    builds a new ring, as each Learner.run does), and the plans it kept per
    slot in its last run."""
    tmem.reset(name)
    staging = dataclasses.replace(tcfg.staging, pack_workers=workers, transfer_depth=2)
    s = tstaging.StagingBuffer(dataclasses.replace(tcfg, staging=staging), tmem.MemoryBroker(name),
                               version_fn=lambda: 3, fused_io=tio)
    bufs = []
    for _ in range(runs):
        for f in frames:
            tmem.MemoryBroker(name).publish_experience(f)
        s.start()
        try:
            for _ in range(3):
                batch, buf = s.get_batch_groups(timeout=20.0)
                assert batch is not None
                bufs.append(np.asarray(buf).copy())
                if s.last_batch_lease is not None:  # a ring slot (workers > 1) goes back to the packers
                    # graftlint: disable=LIF001(no device copy of this slot: its bytes were copied on the host above)
                    s.last_batch_lease.release()
        finally:
            s.stop()
    return bufs, {k: [(p.row_offset, p.n) for p in v] for k, v in s._slot_plans.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("workers", [2, 3, 4])
def test_the_staging_ring_packs_with_plans_the_per_call_bytes(dtype, workers):
    jcfg, tcfg = _cfgs(dtype, True)
    _, tio = _io_pair(jcfg, tcfg)
    frames = _frames(True, "mixed", n=3 * B)
    one, no_plans = _ring_buffers(tcfg, tio, frames, 1, f"pp_w1_{dtype}")
    sharded, plans = _ring_buffers(tcfg, tio, frames, workers, f"pp_w{workers}_{dtype}")
    assert no_plans == {}  # the single-thread path packs per call
    assert set(plans) == {0, 1}  # one plan list per ring slot ...
    assert all(v == list(shard_rows(B, workers)) for v in plans.values())  # ... one plan per shard
    for a, b in zip(one, sharded):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("workers", [2, 4])
def test_a_restarted_staging_packs_into_its_new_ring(workers):
    """start / stop / start: the second run's ring is new, so plans kept
    from the first would pack into the old ring's buffers and leave the
    new slots untouched; every slot of both runs holds the per-call
    pack's bytes."""
    jcfg, tcfg = _cfgs("float32", True)
    _, tio = _io_pair(jcfg, tcfg)
    frames = _frames(True, "mixed", n=3 * B)
    one, _ = _ring_buffers(tcfg, tio, frames, 1, "pp_restart_w1", runs=2)
    sharded, _ = _ring_buffers(tcfg, tio, frames, workers, f"pp_restart_w{workers}", runs=2)
    assert len(one) == len(sharded) == 6
    for a, b in zip(one, sharded):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("obs_bf16", [False, True], ids=["obs_f32", "obs_bf16"])
@pytest.mark.parametrize("aux", [False, True], ids=["no_aux", "aux"])
def test_row_assembler_rows_are_the_references(obs_bf16, aux):
    mine, theirs = RowAssembler(T, H, aux, obs_bf16), JRowAssembler(T, H, aux, obs_bf16)
    assert mine.native_active and theirs.native_active
    for f in _frames(aux, "mixed", n=12):
        a, b = mine.assemble(f), theirs.assemble(f)
        assert a.payload == b.payload
        assert (a.version, a.actor_id, a.episode_return, a.last_done) == (b.version, b.actor_id, b.episode_return,
                                                                         b.last_done)


def test_a_plan_pays_the_glue_once():
    """The plan's per-call work is the frame pointers and lengths: packing
    64 frames with a kept plan takes less host time than building the
    plan and packing (the per-call pack), measured as the minimum of
    interleaved rounds."""
    frames = _frames(False, "bf16") * 8
    lib = native.load_packer()
    out = zeros_train_batch(len(frames), T, H, False)
    out = out._replace(obs=out.obs._replace(**{
        f: np.zeros(v.shape, np.uint16) for f, v in out.obs._asdict().items() if v.dtype == np.float32}))
    plan = native.PackPlan(lib, out, len(frames), T, H, False, True)
    kept, per_call = [], []
    for _ in range(30):
        t0 = time.perf_counter()
        plan.pack(frames)
        t1 = time.perf_counter()
        native.PackPlan(lib, out, len(frames), T, H, False, True).pack(frames)
        t2 = time.perf_counter()
        kept.append(t1 - t0)
        per_call.append(t2 - t1)
    assert min(kept) < min(per_call)
