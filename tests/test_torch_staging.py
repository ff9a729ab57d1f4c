"""The port's staging buffer against the reference's: the same frame list
(DTR1/DTR2/DTR3, short rollouts, frames with and without aux, stale
versions, corrupt and misconfigured frames) goes through the reference
StagingBuffer (Python and native packer, single transfer buffer) and the
port's (Python and native). The packed [B, row_bytes] bytes, the drop /
quarantine / wire-meter counts and the quarantine evidence must be equal,
in f32 and bf16 configs, with and without aux."""

import dataclasses
import time

import jax
import numpy as np
import pytest

from dotaclient_tpu.config import LearnerConfig as JLearnerConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.config import PPOConfig as JPPOConfig
from dotaclient_tpu.parallel import mesh as jmesh
from dotaclient_tpu.parallel import train_step as jts
from dotaclient_tpu.parallel.fused_io import FusedBatchIO as JFusedBatchIO
from dotaclient_tpu.runtime.staging import StagingBuffer as JStagingBuffer
from dotaclient_tpu.runtime.staging import cast_obs_to_compute_dtype as j_cast
from dotaclient_tpu.transport import memory as jmem
from dotaclient_tpu.transport import serialize as jser
from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig, PPOConfig
from dotaclient_tpu_torch.native import frame_header, frame_headers, load_packer
from dotaclient_tpu_torch.ops import batch as tbatch
from dotaclient_tpu_torch.parallel.fused_io import FusedBatchIO
from dotaclient_tpu_torch.runtime import staging as tstaging
from dotaclient_tpu_torch.transport import memory as tmem
from dotaclient_tpu_torch.transport import serialize as tser
from test_transport import make_rollout

B, T, H = 8, 4, 8
VERSION_NOW, MAX_STALE = 10, 4  # frames stamped below 6 are stale
POL = dict(unit_embed_dim=16, lstm_hidden=H, mlp_hidden=16)
COUNTS = ("consumed", "dropped_stale", "dropped_bad", "quarantined", "batches", "rows_packed", "episodes",
          "episode_return_sum", "wire_bytes", "wire_frames_obs_bf16", "wire_frames_obs_f32", "consumer_errors")


def frame_schedule(aux: bool):
    """27 admissible frames (3 full batches + 3 left pending) interleaved
    with 5 stale and 7 bad ones, in a fixed order."""
    good, n = [], 0
    for i in range(27):
        L = (T, 2, 1, T - 1)[i % 4]
        r = make_rollout(L=L, H=H, version=VERSION_NOW - (i % 5), actor_id=i % 6, aux=aux if i % 3 else not aux, seed=100 + i)
        if i % 7 == 3:
            r = r._replace(dones=np.zeros(L, np.float32))  # no episode end
        kind = i % 4
        if kind == 1:
            r = r._replace(trace_id=1000 + i, birth_time=1.5 * i)  # DTR2
        elif kind == 2:
            r = jser.cast_rollout_obs_bf16(r)  # DTR3
        elif kind == 3 and i % 8 == 7:
            r = jser.cast_rollout_obs_bf16(r)._replace(trace_id=i, birth_time=0.5)  # traced DTR3
        good.append(jser.serialize_rollout(r))
        n += 1
    stale = [jser.serialize_rollout(make_rollout(L=T, H=H, version=v, seed=200 + v)) for v in (0, 3, 5, 1, 2)]
    q = bytearray(jser.serialize_rollout(jser.cast_rollout_obs_bf16(make_rollout(L=2, H=H, seed=300))))
    q[38] = 7
    d1 = jser.serialize_rollout(make_rollout(L=T, H=H, version=VERSION_NOW, seed=301))
    bad = [
        bytes(q),  # dtype_map
        d1[:100],  # parse: truncated
        b"DTRX" + d1[4:],  # parse: magic
        d1 + b"\0",  # parse: trailing byte
        jser.serialize_rollout(make_rollout(L=T, H=H + 8, version=VERSION_NOW, seed=302)),  # layout: H
        jser.serialize_rollout(make_rollout(L=T + 2, H=H, version=VERSION_NOW, seed=303)),  # layout: L > T
        b"",  # parse: empty
    ]
    out = []
    for i, f in enumerate(good):
        out.append(f)
        if i % 4 == 1 and stale:
            out.append(stale.pop())
        if i % 3 == 2 and bad:
            out.append(bad.pop())
    return out + stale + bad


def _cfgs(dtype, aux):
    j = JLearnerConfig(batch_size=B, seq_len=T, policy=JPolicyConfig(**POL, dtype=dtype, aux_heads=aux),
                       ppo=JPPOConfig(max_staleness=MAX_STALE))
    t = LearnerConfig(batch_size=B, seq_len=T, policy=PolicyConfig(**POL, dtype=dtype, aux_heads=aux),
                      ppo=PPOConfig(max_staleness=MAX_STALE))
    return j, t


def _io_pair(jcfg, tcfg):
    jt = j_cast(jcfg, jax.tree.map(np.asarray, jts._batch_template(jcfg)))
    jio = JFusedBatchIO(jt, jmesh.make_mesh("dp=1", devices=jax.devices()[:1]))
    jio.single_mode = True
    p = tcfg.policy
    tio = FusedBatchIO(tstaging.cast_obs_to_compute_dtype(tcfg, tbatch.zeros_train_batch(B, T, p.lstm_hidden, p.aux_heads)), "cpu")
    assert jio.row_bytes == tio.row_bytes
    return jio, tio


def _drain(staging, broker, frames, n_batches):
    """Publish every frame, run the consumer, collect n_batches packed
    buffers and wait until the consumer has seen every frame."""
    for f in frames:
        broker.publish_experience(f)
    staging.start()
    try:
        bufs = []
        for _ in range(n_batches):
            batch, buf = staging.get_batch_groups(timeout=20.0)
            assert batch is not None, "staging produced no batch"
            bufs.append(np.asarray(buf).copy())
            if staging.last_batch_lease is not None:  # a ring slot: back to the packers
                staging.last_batch_lease.release()
        deadline = time.monotonic() + 20
        while staging.stats()["consumed"] < len(frames) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert staging.get_batch_groups(timeout=0.3)[0] is None  # nothing more to pack
        return bufs, staging.stats(), staging.quarantine()
    finally:
        staging.stop()


def _run_reference(jcfg, jio, frames, native, name, workers=1):
    jmem.reset(name)
    cfg = dataclasses.replace(jcfg, native_packer=native, staging=dataclasses.replace(jcfg.staging, pack_workers=workers))
    s = JStagingBuffer(cfg, jmem.MemoryBroker(name), version_fn=lambda: VERSION_NOW, fused_io=jio)
    assert s.native == native
    return _drain(s, jmem.MemoryBroker(name), frames, 3)


def _run_port(tcfg, tio, frames, native, name, workers=1, depth=2):
    tmem.reset(name)
    staging = dataclasses.replace(tcfg.staging, pack_workers=workers, transfer_depth=depth)
    s = tstaging.StagingBuffer(dataclasses.replace(tcfg, native_packer=native, staging=staging), tmem.MemoryBroker(name),
                               version_fn=lambda: VERSION_NOW, fused_io=tio)
    assert s.native == native
    return _drain(s, tmem.MemoryBroker(name), frames, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("aux", [False, True])
def test_packed_buffers_and_counts_equal_the_reference(dtype, aux):
    jcfg, tcfg = _cfgs(dtype, aux)
    jio, tio = _io_pair(jcfg, tcfg)
    frames = frame_schedule(aux)
    tag = f"{dtype}_{aux}"
    arms = {
        "ref_python": _run_reference(jcfg, jio, list(frames), False, f"st_rp_{tag}"),
        "ref_native": _run_reference(jcfg, jio, list(frames), True, f"st_rn_{tag}"),
        "port_python": _run_port(tcfg, tio, list(frames), False, f"st_pp_{tag}"),
        "port_native": _run_port(tcfg, tio, list(frames), True, f"st_pn_{tag}"),
    }
    want_bufs, want_stats, want_q = arms["ref_native"]
    # the schedule exercises every path
    assert want_stats["dropped_stale"] == 5 and want_stats["quarantined"] == 7 and want_stats["batches"] == 3
    assert want_stats["wire_frames_obs_bf16"] > 0 and want_stats["wire_frames_obs_f32"] > 0
    assert sorted(e["reason"] for e in want_q) == ["dtype_map", "layout", "layout", "parse", "parse", "parse", "parse"]
    for arm, (bufs, stats, q) in arms.items():
        for i, (got, want) in enumerate(zip(bufs, want_bufs)):
            assert got.shape == want.shape == (B, tio.row_bytes) and np.array_equal(got, want), f"{arm}: batch {i} bytes"
        assert {k: stats[k] for k in COUNTS} == {k: want_stats[k] for k in COUNTS}, arm
        assert stats["pending_rollouts"] == 3 and stats["active_actors"] == want_stats["active_actors"]
        assert [(e["reason"], e["bytes"], e["head"]) for e in q] == [(e["reason"], e["bytes"], e["head"]) for e in want_q], arm


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("workers", [2, 4])
def test_sharded_pack_equals_the_single_pack_and_the_reference(native, workers):
    """pack_workers N: the packed bytes equal pack_workers=1's and the
    reference's N-worker pack (mixed DTR1/2/3, short rows, bad and stale
    frames), the counts and quarantine too; the pool's scoreboard exists.
    With a one-slot ring every batch reuses the slot the last one left."""
    jcfg, tcfg = _cfgs("bfloat16", True)
    jio, tio = _io_pair(jcfg, tcfg)
    frames = frame_schedule(True)
    tag = f"{native}_{workers}"
    single = _run_port(tcfg, tio, list(frames), native, f"st_sh1_{tag}")
    ref = _run_reference(jcfg, jio, list(frames), native, f"st_shr_{tag}", workers)
    for depth in (1, 2):
        bufs, stats, q = _run_port(tcfg, tio, list(frames), native, f"st_sh{depth}_{tag}", workers, depth)
        for want_bufs, want_stats, want_q in (single, ref):
            assert len(bufs) == len(want_bufs) == 3
            for got, want in zip(bufs, want_bufs):
                assert np.array_equal(got, want)
            assert {k: stats[k] for k in COUNTS} == {k: want_stats[k] for k in COUNTS}
            assert [(e["reason"], e["head"]) for e in q] == [(e["reason"], e["head"]) for e in want_q]
        assert stats["pack_workers"] == workers and stats["pack_ring_depth"] == depth
        assert stats["pack_rows_per_s"] > 0 and f"pack_worker_busy_s_{workers - 1}" in stats
        assert {k for k in stats if k.startswith("pack_")} == {k for k in ref[1] if k.startswith("pack_")}
    assert not any(k.startswith("pack_") for k in single[1])  # the classic path adds no meters


def test_a_reused_ring_slot_packs_like_a_fresh_buffer():
    """A slot packed with a full batch, released, then packed with short
    rollouts: padding rows are zeros with the NOOP action mask again, and
    the bytes equal a fresh alloc_transfer's."""
    _, tcfg = _cfgs("float32", False)
    tio = _io_pair(*_cfgs("float32", False))[1]
    ring = tio.make_ring(1)
    lib = load_packer()
    full = [jser.serialize_rollout(make_rollout(L=T, H=H, version=VERSION_NOW, seed=400 + i)) for i in range(B)]
    short = [jser.serialize_rollout(make_rollout(L=1, H=H, version=VERSION_NOW, seed=500 + i)) for i in range(B // 2)]
    from dotaclient_tpu_torch import native

    slot = ring.acquire(timeout=1)
    native.pack_frames(lib, full, T, H, False, False, slot.batch, total_rows=B)
    assert ring.acquire(timeout=0.05) is None and ring.occupancy == 1
    slot.release()
    slot.release()  # idempotent: the slot is in the free queue once
    again = ring.acquire(timeout=1)
    assert again is slot and ring._free.qsize() == 0
    native.pack_frames(lib, short, T, H, False, False, again.batch, total_rows=B)
    fresh_buf, fresh = tio.alloc_transfer()
    native.pack_frames(lib, short, T, H, False, False, fresh, total_rows=B)
    assert np.array_equal(again.payload.numpy(), fresh_buf.numpy())
    with pytest.raises(ValueError, match="depth"):
        tio.make_ring(0)


def test_snapshot_and_restore_keep_pending_frames_in_order():
    _, tcfg = _cfgs("float32", False)
    tio = _io_pair(*_cfgs("float32", False))[1]
    frames = [jser.serialize_rollout(make_rollout(L=2, H=H, version=VERSION_NOW, seed=600 + i)) for i in range(B - 1)]
    for native in (True, False):
        name = f"st_snap_{native}"
        tmem.reset(name)
        s = tstaging.StagingBuffer(dataclasses.replace(tcfg, native_packer=native), tmem.MemoryBroker(name),
                                   version_fn=lambda: VERSION_NOW, fused_io=tio)
        with s._mutate_lock:
            s._ingest(list(frames))
        snap = s.snapshot_state()
        assert snap["pending"] == frames  # wire bytes, arrival order
        fresh = tstaging.StagingBuffer(dataclasses.replace(tcfg, native_packer=native), tmem.MemoryBroker(name),
                                       version_fn=lambda: VERSION_NOW, fused_io=tio)
        assert fresh.restore_state(snap) == {"pending": B - 1}
        assert fresh.snapshot_state() == snap


def test_native_header_parse_matches_the_reference_packer():
    from dotaclient_tpu import native as jnative

    lib, jlib = load_packer(), jnative.load_packer()
    assert jlib is not None
    frames = [tser.strip_rollout_trace(f) for f in frame_schedule(True)]
    assert frame_headers(lib, frames) == tuple(jnative.frame_headers(jlib, frames))
    for f in frames[:12]:
        assert frame_header(lib, f) == jnative.frame_header(jlib, f)


def test_fill_rollouts_writes_bf16_words_into_the_transfer_views():
    """The Python packer casts f32 obs to bf16 words by the explicit
    rounding and widens bf16 obs exactly into f32 views."""
    _, tcfg = _cfgs("bfloat16", False)
    tio = _io_pair(*_cfgs("bfloat16", False))[1]
    rs = [make_rollout(L=1 + i % T, H=H, seed=i) for i in range(B)]
    rs = [tser.deserialize_rollout(jser.serialize_rollout(jser.cast_rollout_obs_bf16(r) if i % 2 else r)) for i, r in enumerate(rs)]
    buf, views = tio.alloc_transfer()
    tstaging.fill_rollouts(views, rs, T)
    assert views.obs.unit_feats.dtype == np.uint16
    r0 = rs[0]
    L = r0.length
    want = r0.obs.unit_feats
    want = tser.bf16_bits(want) if tser.is_bf16(want) else tser.f32_to_bf16_bits(want)
    assert np.array_equal(views.obs.unit_feats[0, : L + 1], want)
    dense = tstaging.pack_rollouts(rs, T, with_aux=False)
    assert dense.obs.unit_feats.dtype == np.float32 and dense.mask.sum() == sum(r.length for r in rs)
    assert tstaging.shard_rows(10, 4) == [(0, 3), (3, 3), (6, 2), (8, 2)] and tstaging.shard_rows(2, 4) == [(0, 1), (1, 1)]
    with pytest.raises(ValueError, match="exceeds learner seq_len"):
        tstaging.fill_rollouts(views, [tser.deserialize_rollout(jser.serialize_rollout(make_rollout(L=T + 1, H=H)))], T)


def test_a_layout_mismatch_kills_the_consumer_and_the_getter_reraises():
    """A bf16 config over an io built for f32 obs: the native packer's
    layout check fails every batch, so the consumer dies and the getter
    raises within one wait slice instead of starving the learner."""
    _, bf16cfg = _cfgs("bfloat16", False)
    tio = _io_pair(*_cfgs("float32", False))[1]
    tmem.reset("st_fatal")
    s = tstaging.StagingBuffer(bf16cfg, tmem.MemoryBroker("st_fatal"), version_fn=lambda: VERSION_NOW, fused_io=tio)
    for f in frame_schedule(False)[:20]:
        tmem.MemoryBroker("st_fatal").publish_experience(f)
    s.start()
    try:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="layout/config mismatch"):
            s.get_batch_groups(timeout=30.0)
        with pytest.raises(RuntimeError, match="layout/config mismatch"):
            s.get_batch(timeout=30.0)
        assert time.monotonic() - t0 < 10
        s._thread.join(timeout=5)
        assert not s._thread.is_alive()
    finally:
        s.stop()


def test_staging_refuses_what_is_not_ported():
    """What is left to refuse: the data modes on a topology they cannot run
    on (the reference's own errors); policy.tf_sp_axis, ported, passes."""
    _, tcfg = _cfgs("float32", False)
    tio = _io_pair(*_cfgs("float32", False))[1]
    b = tmem.MemoryBroker("st_refuse")
    # a learner setting staging does not read (the builders hold it to the mesh)
    assert tstaging.StagingBuffer(dataclasses.replace(tcfg, policy=dataclasses.replace(tcfg.policy, tf_sp_axis="sp")),
                                  b, fused_io=tio).get_batch(timeout=0.01) is None
    with pytest.raises(ValueError, match="DTB1"):
        tstaging.StagingBuffer(dataclasses.replace(tcfg, staging=dataclasses.replace(tcfg.staging, assemble=True)), b,
                               fused_io=tio)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tstaging.StagingBuffer(dataclasses.replace(tcfg, replay=dataclasses.replace(tcfg.replay, enabled=True)), b,
                               fused_io=tio)
    assert tstaging.StagingBuffer(tcfg, b).get_batch(timeout=0.01) is None  # dense staging for the tree path
    with pytest.raises(ValueError, match="pack_workers must be >= 1"):
        tstaging.StagingBuffer(dataclasses.replace(tcfg, staging=dataclasses.replace(tcfg.staging, pack_workers=0)), b,
                               fused_io=tio)


@pytest.mark.parametrize("pack_workers", [1, 4])
def test_the_drain_takes_the_fabric_residual_as_the_reference_does(pack_workers):
    """Frames the fabric's fan-in popped off the shards before the quiesce
    survive the drain into pending, and drained() reads False while any
    sit in the fan-in queue, on the classic consumer and in pool mode; the
    reference's staging over its own fabric ends with the same pending
    frames."""
    from dotaclient_tpu.transport import fabric as jfab
    from dotaclient_tpu_torch.transport import fabric as tfab

    jcfg, tcfg = _cfgs("float32", False)
    jio, tio = _io_pair(jcfg, tcfg)
    frames = [jser.serialize_rollout(make_rollout(L=T, H=H, version=VERSION_NOW, actor_id=aid, seed=700 + aid))
              for aid in range(B - 3)]  # fewer than a batch: they can only drain to pending
    pendings = []
    for pkg, fab, mem, make in (("port", tfab, tmem, tstaging.StagingBuffer), ("ref", jfab, jmem, JStagingBuffer)):
        names = [f"st_fab_{pkg}_{pack_workers}_{i}" for i in range(2)]
        for n in names:
            mem.reset(n)
        fb = fab.FabricBroker([f"mem://{n}" for n in names], failover_window_s=0.4, cooldown_s=0.5)
        for f in frames:
            fb.publish_experience(f)
        cfg = dataclasses.replace(jcfg if pkg == "ref" else tcfg, native_packer=False)
        cfg = dataclasses.replace(cfg, staging=dataclasses.replace(cfg.staging, pack_workers=pack_workers))
        staging = make(cfg, fb, version_fn=lambda: VERSION_NOW, fused_io=jio if pkg == "ref" else tio)
        fb._ensure_fanin()  # pull the frames into the fan-in queue before the consumer starts
        deadline = time.monotonic() + 5
        while fb._fanin.qsize() < len(frames) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fb.fanin_residual() >= len(frames)
        staging.start()
        staging.quiesce()
        assert fb._quiesce.is_set()
        assert not staging.drained() or fb.fanin_residual() == 0
        deadline = time.monotonic() + 5
        while not staging.drained() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert staging.drained() and fb.fanin_residual() == 0
        pending = staging.snapshot_state()["pending"]
        staging.stop()
        fb.close()
        pendings.append(sorted(bytes(p) if isinstance(p, (bytes, bytearray)) else jser.serialize_rollout(p)
                               for p in pending))
    assert pendings[0] == pendings[1] == sorted(frames)
