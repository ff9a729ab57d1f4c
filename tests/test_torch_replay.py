"""The prioritized replay reservoir and the staging and train-step paths
around it, against the JAX package: the same offers into the port's
ReplayReservoir and the reference's give the same samples, evictions,
stats and snapshots (exact: the sampling stream is numpy's in both);
staging with replay on packs the same dense batches, `behavior_staleness`
included (bytes exact), from the same frames; a replay train step on the
tree path matches the reference's tree `build_train_step` on a one-device
CPU mesh (f32 metrics 1e-5, bf16 2e-3; params within test_torch_train's
bounds)."""

import dataclasses
import json
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dotaclient_tpu.config import LearnerConfig as JLearnerConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.config import PPOConfig as JPPOConfig
from dotaclient_tpu.config import ReplayConfig as JReplayConfig
from dotaclient_tpu.parallel import train_step as jts
from dotaclient_tpu.replay import ReplayReservoir as JReservoir
from dotaclient_tpu.replay import td_error_priority as j_td
from dotaclient_tpu.runtime.staging import StagingBuffer as JStagingBuffer
from dotaclient_tpu.transport import memory as jmem
from dotaclient_tpu.transport import serialize as jser
from dotaclient_tpu_torch.config import LearnerConfig, PolicyConfig, PPOConfig, ReplayConfig
from dotaclient_tpu_torch.ops import batch as tbatch
from dotaclient_tpu_torch.ops.batch import tree_flatten
from dotaclient_tpu_torch.parallel import train_step as ts
from dotaclient_tpu_torch.parallel.fused_io import TreeBatchIO
from dotaclient_tpu_torch.replay import AGE_BUCKET_EDGES, ReplayReservoir, td_error_priority
from dotaclient_tpu_torch.runtime import learner as tlearner
from dotaclient_tpu_torch.runtime import staging as tstaging
from dotaclient_tpu_torch.transport import memory as tmem
from dotaclient_tpu_torch.transport import serialize as tser
from test_torch_train import METRIC_TOL, _carry_state, _compare_metrics, _compare_states, _jax_step, _stale_batch
from test_torch_train import _configs as _train_configs
from test_transport import make_rollout

H = 8


def _pair(**kw):
    """The port's and the reference's reservoir over one config."""
    base = dict(enabled=True, max_staleness=64)
    base.update(kw)
    return ReplayReservoir(ReplayConfig(**base)), JReservoir(JReplayConfig(**base))


def _same(got, want):
    """Two reservoirs' sample lists: payloads, versions and metas equal."""
    assert [(p, v) for p, v, _ in got] == [(p, v) for p, v, _ in want]


# ------------------------------------------------------------------ reservoir


def test_priority_eviction_order_matches():
    ours, ref = _pair(byte_budget=250, spill_compress=False)
    for res in (ours, ref):
        for i, pri in enumerate([5.0, 0.1, 3.0]):
            res.offer(bytes([i]) * 100, version=50, priority=pri, nbytes=100, current_version=50)
    assert ours.occupancy == ref.occupancy == 2 and ours.stats() == ref.stats()
    got, want = ours.sample(2, 50), ref.sample(2, 50)
    _same(got, want)
    assert {p[0] for p, _, _ in got} == {0, 2}  # the priority-0.1 entry went


def test_age_decay_and_byte_budget_match():
    ours, ref = _pair(byte_budget=250, spill_compress=False, age_half_life=4.0)
    for res in (ours, ref):
        for tag, v in ((b"old", 10), (b"new", 39), (b"mid", 30)):
            res.offer(tag * 40, version=v, priority=1.0, nbytes=100, current_version=40)
    _same(ours.sample(2, 40), ref.sample(2, 40))
    assert b"old" * 40 not in {p for p, _, _ in ours.sample(2, 40)}
    ours, ref = _pair(byte_budget=1000, spill_compress=False)
    for res in (ours, ref):
        for i in range(50):
            res.offer(bytes([i % 250]) * 300, version=5, priority=float(i), nbytes=300, current_version=5)
    assert ours.occupancy_bytes == ref.occupancy_bytes <= 1000
    assert ours.stats() == ref.stats() and ours.stats()["evicted"] == 47


def test_staleness_window_and_max_replays_match():
    ours, ref = _pair(max_staleness=8)
    for res in (ours, ref):
        assert not res.offer(b"x", version=0, priority=1.0, nbytes=1, current_version=9)
        assert res.offer(b"y", version=1, priority=1.0, nbytes=1, current_version=9)
        assert res.expire(20) == 1 and res.occupancy == 0
    assert ours.stats() == ref.stats()
    ours, ref = _pair(max_replays=2)
    for res in (ours, ref):
        res.offer(b"x", version=5, priority=1.0, nbytes=1, current_version=5)
        assert res.sample(1, 5) and res.sample(1, 5) and res.occupancy == 0
    assert ours.stats() == ref.stats() and ours.stats()["retired"] == 1


def test_spill_round_trip_matches():
    """Cold entries are zlib-compressed in place through encode/decode (the
    Python staging path stores Rollouts); a sampled spilled entry is the
    same rollout, and the stored bytes are the reference's."""
    r0 = make_rollout(L=6, H=H, version=7, seed=3)
    raw = jser.serialize_rollout(r0)
    kw = dict(enabled=True, byte_budget=1 << 20, max_staleness=32, spill_threshold=0.0)
    ours = ReplayReservoir(ReplayConfig(**kw), encode=tser.serialize_rollout, decode=tser.deserialize_rollout)
    ref = JReservoir(JReplayConfig(**kw), encode=jser.serialize_rollout, decode=jser.deserialize_rollout)
    ours.offer(tser.deserialize_rollout(raw), version=7, priority=1.0, nbytes=len(raw), current_version=8)
    ref.offer(r0, version=7, priority=1.0, nbytes=len(raw), current_version=8)
    assert ours.stats() == ref.stats() and ours.stats()["spilled_entries"] == 1
    assert ours.occupancy_bytes == ref.occupancy_bytes < len(raw)
    assert ours.snapshot()["entries"] == ref.snapshot()["entries"]
    ((got, version, _),) = ours.sample(1, 8)
    assert version == 7 and tser.serialize_rollout(got) == raw


def test_td_error_priority_matches():
    r = np.random.RandomState(0)
    for n in (0, 1, 7):
        rw, v, d = r.randn(n).astype(np.float32), r.randn(n).astype(np.float32), (r.rand(n) < 0.3).astype(np.float32)
        assert td_error_priority(rw, v, d, 0.98) == j_td(rw, v, d, 0.98)
    bad = np.array([np.nan, np.inf], np.float32)
    assert td_error_priority(bad, bad, bad, 0.98) == j_td(bad, bad, bad, 0.98)


def test_random_offer_and_sample_stream_matches_sample_for_sample():
    """A seeded stream of offers, samples and expiries with random
    priorities and versions, under a budget that evicts and a threshold
    that spills: every draw, eviction and counter equals the reference's,
    and so does the age histogram."""
    ours, ref = _pair(byte_budget=6000, spill_threshold=0.3, max_replays=3, max_staleness=20, alpha=0.6)
    r = np.random.RandomState(11)
    now = 30
    for t in range(120):
        if r.rand() < 0.6:
            payload = bytes(r.randint(0, 4, size=int(r.randint(50, 400))).astype(np.uint8))
            v = int(now - r.randint(0, 25))
            pri = float(r.exponential()) if r.rand() < 0.9 else float("nan")
            assert ours.offer(payload, v, pri, len(payload), now) == ref.offer(payload, v, pri, len(payload), now)
        elif r.rand() < 0.8:
            k = int(r.randint(1, 6))
            _same(ours.sample(k, now), ref.sample(k, now))
        else:
            now += 1
            assert ours.expire(now) == ref.expire(now)
        assert ours.occupancy == ref.occupancy and ours.occupancy_bytes == ref.occupancy_bytes
    assert ours.stats() == ref.stats() and len(AGE_BUCKET_EDGES) == 4


def test_snapshot_restore_continues_the_stream_sample_for_sample():
    """A restored reservoir draws what the uninterrupted one draws next, and
    both draw what the reference's restored reservoir draws."""
    ours, ref = _pair(byte_budget=1 << 20, spill_threshold=0.2)
    for res in (ours, ref):
        for i in range(12):
            res.offer(bytes([i]) * (60 + i), version=20 - (i % 5), priority=0.1 * i, nbytes=60 + i, current_version=22)
        res.sample(3, 22)
    snap, jsnap = ours.snapshot(), ref.snapshot()
    assert snap == jsnap
    restored, jrestored = _pair(byte_budget=1 << 20, spill_threshold=0.2)
    assert restored.restore(snap) == jrestored.restore(jsnap) == ours.occupancy
    for _ in range(4):
        want = ours.sample(3, 23)
        _same(restored.sample(3, 23), want)
        _same(jrestored.sample(3, 23), want)
    assert restored.snapshot() == ours.snapshot()


def test_reservoir_validation_matches():
    for kw in (dict(ratio=1.0), dict(ratio=-0.1), dict(max_staleness=0), dict(byte_budget=0)):
        with pytest.raises(ValueError) as ours:
            ReplayReservoir(ReplayConfig(enabled=True, **kw))
        with pytest.raises(ValueError) as ref:
            JReservoir(JReplayConfig(enabled=True, **kw))
        assert str(ours.value) == str(ref.value)


# ---------------------------------------------------------------- staging

B, T, NOW = 4, 6, 20
POL = dict(unit_embed_dim=16, lstm_hidden=H, mlp_hidden=16)


def _staging_pair(native: bool, dtype: str, version, **replay):
    rkw = dict(enabled=True, ratio=0.5, max_staleness=16)
    rkw.update(replay)
    jcfg = JLearnerConfig(batch_size=B, seq_len=T, policy=JPolicyConfig(**POL, dtype=dtype), native_packer=native,
                          ppo=JPPOConfig(max_staleness=4), replay=JReplayConfig(**rkw))
    tcfg = LearnerConfig(batch_size=B, seq_len=T, policy=PolicyConfig(**POL, dtype=dtype), native_packer=native,
                         ppo=PPOConfig(max_staleness=4), replay=ReplayConfig(**rkw))
    jmem.reset("rp_j"), tmem.reset("rp_t")
    j = JStagingBuffer(jcfg, jmem.MemoryBroker("rp_j"), version_fn=lambda: version[0])
    t = tstaging.StagingBuffer(tcfg, tmem.MemoryBroker("rp_t"), version_fn=lambda: version[0])
    return j, t


def _feed(buf, frames):
    """Ingest and pack on the calling thread, as the consumer would; the
    batches it formed, in order."""
    with buf._mutate_lock:
        buf._ingest(list(frames))
    buf._pack_pending_loop(buf.cfg.batch_size)
    out = []
    while True:
        try:
            out.append(buf._ready.get_nowait()[0])
        except queue.Empty:
            return out


def _words(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().tobytes() if x.dtype == torch.bfloat16 else x.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _schedule():
    """Three rounds of (frames, learner version): near-stale frames (within
    the reservoir's window), too-stale ones, and fresh ones, DTR1/DTR3;
    no round forms more than the ready queue's 2 batches."""
    def f(L, v, seed, bf16=False):
        r = make_rollout(L=L, H=H, version=v, actor_id=seed % 5, seed=seed)
        return jser.serialize_rollout(jser.cast_rollout_obs_bf16(r) if bf16 else r)

    return [
        ([f(4, 10 + i, i, bf16=i == 2) for i in range(6)] + [f(5, 1, 40), f(6, 19, 41), f(3, 18, 42, bf16=True)], NOW),
        ([f(6, 21, 50), f(2, 8, 51), f(4, 22, 52), f(5, 20, 53), f(6, 7, 54)], NOW + 2),
        ([f(3, 26, 60 + i) for i in range(3)] + [f(4, 24, 70)], NOW + 9),
    ]


@pytest.mark.parametrize("native,dtype", [(True, "bfloat16"), (False, "bfloat16"), (True, "float32")])
def test_replay_staging_batches_equal_the_reference_s(native, dtype):
    version = [NOW]
    j, t = _staging_pair(native, dtype, version)
    assert t.native == native
    for frames, v in _schedule():
        version[0] = v
        jb, tb = _feed(j, frames), _feed(t, frames)
        assert len(jb) == len(tb)
        for a, b in zip(jb, tb):
            assert np.array_equal(np.asarray(b.behavior_staleness), np.asarray(a.behavior_staleness))
            for x, y in zip(tree_flatten(b)[0], tree_flatten(a)[0]):
                assert _words(x) == _words(y)
    js, tsx = j.stats(), t.stats()
    assert {k: v for k, v in tsx.items() if k.startswith("replay_")} == {
        k: v for k, v in js.items() if k.startswith("replay_")}
    for k in ("consumed", "dropped_stale", "rows_packed", "rows_replayed", "batches"):
        assert tsx[k] == js[k], k
    assert tsx["rows_replayed"] > 0 and tsx["replay_admitted"] > 0 and tsx["dropped_stale"] > 0
    assert tsx["replay_hit_ratio"] <= 0.5
    # the reservoir rides the snapshot, and a restored buffer continues it
    snap = t.snapshot_state()
    jsnap = j.snapshot_state()
    assert snap["reservoir"]["entries"] == jsnap["reservoir"]["entries"]
    version2 = [NOW + 9]
    _, fresh = _staging_pair(native, dtype, version2)
    assert fresh.restore_state(snap) == {"pending": len(snap["pending"]), "reservoir": t._reservoir.occupancy}
    tail = [jser.serialize_rollout(make_rollout(L=4, H=H, version=NOW + 9, seed=90 + i)) for i in range(4)]
    for a, b in zip(_feed(t, tail), _feed(fresh, tail)):
        assert all(_words(x) == _words(y) for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]))


def test_replay_staging_validation_matches_the_reference():
    version = [NOW]
    with pytest.raises(ValueError, match="must exceed"):
        _staging_pair(True, "float32", version, max_staleness=4)
    _, tcfg = _train_configs("float32", staleness=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tstaging.StagingBuffer(tcfg, tmem.MemoryBroker("rp_v"), fused_io=object())
    # replay off: no reservoir, no stamp, no replay_* stats
    cfg = dataclasses.replace(tcfg, replay=ReplayConfig(), native_packer=False)
    buf = tstaging.StagingBuffer(cfg, tmem.MemoryBroker("rp_off"))
    frames = [jser.serialize_rollout(make_rollout(L=3, H=32, version=0, seed=i)) for i in range(cfg.batch_size)]
    (batch,) = _feed(buf, frames)
    assert batch.behavior_staleness is None and batch.obs.global_feats.dtype == np.float32
    assert buf._reservoir is None and not any(k.startswith("replay_") for k in buf.stats())


# ------------------------------------------------------------- train step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_replay_train_step_matches_the_reference_tree_step(dtype):
    """Two updates on batches with replayed, far off-policy rows (the IS
    truncation engages) through the port's tree path (TreeBatchIO + the
    step) and the reference's tree build_train_step."""
    jcfg, tcfg = _train_configs(dtype, staleness=True)
    jstep = _jax_step(jcfg)
    jstate = jts.init_train_state(jcfg, jax.random.PRNGKey(4))
    tstate, tstep, io = _carry_state(jstate, tcfg), ts.build_train_step(tcfg, "cpu"), TreeBatchIO("cpu")
    for i in range(2):
        jb = _stale_batch(jts.make_train_batch(jcfg, 30 + i))
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, jb))
        host = tstaging.cast_obs_to_compute_dtype(tcfg, jb)
        tstate, tm = tstep(tstate, io.consume(*io.transfer(host)))
        _compare_metrics(tm, jm, METRIC_TOL[dtype])
        assert tm["replay_trunc_frac"].item() > 0
    _compare_states(tstate, jstate, dtype, 2, "replay after 2 steps:")


# ---------------------------------------------------------------- learner


def test_replay_learner_trains_and_its_reservoir_survives_a_full_state_restore(tmp_path):
    """A replay learner trains on the tree path over frames of which some
    aged past ppo.max_staleness (published once the learner is 3 versions
    on), emits the replay_* meters, and its aux manifest carries the
    reservoir: a fresh learner restores the same entries, priorities,
    version stamps and sampling stream."""
    pol = PolicyConfig(**POL, dtype="float32")
    cfg = LearnerConfig(batch_size=B, seq_len=T, policy=pol, broker_url="mem://rp_ln", log_dir=str(tmp_path / "l"),
                        metrics_every=1, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1000,
                        ppo=PPOConfig(max_staleness=1), replay=ReplayConfig(enabled=True, ratio=0.5, max_staleness=8))
    cfg.learner.prefetch = False
    cfg.ckpt.full_state = True
    tmem.reset("rp_ln")
    pub = tmem.MemoryBroker("rp_ln")

    def publish(n, version, seed):
        for i in range(n):
            pub.publish_experience(jser.serialize_rollout(make_rollout(L=T, H=H, version=version, seed=seed + i)))

    publish(3 * B, 0, 0)
    ln = tlearner.Learner(cfg, tmem.MemoryBroker("rp_ln"), device="cpu")
    try:
        assert ln.fused_io is None and isinstance(ln.io, TreeBatchIO)
        assert ln.run(num_steps=3, batch_timeout=5.0, max_idle=3) == 3
        publish(B, 0, 100)  # 3 versions old now: into the reservoir
        publish(2 * B, 3, 200)
        assert ln.run(num_steps=2, batch_timeout=5.0, max_idle=3) == 2
        stats = ln.staging.stats()
        assert stats["replay_admitted"] == B and stats["rows_replayed"] > 0
        assert 0 < stats["replay_hit_ratio"] <= cfg.replay.ratio
        rec = [json.loads(line) for line in open(tmp_path / "l" / "metrics.jsonl")][-1]
        assert rec["replay_admitted"] == B and np.isfinite(rec["loss"]) and "replay_trunc_frac" in rec
        ln.checkpoint()
        snap = ln.staging.snapshot_state()
    finally:
        ln.close()
    aux = tlearner.decode_aux(tlearner.encode_aux({"step": 5, "staging": snap}))
    assert aux["staging"] == snap
    fresh = tlearner.Learner(cfg, tmem.MemoryBroker("rp_ln"), device="cpu")
    try:
        assert fresh.version == 5 and fresh.resume_info["resume_reservoir_entries"] == len(snap["reservoir"]["entries"])
        assert fresh.staging.snapshot_state() == snap
    finally:
        fresh.close()
