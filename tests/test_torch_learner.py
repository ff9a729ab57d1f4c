"""The port's learner loop against the reference's: the JAX Learner (one
CPU device) and the port Learner (device="cpu") take the same frame
schedule from the same start and agree after 3 steps (params, Adam state,
every DTW2 frame, the metric windows); the port's serial and pipelined
loops give bitwise the same state; checkpoints round-trip bitwise and
refuse another feature schema; a dead producer surfaces as TimeoutError;
unported modes are refused; and a JAX actor on a fake dotaservice trains
the port learner through the reference's broker and runs its weights."""

import asyncio
import dataclasses
import json
import sys
import threading
import time

import jax
import numpy as np
import pytest

from dotaclient_tpu.config import ActorConfig as JActorConfig
from dotaclient_tpu.config import LearnerConfig as JLearnerConfig
from dotaclient_tpu.config import PolicyConfig as JPolicyConfig
from dotaclient_tpu.config import PPOConfig as JPPOConfig
from dotaclient_tpu.config import parse_config as j_parse_config
from dotaclient_tpu.env.fake_dotaservice import FakeDotaService
from dotaclient_tpu.env.service import serve
from dotaclient_tpu.parallel import mesh as jmesh
from dotaclient_tpu.runtime.actor import Actor as JActor
from dotaclient_tpu.runtime.learner import Learner as JLearner
from dotaclient_tpu.transport import memory as jmem
from dotaclient_tpu.transport.serialize import deserialize_weights as j_deserialize_weights
from dotaclient_tpu.transport.serialize import flatten_params
from dotaclient_tpu_torch.config import (
    UNPORTED,
    LearnerConfig,
    PolicyConfig,
    PPOConfig,
    parse_config,
    refuse_unported,
    unported_flags,
)
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.models import policy as P
from dotaclient_tpu_torch.ops import batch as tbatch
from dotaclient_tpu_torch.ops.action_dist import Action
from dotaclient_tpu_torch.parallel import train_step as ts
from dotaclient_tpu_torch.parallel.fused_io import TreeBatchIO
from dotaclient_tpu_torch.runtime import learner as tlearner
from dotaclient_tpu_torch.runtime.checkpoint import Checkpointer, SchemaMismatchError
from dotaclient_tpu_torch.transport import memory as tmem
from dotaclient_tpu_torch.transport import serialize as tser
from dotaclient_tpu_torch.transport.base import connect
from dotaclient_tpu_torch.transport.params import load_named, load_named_adam, named_adam_state, named_params
from test_torch_train import PARAM_LR, _compare_states, _jax_adam_named

B, T = 8, 4
POL = dict(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16)


def frames_for(cfg: LearnerConfig, n_batches: int, version: int = 0, seed0: int = 0):
    """Serialized DTR1 rollouts cut from make_train_batch rows (legal
    actions and masks, one rollout per row, its real length)."""
    out = []
    for k in range(n_batches):
        b = tbatch.make_train_batch(cfg, seed0 + k)
        for i in range(cfg.batch_size):
            L = int(b.mask[i].sum())
            out.append(tser.serialize_rollout(tser.Rollout(
                obs=F.Observation(*(x[i, : L + 1] for x in b.obs)),
                actions=Action(*(a[i, :L] for a in b.actions)),
                behavior_logp=b.behavior_logp[i, :L], behavior_value=b.behavior_value[i, :L],
                rewards=b.rewards[i, :L], dones=b.dones[i, :L],
                initial_state=(b.initial_state[0][i], b.initial_state[1][i]),
                version=version, actor_id=i, episode_return=0.5 * i,
            )))
    return out


def _tcfg(name, tmp_path, **kw):
    pol = kw.pop("policy", PolicyConfig(**POL, dtype="float32"))
    cfg = LearnerConfig(batch_size=B, seq_len=T, policy=pol, broker_url=f"mem://{name}", log_dir=str(tmp_path / name),
                        metrics_every=2, ppo=PPOConfig(max_staleness=1000), **kw)
    return cfg


def _port_learner(name, tmp_path, frames, prefetch=True, **kw):
    cfg = _tcfg(name, tmp_path, **kw)
    cfg.learner.prefetch = prefetch
    tmem.reset(name)
    broker = tmem.MemoryBroker(name)
    for f in frames:
        broker.publish_experience(f)
    return tlearner.Learner(cfg, tmem.MemoryBroker(name), device="cpu"), broker


def _recording(broker, sink):
    publish = broker.publish_weights

    def rec(frame):
        sink.append(frame)
        publish(frame)

    broker.publish_weights = rec


def _metric_lines(path):
    return [json.loads(line) for line in open(path)]


# Keys only one learner writes (none with these configs: obs, replay, the
# pack pool, fabric brokers and checkpoint mirrors are off on both sides).
UNPORTED_METRIC_KEYS = set()


def test_port_learner_matches_the_jax_learner_over_three_steps(tmp_path):
    _learner_vs_jax(tmp_path)


# The transfer paths besides the single buffer: the per-leaf tree and the
# four dtype groups, each in both learners.
MODES = {"tree": dict(fused_h2d=False), "groups": dict(fused_single_h2d=False)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_data_mode_learners_match_the_jax_learner(tmp_path, mode):
    tl = _learner_vs_jax(tmp_path, **MODES[mode])
    assert (tl.fused_io is None) == (mode == "tree")
    assert tl.fused_io is None or not tl.fused_io.single_mode


def _learner_vs_jax(tmp_path, **mode):
    tcfg = _tcfg("ln_port", tmp_path, publish_every=1, **mode)
    jcfg = JLearnerConfig(batch_size=B, seq_len=T, policy=JPolicyConfig(**POL, dtype="float32"),
                          ppo=JPPOConfig(max_staleness=1000), log_dir=str(tmp_path / "ln_jax"), metrics_every=2,
                          publish_every=1, **mode)
    frames = frames_for(tcfg, 3)
    jmem.reset("ln_jax")
    jbroker = jmem.MemoryBroker("ln_jax")
    for f in frames:
        jbroker.publish_experience(f)
    jl = JLearner(jcfg, jmem.MemoryBroker("ln_jax"), mesh=jmesh.make_mesh("dp=1", devices=jax.devices()[:1]))
    tl, tbroker = _port_learner("ln_port", tmp_path, frames, **mode)
    # the JAX learner's initial state, carried across by flax name
    net = load_named(P.PolicyNet(tcfg.policy, device="cpu"), flatten_params(jl.state.params))
    tl.state = ts.TrainState(net, load_named_adam(_jax_adam_named(jl.state.opt_state), net), 0)
    jframes, tframes = [], []
    _recording(jl.broker, jframes)
    _recording(tl.broker, tframes)
    try:
        assert jl.run(num_steps=3, batch_timeout=30.0, max_idle=3) == 3
        assert tl.run(num_steps=3, batch_timeout=30.0, max_idle=3) == 3
    finally:
        jl.close()
        tl.close()
    assert tl.version == jl.version == 3
    _compare_states(tl.state, jl.state, "float32", 3, "after 3 loop steps:")
    # every DTW2 frame: versions from 0 (published before consuming) to 3,
    # coalescing aside; names and shapes equal; values within the
    # tolerance of the steps behind them
    jv = {j_deserialize_weights(f)[1]: f for f in jframes}
    tv = {tser.deserialize_weights(f)[1]: f for f in tframes}
    for frames_by_version, pub in ((jv, jl.publisher), (tv, tl.publisher)):
        assert {0, 3} <= set(frames_by_version) <= {0, 1, 2, 3}
        assert pub.published + pub.coalesced == 3 and len(frames_by_version) == pub.published + 1
    assert all(tser.deserialize_weights(f)[2] == tl.boot_epoch for f in tframes)
    for v in sorted(set(jv) & set(tv)):
        want, got = j_deserialize_weights(jv[v])[0], tser.deserialize_weights(tv[v])[0]
        assert [(n, a.shape) for n, a in got] == [(n, a.shape) for n, a in want]
        for (n, a), (_, b) in zip(got, want):
            assert np.abs(a - b).max() <= PARAM_LR["float32"] * 1e-4 * max(v, 1), (v, n)
    # the metric windows: same steps, same keys, the step's metrics in the
    # train-step tolerance of tests/test_torch_train.py
    jm, tm = _metric_lines(tmp_path / "ln_jax" / "metrics.jsonl"), _metric_lines(tmp_path / "ln_port" / "metrics.jsonl")
    assert [r["step"] for r in tm] == [r["step"] for r in jm] == [2, 3]
    for t_rec, j_rec in zip(tm, jm):
        assert set(t_rec) - UNPORTED_METRIC_KEYS == set(j_rec) - UNPORTED_METRIC_KEYS
        for k in ("loss", "policy_loss", "value_loss", "entropy", "grad_norm", "approx_kl", "return_mean"):
            np.testing.assert_allclose(t_rec[k], j_rec[k], rtol=1e-5, atol=1e-5, err_msg=k)
        for k in ("staleness_dropped", "staging_quarantined", "episodes", "wire_bytes_consumed_total",
                  "wire_frames_obs_f32_total", "mean_episode_return"):
            assert t_rec[k] == j_rec[k], k
        for k in ("env_steps_per_sec", "time_step_s", "pipeline_overlap_ratio", "pipeline_device_idle_s"):
            assert np.isfinite(t_rec[k]), k
    return tl


def _state_words(state):
    return [(n, a.tobytes()) for n, a in named_params(state.net) + named_adam_state(state.opt_state)[1:]] + [
        ("count", int(state.opt_state.count)), ("step", state.step)]


def test_serial_and_pipelined_loops_end_bitwise_equal(tmp_path):
    """Default bf16 policy (obs staged as bf16 words), native packer."""
    pol = PolicyConfig(**POL)
    frames = frames_for(_tcfg("x", tmp_path, policy=pol), 4)
    states = []
    for prefetch in (False, True):
        name = f"ln_pipe_{prefetch}"
        learner, _ = _port_learner(name, tmp_path, frames, prefetch=prefetch, policy=pol)
        try:
            assert learner.run(num_steps=4, batch_timeout=30.0, max_idle=3) == 4
        finally:
            learner.close()
        assert learner._prefetch_lane is None and not learner._prefetch_holding()
        assert not learner.staging._thread.is_alive()
        states.append(_state_words(learner.state))
        lines = _metric_lines(tmp_path / name / "metrics.jsonl")
        assert ("pipeline_overlap_ratio" in lines[-1]) == prefetch
    assert states[0] == states[1]


def test_checkpoint_round_trip_and_schema_guard(tmp_path):
    frames = frames_for(_tcfg("x", tmp_path), 3)
    ck = tmp_path / "ck"
    learner, _ = _port_learner("ln_ck", tmp_path, frames, checkpoint_dir=str(ck), checkpoint_every=2)
    try:
        learner.run(num_steps=3, batch_timeout=30.0, max_idle=3)
        learner.checkpoint()
    finally:
        learner.close()
    assert sorted(p.name for p in ck.iterdir()) == ["2", "3", "feature_schema.json"]  # no temp dir left
    fresh, _ = _port_learner("ln_ck2", tmp_path, [], checkpoint_dir=str(ck))
    assert fresh.version == 3 and fresh.state.step == 3
    assert _state_words(fresh.state) == _state_words(learner.state)
    # an interrupted save (temp dir left behind) is invisible to restore
    (ck / ".tmp_9").mkdir()
    (ck / ".tmp_9" / "arrays.npz").write_bytes(b"torn")
    assert Checkpointer(str(ck)).latest_step() == 3
    # max_to_keep
    cp = Checkpointer(str(ck), max_to_keep=2)
    for step in (4, 5, 6):
        cp.save(learner.state, step)
    assert cp.all_steps() == [5, 6] and not (ck / ".tmp_6").exists()
    (ck / "feature_schema.json").write_text(json.dumps({"feature_schema_version": F.FEATURE_SCHEMA_VERSION - 1}))
    with pytest.raises(SchemaMismatchError, match="feature schema"):
        _port_learner("ln_ck3", tmp_path, [], checkpoint_dir=str(ck))


@pytest.mark.parametrize("prefetch", [True, False], ids=["pipelined", "serial"])
def test_max_idle_raises_timeout_and_tears_down(tmp_path, prefetch):
    learner, broker = _port_learner(f"ln_idle_{prefetch}", tmp_path, [], prefetch=prefetch)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="producers dead or stalled"):
        learner.run(num_steps=2, batch_timeout=0.2, max_idle=2)
    assert time.monotonic() - t0 < 10
    learner.staging._thread.join(timeout=5)
    assert not learner.staging._thread.is_alive() and learner.publisher._thread is None
    assert tser.deserialize_weights(broker.poll_weights())[1] == 0  # version 0 went out before the first wait
    # max_seconds: a clean stop on the wall-clock budget, no error
    t0 = time.monotonic()
    assert learner.run(num_steps=None, batch_timeout=5.0, max_idle=50, max_seconds=0.5) == 0
    assert time.monotonic() - t0 < 5
    learner.close()


@pytest.mark.parametrize("prefetch", [True, False], ids=["pipelined", "serial"])
def test_drain_trains_out_what_staging_popped(tmp_path, prefetch):
    """request_drain: no new broker pops, every popped frame is trained or
    still pending (fewer than a batch), and run() returns. abort: run()
    returns at once."""
    learner, broker = _port_learner(f"ln_drain_{prefetch}", tmp_path, frames_for(_tcfg("x", tmp_path), 6), prefetch=prefetch)
    done = []
    t = threading.Thread(target=lambda: done.append(learner.run(num_steps=None, batch_timeout=5.0, max_idle=3)))
    t.start()
    deadline = time.monotonic() + 30
    while learner.version < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    learner.request_drain()
    t.join(timeout=30)
    assert not t.is_alive() and done and done[0] == learner.version >= 1
    stats = learner.staging.stats()
    assert stats["consumed"] == done[0] * B + stats["pending_rollouts"] and stats["pending_rollouts"] < B
    assert broker.experience_depth() == 6 * B - stats["consumed"]
    learner.close()
    # abort: returns promptly with frames still staged
    learner, _ = _port_learner(f"ln_abort_{prefetch}", tmp_path, [], prefetch=prefetch)
    t = threading.Thread(target=lambda: learner.run(num_steps=None, batch_timeout=5.0, max_idle=3))
    t.start()
    time.sleep(0.3)
    t0 = time.monotonic()
    learner.abort()
    t.join(timeout=10)
    assert not t.is_alive() and time.monotonic() - t0 < 5
    learner.close()


def test_weight_publisher_is_latest_wins_and_reports_each_send():
    """Versions submitted while one is being sent are superseded (counted),
    the newest always goes out, in order, and on_published sees each."""
    tmem.reset("ln_pub")
    sent, gate = [], threading.Event()

    def materialize(payload):
        gate.wait(5)
        return [("params/w", np.full(3, payload, np.float32))]

    pub = tlearner.WeightPublisher(tmem.MemoryBroker("ln_pub"), materialize, boot_epoch=7, on_published=sent.append)
    pub.start()
    pub.submit(0.0, 0)
    time.sleep(0.05)  # version 0 is in materialize, blocked on the gate
    for v in range(1, 6):
        pub.submit(float(v), v)
    gate.set()
    pub.stop()
    assert sent == [0, 5] and (pub.published, pub.coalesced) == (2, 4) and pub._thread is None
    named, version, epoch = tser.deserialize_weights(tmem.MemoryBroker("ln_pub").poll_weights())
    assert (version, epoch) == (5, 7) and named[0][1].tolist() == [5.0] * 3


def test_metrics_logger_and_histogram_scalars_match_the_reference(tmp_path):
    from dotaclient_tpu.runtime import metrics as jmetrics
    from dotaclient_tpu_torch.runtime import metrics as tmetrics

    for edges, counts in (([1, 2, 4], [3, 0, 1, 5]), ([], [2])):
        assert tmetrics.histogram_scalars("age", edges, counts) == jmetrics.histogram_scalars("age", edges, counts)
    log = tmetrics.MetricsLogger(str(tmp_path / "m"))
    assert log.latest() == {} and log.latest_step() == -1
    log.log(3, {"loss": np.float32(0.5), "n": 2})
    log.close()
    log.log(4, {"loss": 1.0})  # after close: dropped, not an error
    assert log.latest() == {"loss": 0.5, "n": 2.0} and log.latest_step() == 3
    (rec,) = _metric_lines(tmp_path / "m" / "metrics.jsonl")
    assert rec["step"] == 3 and rec["loss"] == 0.5 and rec["n"] == 2.0


REFUSED = [
    ("profile_port", 9999, "A.13b"),
]


@pytest.mark.parametrize("field,value,item", REFUSED, ids=[r[0] for r in REFUSED])
def test_unported_modes_are_refused(tmp_path, field, value, item):
    cfg = _tcfg("ln_refuse", tmp_path)
    obj, *path = [cfg] + field.split(".")
    for name in path[:-1]:
        obj = getattr(obj, name)
    setattr(obj, path[-1], value)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        tlearner.Learner(cfg, tmem.MemoryBroker("ln_refuse"), device="cpu")


# The four data modes the learner once refused: each now picks its path
# (assembled intake against a broker with no DTB1 op raises, as the
# reference's does).
DATA_MODES = [("staging.assemble", True), ("replay.enabled", True), ("fused_h2d", False),
              ("fused_single_h2d", False)]


@pytest.mark.parametrize("field,value", DATA_MODES, ids=[r[0] for r in DATA_MODES])
def test_unported_modes_are_refused_no_more_for_the_data_modes(tmp_path, field, value):
    cfg = _tcfg("ln_modes", tmp_path)
    obj, *path = [cfg] + field.split(".")
    for name in path[:-1]:
        obj = getattr(obj, name)
    setattr(obj, path[-1], value)
    cfg.replay.max_staleness = 2 * cfg.ppo.max_staleness  # the reservoir's window must exceed the fresh one
    tmem.reset("ln_modes")
    if field == "staging.assemble":
        with pytest.raises(ValueError, match="DTB1"):
            tlearner.Learner(cfg, tmem.MemoryBroker("ln_modes"), device="cpu")
        return
    ln = tlearner.Learner(cfg, tmem.MemoryBroker("ln_modes"), device="cpu")
    try:
        if field == "fused_single_h2d":
            assert ln.fused_io is ln.io and not ln.fused_io.single_mode
        else:  # the tree path: dense staging, one copy per leaf
            assert ln.fused_io is None and isinstance(ln.io, TreeBatchIO)
            assert (ln.staging._reservoir is not None) == (field == "replay.enabled")
    finally:
        ln.close()


def test_every_unported_mode_is_tested_and_their_settings_do_not_parse():
    """The refusal table is config.UNPORTED, one entry per mode (the
    learner has every flag of it); settings that only unported modes read
    are not flags, so they fail to parse instead of doing nothing. The
    replay tuning parses, with the reference's defaults."""
    assert {r[0] for r in REFUSED} == set(unported_flags(LearnerConfig()))
    assert set(UNPORTED) == set(unported_flags(LearnerConfig())) == {"profile_port"}
    cfg = parse_config(LearnerConfig(), ["--policy.tf_sp_axis", "sp", "--policy.tf_sp_mode", "ulysses"])
    assert (cfg.policy.tf_sp_axis, cfg.policy.tf_sp_mode) == ("sp", "ulysses")
    assert LearnerConfig().policy.tf_sp_mode == JLearnerConfig().policy.tf_sp_mode == "ring"
    cfg = parse_config(LearnerConfig(), ["--coordinator", "h:1", "--num_processes", "2", "--process_id", "1"])
    assert (cfg.coordinator, cfg.num_processes, cfg.process_id) == ("h:1", 2, 1)
    cfg = parse_config(LearnerConfig(), ["--replay.ratio", "0.5", "--replay.alpha", "0.5"])
    assert (cfg.replay.ratio, cfg.replay.alpha) == (0.5, 0.5)
    assert dataclasses.asdict(LearnerConfig().replay) == dataclasses.asdict(JLearnerConfig().replay)


def _assert_same_fields(ours, ref, path=""):
    """Every field of the port's config equals the reference's, nested
    dataclasses field by field."""
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            _assert_same_fields(a, b, f"{path}{f.name}.")
        else:
            assert a == b, f"{path}{f.name}"


def test_main_parses_the_reference_flags_and_trains(tmp_path, monkeypatch):
    argv = ["--broker_url", "mem://ln_main", "--platform", "cpu", "--train_steps", "2", "--batch_size", str(B),
            "--seq_len", str(T), "--policy.lstm_hidden", "16", "--policy.unit_embed_dim", "16", "--policy.mlp_hidden", "16",
            "--policy.dtype", "float32", "--learner.prefetch", "false", "--native_packer", "true",
            "--ppo.max_staleness", "1000", "--log_dir", str(tmp_path / "main"), "--publish_legacy_dtw1", "true"]
    tcfg, jcfg = parse_config(LearnerConfig(), argv), j_parse_config(JLearnerConfig(), argv)
    _assert_same_fields(tcfg, jcfg)
    tmem.reset("ln_main")
    for fr in frames_for(tcfg, 2):
        tmem.MemoryBroker("ln_main").publish_experience(fr)
    watcher = tmem.MemoryBroker("ln_main")
    tlearner.main(argv)
    frame = watcher.poll_weights()
    assert frame[:4] == b"DTW1" and tser.deserialize_weights(frame)[1] == 2
    assert [r["step"] for r in _metric_lines(tmp_path / "main" / "metrics.jsonl")] == [2]
    # amqp:// is ported (A.10d3): the same run over RabbitMQ's fake pika
    # ends at the same version, its DTW1 frame on the model fanout
    from tests import fake_pika
    from dotaclient_tpu_torch.transport.rmq import RmqBroker

    monkeypatch.setitem(sys.modules, "pika", fake_pika)
    fake_pika.reset()
    url = "amqp://guest@localhost/"
    feeder = RmqBroker(url)
    for fr in frames_for(tcfg, 2):
        feeder.publish_experience(fr)
    amqp = tlearner.main([url if a == "mem://ln_main" else a for a in argv[:-4]] +
                         ["--log_dir", str(tmp_path / "amqp"), "--publish_legacy_dtw1", "true"])
    assert isinstance(amqp.broker, RmqBroker) and amqp.version == 2
    frame = feeder.poll_weights()
    assert frame[:4] == b"DTW1" and tser.deserialize_weights(frame)[1] == 2 and feeder.experience_depth() == 0
    fake_pika.reset()


class _BrokerSeen(Exception):
    """Raised by a stand-in Learner once main has handed it the broker."""


@pytest.mark.parametrize("url,wrapped", [("mem://ln_chaos", True), ("mem://ln_chaos_a,mem://ln_chaos_b", False)],
                         ids=["classic", "fabric"])
def test_main_chaos_enabled_wraps_the_broker_and_refuses_a_fabric(monkeypatch, url, wrapped):
    """--chaos.enabled: main hands the Learner a ChaosBroker over the
    production broker, with the flags' seed and spec; a fabric URL is
    refused with the reference's reason."""
    seen = {}

    def fake_learner(cfg, broker, device=None, dist=None):
        seen["broker"] = broker
        raise _BrokerSeen

    monkeypatch.setattr(tlearner, "Learner", fake_learner)
    argv = ["--broker_url", url, "--platform", "cpu", "--chaos.enabled", "true", "--chaos.seed", "5",
            "--chaos.spec", "dup:0.1,kill@3:1"]
    if not wrapped:
        with pytest.raises(ValueError, match="chaos cannot wrap a broker fabric"):
            tlearner.main(argv)
        assert "broker" not in seen
        return
    with pytest.raises(_BrokerSeen):
        tlearner.main(argv)
    from dotaclient_tpu_torch.chaos import ChaosBroker

    broker = seen["broker"]
    assert type(broker) is ChaosBroker and type(broker.inner) is tmem.MemoryBroker
    assert broker.schedule.seed == 5 and broker.schedule.rates == {"dup": 0.1} and len(broker.schedule.kills()) == 1
    with pytest.raises(_BrokerSeen):
        tlearner.main(argv[:4])  # chaos off: the production broker itself
    assert type(seen["broker"]) is tmem.MemoryBroker


def test_main_broker_shards_refuses_a_classic_url():
    with pytest.raises(ValueError, match="broker_shards"):
        tlearner.main(["--broker_url", "mem://ln_classic", "--broker_shards", "0", "--train_steps", "1",
                       "--platform", "cpu"])


def test_main_over_a_fabric_shard_trains_bitwise_a_plain_broker_and_logs_the_fanin(tmp_path):
    """`--broker_url mem://a,mem://b --broker_shards 1`: the learner
    binary's main consumes shard 1 only, through the fenced fan-in, and
    ends with params bitwise those of a learner fed the same frames (the
    ones routed to shard 1, in order) by one plain broker; its metric
    windows carry the fanin_* and broker_shard_1_* scalars."""
    from dotaclient_tpu_torch.transport.fabric import FabricBroker, rendezvous_order

    urls = ["mem://ln_fab_0", "mem://ln_fab_1"]
    for u in urls:
        tmem.reset(u[len("mem://"):])
    cfg = _tcfg("ln_fab_plain", tmp_path)
    frames = frames_for(cfg, 8)
    pub = FabricBroker(urls)
    for f in frames:
        pub.publish_experience(f)
    mine = [f for f in frames if rendezvous_order(tser.peek_rollout_actor_id(f), urls)[0] == 1]
    steps = len(mine) // B
    assert steps >= 2
    argv = ["--broker_url", ",".join(urls), "--broker_shards", "1", "--platform", "cpu", "--train_steps", str(steps),
            "--batch_size", str(B), "--seq_len", str(T), "--policy.lstm_hidden", "16", "--policy.unit_embed_dim", "16",
            "--policy.mlp_hidden", "16", "--policy.dtype", "float32", "--ppo.max_staleness", "1000",
            "--metrics_every", "2", "--native_packer", "true", "--log_dir", str(tmp_path / "ln_fab")]
    fab = tlearner.main(argv)
    assert isinstance(fab.broker, FabricBroker) and fab.broker.consume_shards == [1] and fab.version == steps
    plain, _ = _port_learner("ln_fab_plain", tmp_path, mine, native_packer=True)
    plain.run(num_steps=steps, max_idle=3)
    plain.close()
    for (na, a), (nb, b) in zip(named_params(fab.state.net), named_params(plain.state.net)):
        assert na == nb and np.array_equal(a, b), na
    rec = _metric_lines(tmp_path / "ln_fab" / "metrics.jsonl")[-1]
    assert rec["fanin_delivered_total"] >= steps * B and rec["fanin_pop_threads"] == 1.0
    assert rec["broker_shard_1_up"] == 1.0 and "broker_shard_0_up" not in rec
    assert rec["fanin_fence_dropped_total"] == rec["fanin_dup_dropped_total"] == 0
    fab.broker.close()
    pub.close()


# ------------------------------------------------------------ interop loop

SMALL = dict(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32")


@pytest.fixture()
def env_addr():
    server, port = serve(FakeDotaService(), max_workers=4)
    yield f"127.0.0.1:{port}"
    server.stop(0)


def test_jax_actor_trains_the_port_learner_and_runs_its_weights(env_addr, tmp_path):
    """fake dotaservice → JAX Actor → the reference's mem:// broker → the
    port learner (handed that broker object) → DTW2 → the JAX actor's
    weight hot-swap (the shape of tests/test_e2e.py's weights test)."""
    name = "ln_interop"
    jmem.reset(name)
    tcfg = LearnerConfig(batch_size=8, seq_len=8, policy=PolicyConfig(**SMALL), publish_every=1,
                         log_dir=str(tmp_path / "interop"), metrics_every=1)
    acfg = JActorConfig(env_addr=env_addr, broker_url=f"mem://{name}", rollout_len=8, max_dota_time=15.0,
                        policy=JPolicyConfig(**SMALL), seed=2)
    learner = tlearner.Learner(tcfg, jmem.MemoryBroker(name), device="cpu")
    actor = JActor(acfg, jmem.MemoryBroker(name), actor_id=0)
    errors = []

    def train():
        try:
            learner.run(num_steps=3, batch_timeout=60.0, max_idle=2)
        except BaseException as e:
            errors.append(e)

    async def interleave():
        t = threading.Thread(target=train, daemon=True)
        t.start()
        while t.is_alive():
            await actor.run_episode()
        await actor.run_episode()  # picks up the final published weights
        t.join(timeout=10)
        return t

    try:
        t = asyncio.new_event_loop().run_until_complete(interleave())
    finally:
        learner.close()
    assert not t.is_alive() and not errors
    assert learner.version == 3 and actor.version == 3
    assert actor.weight_epoch == learner.boot_epoch
    # the actor runs exactly the port learner's weights
    for (n, a), (m, b) in zip(flatten_params(actor.params), named_params(learner.state.net)):
        assert n == m and np.array_equal(a, b)
    stats = learner.staging.stats()
    assert stats["consumer_errors"] == 0 and stats["dropped_bad"] == 0 and stats["batches"] >= 3
    lines = _metric_lines(tmp_path / "interop" / "metrics.jsonl")
    assert [r["step"] for r in lines] == [1, 2, 3] and all(np.isfinite(r["loss"]) for r in lines)


# ------------------------------------------------------ production manifest

def _manifest_args():
    import yaml

    from pathlib import Path

    doc = next(d for d in yaml.safe_load_all((Path(__file__).resolve().parents[1] / "k8s" / "learner.yaml").read_text())
               if d and d.get("kind") == "StatefulSet")
    (container,) = doc["spec"]["template"]["spec"]["containers"]
    return list(container["args"])


def _swap(args, flag, value):
    out = list(args)
    out[out.index(flag) + 1] = value
    return out


def test_the_learner_manifest_parses_and_builds_a_port_learner(tmp_path):
    """k8s/learner.yaml's args: every flag parses in the port as in the
    reference and none is refused; the comma-list broker_url builds the
    broker fabric over its three shards (no dial until used); with one
    endpoint, local paths and --platform cpu they build a Learner whose
    obs, pool, ring, checkpoint and drain settings are the manifest's; a
    gs:// remote refuses with its message. chip_smoke.py reads the same
    args without yaml."""
    import signal
    import sys

    import chip_smoke

    args = _manifest_args()
    assert chip_smoke.manifest_args() == args
    tcfg, jcfg = parse_config(LearnerConfig(), args), j_parse_config(JLearnerConfig(), args)
    _assert_same_fields(tcfg, jcfg)
    assert tcfg.staging.pack_workers == 4 and tcfg.ckpt.drain_budget_s == 45.0 and tcfg.mesh_shape == "dp=-1"
    refuse_unported(tcfg)
    from dotaclient_tpu_torch.transport.fabric import FabricBroker

    fabric = connect(tcfg.broker_url)
    assert isinstance(fabric, FabricBroker) and len(fabric.endpoints) == 3
    fabric.close()
    local = _swap(_swap(args, "--broker_url", "mem://ln_manifest"), "--checkpoint_remote_dir", str(tmp_path / "remote"))
    for flag, sub in (("--checkpoint_dir", "ck"), ("--log_dir", "logs"), ("--obs.dump_dir", "logs"),
                      ("--obs.profile_dir", "logs")):
        local = _swap(local, flag, str(tmp_path / sub))
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    local = _swap(local, "--obs.metrics_port", str(port)) + ["--platform", "cpu"]
    cfg = parse_config(LearnerConfig(), local)
    saved = sys.excepthook, threading.excepthook, signal.getsignal(signal.SIGTERM)
    tmem.reset("ln_manifest")
    learner = tlearner.Learner(cfg, tmem.MemoryBroker("ln_manifest"), device="cpu")
    try:
        assert learner.obs is not None and learner.obs.server.port == port and learner.obs.watchdog is not None
        assert learner.obs.compute.timer is not None and learner.obs.compute.timer.overlap
        assert learner.obs.watchdog.cfg.starvation_frac == 0.95
        assert learner._ckpt_worker is not None and learner.checkpointer.mirror_stats() is not None
        learner.staging.start()
        assert learner.staging._pool.n == 4 and learner.staging._ring.depth == 2
        learner.staging.stop()
        learner.install_drain_handler()
        signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        assert learner.drain_requested and learner._drain_timer.interval == 45.0
        learner._drain_timer.cancel()
    finally:
        learner.close()
        sys.excepthook, threading.excepthook = saved[0], saved[1]
        signal.signal(signal.SIGTERM, saved[2])
    with pytest.raises(ValueError, match="URL scheme"):
        tlearner.Learner(parse_config(LearnerConfig(), _swap(local, "--checkpoint_remote_dir", "gs://b/ck")),
                         tmem.MemoryBroker("ln_manifest"), device="cpu")


def test_a_mesh_beyond_one_device_is_refused(tmp_path):
    """A single process is a world of one: dp=2 and dp=1,tp=2 do not cover
    it (ValueError, as parse_mesh_spec); tf_sp_axis naming no mesh axis is
    the reference's ValueError; a mesh of size-1 axes runs."""
    cfg = _tcfg("ln_mesh", tmp_path, mesh_shape="dp=2")
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        tlearner.Learner(cfg, tmem.MemoryBroker("ln_mesh"), device="cpu")
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        tlearner.Learner(_tcfg("ln_mesh", tmp_path, mesh_shape="dp=1,tp=2"), tmem.MemoryBroker("ln_mesh"), device="cpu")
    sp = _tcfg("ln_mesh", tmp_path)
    sp = dataclasses.replace(sp, policy=dataclasses.replace(sp.policy, tf_sp_axis="sp"))
    with pytest.raises(ValueError, match="names no axis of mesh"):
        tlearner.Learner(sp, tmem.MemoryBroker("ln_mesh"), device="cpu")
    assert tlearner.Learner(_tcfg("ln_mesh", tmp_path, mesh_shape="dp=1,tp=1"), tmem.MemoryBroker("ln_mesh"),
                            device="cpu").version == 0
