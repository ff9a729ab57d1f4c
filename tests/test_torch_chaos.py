"""The port's chaos harness (dotaclient_tpu_torch/chaos/) against the
reference's (dotaclient_tpu/chaos/): every fault decision equal for the
same (seed, spec, op index), the grammar's parses and refusals equal, the
ChaosBroker delivering the same bytes with the same meters over mem://,
the env stub's session loss survived by the port's Actor, the fabric
refusal, the kill/restart controllers with their ledgers on the CPU, and
the inertness contract (chaos off: the package is never imported and the
wire bytes do not change)."""

import asyncio
import json
import os
import random
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from dotaclient_tpu import chaos as jchaos
from dotaclient_tpu.chaos import schedule as jschedule
from dotaclient_tpu.transport import memory as jmem
from dotaclient_tpu.transport.base import BrokerShedError as JBrokerShedError
from dotaclient_tpu_torch import chaos as tchaos
from dotaclient_tpu_torch.chaos import schedule as tschedule
from dotaclient_tpu_torch.config import ActorConfig, ChaosConfig, LearnerConfig, PolicyConfig
from dotaclient_tpu_torch.obs import registry as tregistry
from dotaclient_tpu_torch.transport import memory as tmem
from dotaclient_tpu_torch.transport.base import BrokerShedError, RetryPolicy, connect
from dotaclient_tpu_torch.transport.tcp import TcpBroker

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32")

# The reference's pinned golden decision sequence (tests/test_chaos.py):
# (corrupt, truncate, dup, reset, shed) for op indices 0..47 under seed 3.
GOLDEN_SPEC = "corrupt:0.04,truncate:0.03,dup:0.05,reset:0.02,shed:0.03,latency:0.002~0.001"
GOLDEN_SEQ = (
    "010000000001000001000000000000000000000000100000000000000000"
    "100000000000000000000000000000000000000000000000000000000000"
    "000000000010000000000000001000000000000000000000000000000000"
    "000000000000000000001010000100000000000000000000000000000000"
)
FLAGS = ("corrupt", "truncate", "dup", "reset", "shed")

# (spec, seed) pairs whose decisions must match the reference's exactly
DECISION_CASES = [
    (GOLDEN_SPEC, 3),
    (GOLDEN_SPEC + ",kill@10:2@learner:term,kill@20:2@learner,rolling@4:1@broker,scale@5:4@server", 3),
    ("corrupt:0.1,dup:0.05,reset:0.02,latency:0.002~0.001", 11),
    ("corrupt:0.015,truncate:0.008,dup:0.015,reset:0.006,latency:0.001~0.001,stall@16:2,kill@4:2", 7),
    ("shed:0.5,latency:0.01", 0),
    ("truncate:0.2,reset:0.1", 123456),
    ("", 5),
]


def _decision(f):
    """One decision with its sub-rng's next draws (the corrupt/truncate
    byte choices come from it)."""
    return (tuple(getattr(f, n) for n in FLAGS), f.latency_s, f.rng.getstate())


@pytest.mark.parametrize("spec,seed", DECISION_CASES, ids=[f"case{i}" for i in range(len(DECISION_CASES))])
def test_decisions_equal_the_reference_for_2000_ops(spec, seed):
    ours = tschedule.FaultSchedule.parse(spec, seed=seed)
    ref = jschedule.FaultSchedule.parse(spec, seed=seed)
    for i in range(2000):
        assert _decision(ours.decide(i)) == _decision(ref.decide(i)), i


def test_golden_decision_sequence_pinned():
    def seq(spec):
        s = tschedule.FaultSchedule.parse(spec, seed=3)
        return "".join("".join(str(int(getattr(s.decide(i), n))) for n in FLAGS) for i in range(48))

    assert seq(GOLDEN_SPEC) == GOLDEN_SEQ
    # timed events consume no rate draw, whatever their target
    for extra in (",kill@10:2@learner:term,kill@20:2@learner", ",kill@7:2@server", ",rolling@6:1@server",
                  ",rolling@4:1@broker", ",scale@2:3@broker,scale@8:2@actor,scale@11:2@server"):
        assert seq(GOLDEN_SPEC + extra) == GOLDEN_SEQ
    s = tschedule.FaultSchedule.parse(GOLDEN_SPEC + ",kill@9:1@learner", seed=3)
    assert round(s.decide(0).latency_s, 9) == 0.00253577
    assert round(s.decide(47).latency_s, 9) == 0.002151729


# the reference's parse cases (tests/test_chaos.py grammar tests)
PARSE_CASES = [
    "kill@10:2,stall@5:1.5,kill@20:3,latency:0.01~0.002",
    "kill@10:3,kill@20:2@learner:term,kill@30:2@learner,kill@40:1@broker",
    "rolling@5:1.5@server,kill@10:2",
    "rolling@1:2",
    "rolling@3:1@broker",
    "scale@5:4@server,kill@10:2,scale@20:2@broker,scale@30:8@actor",
    "kill@7:2@server,corrupt:0.5,shed:0.25",
    GOLDEN_SPEC,
    " corrupt:0.1 , ,dup:0.2 ",
]

REJECT_CASES = [
    "explode:0.5",
    "corrupt:1.5",
    "melt@3:1",
    "stall@5:1@learner",
    "kill@5:1@broker:term",
    "kill@5:1@learner:hup",
    "kill@5:1@evaluator",
    "rolling@1:2@learner",
    "rolling@1:2@server:term",
    "rolling@1:2@broker:term",
    "stall@1:2@server",
    "scale@5:4",
    "scale@5:4@learner",
    "scale@5:4@server:term",
    "scale@5:0@server",
    "scale@5:1.5@server",
    "corrupt:-0.1",
]


def _parsed(s):
    return ([(e.kind, e.at_s, e.duration_s, e.target, e.signal) for e in s.events], s.rates, s.latency_mean_s,
            s.latency_jitter_s, [e.at_s for e in s.kills()], [e.at_s for e in s.scales()],
            [e.at_s for e in s.stalls()])


@pytest.mark.parametrize("spec", PARSE_CASES)
def test_grammar_parses_as_the_reference(spec):
    ours, ref = tschedule.FaultSchedule.parse(spec, seed=1), jschedule.FaultSchedule.parse(spec, seed=1)
    assert _parsed(ours) == _parsed(ref)
    for t in (0.0, 5.5, 7.0, 16.5):
        assert ours.stall_remaining(t) == ref.stall_remaining(t)


@pytest.mark.parametrize("spec", REJECT_CASES)
def test_grammar_refuses_as_the_reference(spec):
    with pytest.raises(ValueError) as ours:
        tschedule.FaultSchedule.parse(spec)
    with pytest.raises(ValueError) as ref:
        jschedule.FaultSchedule.parse(spec)
    assert str(ours.value) == str(ref.value)


def test_corrupt_and_truncate_bytes_equal_the_reference():
    data = b"DTR1" + bytes(range(200))
    for seed in range(50):
        bad = tschedule.corrupt_bytes(data, random.Random(seed))
        assert bad == jschedule.corrupt_bytes(data, random.Random(seed))
        assert len(bad) == len(data)
        cut = tschedule.truncate_bytes(data, random.Random(seed))
        assert cut == jschedule.truncate_bytes(data, random.Random(seed))
        assert len(data) // 2 <= len(cut) < len(data)
    assert tschedule.corrupt_bytes(data, random.Random(3))[:4] != b"DTR1"  # the first flip lands in the magic
    assert tschedule.corrupt_bytes(b"", random.Random(0)) == b""
    assert tschedule.truncate_bytes(b"x", random.Random(0)) == b"x"


# ------------------------------------------------------------ chaos broker


def _drive(cb, shed_error, frames):
    """Publish every frame through `cb` (outcome per op), then consume
    everything; returns (outcomes, delivered bytes)."""
    outcomes = []
    for f in frames:
        try:
            cb.publish_experience(f)
            outcomes.append("ok")
        except ConnectionResetError:
            outcomes.append("reset")
        except shed_error:
            outcomes.append("shed")
        if len(outcomes) % 7 == 0:  # consume ops draw decisions too
            try:
                outcomes.append(len(cb.consume_experience(3, timeout=0.0)))
            except ConnectionResetError:
                outcomes.append("consume-reset")
    delivered = []
    while True:
        got = cb.inner.consume_experience(64, timeout=0.0)
        if not got:
            return outcomes, delivered
        delivered.extend(got)


@pytest.mark.parametrize("seed", [0, 4, 9])
def test_chaos_broker_delivers_the_reference_bytes_and_meters(seed):
    spec = "corrupt:0.1,truncate:0.08,dup:0.1,reset:0.05,shed:0.05,latency:0.003~0.002,stall@1000:1"
    frames = [b"DTR1" + bytes([i % 251]) * (40 + i) for i in range(300)]
    slept = {"t": [], "j": []}
    name = f"tchaos-bytes-{seed}"
    tmem.reset(name)
    jmem.reset(name)
    ours = tchaos.ChaosBroker(tmem.MemoryBroker(name, maxlen=4096), tschedule.FaultSchedule.parse(spec, seed=seed),
                              sleep=slept["t"].append)
    ref = jchaos.ChaosBroker(jmem.MemoryBroker(name, maxlen=4096), jschedule.FaultSchedule.parse(spec, seed=seed),
                             sleep=slept["j"].append)
    out_t, got_t = _drive(ours, BrokerShedError, frames)
    out_j, got_j = _drive(ref, JBrokerShedError, frames)
    assert out_t == out_j and got_t == got_j and slept["t"] == slept["j"]
    assert ours.meters == ref.meters
    m = ours.meters
    assert m["chaos_corrupted"] and m["chaos_truncated"] and m["chaos_duplicated"] and m["chaos_resets"]
    assert m["chaos_sheds"] and m["chaos_latency_s"] > 0 and m["chaos_ops"] == len(out_t)
    # every meter is a registered family member in both packages
    from dotaclient_tpu.obs import registry as jregistry

    assert all(tregistry.is_registered(k) and jregistry.is_registered(k) for k in m)


def test_chaos_broker_stall_and_weight_ops_pay_delays_only():
    clock = [0.0]
    slept = []
    tmem.reset("tchaos-stall")
    cb = tchaos.ChaosBroker(tmem.MemoryBroker("tchaos-stall"),
                            tschedule.FaultSchedule.parse("reset:1.0,stall@5:2", seed=0), t0=0.0,
                            clock=lambda: clock[0], sleep=slept.append)
    clock[0] = 5.5
    cb.publish_weights(b"w")  # reset never hits a weight op
    assert cb.poll_weights() == b"w"
    assert slept == [1.5, 1.5] and cb.meters["chaos_stall_s"] == 3.0 and cb.meters["chaos_resets"] == 0
    with pytest.raises(ConnectionResetError):
        cb.consume_experience(1, timeout=0.0)
    assert cb.stats()["chaos_resets"] == 1 and cb.experience_depth() == 0


def test_chaos_broker_dup_counts_only_delivered_extras():
    tmem.reset("tchaos-dup")
    inner = tmem.MemoryBroker("tchaos-dup", maxlen=8, shed_high=2, shed_low=1)
    cb = tchaos.ChaosBroker(inner, tschedule.FaultSchedule.parse("dup:1.0", seed=0))
    cb.publish_experience(b"a")  # a + dup(a): depth 2
    assert cb.meters["chaos_duplicated"] == 1
    with pytest.raises(BrokerShedError):
        cb.publish_experience(b"b")
    assert cb.meters["chaos_duplicated"] == 1


class _Fabricish:
    def fanin_residual(self):
        return 0


def test_wrap_broker_refuses_a_fabric_with_the_reference_reason():
    cfg = ChaosConfig(enabled=True, seed=1, spec="dup:0.1")
    with pytest.raises(ValueError) as ref:
        jchaos.wrap_broker(_Fabricish(), cfg)
    fabric = connect("tcp://127.0.0.1:1,tcp://127.0.0.1:2")  # no dial until used
    try:
        for broker in (_Fabricish(), fabric):
            with pytest.raises(ValueError) as ours:
                tchaos.wrap_broker(broker, cfg)
            assert str(ours.value) == str(ref.value)
    finally:
        fabric.close()
    tmem.reset("tchaos-wrap")
    inner = tmem.MemoryBroker("tchaos-wrap")
    wrapped = tchaos.wrap_broker(inner, cfg)
    assert type(wrapped) is tchaos.ChaosBroker and wrapped.inner is inner and wrapped.schedule.rates == {"dup": 0.1}


# ----------------------------------------------------------- env stub


def test_chaos_env_stub_session_loss_is_survived_by_the_actor():
    from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
    from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
    from dotaclient_tpu_torch.eval.evaluator import NullBroker
    from dotaclient_tpu_torch.runtime.actor import Actor

    cfg = ActorConfig(env_addr="local", rollout_len=4, max_dota_time=2.0, policy=PolicyConfig(**SMALL),
                      max_weight_age_s=0.0, platform="cpu")
    stub = tchaos.wrap_env_stub(LocalDotaServiceStub(FakeDotaService()),
                                ChaosConfig(enabled=True, seed=1, spec="reset:1.0,latency:0.001"))
    assert stub.channel is stub.inner.channel
    actor = Actor(cfg, NullBroker(), stub=stub)
    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(actor.run_episode())
        assert actor.episodes_done == 1 and actor.last_win is None  # abandoned, not crashed
        # a partial session loss: the next episodes still run to an end
        stub.schedule = tschedule.FaultSchedule.parse("reset:0.02", seed=3)
        for _ in range(3):
            loop.run_until_complete(actor.run_episode())
    finally:
        loop.close()
    assert actor.episodes_done == 4
    assert stub.sessions_lost >= 1 and stub.latency_s > 0.0


# ------------------------------------------------------- controllers


def test_broker_incarnations_kill_restart_and_ledger_identity():
    inc = tchaos.BrokerIncarnations(port=0, maxlen=32)
    client = TcpBroker(port=inc.port, retry=RetryPolicy(window_s=10, backoff_base_s=0.05))
    try:
        client.publish_experience(b"f1")
        client.publish_experience(b"f2")
        assert inc.server.first_enqueue_t is not None
        assert client.consume_experience(10, timeout=1.0) == [b"f1", b"f2"]
        client.publish_experience(b"dies-with-broker")
        led = inc.kill()
        assert (led["enqueued"], led["popped"], led["resident"]) == (3, 2, 1)
        assert inc.wait_first_enqueue(timeout=0.1) is None  # no live incarnation
        inc.restart()
        assert inc.server.port == inc.port and inc.server.first_enqueue_t is None
        client.publish_experience(b"after-restart")  # the retry loop reconnects
        assert inc.wait_first_enqueue(timeout=5.0) is not None
        total = inc.final_ledger()
        assert total["incarnations"] == 2 and total["enqueued"] == 4
        assert total["enqueued"] == total["popped"] + total["dropped_oldest"] + total["resident"]
        assert inc.ledgers[-1]["killed_at"] is None and inc.replica_count() == 1
        with pytest.raises(RuntimeError):
            inc.kill()
    finally:
        client.close()


def test_schedule_runner_executes_kills_and_reports_recovery():
    inc = tchaos.BrokerIncarnations(port=0, maxlen=32)
    runner = tchaos.ScheduleRunner(tschedule.FaultSchedule.parse("kill@0.3:0.4,kill@1.2:0.3", seed=0), inc,
                                   time.monotonic()).start()
    client = TcpBroker(port=inc.port, retry=RetryPolicy(window_s=15, backoff_base_s=0.05))
    stop = threading.Event()

    def publisher():
        while not stop.is_set():
            try:
                client.publish_experience(b"beat")
            except (ConnectionError, OSError, BrokerShedError):
                pass
            time.sleep(0.05)

    t = threading.Thread(target=publisher, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while len(runner.recovery) < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    stop.set()
    t.join(timeout=5)
    runner.stop()
    client.close()
    assert len(inc.kill_times) == 2 and [r["target"] for r in runner.recovery] == ["broker", "broker"]
    assert all(r["recovery_s"] is not None and r["recovery_s"] < 20 for r in runner.recovery)
    total = inc.final_ledger()
    assert total["incarnations"] == 3
    assert all(l["enqueued"] == l["popped"] + l["dropped_oldest"] + l["resident"] for l in inc.ledgers)


class _Router:
    """N replicas behind kill()/restart() rotation, as a soak's router."""

    def __init__(self, n, probe=None):
        self.n, self.kills, self.restarts, self.probes = n, [], [], 0
        if probe is not None:
            setattr(self, probe, self._probe)

    def replica_count(self):
        return self.n

    def kill(self):
        self.kills.append(time.monotonic())

    def restart(self):
        self.restarts.append(time.monotonic())

    def _probe(self, timeout=30.0, stop=None):
        self.probes += 1
        return time.monotonic()


@pytest.mark.parametrize("target,probe", [("server", "wait_first_request"), ("broker", "wait_first_enqueue")])
def test_rolling_fans_kills_across_replicas_one_at_a_time(target, probe):
    router = _Router(3, probe)
    kw = {"server": router, "broker": None} if target == "server" else {"broker": router}
    runner = tchaos.ScheduleRunner(tschedule.FaultSchedule.parse(f"rolling@0.02:0.03@{target}", seed=0),
                                   t0=time.monotonic(), **kw).start()
    deadline = time.monotonic() + 10
    while len(router.restarts) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    runner.stop()
    assert len(router.kills) == 3 and len(router.restarts) == 3 and router.probes == 3
    assert [e["replica"] for e in runner.recovery] == [0, 1, 2]
    assert all(e["kind"] == "rolling" and e["target"] == target for e in runner.recovery)
    for i in range(2):
        assert router.restarts[i] <= router.kills[i + 1], "two replicas down at once"
    for kt, rt in zip(router.kills, router.restarts):
        assert rt - kt >= 0.028
    with pytest.raises(ValueError, match=target):
        tchaos.ScheduleRunner(tschedule.FaultSchedule.parse(f"rolling@1:1@{target}", seed=0), broker=None, t0=0.0)


def test_schedule_runner_refuses_a_target_without_its_controller():
    for spec, what in (("kill@1:1@learner", "LearnerIncarnations"), ("kill@1:1", "BrokerIncarnations"),
                       ("kill@1:1@server", "server")):
        with pytest.raises(ValueError, match=what):
            tchaos.ScheduleRunner(tschedule.FaultSchedule.parse(spec), broker=None, t0=0.0)


@pytest.mark.parametrize("models", [1, 2])
def test_serve_incarnations_kill_restart_on_one_port_with_ledgers(models):
    """Server lives on one port; each dead life's ledger reads the port
    server as the reference's harvest reads it (per-slot keys with
    --serve.models > 1)."""
    from dotaclient_tpu_torch.config import InferenceConfig, ServeConfig
    from dotaclient_tpu_torch.serve.server import InferenceServer

    def make_server(port):
        cfg = InferenceConfig(serve=ServeConfig(port=port, models=models), policy=PolicyConfig(**SMALL),
                              platform="cpu")
        return InferenceServer(cfg).start()

    inc = tchaos.ServeIncarnations(make_server)
    port = inc.port
    led = inc.kill()
    assert led["killed_at"] is not None and led["requests"] == 0 and led["carries_resident_at_kill"] == 0
    twin = make_server(0)
    ref = jchaos.ServeIncarnations._harvest(twin, chaos_kill=False)
    assert {k: v for k, v in led.items() if k != "killed_at"} == {k: v for k, v in ref.items() if k != "killed_at"}
    assert ("model1_requests" in led) == (models == 2)
    inc.restart()
    assert inc.server.port == port and inc.wait_first_request(timeout=0.1) is None
    total = inc.final_ledger()
    assert total["incarnations"] == 2 and total["requests"] == 0 and inc.replica_count() == 1
    assert inc.ledgers[-1]["killed_at"] is None


def _learner_frames(cfg, version, seed):
    from test_torch_learner import frames_for

    return frames_for(cfg, 1, version=version, seed0=seed)


def test_learner_incarnations_term_then_kill_with_their_ledgers(tmp_path):
    """A term life drains (clean exit, durable full state that the next
    boot resumes at its version), a kill life saves nothing at death (the
    next boot restores the periodic checkpoint, and the published
    high-water keeps the version monotonic), and every life's staging
    intake balances exactly."""
    from dotaclient_tpu_torch.runtime.checkpoint import Checkpointer, state_arrays
    from dotaclient_tpu_torch.runtime.learner import Learner

    name = "tchaos-linc"
    tmem.reset(name)
    ckpt = str(tmp_path / "ckpt")

    def cfg_():
        cfg = LearnerConfig(batch_size=8, seq_len=4, policy=PolicyConfig(**SMALL), checkpoint_dir=ckpt,
                            checkpoint_every=5, publish_every=1, metrics_every=1, platform="cpu")
        cfg.ckpt.full_state = True
        cfg.ckpt.async_save = True
        return cfg

    learners, boot_states = [], []

    def make_learner():
        learner = Learner(cfg_(), connect(f"mem://{name}"), device="cpu")
        learners.append(learner)
        boot_states.append(state_arrays(learner.state))  # before its loop starts
        return learner

    inc = tchaos.LearnerIncarnations(make_learner, run_kwargs={"batch_timeout": 1.0}).start()
    pub = connect(f"mem://{name}")
    stop_feed = threading.Event()

    def feeder():
        k = 0
        while not stop_feed.is_set():
            learner = inc.learner
            depth = pub.experience_depth()
            if depth < 32:
                for f in _learner_frames(cfg_(), learner.version if learner else 0, k):
                    pub.publish_experience(f)
                k += 1
            time.sleep(0.01)

    feed = threading.Thread(target=feeder, daemon=True)
    feed.start()
    try:
        deadline = time.monotonic() + 60
        while inc.learner.version < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert inc.learner.version >= 2, "warm-up never trained"
        led1 = inc.kill(sig="term")
        assert led1["exit_clean"] and led1["sig"] == "term" and led1["loop_error"] is None, led1
        inc.restart()
        assert inc.boots[-1]["resume_version"] == led1["version"], (inc.boots[-1], led1)
        drained = state_arrays(learners[0].state)
        assert drained.keys() == boot_states[1].keys()
        for k, v in drained.items():  # the drained state restores bitwise
            assert v.dtype == boot_states[1][k].dtype and v.tobytes() == boot_states[1][k].tobytes(), k
        assert inc.wait_first_step(timeout=60.0) is not None, "no post-drain step"
        deadline = time.monotonic() + 60
        while inc.learner.version < led1["version"] + 7 and time.monotonic() < deadline:
            time.sleep(0.02)
        led2 = inc.kill(sig="kill")
        assert led2["sig"] == "kill" and not led2["exit_clean"], led2
        hwm = Checkpointer(ckpt).published_hwm()
        inc.restart()
        boot = inc.boots[-1]
        restored = int(boot["resume"]["resume_restored_step"])
        # the last periodic checkpoint (every 5 steps), or the drain's save
        assert restored <= led2["version"] and (restored % 5 == 0 or restored == led1["version"]), boot
        # the published high-water keeps the version stamps monotonic
        assert hwm is not None and hwm >= restored and boot["resume_version"] == hwm, (boot, hwm, led2)
        assert inc.wait_first_step(timeout=60.0) is not None, "no post-kill step"
    finally:
        stop_feed.set()
        feed.join(timeout=5)
    totals = inc.final_ledger()
    assert totals["incarnations"] == 3 and inc.lives[-1]["killed_at"] is None
    for life in inc.lives:  # every frame a life took has a fate
        fresh = life["rows_packed"] - life["rows_replayed"]
        assert (life["consumed"] + life["resume_pending"]
                == life["dropped_stale"] + life["dropped_bad"] + fresh + life["pending_at_death"]
                + life["replay_admitted"]), life


# ---------------------------------------------------------- inertness

_INERT = r"""
import json, sys
from dotaclient_tpu_torch.config import ActorConfig, InferenceConfig, LearnerConfig, PolicyConfig, ServeConfig
from dotaclient_tpu_torch.runtime import actor as A, learner as L
from dotaclient_tpu_torch.serve import server as S
from dotaclient_tpu_torch.transport import memory as mem
from dotaclient_tpu_torch.transport.base import connect
pol = PolicyConfig(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32")
b = connect("mem://inert")
assert type(b) is mem.MemoryBroker
learner = L.Learner(LearnerConfig(batch_size=4, seq_len=4, policy=pol, platform="cpu"), b, device="cpu")
actor = A.Actor(ActorConfig(policy=pol, platform="cpu"), b)
server = S.InferenceServer(InferenceConfig(serve=ServeConfig(port=0), policy=pol, platform="cpu"), b)
learner.close()
print(json.dumps(sorted(m for m in sys.modules if m.startswith("dotaclient_tpu_torch.chaos"))))
"""


def test_chaos_off_imports_nothing_of_the_package():
    proc = subprocess.run([sys.executable, "-c", _INERT], cwd=REPO, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def _episode_bytes(chaos_cfg, name):
    from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
    from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
    from dotaclient_tpu_torch.runtime.actor import Actor

    tmem.reset(name)
    broker = connect(f"mem://{name}")
    cfg = ActorConfig(env_addr="local", rollout_len=4, max_dota_time=2.0, policy=PolicyConfig(**SMALL),
                      max_weight_age_s=0.0, platform="cpu", seed=3, chaos=chaos_cfg)
    actor = Actor(cfg, broker, stub=LocalDotaServiceStub(FakeDotaService()))
    asyncio.new_event_loop().run_until_complete(actor.run_episode())
    return broker.consume_experience(10_000, timeout=0.0)


def test_chaos_off_publishes_the_same_bytes():
    """An off chaos config, whatever its seed and spec, changes nothing on
    the wire."""
    plain = _episode_bytes(ChaosConfig(), "tchaos-off-a")
    off = _episode_bytes(ChaosConfig(enabled=False, seed=9, spec="corrupt:1.0,dup:1.0"), "tchaos-off-b")
    assert plain and plain == off
    assert ChaosConfig() == ChaosConfig(enabled=False, seed=0, spec="")


# ---------------------------------------------------------- the soak


@pytest.mark.nightly
@pytest.mark.slow
def test_chaos_soak_quick_schema_and_invariants(tmp_path):
    """The soak twin's --quick run on the CPU holds the reference's
    invariants, and its artifact carries the reference's keys."""
    out = tmp_path / "soak.json"
    env = dict(os.environ, DOTACLIENT_TPU_ALLOW_STRAYS="1")
    proc = subprocess.run([sys.executable, "-m", "dotaclient_tpu_torch.scripts.chaos_soak", "--quick", "--platform",
                           "cpu", "--out", str(out)], cwd=REPO, capture_output=True, text=True, timeout=420, env=env)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    artifact = json.loads(out.read_text())
    ref = json.loads((REPO / "CHAOS_SOAK.json").read_text())
    assert set(artifact["verdict"]) == set(ref["verdict"])
    assert set(artifact["conservation"]) == set(ref["conservation"])
    for key in ("phase_1_baseline", "phase_2_chaos", "phase_3_overload"):
        assert set(artifact[key]) == set(ref[key]), key
    v = artifact["verdict"]
    assert all(val for val in v.values() if isinstance(val, bool)), v
    assert v["kills_executed"] >= 1 and artifact["conservation"]["unaccounted_frames"] == 0


def test_soak_frames_parse_in_the_port_staging_layout():
    """The soak's own frames (the port's serializer over make_train_batch
    rows) carry the header fields the soak stamps at the offsets it
    stamps them."""
    import struct

    from dotaclient_tpu_torch.scripts import chaos_soak
    from dotaclient_tpu_torch.transport.serialize import deserialize_rollout

    cfg = LearnerConfig(batch_size=4, seq_len=8, policy=PolicyConfig(**SMALL))
    frames = chaos_soak.make_frames(cfg, 6)
    assert len(frames) == 6
    fr = bytearray(frames[5])
    struct.pack_into("<I", fr, chaos_soak._VERSION_AT, 77)
    struct.pack_into("<I", fr, chaos_soak._ACTOR_AT, chaos_soak.SENTINEL_WARM_ID)
    r = deserialize_rollout(bytes(fr))
    assert (r.version, r.actor_id, len(r.rewards)) == (77, chaos_soak.SENTINEL_WARM_ID, 8)
    args = chaos_soak.parse_args(["--quick"])
    assert (args.baseline_s, args.chaos_s, args.overload_s, args.kills, args.actors, args.replayers) == (
        6.0, 16.0, 8.0, "4:2", 2, 2)
    assert args.platform == "" and (args.maxlen, args.shed_high, args.shed_low) == (256, 48, 16)
