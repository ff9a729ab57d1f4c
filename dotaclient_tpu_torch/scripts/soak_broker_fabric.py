"""Broker-fabric soak (twin of scripts/soak_broker_fabric.py): the
closed-loop proof of the sharded transport.

Four phases against the real fabric (transport/fabric.py):

1. KILL + ROLLING CONSERVATION: 3 tcp shards (priority admission on) as
   BrokerIncarnations behind a ShardRouter; 4 producers publish uniquely
   stamped chunks through FabricBroker routers while a fan-in consumer
   drains, and a ScheduleRunner runs a `kill@T:D@broker` and a
   `rolling@T:P@broker` event (at most one shard down at a time). Every
   shard generation's ledger sums exactly (enqueued = popped +
   dropped_oldest + evicted_low + resident), the pop ledger has no
   unaccounted frame (Σpopped − Σreply_lost = delivered + fence_dropped
   + dup_dropped), no chunk is delivered twice, and every producer's
   longest publish gap stays inside the budget.

2. STALE-SHARD RESURRECTION: a publish fails over (epoch bump) and the
   dead primary comes back holding the old-epoch copy of the same chunk:
   the fan-in fence drops it and the chunk is delivered exactly once.

3. TWO LEARNERS, SIGTERM RESUME: two Learners consume disjoint shard
   subsets of one 4-shard fabric (--broker_shards); learner B is drained
   (request_drain, train out, drain_save), restarted from its full-state
   checkpoint, and must end bit-exact against an uninterrupted arm over
   the same frames; learner A's stream stays its own.

4. OFFERED-RATE SCALING: publish throughput through 1 shard vs 3, its
   1.5x bar armed only when an independent probe (GIL-released crc32
   threads) shows the host can run 3 workers in parallel. The phase's
   shards and producers are threads of one interpreter, so on a host the
   probe calls capable the bar can be missed and `scaling_met_or_excused`
   (with the `all_green` it feeds) read false: the reference's verdict,
   kept as it is (HOST_BOUND_VERDICTS).

Plus the inertness subprocess: a single-endpoint broker never imports
the fabric module.

The learners run on the CUDA device unless `--platform cpu`;
`phase_two_learner` takes a PolicyConfig (None: the soak's 8-wide one).

Run: python -m dotaclient_tpu_torch.scripts.soak_broker_fabric --out broker_fabric_soak_torch.json
     python -m dotaclient_tpu_torch.scripts.soak_broker_fabric --quick --platform cpu --out /tmp/x.json
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import subprocess
import sys
import threading
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FABRIC_URLS = ["mem://fab0", "mem://fab1", "mem://fab2", "mem://fab3"]


def _make_rollout(L, H, version, actor_id, uid, rng):
    """One synthetic chunk, uniquely stamped: episode_return carries `uid`
    (exact in f32 below 2^24), so the consumer proves no chunk arrives
    twice without trusting the fence it audits."""
    from dotaclient_tpu_torch.env import featurizer as F
    from dotaclient_tpu_torch.ops.action_dist import Action
    from dotaclient_tpu_torch.transport.serialize import Rollout

    T1 = L + 1
    obs = F.Observation(
        global_feats=rng.randn(T1, F.GLOBAL_FEATURES).astype(np.float32),
        hero_feats=rng.randn(T1, F.HERO_FEATURES).astype(np.float32),
        unit_feats=rng.randn(T1, F.MAX_UNITS, F.UNIT_FEATURES).astype(np.float32),
        unit_mask=rng.rand(T1, F.MAX_UNITS) < 0.5,
        target_mask=rng.rand(T1, F.MAX_UNITS) < 0.3,
        action_mask=np.ones((T1, F.N_ACTION_TYPES), bool),
    )
    return Rollout(
        obs=obs,
        actions=Action(
            type=rng.randint(0, 4, L).astype(np.int32),
            move_x=rng.randint(0, 9, L).astype(np.int32),
            move_y=rng.randint(0, 9, L).astype(np.int32),
            target=rng.randint(0, F.MAX_UNITS, L).astype(np.int32),
        ),
        behavior_logp=rng.randn(L).astype(np.float32),
        behavior_value=rng.randn(L).astype(np.float32),
        rewards=rng.randn(L).astype(np.float32),
        dones=np.zeros(L, np.float32),
        initial_state=(rng.randn(H).astype(np.float32), rng.randn(H).astype(np.float32)),
        version=version,
        actor_id=actor_id,
        episode_return=float(uid),
    )


def _uid_of(frame: bytes) -> float:
    """The unique stamp back out of a serialized frame (episode_return at
    offset 17 in every DTR layout)."""
    return struct.unpack_from("<f", frame, 17)[0]


# --------------------------------------------------------------- host probe


def _cpu_probe(threads_n: int, seconds: float) -> float:
    """Aggregate crc32 MiB/s over `threads_n` threads, each hashing its own
    1 MiB buffer: zlib.crc32 releases the GIL, so this reads how many
    CPU-bound threads the host really runs at once, with none of the
    fabric's own code."""
    import zlib

    stop = threading.Event()
    counts = [0] * threads_n
    buf = os.urandom(1 << 20)

    def work(i):
        while not stop.is_set():
            zlib.crc32(buf)
            counts[i] += 1

    threads = [threading.Thread(target=work, args=(i,), daemon=True) for i in range(threads_n)]
    for t in threads:
        t.start()
    time.sleep(seconds)
    stop.set()
    for t in threads:
        t.join(timeout=3)
    return sum(counts) / seconds


def host_probe(quick: bool) -> dict:
    window = 0.5 if quick else 1.0
    r1 = _cpu_probe(1, window)
    r3 = _cpu_probe(3, window)
    scaling = r3 / max(r1, 1e-9)
    return {
        "disclosed": True,
        "what": "aggregate GIL-released crc32 MiB/s, 1 vs 3 worker threads — none of the fabric's own code",
        "cpu_count": os.cpu_count(),
        "crc_mibs_1thread": round(r1, 1),
        "crc_mibs_3threads": round(r3, 1),
        "scaling_3_over_1": round(scaling, 3),
        # 3 shard event loops + producers need >= 3 parallel cores; a
        # 2-core host tops out at 2.0 on this probe
        "capable": scaling >= 2.2,
    }


# The verdicts that phase 4's in-process scaling decides: on a host whose
# probe reads >= 2.2x the bar is armed over shards that share one
# interpreter's lock, and it can read false with every other verdict true
# (ROADMAP.md §C). Callers that hold the soak to its other verdicts leave
# out exactly these, by name.
HOST_BOUND_VERDICTS = ("scaling_met_or_excused", "all_green")


# ------------------------------------------------------------ phase 1: kill


class ShardRouter:
    """Round-robin kill/restart over N BrokerIncarnations: the
    rolling@T:P@broker contract (replica_count and the first-enqueue
    recovery probe on the replica just restarted)."""

    def __init__(self, incs):
        self.incs = incs
        self._next = 0
        self._cur = 0

    def replica_count(self) -> int:
        return len(self.incs)

    def kill(self):
        self._cur = self._next
        self._next = (self._next + 1) % len(self.incs)
        return self.incs[self._cur].kill()

    def restart(self):
        self.incs[self._cur].restart()

    def wait_first_enqueue(self, timeout=30.0, stop=None):
        return self.incs[self._cur].wait_first_enqueue(timeout, stop)


def kill_spec(quick: bool) -> str:
    return "kill@1.5:1@broker,rolling@4:0.6@broker" if quick else "kill@2:1.5@broker,kill@6:1@broker,rolling@8:0.8@broker"


def phase_kill(quick: bool, duration=None, spec=None) -> dict:
    from dotaclient_tpu_torch.chaos.controller import BrokerIncarnations, ScheduleRunner
    from dotaclient_tpu_torch.chaos.schedule import FaultSchedule
    from dotaclient_tpu_torch.transport.base import BrokerShedError, RetryPolicy
    from dotaclient_tpu_torch.transport.fabric import FabricBroker
    from dotaclient_tpu_torch.transport.serialize import serialize_rollout

    n_shards = 3
    incs = [BrokerIncarnations(port=0, maxlen=4096, shed_high=1024, shed_low=256, priority_shed=True)
            for _ in range(n_shards)]
    urls = [f"tcp://127.0.0.1:{inc.port}" for inc in incs]
    retry = RetryPolicy(window_s=1.0, backoff_base_s=0.05, backoff_cap_s=0.4, jitter=0.5)
    duration = (8.0 if quick else 14.0) if duration is None else duration
    spec = kill_spec(quick) if spec is None else spec
    recovery_budget_s = 5.0

    stop = threading.Event()
    producers = []
    prod_stats = []

    def producer(pid: int):
        fb = FabricBroker(urls, retry=retry, failover_window_s=1.0, cooldown_s=1.0)
        rng = np.random.RandomState(1000 + pid)
        st = {"attempted": 0, "acked": 0, "shed": 0, "failed": 0, "max_gap_s": 0.0, "failovers": 0}
        prod_stats.append(st)
        last_ok = time.monotonic()
        uid = pid * 1_000_000
        while not stop.is_set():
            uid += 1
            r = _make_rollout(2, 8, 0, actor_id=pid * 8 + (uid % 8), uid=uid, rng=rng)
            st["attempted"] += 1
            try:
                fb.publish_experience(serialize_rollout(r), priority=float(uid % 7))
                st["acked"] += 1
                now = time.monotonic()
                st["max_gap_s"] = max(st["max_gap_s"], now - last_ok)
                last_ok = now
            except BrokerShedError:
                st["shed"] += 1
            except (ConnectionError, OSError):
                st["failed"] += 1
            time.sleep(0.008)
        st["failovers"] = fb.failovers_total
        fb.close()

    consumer_fb = FabricBroker(urls, retry=retry, failover_window_s=1.0, cooldown_s=1.0)
    seen_uids: dict = {}
    consumed = {"n": 0}

    def consumer():
        while not stop.is_set():
            for f in consumer_fb.consume_experience(64, timeout=0.2):
                uid = _uid_of(bytes(f))
                seen_uids[uid] = seen_uids.get(uid, 0) + 1
                consumed["n"] += 1

    for pid in range(4):
        t = threading.Thread(target=producer, args=(pid,), daemon=True)
        producers.append(t)
        t.start()
    cons = threading.Thread(target=consumer, daemon=True)
    cons.start()

    router = ShardRouter(incs)
    t0 = time.monotonic()
    runner = ScheduleRunner(FaultSchedule.parse(spec, seed=7), broker=router, t0=t0).start()
    time.sleep(duration)
    # the schedule completes (a rolling event's restarts and probes can
    # outlast the window) before the fleet stops: a roll cut short would
    # undercount restarts
    runner._thread.join(timeout=60)
    stop.set()
    for t in producers:
        t.join(timeout=10)
    cons.join(timeout=10)
    runner.stop()
    # settle: no new shard pops, no pop in flight, the fan-in drained to
    # zero; then the fence counters are final and every popped frame is in
    # exactly one of delivered, fence_dropped, dup_dropped
    consumer_fb.quiesce()
    deadline = time.monotonic() + 10
    while any(consumer_fb._mid_pop) and time.monotonic() < deadline:
        time.sleep(0.02)
    for f in consumer_fb.consume_residual(1_000_000):
        uid = _uid_of(bytes(f))
        seen_uids[uid] = seen_uids.get(uid, 0) + 1
        consumed["n"] += 1
    fence = consumer_fb._fence
    fanin_left = consumer_fb.fanin_residual()
    consumer_fb.close()

    generations = []
    for i, inc in enumerate(incs):
        inc.final_ledger()  # folds the live incarnation into .ledgers
        for g, led in enumerate(inc.ledgers):
            generations.append({"shard": i, "generation": g, **{
                k: led[k] for k in ("enqueued", "popped", "dropped_oldest", "shed", "reply_lost", "evicted_low",
                                    "resident")}})
    sum_popped = sum(g["popped"] for g in generations)
    sum_reply_lost = sum(g["reply_lost"] for g in generations)
    delivered = fence.delivered
    unaccounted = sum_popped - sum_reply_lost - (delivered + fence.fence_dropped + fence.dup_dropped)
    return {
        "shards": n_shards,
        "schedule": spec,
        "duration_s": duration,
        "shard_generations": generations,
        "per_generation_ledgers_sum_exactly": all(
            g["enqueued"] == g["popped"] + g["dropped_oldest"] + g["evicted_low"] + g["resident"] for g in generations),
        "producers": prod_stats,
        "producer_acked_total": sum(s["acked"] for s in prod_stats),
        "consumer": {
            "delivered": delivered,
            "fence_dropped": fence.fence_dropped,
            "dup_dropped": fence.dup_dropped,
            "fanin_residual_after_drain": fanin_left,
            "unique_chunks": len(seen_uids),
        },
        "recovery": runner.recovery,
        "rolling_replicas_restarted": sum(1 for e in runner.recovery if e.get("kind") == "rolling"),
        "max_publish_gap_s": round(max(s["max_gap_s"] for s in prod_stats), 3),
        "recovery_budget_s": recovery_budget_s,
        "unaccounted": int(unaccounted),
        "duplicates_delivered": sum(1 for c in seen_uids.values() if c > 1),
    }


# --------------------------------------------- phase 2: stale resurrection


def phase_resurrection() -> dict:
    from dotaclient_tpu_torch.transport.base import RetryPolicy
    from dotaclient_tpu_torch.transport.fabric import FabricBroker, rendezvous_order, wrap_fabric
    from dotaclient_tpu_torch.transport.serialize import peek_rollout_actor_id, serialize_rollout
    from dotaclient_tpu_torch.transport.tcp import BrokerServer, TcpBroker

    s = [BrokerServer(port=0).start(), BrokerServer(port=0).start()]
    urls = [f"tcp://127.0.0.1:{srv.port}" for srv in s]
    fb = FabricBroker(urls, retry=RetryPolicy(window_s=0.4, backoff_base_s=0.02, backoff_cap_s=0.1, jitter=0.0),
                      failover_window_s=0.4, cooldown_s=0.5)
    rng = np.random.RandomState(0)
    frames = [serialize_rollout(_make_rollout(2, 8, 0, actor_id=5, uid=9000 + i, rng=rng)) for i in range(6)]
    key = peek_rollout_actor_id(frames[0])
    order = rendezvous_order(key, urls)
    primary = s[order[0]]
    # steady state: 5 chunks through the primary, drained before the kill
    # (frames resident in a killed in-process broker die with it; this
    # phase is about the fence, phase 1 ledgers that loss)
    for f in frames[:5]:
        fb.publish_experience(f)
    got = []
    deadline = time.monotonic() + 8
    while len(got) < 5 and time.monotonic() < deadline:
        got.extend(bytes(f) for f in fb.consume_experience(32, timeout=0.2))
    assert len(got) == 5, f"steady state only delivered {len(got)}/5"
    # partition: the primary dies; chunk 5 fails over with an epoch bump
    primary.stop()
    fb.publish_experience(frames[5])
    # resurrection: the primary returns holding the old-epoch copy of
    # chunk 5 (the ack-lost-but-landed fate, re-injected verbatim)
    deadline = time.monotonic() + 15
    reborn = None
    while reborn is None:
        try:
            reborn = BrokerServer(port=primary.port).start()
        except (RuntimeError, OSError):
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.05)
    direct = TcpBroker(port=reborn.port)
    direct.publish_experience(wrap_fabric(frames[5], key=key, boot=fb._boot, epoch=0, seq=5))
    time.sleep(0.6)  # the cooldown expires: the reborn primary is polled again

    deadline = time.monotonic() + 8
    while (len(got) < 6 or fb._fence.fence_dropped < 1) and time.monotonic() < deadline:
        got.extend(bytes(f) for f in fb.consume_experience(32, timeout=0.2))
    uids = [_uid_of(f) for f in got]
    out = {
        "chunks_published": 6,
        "delivered": len(got),
        "delivered_unique": len(set(uids)),
        "duplicates_delivered": len(uids) - len(set(uids)),
        "fence_dropped": fb._fence.fence_dropped,
        "dup_dropped": fb._fence.dup_dropped,
        "failovers": fb.failovers_total,
        "fence_fired": fb._fence.fence_dropped >= 1,
        "republished_chunk_delivered_exactly_once": uids.count(9005.0) == 1,
    }
    direct.close()
    fb.close()
    reborn.stop()
    s[order[1]].stop()
    return out


# ------------------------------------ phase 3: 2-learner fan-in + resume


def small_policy():
    from dotaclient_tpu_torch.config import PolicyConfig

    return PolicyConfig(unit_embed_dim=8, lstm_hidden=8, mlp_hidden=8, dtype="float32")


def disjoint_ids(urls, n: int):
    """Actor ids by rendezvous primary: the A stream lands on shards {0,1},
    the B stream on shard 3 only (shard 2 stays empty, so learner B's
    2-shard subset has a deterministic fan-in order)."""
    from dotaclient_tpu_torch.transport.fabric import rendezvous_order

    ids_a, ids_b = [], []
    for aid in range(4096):
        p = rendezvous_order(aid, urls)[0]
        if p in (0, 1) and len(ids_a) < n:
            ids_a.append(aid)
        elif p == 3 and len(ids_b) < n:
            ids_b.append(aid)
        if len(ids_a) == n and len(ids_b) == n:
            break
    assert len(ids_a) == n and len(ids_b) == n
    return ids_a, ids_b


def phase_two_learner(quick: bool, tmpdir: str, policy=None, platform: str = "") -> dict:
    """Also returns, under "steps_trained", the learner steps it ran (both
    arms, both of B's lives and learner A)."""
    from dotaclient_tpu_torch.config import LearnerConfig
    from dotaclient_tpu_torch.runtime.learner import Learner
    from dotaclient_tpu_torch.scripts.resume_soak import state_hash
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.fabric import FabricBroker
    from dotaclient_tpu_torch.transport.serialize import serialize_rollout

    policy = small_policy() if policy is None else policy
    urls = FABRIC_URLS
    K = 4 if quick else 6  # steps per learner
    B, L, H = 8, 4, policy.lstm_hidden
    ids_a, ids_b = disjoint_ids(urls, K * B)

    def frames_for(ids, seed0):
        return [serialize_rollout(_make_rollout(L, H, 0, actor_id=aid, uid=seed0 + i,
                                                rng=np.random.RandomState(seed0 + i))) for i, aid in enumerate(ids)]

    frames_a = frames_for(ids_a, 50_000)
    frames_b = frames_for(ids_b, 90_000)
    k1 = max(1, K // 2)
    # B's schedule comes in two tranches, the first with a 3-frame partial
    # tail: the drain lands with k1 trained steps and 3 popped pending
    # frames, which the full-state checkpoint carries across the restart;
    # tranche 2 exists only for life 2.
    cut = k1 * B + 3
    tranche1_b, tranche2_b = frames_b[:cut], frames_b[cut:]

    def reset_hubs():
        for u in urls:
            mem.reset(u[len("mem://"):])

    def publish(frames):
        pub = FabricBroker(urls)
        for f in frames:
            pub.publish_experience(f)
        pub.close()

    def make_learner(tag: str, shards, full_state: bool):
        cfg = LearnerConfig(batch_size=B, seq_len=L, policy=policy, publish_every=1, metrics_every=1,
                            checkpoint_every=10_000, checkpoint_dir=os.path.join(tmpdir, tag) if full_state else "",
                            platform=platform)
        cfg.ppo.max_staleness = 100_000
        if full_state:
            cfg.ckpt.full_state = True
        fb = FabricBroker(urls, consume_shards=shards)
        return Learner(cfg, fb, device="cpu" if platform == "cpu" else None), fb

    # arm 1: an uninterrupted learner B over the whole schedule
    reset_hubs()
    publish(frames_a + tranche1_b + tranche2_b)
    lb1, fb1 = make_learner("arm1", [2, 3], full_state=False)
    steps = lb1.run(num_steps=K, batch_timeout=30.0, max_idle=4)
    hash_arm1 = state_hash(lb1.state)
    consumed_arm1 = lb1.staging.stats()["consumed"]
    lb1.close()
    fb1.close()

    # arm 2: learner A on the other shards, and learner B drained mid-run
    # and resumed from its full state; B's tranche 2 lands only after the
    # restart, so life 1 really stops mid-schedule
    reset_hubs()
    publish(frames_a + tranche1_b)
    la, fba = make_learner("arm2a", [0, 1], full_state=False)
    a_result = {}

    def run_a():
        a_result["steps"] = la.run(num_steps=K, batch_timeout=60.0, max_idle=8)

    ta = threading.Thread(target=run_a, daemon=True, name="fabric-learner-a")
    ta.start()
    lb2, fbb = make_learner("arm2b", [2, 3], full_state=True)
    b_result = {}

    def run_b():
        b_result["steps"] = lb2.run(num_steps=K, batch_timeout=60.0, max_idle=8)

    tb = threading.Thread(target=run_b, daemon=True, name="fabric-learner-b")
    tb.start()
    deadline = time.monotonic() + 300
    while lb2.version < k1 and time.monotonic() < deadline:
        time.sleep(0.02)
    lb2.request_drain()  # the SIGTERM path
    tb.join(timeout=180)
    assert not tb.is_alive(), "learner B's drain wedged"
    lb2.drain_save()
    drained_version = lb2.version
    pending_saved = lb2.staging.stats()["pending_rollouts"]
    lb2.close()
    fbb.close()

    # life 2: restore (the pending tail included) and train out the rest,
    # whose tranche-2 frames arrive only now
    publish(tranche2_b)
    lb3, fbb3 = make_learner("arm2b", [2, 3], full_state=True)
    resumed_version = lb3.version
    remaining = K - resumed_version
    b3_steps = lb3.run(num_steps=remaining, batch_timeout=60.0, max_idle=8) if remaining > 0 else 0
    hash_arm2 = state_hash(lb3.state)
    lb3.close()
    fbb3.close()

    ta.join(timeout=300)
    a_steps = a_result.get("steps", -1)
    a_consumed = la.staging.stats()["consumed"]
    la.close()
    fba.close()
    return {
        "steps_per_learner": K,
        "frames_per_learner": K * B,
        "arm1_hash": hash_arm1,
        "arm1_consumed": int(consumed_arm1),
        "drained_at_version": int(drained_version),
        "pending_frames_saved": int(pending_saved),
        "resumed_at_version": int(resumed_version),
        "arm2_hash": hash_arm2,
        "bit_exact": hash_arm1 == hash_arm2,
        "learner_a": {
            "steps": int(a_steps),
            "consumed": int(a_consumed),
            # disjoint fan-in: A consumed exactly its own stream
            "cross_contaminated": bool(a_consumed != K * B),
        },
        "resume_note": "sha256 over every params / Adam / step array, arm1 vs arm2 (drain at ~K/2 and a full-state "
                       "restore), the same frame schedule in both",
        "steps_trained": int(steps + b_result.get("steps", 0) + b3_steps + max(a_steps, 0)),
    }


# ----------------------------------------------- phase 4: offered scaling


def phase_scaling(quick: bool) -> dict:
    from dotaclient_tpu_torch.transport.base import RetryPolicy
    from dotaclient_tpu_torch.transport.fabric import FabricBroker
    from dotaclient_tpu_torch.transport.serialize import serialize_rollout
    from dotaclient_tpu_torch.transport.tcp import BrokerServer, TcpBroker

    window = 1.0 if quick else 2.0
    rng = np.random.RandomState(0)
    payloads = [serialize_rollout(_make_rollout(2, 8, 0, actor_id=a, uid=a, rng=rng)) for a in range(32)]

    def offered_rate(n_shards: int) -> float:
        servers = [BrokerServer(port=0, maxlen=200_000).start() for _ in range(n_shards)]
        urls = [f"tcp://127.0.0.1:{s.port}" for s in servers]
        stop = threading.Event()
        counts = [0] * 4

        def pump(i):
            if n_shards == 1:
                cli = TcpBroker(port=servers[0].port)
            else:
                cli = FabricBroker(urls, retry=RetryPolicy(window_s=1.0))
            j = i
            while not stop.is_set():
                cli.publish_experience(payloads[j % len(payloads)])
                counts[i] += 1
                j += 1
            cli.close()

        threads = [threading.Thread(target=pump, args=(i,), daemon=True) for i in range(4)]
        for t in threads:
            t.start()
        time.sleep(window)
        stop.set()
        for t in threads:
            t.join(timeout=5)
        for s in servers:
            s.stop()
        return sum(counts) / window

    r1 = offered_rate(1)
    r3 = offered_rate(3)
    return {
        "window_s": window,
        "producers": 4,
        "rate_1_shard_fps": round(r1, 1),
        "rate_3_shards_fps": round(r3, 1),
        "scaling_3_over_1": round(r3 / max(r1, 1e-9), 3),
    }


def judge_scaling(scaling: dict, probe: dict) -> dict:
    """The reference's probe-keyed bar: 1.5x, required only on a host the
    probe calls capable."""
    s = scaling["scaling_3_over_1"]
    scaling["bar"] = 1.5
    scaling["required"] = probe["capable"]
    scaling["met"] = s >= 1.5
    scaling["excused_by_probe"] = (not probe["capable"]) and s < 1.5
    scaling["note"] = "the %d-core host's probe scaling is %.2fx: shard scaling is %s here" % (
        os.cpu_count() or 0, probe["scaling_3_over_1"], "required" if probe["capable"] else "excused by the probe")
    return scaling


# ------------------------------------------------------------- inertness


def inertness_proof() -> dict:
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from dotaclient_tpu_torch.transport.base import connect\n"
        "b = connect('mem://soak_inert'); b.publish_experience(b'x')\n"
        "assert b.consume_experience(1, timeout=0.5) == [b'x']\n"
        "assert 'dotaclient_tpu_torch.transport.fabric' not in sys.modules\n"
        "print('INERT_OK')\n" % REPO_ROOT
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    return {"fabric_imported_on_classic_path": "INERT_OK" not in proc.stdout, "rc": proc.returncode}


# ------------------------------------------------------------------- main


def verdict_of(artifact: dict) -> dict:
    pk, pr = artifact["phase_kill"], artifact["phase_resurrection"]
    tl, sc = artifact["phase_two_learner"], artifact["phase_scaling"]
    verdict = {
        "per_shard_generation_ledgers_sum_exactly": pk["per_generation_ledgers_sum_exactly"],
        "unaccounted_frames": int(pk["unaccounted"]),
        "duplicate_applied_chunks": int(pk["duplicates_delivered"] + pr["duplicates_delivered"]),
        "fence_fired_under_resurrection": bool(pr["fence_fired"]),
        "resurrected_chunk_exactly_once": bool(pr["republished_chunk_delivered_exactly_once"]),
        "actor_recovery_bounded": pk["max_publish_gap_s"] <= pk["recovery_budget_s"],
        "rolling_at_most_one_down": pk["rolling_replicas_restarted"] == pk["shards"],
        "two_learner_resume_bit_exact": bool(tl["bit_exact"]),
        "fanin_disjoint_no_cross_contamination": not tl["learner_a"]["cross_contaminated"],
        "scaling_met_or_excused": bool(sc["met"] or sc["excused_by_probe"]),
        "inert_on_classic_path": not artifact["inertness"]["fabric_imported_on_classic_path"],
    }
    verdict["all_green"] = all((v is True) if isinstance(v, bool) else (v == 0) for v in verdict.values())
    return verdict


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="broker_fabric_soak_torch.json")
    p.add_argument("--quick", action="store_true")
    # "" = the CUDA device; "cpu" runs the learners on the host
    p.add_argument("--platform", default="", choices=("", "cpu"))
    return p.parse_args(argv)


def run_soak(args, policy=None) -> dict:
    import tempfile

    from dotaclient_tpu_torch.obs.preflight import check as preflight_check

    artifact = {
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "quick": bool(args.quick),
        "host_preflight": preflight_check("soak_broker_fabric"),
        "host": {"cpu_count": os.cpu_count(), "platform": sys.platform},
    }
    print("== host probe", flush=True)
    artifact["host_probe"] = host_probe(args.quick)
    print(json.dumps(artifact["host_probe"]), flush=True)
    print("== phase 1: shard kills + rolling restart conservation", flush=True)
    artifact["phase_kill"] = phase_kill(args.quick)
    print(json.dumps({k: v for k, v in artifact["phase_kill"].items()
                      if k not in ("shard_generations", "recovery", "producers")}), flush=True)
    print("== phase 2: stale-shard resurrection fence", flush=True)
    artifact["phase_resurrection"] = phase_resurrection()
    print(json.dumps(artifact["phase_resurrection"]), flush=True)
    print("== phase 3: 2-learner disjoint fan-in + SIGTERM resume", flush=True)
    with tempfile.TemporaryDirectory() as td:
        artifact["phase_two_learner"] = phase_two_learner(args.quick, td, policy, args.platform)
    print(json.dumps(artifact["phase_two_learner"]), flush=True)
    print("== phase 4: offered-rate scaling (probe-keyed)", flush=True)
    artifact["phase_scaling"] = judge_scaling(phase_scaling(args.quick), artifact["host_probe"])
    print(json.dumps(artifact["phase_scaling"]), flush=True)
    print("== inertness", flush=True)
    artifact["inertness"] = inertness_proof()
    artifact["verdict"] = verdict_of(artifact)
    return artifact


def main(argv=None) -> int:
    args = parse_args(argv)
    artifact = run_soak(args)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(json.dumps(artifact["verdict"], indent=2), flush=True)
    return 0 if artifact["verdict"]["all_green"] else 1


if __name__ == "__main__":
    sys.exit(main())
