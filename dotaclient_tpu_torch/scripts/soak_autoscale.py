"""Closed-loop autoscale soak (twin of scripts/soak_autoscale.py): the
control plane serves a load ramp hands-off.

The control plane (control/) scrapes the fleet's /metrics surfaces,
evaluates the declarative hysteresis policy and actuates replica counts.
This soak closes that loop inside one process with real components at
every layer:

- an elastic SERVING tier (ServeIncarnations per replica, each with an
  obs surface and a 2-shard carry store armed through a comma-list
  `--serve.handoff_endpoint` → ShardedCarryStore);
- an elastic BROKER tier (real BrokerServer shards, rendezvous-routed
  publishes, throttled per-shard drain consumers standing in for the
  learner's fan-in);
- an elastic ACTOR pool (RemoteActors over DISCOVERY endpoints,
  `control:<controller>`, each worker with its own client and a local
  fake env, publishing experience chunks to the broker tier);
- ONE ControlPlane (in-process driver, real HTTP /metrics scraping, real
  /topology discovery) making every scale decision.

A demand ramp (episode tokens at warm → burst → cool rates) is the only
external input. The controller must scale the actor pool up into the
burst and back down, serve replicas 2→4→2 off serve_load_clients, and
broker shards 2→4→2 off per-shard queue depth, while a `rolling@` +
`kill@` chaos schedule restarts serve replicas mid-burst. The bars: no
abandoned episode (sessions resume through the sharded store across the
chaos kills and the scale-downs), the conservation ledgers intact
(producer attempted = acked + shed + failed; per-shard enqueued = popped
+ resident; no unaccounted frame), and every scale decision ledgered
with the meter values that justified it.

The serve replicas run on the CUDA device unless `--platform cpu`;
`run_soak` takes the served PolicyConfig (None: the soak's tiny one).
The actors only step envs and publish: their policy is the servers'.

Run: python -m dotaclient_tpu_torch.scripts.soak_autoscale --out autoscale_soak_torch.json
     python -m dotaclient_tpu_torch.scripts.soak_autoscale --quick --platform cpu --out /tmp/x.json
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import json
import threading
import time

from dotaclient_tpu_torch.scripts.chaos_soak import tiny_policy

MAX_WORKERS = 8
BOOT_REPLICAS = 2  # every tier boots at 2

POLICY = (
    "actor:actor_pool_backlog_share.mean,high=3,low=0.4,min=2,max=8,step=3,cooldown=3;"
    "server:serve_load_clients.mean,high=2.5,low=0.75,min=2,max=4,step=2,cooldown=5;"
    "broker:broker_shard_depth.max,high=25,low=3,min=2,max=4,step=2,cooldown=6"
)


# ----------------------------------------------------------- serve tier


class ServeElastic:
    """Elastic serving tier: one ServeIncarnations and one obs surface per
    replica. scale_to() grows by booting fresh replicas and shrinks by
    stopping the highest index (the StatefulSet removal order, and the k8s
    driver's contract); kill()/restart() round-robin across live replicas
    for the chaos runner."""

    def __init__(self, make_server, boot: int):
        from dotaclient_tpu_torch.obs.http import MetricsHTTPServer

        self._metrics_cls = MetricsHTTPServer
        self._make_server = make_server
        # _lock guards the lists only (endpoints() feeds /topology and must
        # never wait out a replica boot); _op_lock serializes the slow
        # mutations (scale vs chaos kill/restart), so a scale-down cannot
        # pop a replica mid-restart.
        self._lock = threading.Lock()
        self._op_lock = threading.Lock()
        self.replicas = []  # [{"inc", "obs"}] live, index order
        self.retired = []  # final ledgers of scaled-away replicas
        self._rr = 0
        self._pending = []  # incarnations killed by chaos, awaiting restart
        self._kills = 0
        for _ in range(boot):
            self._boot_one()

    def _boot_one(self):
        from dotaclient_tpu_torch.chaos import ServeIncarnations

        inc = ServeIncarnations(self._make_server, port=0)

        def stats(inc=inc):
            s = inc.server  # None while chaos holds the replica down
            return dict(s.stats()) if s is not None else {}

        obs = self._metrics_cls(0, sources=[stats]).start()
        with self._lock:
            self.replicas.append({"inc": inc, "obs": obs})

    # -- driver interface
    def replica_count(self) -> int:
        with self._lock:
            return len(self.replicas)

    def scale_to(self, n: int) -> None:
        with self._op_lock:
            while True:
                with self._lock:
                    cur = len(self.replicas)
                    r = self.replicas.pop() if cur > n else None
                    if r is not None and r["inc"] in self._pending:
                        # chaos killed it and a restart is queued: the
                        # harvest below ends the incarnation, so the restart
                        # must not revive it
                        self._pending.remove(r["inc"])
                if r is not None:
                    self.retired.append(r["inc"].final_ledger())
                    r["obs"].stop()
                elif cur < n:
                    self._boot_one()
                else:
                    return

    # -- endpoint lists
    def endpoints(self):
        with self._lock:
            return [f"127.0.0.1:{r['inc'].port}" for r in self.replicas]

    def obs_endpoints(self):
        with self._lock:
            return [f"127.0.0.1:{r['obs'].port}" for r in self.replicas]

    # -- chaos controller interface (the _ReplicaRouter shape)
    def kill(self):
        with self._op_lock:
            with self._lock:
                i = self._rr % len(self.replicas)
                self._rr += 1
                inc = self.replicas[i]["inc"]
                self._pending.append(inc)
            self._kills += 1
            return inc.kill()

    def restart(self):
        with self._op_lock:
            with self._lock:
                inc = self._pending[-1] if self._pending else None
                live = inc is not None and any(r["inc"] is inc for r in self.replicas)
            if live:
                inc.restart()

    def wait_first_request(self, timeout=30.0, stop=None):
        with self._lock:
            inc = self._pending[-1] if self._pending else None
        return None if inc is None else inc.wait_first_request(timeout, stop)

    def kills_executed(self) -> int:
        return self._kills

    def close(self) -> dict:
        """Stop everything and sum every life ever (live and retired)."""
        self.scale_to(0)
        keys = ("requests", "episode_resets", "unknown_client", "evictions", "carries_resident_at_kill",
                "handoff_writes", "handoff_write_errors", "resumes", "resume_misses", "replayed_steps", "incarnations")
        return {k: sum(led.get(k, 0) for led in self.retired) for k in keys}


# ---------------------------------------------------------- broker tier


class BrokerElastic:
    """Elastic experience fabric: real BrokerServer shards. Publishes
    rendezvous-route over the live rotation; each shard has a throttled
    drain consumer (the learner fan-in's stand-in) that keeps popping after
    the shard leaves the rotation. A scale-down drains, it never drops, so
    per-shard conservation (enqueued = popped + resident) survives
    rescaling by construction."""

    def __init__(self, boot: int, drain_frames: int, drain_interval_s: float):
        self._drain_frames = drain_frames
        self._drain_interval = drain_interval_s
        self._lock = threading.Lock()
        self.live = []  # publish rotation
        self.all_shards = []  # every shard ever (conservation reads these)
        for _ in range(boot):
            self._add()

    def _add(self):
        from dotaclient_tpu_torch.obs.http import MetricsHTTPServer
        from dotaclient_tpu_torch.transport.base import RetryPolicy
        from dotaclient_tpu_torch.transport.tcp import BrokerServer, TcpBroker

        srv = BrokerServer(port=0, maxlen=100_000).start()
        shard = {"name": f"127.0.0.1:{srv.port}", "srv": srv, "consumed": 0, "stop": threading.Event(),
                 "pub": None}  # the publishing client, built in the worker thread
        shard["obs"] = MetricsHTTPServer(
            0, sources=[lambda srv=srv: {"broker_shard_depth": float(len(srv.experience))}]).start()

        def drain():
            client = TcpBroker(port=srv.port, retry=RetryPolicy(window_s=5.0))
            try:
                while not shard["stop"].is_set():
                    got = client.consume_experience(self._drain_frames, timeout=0.1)
                    shard["consumed"] += len(got)
                    shard["stop"].wait(self._drain_interval)
                # terminal unthrottled drain: pop everything still resident
                # so `popped == consumed` closes exactly
                deadline = time.monotonic() + 15.0
                while len(srv.experience) and time.monotonic() < deadline:
                    shard["consumed"] += len(client.consume_experience(256, timeout=0.1))
            finally:
                client.close()

        shard["thread"] = threading.Thread(target=drain, daemon=True, name="soak-drain")
        shard["thread"].start()
        self.live.append(shard)
        self.all_shards.append(shard)

    # -- driver interface
    def replica_count(self) -> int:
        return len(self.live)

    def scale_to(self, n: int) -> None:
        with self._lock:
            while len(self.live) < n:
                self._add()
            while len(self.live) > n:
                shard = self.live.pop()  # out of rotation; its drain continues
                shard["obs"].stop()

    def obs_endpoints(self):
        with self._lock:
            return [f"127.0.0.1:{s['obs'].port}" for s in self.live]

    # -- producer side (worker-thread only)
    def publish(self, key: int, data: bytes) -> None:
        from dotaclient_tpu_torch.transport.base import RetryPolicy
        from dotaclient_tpu_torch.transport.fabric import rendezvous_order
        from dotaclient_tpu_torch.transport.tcp import TcpBroker

        with self._lock:
            rotation = list(self.live)
        shard = rotation[rendezvous_order(key, [s["name"] for s in rotation])[0]]
        if shard["pub"] is None:
            shard["pub"] = TcpBroker(port=shard["srv"].port, retry=RetryPolicy(window_s=5.0))
        shard["pub"].publish_experience(data)

    def close(self):
        """Stop the drains (each runs its terminal unthrottled drain first),
        stop the servers, and return each shard's exact ledger."""
        for s in self.all_shards:
            s["stop"].set()
        for s in self.all_shards:
            s["thread"].join(timeout=30)
            if s["pub"] is not None:
                s["pub"].close()
            s["srv"].stop()
            if s in self.live:
                s["obs"].stop()
        return [{"name": s["name"], "consumed": s["consumed"], **s["srv"].ledger()} for s in self.all_shards]


class _FabricShim:
    """The broker an actor publishes through: rendezvous over the live shard
    rotation per chunk (re-resolved at every publish, so a rescale re-routes
    the next chunk, not a reconnect). No weight fanout in this soak:
    version-0 serving throughout, the handoff soak's shape."""

    wants_priority = False

    def __init__(self, brokers: BrokerElastic, key: int):
        self._brokers = brokers
        self._key = key

    def publish_experience(self, data: bytes) -> None:
        self._brokers.publish(self._key, data)

    def poll_weights(self):
        return None

    def close(self):
        pass  # the router owns the shard clients


# ----------------------------------------------------------- actor tier


class ActorElastic:
    """Elastic actor pool: `target` is the controller-set worker count; the
    asyncio supervisor spawns and retires worker slots to match. One obs
    surface per slot reports the pool's demand-backlog SHARE (backlog /
    workers): the meter rises while the pool is undersized and falls as the
    controller grows it."""

    def __init__(self, boot: int, demand: collections.deque):
        from dotaclient_tpu_torch.obs.http import MetricsHTTPServer

        self.target = boot
        self.demand = demand
        self.surfaces = [
            MetricsHTTPServer(0, sources=[lambda: {
                "actor_pool_backlog_share": len(self.demand) / max(1, self.target)}]).start()
            for _ in range(MAX_WORKERS)
        ]

    def replica_count(self) -> int:
        return self.target

    def scale_to(self, n: int) -> None:
        self.target = max(0, min(MAX_WORKERS, int(n)))

    def obs_endpoints(self):
        return [f"127.0.0.1:{s.port}" for s in self.surfaces[: self.target]]

    def close(self):
        for s in self.surfaces:
            s.stop()


class _PacedStub:
    """A fixed wall delay per observe(): episodes stretch over wall time, so
    chaos kills and scale-downs land mid-episode on any host."""

    def __init__(self, inner, delay_s: float):
        self._inner = inner
        self._delay = delay_s

    def __getattr__(self, name):
        return getattr(self._inner, name)

    async def observe(self, req):
        await asyncio.sleep(self._delay)
        return await self._inner.observe(req)


def _acfg(policy, control_endpoint: str, platform: str = ""):
    from dotaclient_tpu_torch.config import ActorConfig, RetryConfig, ServeClientConfig

    return ActorConfig(
        env_addr="local",
        rollout_len=4,  # 3 chunk boundaries per 12-step episode
        max_dota_time=12.0,
        policy=policy,
        seed=100,
        max_weight_age_s=0.0,
        platform=platform,
        serve=ServeClientConfig(
            endpoint=control_endpoint,  # discovery: control:<host:port>
            timeout_s=8.0,
            # generous: a /topology fetch can queue behind an in-flight
            # replica boot on a loaded host
            connect_timeout_s=4.0,
            cooldown_s=0.3,
            resume=True,
            resume_window_s=15.0,
            route="load",
        ),
        retry=RetryConfig(window_s=5.0, backoff_base_s=0.05, backoff_cap_s=0.5),
    )


# ------------------------------------------------------ the decision audit


def audit_moves(decisions):
    """(moves, holds, justified): every move of the decision ledger, the
    count of holds, and whether every move's value is the meter it carried
    and lies past its bound (above `high` up, below `low` down)."""
    moves = [d for d in decisions if d["action"] in ("up", "down")]
    justified = all(
        d["value"] is not None
        and d["meters"].get(d["meter"]) == d["value"]
        and (d["value"] > d["high"] if d["action"] == "up" else d["value"] < d["low"])
        for d in moves
    )
    return moves, len(decisions) - len(moves), justified


def tier_path(moves, tier: str):
    """The tier's replica counts: the boot count, then each actuated move's
    target in ledger order."""
    path = [BOOT_REPLICAS]
    for d in moves:
        if d["tier"] == tier and d.get("actuation", {}).get("actuated"):
            path.append(d["target"])
    return path


def verdict_of(artifact: dict) -> dict:
    """The reference's bools and its two counts, read off the artifact."""
    paths, totals = artifact["replica_paths"], artifact["producer_totals"]
    moves, per_shard = artifact["decisions"]["moves"], artifact["broker_shards"]
    disc, serve_totals = artifact["discovery"], artifact["serve_totals"]
    _, _, justified = audit_moves(moves)
    actuated = [d for d in moves if d.get("actuation", {}).get("actuated")]
    return {
        # the headline: the controller, not the operator, worked the fleet
        "controller_scaled_server_2_4_2": paths["server"][0] == 2 and max(paths["server"]) == 4
        and paths["server"][-1] == 2 and len(paths["server"]) >= 3,
        "controller_scaled_broker_shards_up_and_back": max(paths["broker"]) == 4 and paths["broker"][-1] == 2,
        "controller_scaled_actor_pool_up_and_back": max(paths["actor"]) >= 5 and paths["actor"][-1] == 2,
        "every_move_justified_by_meters": justified and len(actuated) >= 6,
        "all_moves_actuated": len(actuated) == len(moves),
        # sessions survive chaos and rescale
        "zero_abandoned_episodes": totals["episodes_abandoned"] == 0,
        "episodes_resumed_cover_interruptions": totals["episodes_resumed"] >= 1,
        "chaos_killed_serve_replicas": artifact["serve_kills"] >= 3,
        "sharded_store_both_shards_carried": all(s["serve_handoff_store_puts_total"] >= 1
                                                 for s in artifact["stores"]),
        "store_no_errors_or_misses": serve_totals["handoff_write_errors"] == 0 and serve_totals["resume_misses"] == 0,
        # discovery served the fleet
        "discovery_adopted_topology": disc["clients_stepped"] >= 2
        and all(n >= 1 for n in disc["refreshes_per_stepped_client"]) and disc["max_epoch_seen"] >= 2,
        # conservation, intact across every rescale
        "producer_ledgers_balance": all(pr["attempted"] == pr["acked"] + pr["shed"] + pr["failed"]
                                        for pr in artifact["producers"]),
        "acked_equals_enqueued": totals["acked"] == sum(led["enqueued"] for led in per_shard),
        "per_shard_conservation": all(led["conserves"] for led in per_shard)
        and all(led["dropped_oldest"] == 0 for led in per_shard),
        "zero_unaccounted_frames": sum(led["unaccounted"] for led in per_shard) == 0
        and all(led["reply_lost"] == 0 for led in per_shard),
        "demand_fully_served": artifact["tokens"]["unserved"] == 0 and totals["episodes_done"] > 0,
        "no_worker_errors": not artifact["worker_errors"],
        "episodes_total": totals["episodes_done"],
        "scale_moves_total": len(moves),
    }


# ------------------------------------------------------------------ main


# A cut of --quick for the CPU tests' run (each test file within 60 s):
# every event of --quick stays (the warm, burst and cool ramp, the rolling
# and the hard kill, every tier's up and down move), with the ramp 2 / 8 /
# 6 s (--quick: 4 / 10 / 10) and the chaos at 5 and 10 s (7 and 14).
SMOKE_CUT = dict(warm_s=2.0, burst_s=8.0, cool_s=6.0, chaos="rolling@5:0.4@server,kill@10:0.6@server")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="autoscale_soak_torch.json")
    p.add_argument("--warm-s", type=float, default=6.0)
    p.add_argument("--warm-rate", type=float, default=1.0)
    p.add_argument("--burst-s", type=float, default=15.0)
    p.add_argument("--burst-rate", type=float, default=9.0)
    p.add_argument("--cool-s", type=float, default=15.0)
    p.add_argument("--cool-rate", type=float, default=0.4)
    p.add_argument("--chaos", default="rolling@10:0.5@server,kill@20:0.8@server")
    p.add_argument("--deadline-s", type=float, default=150.0)
    p.add_argument("--quick", action="store_true", help="nightly scale: a shorter ramp, the same invariants")
    # "" = the CUDA device; "cpu" runs the serve replicas on the host
    p.add_argument("--platform", default="", choices=("", "cpu"))
    args = p.parse_args(argv)
    if args.quick:
        args.warm_s, args.burst_s, args.cool_s = 4.0, 10.0, 10.0
        args.burst_rate = 7.0
        args.chaos = "rolling@7:0.4@server,kill@14:0.6@server"
        args.deadline_s = 120.0
    return args


def cut_args(argv=()) -> argparse.Namespace:
    """`--quick` and the flags in argv, with SMOKE_CUT applied."""
    args = parse_args(["--quick", *argv])
    for k, v in SMOKE_CUT.items():
        setattr(args, k, v)
    return args


def run_soak(args, policy=None) -> dict:
    """The closed loop; returns the artifact ("verdict" holds the bools,
    "wall_s" the run's seconds)."""
    from dotaclient_tpu_torch.chaos import FaultSchedule, ScheduleRunner
    from dotaclient_tpu_torch.config import ControlConfig, ControlLoopConfig, InferenceConfig, ServeConfig
    from dotaclient_tpu_torch.control.drivers import InProcessDriver
    from dotaclient_tpu_torch.control.server import ControlPlane
    from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
    from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
    from dotaclient_tpu_torch.obs.preflight import check as preflight_check
    from dotaclient_tpu_torch.serve.client import RemoteActor, RemoteInferenceError, _client_from_cfg
    from dotaclient_tpu_torch.serve.handoff import CarryStoreServer
    from dotaclient_tpu_torch.serve.server import InferenceServer

    policy = tiny_policy() if policy is None else policy
    t_start = time.perf_counter()

    # -- sharded carry store: two real store shards behind a comma list
    stores = [CarryStoreServer(port=0).start() for _ in range(2)]
    store_spec = ",".join(f"127.0.0.1:{s.port}" for s in stores)

    def make_server(port):
        cfg = InferenceConfig(
            serve=ServeConfig(port=port, max_batch=4, gather_window_s=0.002, weight_poll_s=0.05,
                              handoff_endpoint=store_spec,  # comma list → ShardedCarryStore
                              handoff_timeout_s=2.0),
            policy=policy,
            seed=1,
            platform=args.platform,
        )
        return InferenceServer(cfg).start()

    demand: collections.deque = collections.deque()
    tokens_produced = [0]
    serve_router = ServeElastic(make_server, boot=BOOT_REPLICAS)
    broker_router = BrokerElastic(boot=BOOT_REPLICAS, drain_frames=1, drain_interval_s=0.3)
    actor_router = ActorElastic(boot=BOOT_REPLICAS, demand=demand)

    driver = InProcessDriver(
        {"server": serve_router, "broker": broker_router, "actor": actor_router},
        metrics={"server": serve_router.obs_endpoints, "broker": broker_router.obs_endpoints,
                 "actor": actor_router.obs_endpoints},
        topology_fn=lambda: {"server": serve_router.endpoints()},
    )
    plane = ControlPlane(ControlConfig(control=ControlLoopConfig(port=0, poll_s=0.4, policy=POLICY)), driver).start()
    control_endpoint = f"control:127.0.0.1:{plane.port}"

    # -- the demand ramp: the soak's only external input
    t0 = time.monotonic()
    phases = [("warm", args.warm_s, args.warm_rate), ("burst", args.burst_s, args.burst_rate),
              ("cool", args.cool_s, args.cool_rate)]
    phases_done = threading.Event()

    def ramp():
        for _, dur, rate in phases:
            end = time.monotonic() + dur
            period = 1.0 / max(rate, 1e-9)
            while time.monotonic() < end:
                demand.append(1)
                tokens_produced[0] += 1
                time.sleep(period)
        phases_done.set()

    threading.Thread(target=ramp, daemon=True, name="soak-ramp").start()

    # -- chaos: a rolling restart and a hard kill of the serve tier mid-burst
    runner = ScheduleRunner(FaultSchedule.parse(args.chaos, seed=0), broker=None, t0=t0, server=serve_router).start()

    # -- the elastic actor pool
    all_actors, all_clients, worker_errors, timeline = [], [], [], []
    stop_all = threading.Event()
    occupied = set()

    async def worker(slot: int, wid: int):
        cfg = _acfg(policy, control_endpoint, args.platform)
        client = _client_from_cfg(cfg)
        actor = RemoteActor(cfg, _FabricShim(broker_router, key=wid), actor_id=wid,
                            stub=_PacedStub(LocalDotaServiceStub(FakeDotaService()), 0.02), client=client)
        all_actors.append(actor)
        all_clients.append(client)
        try:
            while not stop_all.is_set() and slot < actor_router.target:
                try:
                    demand.popleft()
                except IndexError:
                    await asyncio.sleep(0.05)
                    continue
                try:
                    await actor.run_episode()
                except RemoteInferenceError:
                    # the last-resort abandon (ledgered by the actor): it
                    # firing at all turns the verdict red
                    await asyncio.sleep(0.1)
                except Exception as e:
                    worker_errors.append(f"worker {wid}: {type(e).__name__}: {e}")
                    return
                await asyncio.sleep(0.01)
        finally:
            occupied.discard(slot)
            await client.close()

    async def drive():
        tasks = []
        wid = 0
        while True:
            for slot in range(actor_router.target):
                if slot not in occupied:
                    occupied.add(slot)
                    tasks.append(asyncio.ensure_future(worker(slot, wid)))
                    wid += 1
            t = time.monotonic() - t0
            timeline.append({"t": round(t, 1), "server": serve_router.replica_count(),
                             "broker": broker_router.replica_count(), "actor_target": actor_router.target,
                             "actor_active": len(occupied), "backlog": len(demand),
                             "broker_depth": sum(len(s["srv"].experience) for s in broker_router.live)})
            settled = (phases_done.is_set() and not demand and serve_router.replica_count() == 2
                       and broker_router.replica_count() == 2 and actor_router.target == 2)
            if settled or t > args.deadline_s:
                break
            await asyncio.sleep(0.5)
        stop_all.set()
        actor_router.scale_to(0)  # let every worker slot retire
        await asyncio.gather(*tasks, return_exceptions=True)

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(drive())
    finally:
        loop.close()
    runner.stop()
    plane.stop()  # freeze the loop before the teardown: no scale mid-harvest
    decisions = plane.ledger()

    # -- harvest: serve ledgers, broker conservation, store stats
    serve_kills = serve_router.kills_executed()
    serve_totals = serve_router.close()
    shard_ledgers = broker_router.close()
    actor_router.close()
    store_stats = [s.stats() for s in stores]
    for s in stores:
        s.stop()

    producers = [
        {
            "actor_id": a.actor_id,
            "acked": int(a.rollouts_published),
            "shed": int(a.publish_throttle.shed),
            "failed": int(a.publish_throttle.failed),
            "attempted": int(a.rollouts_published + a.publish_throttle.shed + a.publish_throttle.failed),
            "episodes_done": int(a.episodes_done),
            "episodes_abandoned": int(a.episodes_abandoned),
            "episodes_resumed": int(a.episodes_resumed),
        }
        for a in all_actors
    ]
    totals = {k: sum(pr[k] for pr in producers) for k in ("attempted", "acked", "shed", "failed", "episodes_done",
                                                           "episodes_abandoned", "episodes_resumed")}
    per_shard = [
        {**led,
         "conserves": led["enqueued"] == led["popped"] + led["dropped_oldest"] + led["evicted_low"] + led["resident"],
         "unaccounted": led["popped"] - led["reply_lost"] - led["consumed"]}
        for led in shard_ledgers
    ]
    moves, holds, _ = audit_moves(decisions)
    paths = {t: tier_path(moves, t) for t in ("server", "broker", "actor")}
    stepped = [c for c in all_clients if c.steps > 0]
    artifact = {
        "host": "single host: in-process serve replicas + real-TCP broker shards + 2-shard real-TCP carry store + "
                f"real HTTP control plane, serve replicas on {args.platform or 'the CUDA device'}",
        "host_preflight": preflight_check("soak_autoscale"),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "policy": POLICY,
        "phases": [{"name": n, "duration_s": d, "tokens_per_s": r} for n, d, r in phases],
        "chaos": args.chaos,
        "chaos_recovery": runner.recovery,
        "tokens": {"produced": tokens_produced[0], "unserved": len(demand)},
        "replica_paths": paths,
        "timeline": timeline,
        "decisions": {"moves": moves, "holds": holds, "polls": plane.polls_total},
        "producers": producers,
        "producer_totals": totals,
        "broker_shards": per_shard,
        "serve_totals": serve_totals,
        "serve_kills": serve_kills,
        "stores": store_stats,
        "worker_errors": worker_errors,
        "discovery": {
            "clients_stepped": len(stepped),
            "topology_refreshes": sum(c.topology_refreshes for c in stepped),
            "topology_errors": sum(c.topology_errors for c in all_clients),
            "max_epoch_seen": max((c.topology_epoch for c in stepped), default=-1),
            "refreshes_per_stepped_client": [c.topology_refreshes for c in stepped],
        },
    }
    artifact["verdict"] = verdict_of(artifact)
    artifact["wall_s"] = round(time.perf_counter() - t_start, 2)
    return artifact


def main(argv=None) -> int:
    args = parse_args(argv)
    artifact = run_soak(args)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(json.dumps({**artifact["verdict"], "paths": artifact["replica_paths"]}, indent=2))
    return 0 if all(v for v in artifact["verdict"].values() if isinstance(v, bool)) else 1


if __name__ == "__main__":
    raise SystemExit(main())
