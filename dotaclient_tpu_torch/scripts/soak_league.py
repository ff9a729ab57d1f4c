"""League-through-serve soak (twin of scripts/soak_league.py): the
standing-population closed loop.

A 3-opponent league (two frozen mains and one gated exploiter) served
from ONE multi-model inference server (`--serve.models 4`; slot 0 stays
the live tree and is never stepped remotely), matched to a 3-actor
self-play fleet by the standing league service, while a
`rolling@T:P@server` schedule kills the serve tier mid-stream. The bars:

- ZERO abandoned episodes: every interrupted opponent session resumes on
  the reborn server from the shared carry store (entries keyed by
  compose_store_key(client_key, model_id), so sibling slots on one server
  never cross), with FLAG_REPLAY rebuilding the partial chunk
  (runtime/selfplay.py `_resume_opp_side`). `remote_fallbacks` (an
  episode degraded to mirror) must be zero.
- EXACT per-model ledgers across server lives: slot 0 requests == 0,
  per-slot request counts partition the aggregate in every life,
  evictions partition, and every life's league sync installed all three
  assigned slots.
- At least one exploiter PROMOTED through the matchmaking policy: the
  exploiter clause seeds the candidate's gate games (its [wins, games]
  ledger moves only through matchmade /result posts), and the gate
  promotes it mid-soak (gate_winrate=0: the claim is the
  matchmaking → gate → promote loop, not the toy env's win distribution).
- The leaderboard BIT FOR BIT from the match log: a fresh LeagueService
  booted on the registry dir reproduces every rating, every gate and
  results_total exactly by replaying matches.jsonl.

The frozen mains' params come from the port's init_params under
torch.Generator().manual_seed(101 / 202 / 303) (the reference seeds jax
keys 101 / 202 / 303); no verdict depends on the values. The server and
the actors run on the CUDA device unless `--platform cpu`; the actors
reach their envs over gRPC (`--env grpc`, the reference) or in process
(`--env local`). `run_soak` takes a PolicyConfig (None: the soak's tiny
one).

Run: python -m dotaclient_tpu_torch.scripts.soak_league --out league_soak_torch.json
     python -m dotaclient_tpu_torch.scripts.soak_league --quick --platform cpu --out /tmp/x.json
"""

from __future__ import annotations

import argparse
import asyncio
import json
import shutil
import tempfile
import time

from dotaclient_tpu_torch.scripts.chaos_soak import tiny_policy
from dotaclient_tpu_torch.scripts.soak_serve_handoff import _PacedStub

MODELS, SLOTS, GATE_GAMES = 4, 3, 2
LEAGUE_POLICY = "prioritized@0.4;uniform@0.2;exploiter@0.4"
# the frozen trees the league registers: (name, version, init seed, kind, parent)
TREES = (("main-v100", 100, 101, "snapshot", None), ("main-v200", 200, 202, "snapshot", None),
         ("exp-1", 250, 303, "exploiter", "main-v200"))


def league_config(reg_dir: str):
    """The standing league's config (the live service and its replay)."""
    from dotaclient_tpu_torch.config import LeagueConfig, LeagueServiceConfig

    return LeagueConfig(league=LeagueServiceConfig(
        port=0, dir=reg_dir, capacity=8, slots=SLOTS, policy=LEAGUE_POLICY,
        gate_games=GATE_GAMES, gate_winrate=0.0, seed=0,
    ))


def server_config(policy, port: int, league_ep: str, store_port: int, platform: str = ""):
    """The multi-model server's config for one life."""
    from dotaclient_tpu_torch.config import InferenceConfig, ServeConfig

    return InferenceConfig(
        serve=ServeConfig(
            port=port, max_batch=8, gather_window_s=0.002, models=MODELS, league_endpoint=league_ep,
            league_sync_s=0.25, handoff_endpoint=f"127.0.0.1:{store_port}", handoff_timeout_s=2.0,
        ),
        policy=policy,
        seed=7,
        platform=platform,
    )


def actor_config(policy, j: int, env_addr: str, serve_port: int, league_ep: str, platform: str = ""):
    """Self-play actor j's config: league opponents stepped on the server."""
    from dotaclient_tpu_torch.config import ActorConfig, RetryConfig, ServeClientConfig

    return ActorConfig(
        env_addr=env_addr,
        rollout_len=2,  # short chunks: every episode crosses several carry
        # boundaries, so a mid-episode kill usually finds a store-backed
        # session to resume (boundary > 0)
        max_dota_time=12.0,
        policy=policy,
        seed=100 + j,
        opponent="league",
        max_weight_age_s=0.0,  # no learner in the loop: no kill switch
        platform=platform,
        serve=ServeClientConfig(
            endpoint=f"127.0.0.1:{serve_port}", league=league_ep, timeout_s=6.0, connect_timeout_s=1.5,
            cooldown_s=0.3, resume=True, resume_window_s=15.0,
        ),
        retry=RetryConfig(window_s=5.0, backoff_base_s=0.05, backoff_cap_s=0.5),
    )


def register_trees(lc, policy) -> None:
    """Two frozen mains and one exploiter candidate into the league."""
    import torch

    from dotaclient_tpu_torch.models.policy import init_params
    from dotaclient_tpu_torch.transport.params import named_params

    for name, version, seed, kind, parent in TREES:
        net = init_params(policy, torch.Generator().manual_seed(seed), torch.device("cpu"))
        lc.register(name, version, named_params(net), kind=kind, parent=parent)


def per_life_record(led: dict) -> dict:
    """One server life's ledger, per model."""
    return {
        "requests": led["requests"],
        "model_requests": [led[f"model{m}_requests"] for m in range(MODELS)],
        "model_evictions": [led[f"model{m}_evictions"] for m in range(MODELS)],
        "model_swaps": [led[f"model{m}_swaps"] for m in range(MODELS)],
        "resumes": led["resumes"],
        "resume_misses": led["resume_misses"],
        "handoff_writes": led["handoff_writes"],
        "handoff_write_errors": led["handoff_write_errors"],
        "replayed_steps": led["replayed_steps"],
        "evictions": led["evictions"],
    }


def verdict_of(args, artifact: dict) -> dict:
    """The twelve bars, from the artifact alone."""
    fleet, league, per_life = artifact["fleet"], artifact["league"], artifact["serve"]["per_life"]
    totals = artifact["serve"]["totals"]
    agg = totals["model_requests"]
    min_kills = 1 if args.quick else 2
    return {
        # the headline: a serve-tier rolling restart is an episode
        # non-event for the league fleet
        "zero_abandoned_episodes": fleet["remote_fallbacks"] == 0 and fleet["finished_all"],
        "store_backed_resumes": fleet["remote_resumes"] >= 1
        and totals["resumes"] >= 1
        and totals["resume_misses"] == 0
        and totals["handoff_writes"] >= 1
        and totals["handoff_write_errors"] == 0,
        "rolling_killed_server": artifact["kills_executed"] >= min_kills,
        # per-model ledgers exact, every life
        "model_requests_partition_aggregate": all(sum(l["model_requests"]) == l["requests"] for l in per_life),
        "model_evictions_partition_aggregate": all(sum(l["model_evictions"]) == l["evictions"] for l in per_life),
        "live_tree_never_stepped_remotely": all(l["model_requests"][0] == 0 for l in per_life),
        "league_sync_installed_all_slots_every_life": all(
            sum(l["model_swaps"][1:]) == SLOTS and l["model_swaps"][0] == 0 for l in per_life),
        "every_league_slot_served": all(agg[m] > 0 for m in range(1, MODELS)),
        # matchmaking and ratings closed the loop
        "matchmaking_no_errors": fleet["remote_match_errors"] == 0 and fleet["remote_result_errors"] == 0
        and league["bad_results_total"] == 0,
        "results_ledger_exact": fleet["remote_results_posted"] == league["results_total"],
        "exploiter_promoted_via_matchmaking": league["promotions_total"] >= 1
        and "exp-1" in league["pool"]
        and league["gate"].get("exp-1", [0, 0])[1] >= GATE_GAMES
        and fleet["exploiter_matches"] >= GATE_GAMES
        and league["exploiter_lineage_events"] == ["admit", "promote"],
        # the registry dir IS the service: bit for bit on reboot
        "leaderboard_replay_bitwise": all(artifact["replay"].values()),
    }


def _env_stubs(env: str, n: int):
    """(env_addrs, make_stub per actor or None, servers): `grpc` serves
    one FakeDotaService per actor on a loopback port, as the reference
    does; `local` hands each actor an in-process stub of its own."""
    from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService

    if env == "grpc":
        from dotaclient_tpu_torch.env.service import serve as env_serve

        servers = [env_serve(FakeDotaService()) for _ in range(n)]
        return [f"127.0.0.1:{port}" for _, port in servers], [None] * n, [s for s, _ in servers]
    if env != "local":
        raise ValueError(f"--env must be grpc or local, got {env!r}")
    from dotaclient_tpu_torch.env.service import LocalDotaServiceStub

    services = [FakeDotaService() for _ in range(n)]
    return ["local"] * n, [lambda s=s: LocalDotaServiceStub(s) for s in services], []


def run_soak(args, policy=None) -> dict:
    """The soak; returns the artifact ("verdict" holds the bools, "wall_s"
    the seconds)."""
    from dotaclient_tpu_torch.chaos import FaultSchedule, ScheduleRunner, ServeIncarnations
    from dotaclient_tpu_torch.league.client import LeagueClient
    from dotaclient_tpu_torch.league.server import LeagueService
    from dotaclient_tpu_torch.obs.preflight import check as preflight_check
    from dotaclient_tpu_torch.runtime.actor import connect_env_async
    from dotaclient_tpu_torch.runtime.selfplay import SelfPlayActor
    from dotaclient_tpu_torch.serve.handoff import CarryStoreServer
    from dotaclient_tpu_torch.serve.server import InferenceServer
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect

    t_start = time.perf_counter()
    policy = tiny_policy() if policy is None else policy
    reg_dir = tempfile.mkdtemp(prefix="league_soak_registry_")
    artifact = {
        "host": "single host: one in-process multi-model serve tier (4 slots) under rolling restart, real-TCP carry "
                f"store, standing league service (HTTP), 3 self-play actors with remote league opponents, envs over "
                f"{args.env}, server and actors on {args.platform or 'the CUDA device'}",
        "host_preflight": preflight_check("soak_league"),
        "actors": args.actors,
        "episodes_per_actor": args.episodes_per_actor,
        "rolling_spec": args.rolling,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "gate_disclosure": (
            "gate_winrate=0 on purpose: promotion fires on gate GAMES (each one "
            "a matchmade exploiter-vs-main result), so the verdict tests the "
            "matchmaking->gate->promote loop, not the toy env's win distribution"
        ),
    }
    try:
        # ---------------- the standing population ----------------------
        svc = LeagueService(league_config(reg_dir)).start()
        league_ep = f"127.0.0.1:{svc.port}"
        lc = LeagueClient(league_ep)
        register_trees(lc, policy)
        if svc.registry.candidates() != ["exp-1"]:
            raise RuntimeError(f"the exploiter is not the one candidate: {svc.registry.candidates()}")
        assignments_at_start = lc.assignments()

        # ------------- ONE multi-model server under the fault schedule --
        store_srv = CarryStoreServer(port=0).start()
        inc = ServeIncarnations(
            lambda port: InferenceServer(server_config(policy, port, league_ep, store_srv.port,
                                                       args.platform)).start(), port=0)
        deadline = time.monotonic() + 60.0
        while sum(inc.server.model_swaps[1:]) < SLOTS:  # the initial league sync
            if time.monotonic() > deadline:
                raise RuntimeError("initial league sync never installed the slots")
            time.sleep(0.05)

        # -------------------------- the fleet ----------------------------
        env_addrs, make_stubs, env_servers = _env_stubs(args.env, args.actors)
        mem.reset("league_soak")
        actors = []
        for j in range(args.actors):
            cfg = actor_config(policy, j, env_addrs[j], inc.port, league_ep, args.platform)
            actor = SelfPlayActor(cfg, connect("mem://league_soak"), actor_id=j)
            if actor.league is not None:
                raise RuntimeError("remote league mode built a local pool")
            actors.append(actor)

        soak_deadline = time.monotonic() + 240.0
        runner_box = {}
        exploiter_matches = 0

        async def drive():
            nonlocal exploiter_matches

            async def one(j, actor):
                nonlocal exploiter_matches
                while actor.episodes_done < args.episodes_per_actor and time.monotonic() < soak_deadline:
                    # paced env: ~0.02 s per observe stretches episodes
                    # across the kill windows (set before the lazy connect)
                    if actor._stub is None:
                        inner = make_stubs[j]() if make_stubs[j] is not None else connect_env_async(actor.cfg)
                        actor._stub = _PacedStub(inner, 0.02)
                    await actor.run_episode()
                    if actor._opp_role == "exploiter":
                        exploiter_matches += 1
                    await asyncio.sleep(0.02)

            async def arm_runner():
                # a progress-gated epoch: t0 starts once episodes flow, so
                # the roll hits a mid-stream fleet on any host
                while sum(a.episodes_done for a in actors) < 1:
                    if time.monotonic() > soak_deadline:
                        return
                    await asyncio.sleep(0.02)
                runner_box["r"] = ScheduleRunner(FaultSchedule.parse(args.rolling, seed=0), broker=None,
                                                 t0=time.monotonic(), server=inc).start()

            try:
                await asyncio.gather(*(one(j, a) for j, a in enumerate(actors)), arm_runner())
            finally:
                # park every remote client's read loop so the loop closes quietly
                for a in actors:
                    for cli in a._remote_clients.values():
                        await cli.close()

        loop = asyncio.new_event_loop()
        try:
            loop.run_until_complete(drive())
        finally:
            loop.close()
        runner = runner_box.get("r")
        if runner is not None:
            runner.stop()
        for es in env_servers:
            es.stop(0)

        # ------------------------- harvest ------------------------------
        total = inc.final_ledger()
        lives = list(inc.ledgers)
        store_stats = store_srv.stats()
        store_srv.stop()
        fleet = {k: sum(getattr(a, k) for a in actors)
                 for k in ("episodes_done", "remote_matches", "remote_match_errors", "remote_results_posted",
                           "remote_result_errors", "remote_fallbacks", "remote_resumes", "remote_replay_steps")}
        fleet["exploiter_matches"] = exploiter_matches
        fleet["finished_all"] = all(a.episodes_done >= args.episodes_per_actor for a in actors)
        per_life = [per_life_record(led) for led in lives]
        serve_totals = {
            "incarnations": total["incarnations"],
            "requests": total["requests"],
            "model_requests": [sum(l["model_requests"][m] for l in per_life) for m in range(MODELS)],
            **{k: total[k] for k in ("resumes", "resume_misses", "handoff_writes", "handoff_write_errors",
                                     "replayed_steps")},
        }

        # ----------------- league state + bit-for-bit replay -------------
        live_board = svc.leaderboard()
        live_gate = {k: list(v) for k, v in svc._gate.items()}
        league_live = {
            "pool": svc.registry.pool(),
            "candidates": svc.registry.candidates(),
            "promotions_total": svc.promotions_total,
            "results_total": svc.results_total,
            "bad_results_total": svc.bad_results_total,
            "matches_total": svc.matches_total,
            "gate": live_gate,
            "exploiter_lineage_events": [e["event"] for e in svc.registry.record("exp-1")["events"]],
            "assignments_at_start": assignments_at_start,
            "leaderboard": live_board["leaderboard"],
        }
        svc.stop()
        replay = LeagueService(league_config(reg_dir))
        replay_board = replay.leaderboard()
        replay_cmp = {
            "leaderboard_bitwise": replay_board == live_board,
            "gates_bitwise": {k: list(v) for k, v in replay._gate.items()} == live_gate,
            "results_total_match": replay.results_total == league_live["results_total"],
            "pool_match": replay.registry.pool() == league_live["pool"],
        }
    finally:
        shutil.rmtree(reg_dir, ignore_errors=True)
    artifact["fleet"] = fleet
    artifact["serve"] = {"per_life": per_life, "totals": serve_totals}
    artifact["store"] = store_stats
    artifact["league"] = league_live
    artifact["replay"] = replay_cmp
    artifact["rolling_recovery"] = None if runner is None else runner.recovery
    artifact["kills_executed"] = len(inc.kill_times)
    artifact["verdict"] = verdict_of(args, artifact)
    artifact["wall_s"] = round(time.perf_counter() - t_start, 2)
    return artifact


# A cut of the default that keeps two rolls, run by the smoke's phase 23 and
# the CPU tests: --quick's one roll and one more at 1.6 s (the default's
# second lands at 3.17 s) over 5 episodes per actor (--quick: 3; the
# default: 6), so the second roll still finds the fleet stepping. Only
# --quick's verdict rule (one kill) differs from the default's.
SMOKE_CUT = dict(episodes_per_actor=5, rolling="rolling@0.35:0.7@server,rolling@1.6:0.7@server")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="league_soak_torch.json")
    p.add_argument("--actors", type=int, default=3)
    p.add_argument("--episodes-per-actor", type=int, default=6)
    # offsets land the kills MID-EPISODE past a chunk boundary (episodes
    # run ~0.4-0.6 s under the paced stub; boundaries every 2 steps): the
    # interesting resume is the store-backed one
    p.add_argument("--rolling", default="rolling@0.35:0.7@server,rolling@3.17:0.7@server")
    p.add_argument("--quick", action="store_true",
                   help="nightly-wrapper scale: fewer episodes, one rolling event, same invariants")
    # "" = the CUDA device; "cpu" runs the server and the actors on the host
    p.add_argument("--platform", default="", choices=("", "cpu"))
    # how the actors reach their envs: gRPC (the reference), or in process
    p.add_argument("--env", default="grpc", choices=("grpc", "local"))
    args = p.parse_args(argv)
    if args.quick:
        args.episodes_per_actor = 3
        args.rolling = "rolling@0.35:0.7@server"
    return args


def cut_args(argv=()) -> argparse.Namespace:
    """`--quick` and the flags in argv, with SMOKE_CUT applied."""
    args = parse_args(["--quick", *argv])
    for k, v in SMOKE_CUT.items():
        setattr(args, k, v)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    artifact = run_soak(args)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(json.dumps(artifact, indent=2))
    return 0 if all(v for v in artifact["verdict"].values() if isinstance(v, bool)) else 1


if __name__ == "__main__":
    raise SystemExit(main())
