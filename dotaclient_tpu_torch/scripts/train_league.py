"""League self-play with auxiliary value heads (twin of
scripts/train_league.py; BASELINE config 5).

The benchmark ladder's top rung ("5v5 league self-play (PFSP) + aux value
heads"), run end to end at the reference's small scale: SelfPlayActors in
league mode (frozen PFSP snapshots taken from the weight fanout, the live
side publishes experience) and aux heads (win-prob, last-hit, net-worth)
on the policy and in the loss. Writes `<out_dir>/LEAGUE.md` and the
learner's `learner_logs/metrics.jsonl`: the proof that the pieces run
together. Team size defaults to 1; `--team_size 5` is the full 5v5 shape.

The learner and the actors run on the CUDA device; pass `--platform cpu`
to run them on the host.

Run: python -m dotaclient_tpu_torch.scripts.train_league --out_dir league_run_torch
"""

from __future__ import annotations

import argparse
import json
import os
import time

from dotaclient_tpu_torch.config import ActorConfig, LearnerConfig, PolicyConfig
from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
from dotaclient_tpu_torch.runtime.harness import ActorPool
from dotaclient_tpu_torch.runtime.learner import Learner
from dotaclient_tpu_torch.runtime.selfplay import SelfPlayActor
from dotaclient_tpu_torch.scripts.train_north_star import frozen_copy, hardware_line
from dotaclient_tpu_torch.transport import memory as mem
from dotaclient_tpu_torch.transport.base import connect as broker_connect

BROKER = "league_run"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out_dir", default="league_run_torch")
    p.add_argument("--updates", type=int, default=150)
    p.add_argument("--team_size", type=int, default=1)
    p.add_argument("--n_actors", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    # "" = the CUDA device; "cpu" runs the learner and the actors on the host
    p.add_argument("--platform", default="", choices=("", "cpu"))
    return p.parse_args(argv)


def config5(seed: int, team_size: int, n_actors: int, out_dir: str, ppo_reuse: bool = False, platform: str = ""):
    """The config-5 run's configs: (policy, learner config, one actor
    config per actor), the reference's values field for field."""
    policy = PolicyConfig(
        unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32",
        aux_heads=True,  # config 5: win-prob / last-hit / net-worth heads
    )
    lcfg = LearnerConfig(
        batch_size=16, seq_len=16, policy=policy, mesh_shape="dp=-1",
        publish_every=1, seed=seed, platform=platform,
        log_dir=os.path.join(out_dir, "learner_logs"),
    )
    lcfg.ppo.lr = 1e-3
    if ppo_reuse:
        # the sample-reuse knob (3.4x fewer env steps to the same skill on
        # the north star); the 5v5 grader trains with it
        lcfg.ppo.epochs = 2
        lcfg.ppo.minibatches = 2
        lcfg.ppo.kl_stop = 0.05
    acfgs = [
        ActorConfig(
            env_addr="local", rollout_len=16, max_dota_time=30.0,
            opponent="league", team_size=team_size, policy=policy,
            league_capacity=8, league_snapshot_every=10, pfsp_mode="hard",
            seed=seed * 577 + i, platform=platform,
        )
        for i in range(n_actors)
    ]
    return policy, lcfg, acfgs


def train_config5(
    seed: int,
    updates: int,
    team_size: int,
    n_actors: int,
    out_dir: str,
    ppo_reuse: bool = False,
    platform: str = "",
):
    """Run the config-5 topology (league-mode SelfPlayActors and an
    aux-head learner over a mem:// broker) and return what a grader
    needs: frozen copies of the INITIAL and FINAL nets and the run's
    liveness evidence. grade_5v5 trains each seed through this function."""
    policy, lcfg, acfgs = config5(seed, team_size, n_actors, out_dir, ppo_reuse, platform)
    service = FakeDotaService()
    mem.reset(BROKER)

    def make_actor(i: int):
        return SelfPlayActor(acfgs[i], broker_connect(f"mem://{BROKER}"), actor_id=i,
                             stub=LocalDotaServiceStub(service))

    pool = ActorPool(make_actor, n_actors).start()
    actors = pool.actors
    learner = Learner(lcfg, broker_connect(f"mem://{BROKER}"), device="cpu" if platform == "cpu" else None)
    init_params = frozen_copy(learner.state.net)  # the frozen yardstick twin
    try:
        learner.run(num_steps=updates, batch_timeout=120.0, max_idle=3)
    except TimeoutError as e:
        print(f"[league] aborted: {e}", flush=True)
    finally:
        pool.stop(timeout=30)
        learner.close()

    mlines = []
    mpath = os.path.join(out_dir, "learner_logs", "metrics.jsonl")
    if os.path.exists(mpath):
        with open(mpath) as f:
            mlines = [json.loads(line) for line in f]
    aux_keys = [k for k in (mlines[-1] if mlines else {}) if k.startswith("aux_")]
    return {
        "policy": policy,
        "init_params": init_params,
        "final_params": frozen_copy(learner.state.net),
        "aux_keys": aux_keys,
        "league_sizes": [len(a.league) for a in actors if a.league is not None],
        "episodes": sum(a.episodes_done for a in actors),
        "pool_dead": pool.dead,
        "version": learner.version,
        "env_steps": learner.env_steps_done,
        "ppo": f"{lcfg.ppo.epochs}x{lcfg.ppo.minibatches} kl_stop {lcfg.ppo.kl_stop}",
    }


def league_ok(res: dict, updates: int) -> bool:
    """The artifact's bar: no dead actor, every update taken, aux-head
    terms in the metrics, a league pool that snapshotted, and episodes."""
    return (
        res["pool_dead"] == 0
        and res["version"] >= updates
        and bool(res["aux_keys"])
        and any(s > 0 for s in res["league_sizes"])
        and res["episodes"] > 0
    )


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    t_start = time.time()
    res = train_config5(args.seed, args.updates, args.team_size, args.n_actors, args.out_dir,
                        platform=args.platform)
    wall_min = (time.time() - t_start) / 60.0
    aux_keys, league_sizes, episodes = res["aux_keys"], res["league_sizes"], res["episodes"]
    ok = league_ok(res, args.updates)
    summary = [
        "# League self-play + aux heads artifact (BASELINE config 5)",
        "",
        f"- result: **{'OK' if ok else 'INCOMPLETE'}**",
        f"- learner updates: {res['version']} (aux-head loss terms in metrics: {aux_keys})",
        f"- league pools (PFSP 'hard'): {league_sizes} frozen snapshots per actor",
        f"- self-play episodes: {episodes} (team_size {args.team_size}; "
        f"live side publishes, frozen side from the pool)",
        f"- env steps trained: {res['env_steps']}  |  wall-clock: {wall_min:.1f} min "
        f"({hardware_line(args.platform)})",
        "",
        f"Reproduce: `python -m dotaclient_tpu_torch.scripts.train_league --seed {args.seed} "
        f"--updates {args.updates} --team_size {args.team_size}"
        + (" --platform cpu" if args.platform == "cpu" else "") + "`",
    ]
    with open(os.path.join(args.out_dir, "LEAGUE.md"), "w") as f:
        f.write("\n".join(summary) + "\n")
    print("\n".join(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
