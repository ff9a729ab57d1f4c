"""1v1 hero-pool self-play with ONE shared policy (twin of
scripts/train_hero_pool.py; BASELINE config 3).

The ladder's third rung: both sides draw a hero per episode from a pool
(Nevermore / Sniper / Viper: different stats, one policy net), the shared
LSTM conditioning on the 8-dim hashed hero-identity code in the hero
features (env/heroes.py). The run trains on the pool by mirror self-play,
then grades against a FIXED yardstick: in mirror self-play the opponent
improves in lockstep, so a hero's in-training return can fall while its
skill rises. The frozen FINAL and the frozen INITIAL policy each play
`--eval_episodes` per hero against the scripted hard bot on paired seeds.
Bar: every hero's final eval return beats its initial one (3/3). The
in-training per-hero returns go to `<out_dir>/metrics.jsonl`, unbarred;
the summary to `<out_dir>/HERO_POOL.md`.

The learner, the actors and the evaluator run on the CUDA device; pass
`--platform cpu` to run them on the host.

Run: python -m dotaclient_tpu_torch.scripts.train_hero_pool --out_dir hero_pool_run_torch
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

from dotaclient_tpu_torch.config import ActorConfig, LearnerConfig, PolicyConfig
from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
from dotaclient_tpu_torch.eval.evaluator import Evaluator
from dotaclient_tpu_torch.runtime.harness import ActorPool
from dotaclient_tpu_torch.runtime.learner import Learner
from dotaclient_tpu_torch.runtime.selfplay import SelfPlayActor
from dotaclient_tpu_torch.scripts.train_north_star import frozen_copy, hardware_line
from dotaclient_tpu_torch.transport import memory as mem
from dotaclient_tpu_torch.transport.base import connect as broker_connect

BROKER = "hero_pool_run"
POOL = "npc_dota_hero_nevermore,npc_dota_hero_sniper,npc_dota_hero_viper"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out_dir", default="hero_pool_run_torch")
    p.add_argument("--updates", type=int, default=150)
    p.add_argument("--n_actors", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_episodes", type=int, default=24, help="per hero, per policy")
    p.add_argument("--ppo_epochs", type=int, default=2)
    p.add_argument("--ppo_minibatches", type=int, default=2)
    p.add_argument("--ppo_kl_stop", type=float, default=0.05)
    # "" = the CUDA device; "cpu" runs the learner, actors and evaluator on the host
    p.add_argument("--platform", default="", choices=("", "cpu"))
    return p.parse_args(argv)


def run_configs(args):
    """The run's configs: (policy, learner config, one self-play actor
    config per actor), the reference's values field for field."""
    policy = PolicyConfig(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32")
    lcfg = LearnerConfig(
        batch_size=16, seq_len=16, policy=policy, mesh_shape="dp=-1",
        publish_every=1, seed=args.seed, platform=args.platform,
        log_dir=os.path.join(args.out_dir, "learner_logs"),
    )
    lcfg.ppo.lr = 1e-3
    lcfg.ppo.entropy_coef = 0.005
    lcfg.ppo.epochs = args.ppo_epochs
    lcfg.ppo.minibatches = args.ppo_minibatches
    lcfg.ppo.kl_stop = args.ppo_kl_stop
    acfgs = [
        ActorConfig(
            env_addr="local", rollout_len=16, max_dota_time=30.0,
            opponent="self", hero=POOL, policy=policy, seed=args.seed * 733 + i,
            platform=args.platform,
        )
        for i in range(args.n_actors)
    ]
    return policy, lcfg, acfgs


def eval_config(policy_cfg, hero: str, seed: int, platform: str = "") -> ActorConfig:
    """The frozen-policy eval's actor config for one hero."""
    return ActorConfig(
        env_addr="local", rollout_len=16, max_dota_time=30.0,
        opponent="scripted_hard", hero=hero, policy=policy_cfg, seed=seed, platform=platform,
    )


def eval_per_hero(params, policy_cfg, heroes_list, episodes, seed, platform: str = ""):
    """Frozen-policy eval: `episodes` per hero against the SCRIPTED hard
    bot (the fixed yardstick), a fresh env per hero, through the port's
    Evaluator. Returns {hero: mean_return}."""
    out = {}
    for hero in heroes_list:
        ev = Evaluator(eval_config(policy_cfg, hero, seed, platform), stub=LocalDotaServiceStub(FakeDotaService()))
        out[hero] = float(ev.evaluate(params, n_episodes=episodes).mean_return)
        ev.close()
    return out


def hero_pool_ok(pool_dead: int, version: int, updates: int, heroes_seen, deltas: dict) -> bool:
    """The bar: no dead actor, every update taken, all three heroes drawn,
    and every hero's final eval return above its initial one."""
    return pool_dead == 0 and version >= updates and len(heroes_seen) == 3 and all(d > 0 for d in deltas.values())


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    t_start = time.time()

    policy, lcfg, acfgs = run_configs(args)
    service = FakeDotaService()
    mem.reset(BROKER)
    records = []  # (hero_name, episode_return) in completion order
    lock = threading.Lock()

    def make_actor(i: int):
        return SelfPlayActor(acfgs[i], broker_connect(f"mem://{BROKER}"), actor_id=i,
                             stub=LocalDotaServiceStub(service))

    def on_episode(i, actor, ret):
        with lock:
            records.append((actor.last_heroes[0], float(ret)))

    pool = ActorPool(make_actor, args.n_actors, on_episode).start()
    learner = Learner(lcfg, broker_connect(f"mem://{BROKER}"), device="cpu" if args.platform == "cpu" else None)
    init_params = frozen_copy(learner.state.net)  # the frozen yardstick twin
    try:
        learner.run(num_steps=args.updates, batch_timeout=120.0, max_idle=3)
    except TimeoutError as e:
        print(f"[hero-pool] aborted: {e}", flush=True)
    finally:
        pool.stop(timeout=30)
        learner.close()

    final_params = frozen_copy(learner.state.net)
    with lock:
        recs = list(records)
    with open(os.path.join(args.out_dir, "metrics.jsonl"), "w") as f:
        for hero, ret in recs:
            f.write(json.dumps({"hero": hero, "return": ret}) + "\n")
    heroes_seen = sorted({h for h, _ in recs})
    drawn = {h: sum(1 for hh, _ in recs if hh == h) for h in heroes_seen}

    # ---- fixed-yardstick eval: init vs final policy, per hero ----------
    pool_list = POOL.split(",")
    print("[hero-pool] eval phase: initial policy vs scripted_hard...", flush=True)
    init_eval = eval_per_hero(init_params, policy, pool_list, args.eval_episodes, args.seed + 7, args.platform)
    print("[hero-pool] eval phase: final policy vs scripted_hard...", flush=True)
    final_eval = eval_per_hero(final_params, policy, pool_list, args.eval_episodes, args.seed + 7, args.platform)
    deltas = {h: final_eval[h] - init_eval[h] for h in pool_list}

    wall_min = (time.time() - t_start) / 60.0
    ok = hero_pool_ok(pool.dead, learner.version, args.updates, heroes_seen, deltas)
    lines = [
        "# Hero-pool self-play artifact (BASELINE config 3)",
        "",
        f"- result: **{'OK' if ok else 'INCOMPLETE'}**",
        f"- pool: {POOL} (both sides draw per episode; ONE shared policy, "
        f"hero-id conditioning in the features)",
        f"- learner updates: {learner.version} "
        f"(ppo reuse {args.ppo_epochs}x{args.ppo_minibatches}, kl_stop {args.ppo_kl_stop}); "
        f"{len(recs)} self-play episodes, draws per hero: "
        + ", ".join(f"{h.split('_')[-1]} {n}" for h, n in drawn.items()),
        f"- bar: FINAL policy beats INITIAL policy for EVERY hero on the fixed "
        f"yardstick (scripted_hard, {args.eval_episodes} eval eps/hero, paired seeds) — "
        f"self-play training curves are not graded (the opponent improves too; "
        f"see module docstring)",
    ] + [
        f"- {h.split('_')[-1]}: init {init_eval[h]:+.3f} -> final {final_eval[h]:+.3f} "
        f"({deltas[h]:+.3f})"
        for h in pool_list
    ] + [
        f"- wall-clock: {wall_min:.1f} min ({hardware_line(args.platform)}, incl. both eval phases)",
        "",
        f"Reproduce: `python -m dotaclient_tpu_torch.scripts.train_hero_pool --seed {args.seed} "
        f"--updates {args.updates}" + (" --platform cpu" if args.platform == "cpu" else "") + "`",
    ]
    with open(os.path.join(args.out_dir, "HERO_POOL.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
