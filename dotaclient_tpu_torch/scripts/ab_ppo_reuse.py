"""A/B: PPO sample reuse (epochs x minibatches + KL stop) vs one update per
batch (twin of scripts/ab_ppo_reuse.py).

Both arms run the same closed loop (fake env -> 3 actors -> mem:// broker
-> learner) with the same number of consumed learner batches, an identical
env-step budget, and differ only in ppo.epochs / minibatches / kl_stop.
The reuse arm takes more gradient steps per consumed env step; equal or
better return per env step means the knob is a pure win.

The learner and the actors run on the CUDA device unless `--platform
cpu`. Writes per-run early/late return windows, per-arm means and the
verdict.

Run: python -m dotaclient_tpu_torch.scripts.ab_ppo_reuse [--updates 45] [--seeds 2] [--out ppo_reuse_ab_torch.json]
"""

from __future__ import annotations

import argparse
import json
import threading
import time

import numpy as np

from dotaclient_tpu_torch.config import ActorConfig, LearnerConfig, PolicyConfig

SMALL = PolicyConfig(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32")
N_ACTORS = 3
# The smoke's cut: 2 updates of one seed per arm (45 x 2 by default).
SMOKE_CUT = dict(updates=2, seeds=1)
# Equal-or-better with a noise allowance: the smoke's seed-to-seed spread
# is ~0.2 return.
NOISE = 0.2


def learner_config(seed: int, platform: str = "", epochs: int = 1, minibatches: int = 1,
                   kl_stop: float = 0.0) -> LearnerConfig:
    """The calibrated learning smoke's learner (16 x 16, the 16-wide f32
    policy, lr 1e-3, entropy 0.005) with the arm's PPO knobs."""
    lcfg = LearnerConfig(batch_size=16, seq_len=16, policy=SMALL, publish_every=1, seed=seed, platform=platform)
    lcfg.ppo.lr = 1e-3
    lcfg.ppo.entropy_coef = 0.005
    lcfg.ppo.epochs = epochs
    lcfg.ppo.minibatches = minibatches
    lcfg.ppo.kl_stop = kl_stop
    return lcfg


def actor_config(seed: int, i: int, platform: str = "", **kw) -> ActorConfig:
    """Actor i of a seed's run: the local fake env, 16-step chunks, 30 s
    episodes."""
    return ActorConfig(env_addr="local", rollout_len=16, max_dota_time=30.0, policy=SMALL, seed=seed * 1000 + i,
                       platform=platform, **kw)


def closed_loop(broker: str, lcfg: LearnerConfig, make_acfg, n_updates: int, platform: str = "") -> dict:
    """One closed-loop run: N_ACTORS actors on one FakeDotaService publish
    over mem://`broker` while a Learner trains `n_updates` steps. Returns
    the episode returns in completion order, the learner's steps, env
    steps, staging stats and seconds, and the env service (its telemetry
    is the ground truth of what the actors did)."""
    from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
    from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
    from dotaclient_tpu_torch.runtime.actor import Actor
    from dotaclient_tpu_torch.runtime.harness import ActorPool
    from dotaclient_tpu_torch.runtime.learner import Learner
    from dotaclient_tpu_torch.transport import memory as mem
    from dotaclient_tpu_torch.transport.base import connect

    service = FakeDotaService()
    mem.reset(broker)
    returns, lock = [], threading.Lock()

    def make_actor(i):
        return Actor(make_acfg(i), connect(f"mem://{broker}"), actor_id=i, stub=LocalDotaServiceStub(service))

    def on_episode(i, actor, ret):
        with lock:
            returns.append(ret)

    pool = ActorPool(make_actor, N_ACTORS, on_episode).start()
    learner = Learner(lcfg, connect(f"mem://{broker}"), device="cpu" if platform == "cpu" else None)
    try:
        t0 = time.time()
        done = learner.run(num_steps=n_updates, batch_timeout=300.0)
        wall = time.time() - t0
        stats = learner.staging.stats()
        env_steps = learner.env_steps_done
    finally:
        pool.stop(timeout=60, raise_on_dead=True)
        learner.close()
    with lock:
        rets = np.asarray(returns, float)
    return {"returns": rets, "learner_steps": done, "env_steps": env_steps, "stats": stats, "wall_s": wall,
            "service": service, "dead_actors": pool.dead}


def window_stats(rets: np.ndarray) -> dict:
    k = max(len(rets) // 3, 1)
    return {
        "episodes": len(rets),
        "early_mean": round(float(rets[:k].mean()), 4),
        "late_mean": round(float(rets[-k:].mean()), 4),
        "improvement": round(float(rets[-k:].mean() - rets[:k].mean()), 4),
    }


def arms_of(args) -> dict:
    return {
        "single_update": dict(epochs=1, minibatches=1, kl_stop=0.0),
        "reuse": dict(epochs=args.epochs, minibatches=args.minibatches, kl_stop=args.kl_stop),
    }


def verdict_of(runs: dict) -> dict:
    """Per-arm late / improvement means and the equal-or-better bar."""
    arm_late = {n: float(np.mean([r["late_mean"] for r in rs])) for n, rs in runs.items()}
    arm_impr = {n: float(np.mean([r["improvement"] for r in rs])) for n, rs in runs.items()}
    return {
        "arm_late_mean": {k: round(v, 4) for k, v in arm_late.items()},
        "arm_improvement_mean": {k: round(v, 4) for k, v in arm_impr.items()},
        "equal_or_better_per_env_step": bool(arm_late["reuse"] >= arm_late["single_update"] - NOISE),
    }


def run(args) -> dict:
    from dotaclient_tpu_torch.scripts.train_north_star import hardware_line

    t0 = time.time()
    arms = arms_of(args)
    runs = {name: [] for name in arms}
    for name, knobs in arms.items():
        for seed in range(args.seeds):
            lcfg = learner_config(seed, args.platform, **knobs)
            res = closed_loop(f"ab_{name}_{seed}", lcfg, lambda i, s=seed: actor_config(s, i, args.platform),
                              args.updates, args.platform)
            row = {"seed": seed, **window_stats(res["returns"]), "learner_steps": res["learner_steps"],
                   "ppo_epochs": lcfg.ppo.epochs, "dead_actors": res["dead_actors"]}
            runs[name].append(row)
            print(f"{name} seed={seed}: {row}", flush=True)
    artifact = {
        "generated_by": "dotaclient_tpu_torch/scripts/ab_ppo_reuse.py",
        "hardware": hardware_line(args.platform),
        "knobs": arms,
        "updates_per_arm": args.updates,
        "env_steps_per_arm": args.updates * 16 * 16,
        "runs": runs,
        **verdict_of(runs),
    }
    artifact["wall_s"] = round(time.time() - t0, 1)
    artifact["timestamp"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    return artifact


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="ppo_reuse_ab_torch.json")
    p.add_argument("--updates", type=int, default=45)
    p.add_argument("--seeds", type=int, default=2)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--minibatches", type=int, default=2)
    p.add_argument("--kl_stop", type=float, default=0.05)
    # "" = the CUDA device; "cpu" runs the learner and the actors on the host
    p.add_argument("--platform", default="", choices=("", "cpu"))
    return p.parse_args(argv)


def cut_args(argv=()) -> argparse.Namespace:
    """The flags in argv with SMOKE_CUT applied."""
    args = parse_args(list(argv))
    for k, v in SMOKE_CUT.items():
        setattr(args, k, v)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    artifact = run(args)
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print(json.dumps({k: artifact[k] for k in ("arm_late_mean", "equal_or_better_per_env_step")}), flush=True)
    return 0 if artifact["equal_or_better_per_env_step"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
