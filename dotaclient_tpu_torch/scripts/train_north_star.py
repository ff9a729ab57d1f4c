"""North-star skill driver (twin of scripts/train_north_star.py; BASELINE.md
metric of record #2: "1v1 TrueSkill above the hard scripted bot").

Trains the policy against the fake env's HARD scripted bot (farms +
retreats, env/fake_dotaservice.py) at the reference's small config,
pausing every `--updates_per_eval` learner steps to evaluate a FROZEN copy
of the learner's net with the anchored-TrueSkill evaluator
(eval/evaluator.py). Writes `<out_dir>/metrics.jsonl` (one record per
evaluation) and `<out_dir>/NORTH_STAR.md` (summary) and exits 0 when the
success bar is met, 1 on budget exhaustion.

Success bar, both must hold (an agent at 50% win rate also clears the
first once sigma shrinks):
1. agent TrueSkill conservative (mu - 3 sigma) > the anchored hard bot's
   conservative (0 at the canonical 25/8.33 anchor);
2. mean decided win rate >= 0.55 over the last two evaluations.

The learner, the actors and the evaluator run on the CUDA device; pass
`--platform cpu` to run them on the host.

Reproduce:  python -m dotaclient_tpu_torch.scripts.train_north_star --out_dir north_star_torch
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import time

import numpy as np

from dotaclient_tpu_torch.config import ActorConfig, LearnerConfig, PolicyConfig
from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
from dotaclient_tpu_torch.eval.evaluator import Evaluator
from dotaclient_tpu_torch.runtime.actor import Actor
from dotaclient_tpu_torch.runtime.harness import ActorPool
from dotaclient_tpu_torch.runtime.learner import Learner
from dotaclient_tpu_torch.transport import memory as mem
from dotaclient_tpu_torch.transport.base import connect as broker_connect

SMALL = PolicyConfig(unit_embed_dim=16, lstm_hidden=16, mlp_hidden=16, dtype="float32")
BROKER = "north_star"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out_dir", default="north_star_torch")
    p.add_argument("--updates_per_eval", type=int, default=25)
    p.add_argument("--eval_episodes", type=int, default=16)
    p.add_argument("--max_updates", type=int, default=1500)
    p.add_argument("--max_minutes", type=float, default=90.0)
    p.add_argument("--n_actors", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    # PPO sample reuse: more gradient steps per consumed env step.
    p.add_argument("--ppo_epochs", type=int, default=1)
    p.add_argument("--ppo_minibatches", type=int, default=1)
    p.add_argument("--ppo_kl_stop", type=float, default=0.0)
    # "" = the CUDA device; "cpu" runs the learner, actors and evaluator on the host
    p.add_argument("--platform", default="", choices=("", "cpu"))
    return p.parse_args(argv)


def hardware_line(platform: str) -> str:
    """What the run ran on: the card's `nvidia-smi` name and power limit,
    or "CPU" for a host run."""
    if platform == "cpu":
        return "CPU"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    if not out:
        import torch

        out = f"{torch.cuda.get_device_name(0)}, power limit not read"
    return out.splitlines()[0]


def frozen_copy(net):
    """A copy of the learner's net that the evaluator holds while the
    learner trains on (the twin of `jax.device_get(state.params)`)."""
    return copy.deepcopy(net).requires_grad_(False).eval()


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    t_start = time.time()

    # --- training side: actors vs the HARD bot --------------------------
    service = FakeDotaService()
    mem.reset(BROKER)
    lcfg = LearnerConfig(
        batch_size=16, seq_len=16, policy=SMALL, mesh_shape="dp=-1",
        publish_every=1, seed=args.seed, platform=args.platform,
        log_dir=os.path.join(args.out_dir, "learner_logs"),
    )
    lcfg.ppo.lr = 1e-3
    lcfg.ppo.entropy_coef = 0.005
    lcfg.ppo.epochs = args.ppo_epochs
    lcfg.ppo.minibatches = args.ppo_minibatches
    lcfg.ppo.kl_stop = args.ppo_kl_stop

    def make_actor(i: int):
        acfg = ActorConfig(
            env_addr="local", rollout_len=16, max_dota_time=30.0,
            opponent="scripted_hard", policy=SMALL, seed=args.seed * 1000 + 100 + i,
            platform=args.platform,
        )
        return Actor(
            acfg, broker_connect(f"mem://{BROKER}"), actor_id=i,
            stub=LocalDotaServiceStub(service),
        )

    pool = ActorPool(make_actor, args.n_actors).start()
    learner = Learner(lcfg, broker_connect(f"mem://{BROKER}"), device="cpu" if args.platform == "cpu" else None)

    # --- eval side: frozen params vs the same HARD bot, own env ----------
    eval_cfg = ActorConfig(
        env_addr="local", rollout_len=16, max_dota_time=30.0,
        opponent="scripted_hard", policy=SMALL, seed=97, platform=args.platform,
    )
    evaluator = Evaluator(eval_cfg, stub=LocalDotaServiceStub(FakeDotaService()))

    history = []
    ok = False
    jsonl = open(os.path.join(args.out_dir, "metrics.jsonl"), "a", buffering=1)
    try:
        while learner.version < args.max_updates and (time.time() - t_start) < args.max_minutes * 60:
            # max_idle: if all actor threads die, surface a TimeoutError
            # instead of hanging past the max_minutes budget
            learner.run(num_steps=args.updates_per_eval, batch_timeout=60.0, max_idle=3)
            params = frozen_copy(learner.state.net)
            res = evaluator.evaluate(params, n_episodes=args.eval_episodes, version=learner.version)
            rec = {
                "version": learner.version,
                "wall_s": round(time.time() - t_start, 1),
                "episodes": res.episodes,
                "wins": res.wins,
                "losses": res.losses,
                "draws": res.draws,
                "win_rate": round(res.win_rate, 4),
                "mean_return": round(res.mean_return, 4),
                "mu": round(res.rating.mu, 4),
                "sigma": round(res.rating.sigma, 4),
                "conservative": round(res.skill, 4),
            }
            history.append(rec)
            jsonl.write(json.dumps(rec) + "\n")
            print(
                f"[north-star] v{rec['version']:4d} {rec['wall_s']:7.1f}s "
                f"win_rate={rec['win_rate']:.2f} mu={rec['mu']:.2f} "
                f"sigma={rec['sigma']:.2f} conservative={rec['conservative']:.2f}",
                flush=True,
            )
            recent = history[-2:]
            recent_wr = float(np.mean([r["win_rate"] for r in recent]))
            if len(history) >= 2 and res.skill > 0.0 and recent_wr >= 0.55:
                ok = True
                break
    except TimeoutError as e:
        print(f"[north-star] aborted: {e}", flush=True)
    finally:
        # let in-flight episodes drain (ActorPool.stop joins with a
        # bounded timeout)
        pool.stop(timeout=30)
        jsonl.close()
        learner.close()
        evaluator.close()

    ok = ok and pool.dead == 0  # a degraded actor pool taints the artifact
    final = history[-1] if history else {}
    wall_min = (time.time() - t_start) / 60.0
    summary = [
        "# North-star skill artifact (BASELINE.md metric of record #2)",
        "",
        f"- result: **{'PASSED' if ok else 'NOT reached'}**",
        "- opponent: `scripted_hard` (fake env hard bot — farms, retreats; the anchored yardstick)",
        "- anchor: TrueSkill(mu=25, sigma=8.333) fixed; conservative = 0.0",
        f"- final agent rating: mu={final.get('mu')}, sigma={final.get('sigma')}, "
        f"conservative={final.get('conservative')}",
        f"- final eval win rate: {final.get('win_rate')} "
        f"({final.get('wins')}W/{final.get('losses')}L/{final.get('draws')}D of {final.get('episodes')})",
        f"- learner updates: {final.get('version')}  |  wall-clock: {wall_min:.1f} min ({hardware_line(args.platform)})",
        f"- evaluations: {len(history)} (full curve in metrics.jsonl)",
        "",
        "Success bar: conservative > anchor conservative (0.0) AND mean win",
        "rate >= 0.55 over the last two evals (see module docstring for why",
        "both).",
        "",
        f"Reproduce: `python -m dotaclient_tpu_torch.scripts.train_north_star --seed {args.seed}"
        + (
            f" --ppo_epochs {args.ppo_epochs} --ppo_minibatches {args.ppo_minibatches}"
            f" --ppo_kl_stop {args.ppo_kl_stop}"
            if args.ppo_epochs * args.ppo_minibatches > 1 or args.ppo_kl_stop > 0
            else ""
        )
        + (" --platform cpu" if args.platform == "cpu" else "")
        + "`",
    ]
    with open(os.path.join(args.out_dir, "NORTH_STAR.md"), "w") as f:
        f.write("\n".join(summary) + "\n")
    print("\n".join(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
