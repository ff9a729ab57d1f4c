"""A/B: is ability (CAST) usage advantageous? (twin of scripts/ab_cast.py)

Two arms of the closed-loop learning smoke (fake env -> 3 actors -> mem://
broker -> learner), identical but for `disable_cast`: the ablation arm
masks the CAST action out of every observation, so its policy can never
use the slot-0 nuke. Evidence of advantage: the cast-enabled arm's policy
(a) casts at a NONZERO rate measured by the ENV (ground truth: casts that
fired, FakeDotaService.action_telemetry) and (b) reaches an equal or
better late-window return than the ablation at the same env-step budget.

The learner and the actors run on the CUDA device unless `--platform
cpu`.

Run: python -m dotaclient_tpu_torch.scripts.ab_cast [--updates 45] [--seeds 2] [--out cast_ab_torch.json]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.scripts.ab_ppo_reuse import NOISE, actor_config, closed_loop, learner_config, window_stats

ARMS = (("cast_enabled", False), ("cast_disabled", True))
# The smoke's cut: 2 updates of one seed per arm (45 x 2 by default).
SMOKE_CUT = dict(updates=2, seeds=1)


def telemetry(service) -> dict:
    """The policy hero's action counts from the env (pid 0 in every 1v1
    session; the scripted foe is pid 1 and never goes through the action
    API)."""
    counts, casts = service.action_telemetry()
    mine = counts.get(0, {})
    total_actions = sum(mine.values())
    return {
        "actions_total": total_actions,
        "cast_actions": mine.get(F.ACT_CAST, 0),
        "casts_landed": casts.get(0, 0),
        "cast_action_rate": round(mine.get(F.ACT_CAST, 0) / max(total_actions, 1), 5),
        "attack_actions": mine.get(F.ACT_ATTACK, 0),
    }


def cast_actor_config(seed: int, i: int, disable_cast: bool, platform: str = ""):
    """An arm's actor: the smoke's, against the scripted foe, CAST masked
    out in the ablation."""
    return actor_config(seed, i, platform, opponent="scripted", disable_cast=disable_cast)


def verdict_of(runs: dict) -> dict:
    """The reference's three bars: the ablation casts nothing, the enabled
    arm casts (> 1% of actions, > 0 landed), and casting does not cost
    return (noise allowance 0.2)."""
    late = {n: float(np.mean([r["late_mean"] for r in rs])) for n, rs in runs.items()}
    cast_rate = float(np.mean([r["cast_action_rate"] for r in runs["cast_enabled"]]))
    landed = int(np.sum([r["casts_landed"] for r in runs["cast_enabled"]]))
    return {
        "arm_late_mean": {k: round(v, 4) for k, v in late.items()},
        "cast_enabled_cast_action_rate": round(cast_rate, 5),
        "cast_enabled_casts_landed_total": landed,
        "ablation_clean_zero_casts": bool(all(r["cast_actions"] == 0 for r in runs["cast_disabled"])),
        "cast_rate_nonzero": bool(cast_rate > 0.01 and landed > 0),
        "cast_equal_or_better_return": bool(late["cast_enabled"] >= late["cast_disabled"] - NOISE),
    }


VERDICTS = ("ablation_clean_zero_casts", "cast_rate_nonzero", "cast_equal_or_better_return")


def run(args) -> dict:
    from dotaclient_tpu_torch.scripts.train_north_star import hardware_line

    t0 = time.time()
    runs = {name: [] for name, _ in ARMS}
    for name, disable in ARMS:
        for seed in range(args.seeds):
            res = closed_loop(f"castab_{name}_{seed}", learner_config(seed, args.platform),
                              lambda i, s=seed, d=disable: cast_actor_config(s, i, d, args.platform), args.updates,
                              args.platform)
            row = {"seed": seed, **window_stats(res["returns"]), **telemetry(res["service"]),
                   "learner_steps": res["learner_steps"], "dead_actors": res["dead_actors"]}
            runs[name].append(row)
            print(f"{name} seed={seed}: {row}", flush=True)
    artifact = {"generated_by": "dotaclient_tpu_torch/scripts/ab_cast.py", "hardware": hardware_line(args.platform),
                "runs": runs, **verdict_of(runs), "updates_per_arm": args.updates}
    artifact["wall_s"] = round(time.time() - t0, 1)
    artifact["timestamp"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    return artifact


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="cast_ab_torch.json")
    p.add_argument("--updates", type=int, default=45)
    p.add_argument("--seeds", type=int, default=2)
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
    print(json.dumps({k: artifact[k] for k in VERDICTS}), flush=True)
    return 0 if all(artifact[k] for k in VERDICTS) else 1


if __name__ == "__main__":
    raise SystemExit(main())
