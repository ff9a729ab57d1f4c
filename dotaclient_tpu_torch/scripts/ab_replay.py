"""A/B: the host-side prioritized replay reservoir on vs off (twin of
scripts/ab_replay.py).

Both arms run the closed loop of ab_ppo_reuse.py (fake env -> 3 actors ->
mem:// broker -> learner) with the same number of consumed learner
batches, under a deliberately tight ppo.max_staleness (1) so the
learner's version counter outruns the frames in flight: the off arm drops
stale frames, the on arm admits them to the reservoir and replays them.
The arms differ only in LearnerConfig.replay: off vs on at ratio 0.25
with truncated importance weights. Bar: stale drops fall and the
reservoir serves rows (hit ratio > 0); if the off arm never dropped
anything the A/B has nothing to show and passes vacuously (recorded).

The learner and the actors run on the CUDA device unless `--platform
cpu`.

Run: python -m dotaclient_tpu_torch.scripts.ab_replay [--updates 30] [--seeds 2] [--out replay_ab_torch.json]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from dotaclient_tpu_torch.scripts.ab_ppo_reuse import actor_config, closed_loop, learner_config

ARMS = (("replay_off", False), ("replay_on", True))
REPLAY_KEYS = ("replay_admitted", "replay_sampled", "replay_hit_ratio", "replay_occupancy", "replay_bytes_spilled")
# The smoke's cut: 2 updates of one seed per arm (30 x 2 by default).
SMOKE_CUT = dict(updates=2, seeds=1)


def replay_learner_config(seed: int, replay_on: bool, ratio: float, platform: str = ""):
    """The smoke's learner with ppo.max_staleness 1 and the reservoir on
    or off (ratio, replay.max_staleness 16)."""
    lcfg = learner_config(seed, platform)
    lcfg.ppo.max_staleness = 1
    lcfg.replay.enabled = replay_on
    lcfg.replay.ratio = ratio
    lcfg.replay.max_staleness = 16
    return lcfg


def window_stats(rets: np.ndarray) -> dict:
    if len(rets) == 0:
        return {"episodes": 0, "early_mean": 0.0, "late_mean": 0.0, "improvement": 0.0}
    k = max(len(rets) // 3, 1)
    return {
        "episodes": len(rets),
        "early_mean": round(float(rets[:k].mean()), 4),
        "late_mean": round(float(rets[-k:].mean()), 4),
        "improvement": round(float(rets[-k:].mean() - rets[:k].mean()), 4),
    }


def arm_row(seed: int, on: bool, res: dict) -> dict:
    """One run's record: rates, the staging drop / replay counters, the
    return windows."""
    stats, wall, done, env_steps = res["stats"], res["wall_s"], res["learner_steps"], res["env_steps"]
    row = {
        "seed": seed,
        "learner_steps": done,
        "env_steps": int(env_steps),
        "env_steps_per_sec": round(env_steps / max(wall, 1e-9), 1),
        "learner_steps_per_sec": round(done / max(wall, 1e-9), 3),
        "dropped_stale": int(stats["dropped_stale"]),
        "consumed": int(stats["consumed"]),
        "rows_replayed": int(stats["rows_replayed"]),
        "rows_packed": int(stats["rows_packed"]),
        "dead_actors": res["dead_actors"],
        **window_stats(res["returns"]),
    }
    if on:
        for k in REPLAY_KEYS:
            row[k] = round(float(stats[k]), 4) if k == "replay_hit_ratio" else int(stats[k])
    return row


def verdict_of(runs: dict, ratio: float, updates: int) -> dict:
    """The reference's arm means and bar."""

    def arm_mean(name, key):
        return float(np.mean([r[key] for r in runs[name]]))

    names = [n for n, _ in ARMS]
    off_dropped, on_dropped = arm_mean("replay_off", "dropped_stale"), arm_mean("replay_on", "dropped_stale")
    on_hit = arm_mean("replay_on", "replay_hit_ratio")
    no_staleness = off_dropped == 0
    return {
        "updates_per_arm": updates,
        "replay_ratio": ratio,
        "arm_mean": {
            "dropped_stale": {"replay_off": off_dropped, "replay_on": on_dropped},
            "env_steps_per_sec": {n: round(arm_mean(n, "env_steps_per_sec"), 1) for n in names},
            "learner_steps_per_sec": {n: round(arm_mean(n, "learner_steps_per_sec"), 3) for n in names},
            "late_return": {n: round(arm_mean(n, "late_mean"), 4) for n in names},
            "replay_hit_ratio": round(on_hit, 4),
        },
        "no_staleness_observed": bool(no_staleness),
        "stale_drops_recovered": bool(no_staleness or (on_dropped < off_dropped and on_hit > 0)),
    }


def run(args) -> dict:
    from dotaclient_tpu_torch.scripts.train_north_star import hardware_line

    t0 = time.time()
    runs = {name: [] for name, _ in ARMS}
    for name, on in ARMS:
        for seed in range(args.seeds):
            res = closed_loop(f"abr_{name}_{seed}", replay_learner_config(seed, on, args.ratio, args.platform),
                              lambda i, s=seed: actor_config(s, i, args.platform), args.updates, args.platform)
            row = arm_row(seed, on, res)
            runs[name].append(row)
            print(f"{name} seed={seed}: {row}", flush=True)
    artifact = {"generated_by": "dotaclient_tpu_torch/scripts/ab_replay.py", "hardware": hardware_line(args.platform),
                **verdict_of(runs, args.ratio, args.updates), "runs": runs}
    artifact["wall_s"] = round(time.time() - t0, 1)
    artifact["timestamp"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    return artifact


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="replay_ab_torch.json")
    p.add_argument("--updates", type=int, default=30)
    p.add_argument("--seeds", type=int, default=2)
    p.add_argument("--ratio", type=float, default=0.25)
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
    print(json.dumps({k: artifact[k] for k in ("arm_mean", "stale_drops_recovered")}), flush=True)
    return 0 if artifact["stale_drops_recovered"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
