"""5v5 league self-play, GRADED (twin of scripts/grade_5v5.py; BASELINE
configs 4-5): the trained policy against a fixed team of five scripted
hard bots, with an explicit bar at every seed.

Self-play training curves are not graded (the opponent improves in
lockstep). Each seed trains config 5 end to end through
train_league.train_config5 (league-mode SelfPlayActors, PFSP pool, aux
heads, team_size 5, sample reuse), then the frozen INITIAL and the frozen
FINAL policy each play eval episodes as a 5-hero radiant team against
five scripted HARD dire bots (control_mode=2). The fake env decides a 5v5
by team wipe or, at time-up, by team net worth (env/fake_dotaservice.py
_check_end).

Two gradings per seed, both must pass:
  1. mean team eval return: final > init (the same eval seeds, paired);
  2. anchored two-team TrueSkill: every eval episode is scored with
     RatingTable.record_teams, five per-slot ratings per policy against
     five ANCHORED bot ratings (eval/rating.py rate_teams); the final
     team's summed conservative rating must beat the init team's.

An eval tick is one B=5 step on one jax key (runtime/actor.py
make_group_key_step, the reference's batched make_actor_step), the key
stream started from the reference's PRNGKey(seed) through ops/threefry.py.
The training and the eval run on the CUDA device; pass `--platform cpu`
to run them on the host. Writes `<out_dir>/LEAGUE.md` and
`<out_dir>/grade_5v5.json`.

Run: python -m dotaclient_tpu_torch.scripts.grade_5v5 --out_dir league_run_5v5_torch
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import time

import numpy as np

from dotaclient_tpu_torch.config import ActorConfig
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.env import rewards as R
from dotaclient_tpu_torch.env.fake_dotaservice import FakeDotaService
from dotaclient_tpu_torch.env.service import LocalDotaServiceStub
from dotaclient_tpu_torch.eval.rating import Rating, RatingTable, team_win_probability
from dotaclient_tpu_torch.models import policy as P
from dotaclient_tpu_torch.ops import action_dist as ad
from dotaclient_tpu_torch.ops import threefry
from dotaclient_tpu_torch.ops.batch import as_tensors
from dotaclient_tpu_torch.protos import dotaservice as ds
from dotaclient_tpu_torch.protos import worldstate as ws
from dotaclient_tpu_torch.runtime.actor import _to_host, build_action, make_group_key_step
from dotaclient_tpu_torch.scripts.train_league import train_config5
from dotaclient_tpu_torch.scripts.train_north_star import hardware_line

TEAM_RADIANT, TEAM_DIRE = 2, 3
N = 5


async def _team_episode(cfg, step_fn, params, stub, rng, np_rng):
    """One 5v5 eval episode: our five externally controlled radiant heroes
    (ONE shared policy, one B=5 step per tick) against five env-scripted
    HARD dire bots. Returns (mean team return, win in {+1, 0, -1},
    net-worth gap, rng)."""
    config = ds.GameConfig(
        host_timescale=cfg.host_timescale,
        ticks_per_observation=cfg.ticks_per_observation,
        max_dota_time=cfg.max_dota_time,
        seed=np_rng.randint(1 << 30),
        hero_picks=[ds.HeroPick(team_id=TEAM_RADIANT, hero_name=cfg.hero, control_mode=1) for _ in range(N)]
        + [ds.HeroPick(team_id=TEAM_DIRE, hero_name=cfg.hero, control_mode=2) for _ in range(N)],
    )
    device = next(params.parameters()).device
    resp = await stub.reset(config)
    world = resp.world_state
    state = P.initial_state(cfg.policy, (N,), device)
    per = [F.featurize_with_handles(world, pid) for pid in range(N)]
    last_hero = [None] * N
    returns = [0.0] * N
    done = False
    while not done:
        obs_b = as_tensors(F.stack([p[0] for p in per]), device)
        state, action_b, logp_b, value_b, rng = step_fn(params, state, obs_b, rng)
        acts, _ = _to_host(action_b, logp_b, value_b)  # one device-to-host copy per tick
        action_h = ad.Action(*(acts[:, k] for k in range(4)))
        out = []
        for pid in range(N):
            hero = F.find_hero(world, pid)
            if hero is not None:
                snap = ws.Unit()
                snap.CopyFrom(hero)
                last_hero[pid] = snap
            out.append(build_action(cfg, action_h, per[pid][1], hero, pid, batch_index=pid))
        await stub.act(ds.Actions(actions=out, dota_time=world.dota_time, team_id=TEAM_RADIANT))
        resp = await stub.observe(ds.ObserveRequest(team_id=TEAM_RADIANT))
        if resp.status == ds.Observation.RESOURCE_EXHAUSTED:
            raise RuntimeError("eval env session lost")
        next_world = resp.world_state
        done = resp.status == ds.Observation.EPISODE_DONE
        for pid in range(N):
            returns[pid] += R.reward(world, next_world, pid, last_hero[pid])
        world = next_world
        per = [F.featurize_with_handles(world, pid) for pid in range(N)]
    winning = world.winning_team
    win = 0 if not winning else (1 if winning == TEAM_RADIANT else -1)
    # net-worth margin from the final worldstate (each hero's gold + xp,
    # summed per team: the env's time-up decider), the distance-to-win
    # telemetry beside the W/L column
    nw = {TEAM_RADIANT: 0, TEAM_DIRE: 0}
    for u in world.units:
        if u.unit_type == ws.Unit.HERO and u.team_id in nw:
            nw[u.team_id] += int(u.gold) + int(u.xp)
    return float(np.mean(returns)), win, nw[TEAM_RADIANT] - nw[TEAM_DIRE], rng


def eval_config(policy_cfg, seed: int, platform: str = "") -> ActorConfig:
    """The frozen-params 5v5 eval's actor config."""
    return ActorConfig(
        env_addr="local",
        rollout_len=16,
        max_dota_time=30.0,
        opponent="scripted_hard",  # documentation; the picks carry the mode
        team_size=N,
        policy=policy_cfg,
        seed=seed,
        max_weight_age_s=0.0,  # frozen-params eval: no learner feeds this
        platform=platform,
    )


def record_outcome(table: RatingTable, ours, bots, win: int) -> None:
    """One eval episode's result into the anchored team table."""
    if win > 0:
        table.record_teams(ours, bots)
    elif win < 0:
        table.record_teams(bots, ours)
    else:
        table.record_teams(ours, bots, draw=True)


def anchored_table() -> RatingTable:
    """A table holding the five scripted bots, anchored at the default."""
    table = RatingTable()
    for i in range(N):
        table.add(f"hard_bot_{i}", Rating(), anchored=True)
    return table


def eval_team(policy_cfg, params, episodes, seed, table, slot_prefix, platform: str = ""):
    """Play `episodes` of frozen-params 5v5 against the scripted hard team,
    recording every outcome into `table` through record_teams:
    [slot_prefix]_h0..h4 (rated) against hard_bot_0..4 (anchored)."""
    cfg = eval_config(policy_cfg, seed, platform)
    step_fn = make_group_key_step(cfg.policy)
    rng = threefry.prng_key(seed)
    np_rng = np.random.RandomState(seed)
    ours = [f"{slot_prefix}_h{i}" for i in range(N)]
    bots = [f"hard_bot_{i}" for i in range(N)]
    rets, wins, losses, draws = [], 0, 0, 0
    loop = asyncio.new_event_loop()  # one loop for the whole eval (the Evaluator's pattern)
    nw_gaps = []
    try:
        for _ in range(episodes):
            stub = LocalDotaServiceStub(FakeDotaService())
            ret, win, nw_gap, rng = loop.run_until_complete(_team_episode(cfg, step_fn, params, stub, rng, np_rng))
            rets.append(ret)
            nw_gaps.append(nw_gap)
            record_outcome(table, ours, bots, win)
            wins += win > 0
            losses += win < 0
            draws += win == 0
    finally:
        loop.close()
    return {
        "mean_return": float(np.mean(rets)),
        "mean_net_worth_gap": float(np.mean(nw_gaps)),
        "wins": wins,
        "losses": losses,
        "draws": draws,
        "ratings": [table.get(n) for n in ours],
    }


def grade_seed(seed: int, res: dict, init_ev: dict, final_ev: dict) -> dict:
    """One seed's record and its two bars, from the run and both evals."""
    init_skill = sum(r.conservative for r in init_ev["ratings"])
    final_skill = sum(r.conservative for r in final_ev["ratings"])
    keys = ("mean_return", "mean_net_worth_gap", "wins", "losses", "draws")
    return {
        "seed": seed,
        "train": {k: res[k] for k in ("episodes", "league_sizes", "aux_keys", "version", "env_steps", "ppo")},
        "pool_dead": res["pool_dead"],
        "init": {k: init_ev[k] for k in keys},
        "final": {k: final_ev[k] for k in keys},
        "init_team_conservative": init_skill,
        "final_team_conservative": final_skill,
        "p_final_beats_init": team_win_probability(final_ev["ratings"], init_ev["ratings"]),
        "return_bar": final_ev["mean_return"] > init_ev["mean_return"],
        "trueskill_bar": final_skill > init_skill,
    }


def grade_ok(per_seed, updates: int) -> bool:
    """Every seed: both bars, no dead actor, every update taken."""
    return all(
        s["return_bar"] and s["trueskill_bar"] and s["pool_dead"] == 0 and s["train"]["version"] >= updates
        for s in per_seed
    )


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out_dir", default="league_run_5v5_torch")
    p.add_argument("--updates", type=int, default=80)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--n_actors", type=int, default=2)
    p.add_argument("--eval_episodes", type=int, default=16, help="per policy, per seed")
    # "" = the CUDA device; "cpu" runs the training and the evals on the host
    p.add_argument("--platform", default="", choices=("", "cpu"))
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    t_start = time.time()
    per_seed = []
    for seed in args.seeds:
        print(f"[5v5] seed {seed}: training config 5 ({args.updates} updates)...", flush=True)
        res = train_config5(seed, args.updates, team_size=N, n_actors=args.n_actors, out_dir=args.out_dir,
                            ppo_reuse=True, platform=args.platform)
        table = anchored_table()
        print(f"[5v5] seed {seed}: eval INIT policy vs scripted-hard team...", flush=True)
        init_ev = eval_team(res["policy"], res["init_params"], args.eval_episodes, seed + 7, table, "init",
                            args.platform)
        print(f"[5v5] seed {seed}: eval FINAL policy vs scripted-hard team...", flush=True)
        final_ev = eval_team(res["policy"], res["final_params"], args.eval_episodes, seed + 7, table, "final",
                             args.platform)
        per_seed.append(grade_seed(seed, res, init_ev, final_ev))
        print(json.dumps(per_seed[-1], indent=2, default=str), flush=True)

    ok = grade_ok(per_seed, args.updates)
    wall_min = (time.time() - t_start) / 60.0
    lines = [
        "# 5v5 league self-play, GRADED (BASELINE configs 4-5)",
        "",
        f"- result: **{'PASS' if ok else 'FAIL'}** (bar below, every seed)",
        f"- training per seed: config 5 end-to-end — league-mode SelfPlayActors "
        f"(team_size 5, PFSP 'hard'), aux value heads, ppo reuse "
        f"{per_seed[0]['train']['ppo']}, {args.updates} updates",
        "- yardstick: FIXED team of 5 scripted-HARD bots (control_mode=2); "
        "5v5 outcome = team wipe or team net worth at time-up "
        "(env/fake_dotaservice.py _check_end)",
        f"- bar (each seed): (1) final mean team eval return > init's, paired "
        f"eval seeds, {args.eval_episodes} episodes per policy; (2) final team's "
        f"summed conservative TrueSkill > init's, scored per episode via "
        f"record_teams vs the 5 ANCHORED bot ratings (two-team partial-play "
        f"closed form, eval/rating.py:rate_teams)",
        "",
    ]
    for s in per_seed:
        lines += [
            f"## seed {s['seed']}",
            f"- league liveness: {s['train']['episodes']} self-play episodes, "
            f"pools {s['train']['league_sizes']}, aux keys {s['train']['aux_keys']}, "
            f"{s['train']['env_steps']} env steps",
            f"- mean team return: init {s['init']['mean_return']:+.3f} -> "
            f"final {s['final']['mean_return']:+.3f} "
            f"({s['final']['mean_return'] - s['init']['mean_return']:+.3f}) "
            f"[{'PASS' if s['return_bar'] else 'FAIL'}]",
            f"- episodes W/L/D vs hard bots: init {s['init']['wins']}/"
            f"{s['init']['losses']}/{s['init']['draws']}, final {s['final']['wins']}/"
            f"{s['final']['losses']}/{s['final']['draws']}",
            f"- mean team net-worth margin at episode end (the time-up decider): "
            f"init {s['init']['mean_net_worth_gap']:+.0f} -> "
            f"final {s['final']['mean_net_worth_gap']:+.0f}",
            f"- team TrueSkill (sum of conservative, bots anchored at default): "
            f"init {s['init_team_conservative']:+.2f} -> final "
            f"{s['final_team_conservative']:+.2f} "
            f"[{'PASS' if s['trueskill_bar'] else 'FAIL'}]",
            f"- model P(final team beats init team): {s['p_final_beats_init']:.3f}",
            "",
        ]
    lines += [
        f"- wall-clock: {wall_min:.1f} min ({hardware_line(args.platform)}, both seeds incl. evals)",
        "",
        f"Reproduce: `python -m dotaclient_tpu_torch.scripts.grade_5v5 --updates {args.updates} "
        f"--seeds {' '.join(str(s) for s in args.seeds)}" + (" --platform cpu" if args.platform == "cpu" else "")
        + "`",
    ]
    with open(os.path.join(args.out_dir, "LEAGUE.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(args.out_dir, "grade_5v5.json"), "w") as f:
        json.dump(per_seed, f, indent=2, default=str)
    print("\n".join(lines))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
