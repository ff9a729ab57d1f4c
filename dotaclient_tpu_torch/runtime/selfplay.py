"""Self-play actor (torch twin of dotaclient_tpu/runtime/selfplay.py): all
controlled heroes of one game driven by one process, 1v1 mirror or
league up to 5v5 team play (cfg.team_size).

One asyncio process controls both teams' player ids in a single env
session, so the two sides stay in lockstep without cross-process game
synchronization:

- **mirror** (`opponent="self"`): both sides play the live net and BOTH
  publish experience: every game yields 2n trajectories, and the one
  shared LSTM sees both the radiant and the dire view of the same states.
- **league** (`opponent="league"`): the dire side plays a frozen PFSP
  snapshot from the actor's local league pool (eval/league.py), taken
  from the weight frames the actor receives anyway; only the live
  (radiant) side publishes.
- **remote league** (`--opponent league --serve.endpoint ...
  --serve.league host:port`): the league service's GET /match names the
  opponent and the serve tier's model slot it is resident on; the dire
  heroes step on that slot over the serve wire, the live side steps
  here, and the result is POSTed to /result. Any failure falls back to a
  mirror for the episode.

All the heroes one net plays in a tick go in one step call on one key,
the reference's draw (5v5 mirror: one B=10 call per tick); each row's net
work is its B=1 step, bitwise, whatever B is (make_group_key_step).

Differences from the reference by design: the boot net is drawn from
torch.Generator().manual_seed(seed) (the first weight frame replaces it),
and the env retry catches the port's EnvRpcError, not grpc's AioRpcError.
The keys follow the reference's stream: PRNGKey(seed * 9973 + actor_id)
through ops/threefry.py.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from dotaclient_tpu_torch.config import ACTOR_UNPORTED, ActorConfig, refuse_unported
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.env import heroes
from dotaclient_tpu_torch.env import rewards as R
from dotaclient_tpu_torch.env.service import EnvRpcError
from dotaclient_tpu_torch.eval.league import League, Snapshot
from dotaclient_tpu_torch.models import policy as P
from dotaclient_tpu_torch.ops import threefry
from dotaclient_tpu_torch.ops.batch import as_tensors, tree_map
from dotaclient_tpu_torch.protos import dotaservice as ds
from dotaclient_tpu_torch.protos import worldstate as ws
from dotaclient_tpu_torch.runtime.actor import (
    _cat,
    _check_actor_policy,
    _host_action,
    _to_host,
    actor_device,
    apply_weight_frame,
    build_action,
    check_weight_freshness,
    connect_env_async,
    make_group_key_step,
    net_like,
    next_chunk,
    reset_env_stub,
    rollout_priority_fn,
)
from dotaclient_tpu_torch.transport.base import Broker, BrokerShedError
from dotaclient_tpu_torch.transport.serialize import serialize_rollout, wire_cast_fn

_log = logging.getLogger(__name__)

RADIANT_PLAYER, DIRE_PLAYER = 0, 5
TEAM_RADIANT, TEAM_DIRE = 2, 3


class _Side:
    """Per-player episode state (view, LSTM carry, chunk, reward memory)."""

    def __init__(self, player_id: int, team_id: int, cfg: ActorConfig, device):
        self.player_id = player_id
        self.team_id = team_id
        self.state, self.chunk = next_chunk(cfg.policy, P.initial_state(cfg.policy, (1,), device))
        self.world: Optional[ws.World] = None
        self.obs: Optional[F.Observation] = None
        self.handles: Optional[np.ndarray] = None
        self.last_hero: Optional[ws.Unit] = None
        self.episode_return = 0.0
        # Remote-opponent session continuity (--serve.resume; the
        # RemoteActor protocol, per opponent side): completed remote
        # steps, the last OBSERVED chunk boundary (durably restorable —
        # the server's write-ahead lands before the reply that vouches
        # for it), the [1, H] boundary carry the resume handshake
        # fingerprints, and the obs replay set since that boundary.
        self.remote_steps = 0
        self.remote_boundary = 0
        self.remote_boundary_carry = None
        self.remote_chunk_obs: list = []


class SelfPlayActor:
    """Drives both sides of a self-play episode through one env session."""

    def __init__(
        self,
        cfg: ActorConfig,
        broker: Broker,
        actor_id: int = 0,
        stub=None,
        device=None,
    ):
        if cfg.opponent not in ("self", "league"):
            raise ValueError(f"SelfPlayActor wants opponent 'self' or 'league', got {cfg.opponent!r}")
        refuse_unported(cfg, table=ACTOR_UNPORTED)
        _check_actor_policy(cfg)
        self.cfg = cfg
        self.broker = broker
        self.actor_id = actor_id
        self._stub = stub
        self.device = actor_device(cfg) if device is None else torch.device(device)
        self.params = P.init_params(cfg.policy, torch.Generator().manual_seed(cfg.seed), self.device)
        self.version = 0
        self.weight_epoch = None
        self.step_fn = make_group_key_step(cfg.policy)
        self.rng = threefry.prng_key(cfg.seed * 9973 + actor_id)
        self.np_rng = np.random.RandomState(cfg.seed * 1000003 + actor_id)
        self.steps_done = 0
        self.episodes_done = 0
        self.rollouts_published = 0
        self.rollouts_shed = 0  # publishes refused at admission, chunk dropped
        self.rollouts_failed = 0  # publishes lost to transport failure
        self.last_win: Optional[float] = None  # radiant (live) perspective
        self.last_heroes: list = []  # live side's pool draws, last episode
        self.last_weight_time = time.monotonic()  # kill-switch clock
        # Same cast-at-source wire quantization as Actor (identity under
        # the default --wire.obs_dtype f32).
        wire_cfg = getattr(cfg, "wire", None)
        self._wire_cast = wire_cast_fn(wire_cfg.obs_dtype if wire_cfg is not None else "f32")
        # Fabric priority stamp, same resolution as Actor (None against
        # classic brokers) — without it, self-play chunks would publish
        # at priority 0 and be the FIRST evicted by every shard's
        # priority shed, silently starving the league of its own data.
        self._priority_fn = rollout_priority_fn(broker)
        # Same opt-in trace stamping as Actor (runtime/actor.py): None
        # when --obs.enabled is off, and frames stay legacy DTR1.
        from dotaclient_tpu_torch.obs import ObsRuntime

        self.obs = ObsRuntime.create(cfg.obs, role=f"selfplay{actor_id}")
        # Remote league mode (--serve.league <host:port> + --serve.endpoint):
        # the standing league service owns the opponent pool — matches come
        # from GET /match, opponent sessions step the serve tier's resident
        # model slots, and results post back to the rating service. The
        # LOCAL League pool is only built when this mode is off (the two
        # pools must never compete for the same episodes).
        serve_cfg = getattr(cfg, "serve", None)
        self._league_endpoint = ""
        if serve_cfg is not None and getattr(serve_cfg, "endpoint", ""):
            self._league_endpoint = str(getattr(serve_cfg, "league", "") or "")
        self._remote_clients: Dict[tuple, object] = {}
        self._opp_remote = None  # this episode's RemotePolicyClient
        self._opp_model = 0
        self._opp_role = "main"
        self.remote_matches = 0
        self.remote_match_errors = 0
        self.remote_results_posted = 0
        self.remote_result_errors = 0
        self.remote_fallbacks = 0  # episodes degraded to mirror mid-flight
        self.remote_resumes = 0  # opponent sessions restored via the store
        self.remote_replay_steps = 0  # FLAG_REPLAY steps issued on resume
        self.league: Optional[League] = None
        if cfg.opponent == "league" and not self._league_endpoint:
            self.league = League(
                capacity=cfg.league_capacity,
                snapshot_every=cfg.league_snapshot_every,
                mode=cfg.pfsp_mode,
                seed=cfg.seed * 31 + actor_id,
            )
        # frozen opponent params for the current episode (league mode)
        self._opp_params = None
        self._opp_name: Optional[str] = None

    # ------------------------------------------------------------- weights

    def maybe_update_weights(self) -> bool:
        frame = self.broker.poll_weights()
        if frame is None:
            return False
        on_applied = None
        if self.league is not None:
            on_applied = lambda named, version: self.league.maybe_snapshot(version, named)
        return apply_weight_frame(
            self, frame, f"selfplay actor {self.actor_id}", on_applied=on_applied
        )

    # ------------------------------------------------------------- episode

    @property
    def stub(self):
        if self._stub is None:
            self._stub = connect_env_async(self.cfg)
        return self._stub

    def _pick_opponent(self) -> None:
        """League: sample a frozen snapshot (falls back to mirror while the
        pool is empty). Remote league: ask the standing service for a match
        (falls back to mirror when the service is unreachable or the pool
        empty). Mirror: live weights both sides."""
        self._opp_params = None
        self._opp_name = None
        self._opp_remote = None
        self._opp_model = 0
        self._opp_role = "main"
        if self._league_endpoint:
            self._pick_remote_opponent()
            return
        if self.league is None:
            return
        snap: Optional[Snapshot] = self.league.sample_opponent()
        if snap is not None:
            self._opp_params = net_like(self.params, snap.named_params)
            self._opp_name = snap.name

    def _pick_remote_opponent(self) -> None:
        """GET /match off the league service → {model, name, serve, role}.
        Any failure (service down, empty pool) degrades to mirror for this
        episode — a league outage must never stall the env session. Plain
        stdlib HTTP (the /topology precedent): matchmaking is a wire
        contract, not a code dependency."""
        import json as _json
        from urllib.request import urlopen

        try:
            with urlopen(
                f"http://{self._league_endpoint}/match", timeout=2.0
            ) as resp:
                match = _json.loads(resp.read().decode("utf-8", "replace"))
        except Exception:
            self.remote_match_errors += 1
            return
        name = match.get("name")
        if not name:
            return  # empty pool: mirror this episode
        self.remote_matches += 1
        self._opp_name = str(name)
        self._opp_model = int(match.get("model", 0))
        self._opp_role = str(match.get("role", "main"))
        endpoint = str(match.get("serve") or self.cfg.serve.endpoint)
        self._opp_remote = self._remote_client(endpoint, self._opp_model)

    def _remote_client(self, endpoint: str, model: int):
        """One connection per (endpoint, model slot), cached for the
        process lifetime: the model id binds at the S_INFO handshake, so
        different opponents on the same server still need distinct
        sockets. Gated import (the chaos/ckpt precedent)."""
        key = (endpoint, model)
        cli = self._remote_clients.get(key)
        if cli is None:
            from dotaclient_tpu_torch.serve.client import RemotePolicyClient
            from dotaclient_tpu_torch.transport.base import RetryPolicy

            cfg = self.cfg
            cli = RemotePolicyClient(
                endpoint,
                cfg.policy,
                wire_obs_dtype=getattr(getattr(cfg, "wire", None), "obs_dtype", "f32"),
                timeout_s=cfg.serve.timeout_s,
                connect_timeout_s=cfg.serve.connect_timeout_s,
                cooldown_s=cfg.serve.cooldown_s,
                retry=RetryPolicy.from_config(cfg.retry),
                route=cfg.serve.route,
                model=model,
            )
            self._remote_clients[key] = cli
        return cli

    async def _remote_opp_step(self, group: list, episode_start: bool) -> bool:
        """One serve-tier step per opponent hero (concurrent, one socket —
        the server gathers them into its per-model tick batch). With
        `--serve.resume` armed, a replica loss mid-episode re-establishes
        each side's session on the reborn server — store-backed boundary
        restore keyed by (client_key, model_id) plus FLAG_REPLAY of the
        partial chunk, the RemoteActor choreography — before this method
        reports failure. Returns False only on unrecoverable remote
        failure (resume disarmed, refused, or window exhausted): the
        episode then degrades to mirror (a zero-carry mirror finish
        beats abandoning the env session)."""
        from dotaclient_tpu_torch.serve.client import RemoteInferenceError, reply_action

        cli = self._opp_remote
        resume_armed = bool(getattr(self.cfg.serve, "resume", False))
        rollout_len = max(1, int(self.cfg.rollout_len))

        async def one(s: _Side) -> None:
            # Boundary cadence mirrors the chunk protocol: the carry
            # rides the reply on chunk-fill steps, and the server's
            # write-ahead makes exactly those boundaries restorable.
            want_carry = resume_armed and (s.remote_steps + 1) % rollout_len == 0
            try:
                res = await cli.step(
                    s.remote_key,
                    s.obs,
                    s.remote_rng,
                    episode_start=episode_start,
                    want_carry=want_carry,
                )
            except RemoteInferenceError as e:
                if not resume_armed:
                    raise
                res = await self._resume_opp_side(
                    cli, s, episode_start, want_carry, e
                )
                self.remote_resumes += 1
            if resume_armed:
                s.remote_steps += 1
                if want_carry and res.carry is not None:
                    c, h = res.carry
                    s.remote_boundary = s.remote_steps
                    s.remote_boundary_carry = (
                        np.ascontiguousarray(c, np.float32)[None],
                        np.ascontiguousarray(h, np.float32)[None],
                    )
                    s.remote_chunk_obs = []
                else:
                    s.remote_chunk_obs.append(s.obs)
            s.remote_rng = res.rng
            action = reply_action(res)
            s._step_record = (action, float(res.logp), float(res.value))
            s._action_h = action

        try:
            await asyncio.gather(*(one(s) for s in group))
            return True
        except (RemoteInferenceError, RuntimeError) as e:
            _log.warning(
                "selfplay actor %d: remote opponent %s lost (%s); finishing "
                "episode as mirror",
                self.actor_id,
                self._opp_name,
                type(e).__name__,
            )
            return False

    async def _resume_opp_side(
        self, cli, s: _Side, episode_start: bool, want_carry: bool, first_err
    ):
        """One opponent side's resume-and-retry (the RemoteActor
        _resume_and_retry choreography, per side): reconnect, S_RESUME
        the boundary carry — the store key composes (client_key,
        model_id) server-side, so sibling slots on the same server never
        cross — replay the buffered partial-chunk obs (outputs
        discarded; the carry update is rng-independent), then re-issue
        the failed step for real. A SessionResumeRefused is
        authoritative (store miss/stale) and propagates — the caller's
        mirror-degrade path takes over; transport failures retry with
        backoff until `--serve.resume_window_s` runs out."""
        from dotaclient_tpu_torch.serve.client import (
            RemoteInferenceError,
            SessionResumeRefused,
        )

        deadline = time.monotonic() + float(self.cfg.serve.resume_window_s)
        backoff = 0.05
        err = first_err
        while True:
            if getattr(cli, "_closed", False):
                raise err  # teardown, not an outage: fail fast
            try:
                if s.remote_boundary > 0:
                    from dotaclient_tpu_torch.serve.handoff import carry_fingerprint

                    fp = carry_fingerprint(
                        s.remote_boundary_carry[0], s.remote_boundary_carry[1]
                    )
                    await cli.resume(s.remote_key, s.remote_boundary, fp)
                for i, o in enumerate(s.remote_chunk_obs):
                    await cli.step(
                        s.remote_key,
                        o,
                        s.remote_rng,
                        episode_start=(s.remote_boundary == 0 and i == 0),
                        replay=True,
                    )
                    self.remote_replay_steps += 1
                res = await cli.step(
                    s.remote_key,
                    s.obs,
                    s.remote_rng,
                    episode_start=episode_start,
                    want_carry=want_carry,
                )
            except SessionResumeRefused:
                raise
            except RemoteInferenceError as e:
                err = e
                now = time.monotonic()
                if now >= deadline:
                    raise err
                await asyncio.sleep(min(backoff, max(0.0, deadline - now)))
                backoff = min(backoff * 2.0, 1.0)
                continue
            _log.info(
                "selfplay actor %d: opponent %s session %d RESUMED at "
                "boundary %d (+%d replayed steps)",
                self.actor_id,
                self._opp_name,
                s.remote_key,
                s.remote_boundary,
                len(s.remote_chunk_obs),
            )
            return res

    def _post_result(self) -> None:
        """POST the finished match to the league rating service. The live
        side is the canonical AGENT name (eval/league.py); failure only
        counts — ratings tolerate a lost game, the env session must not."""
        import json as _json
        from urllib.request import Request, urlopen

        win = self.last_win
        if win is None or self._opp_name is None:
            return
        body = {"winner": "agent", "loser": self._opp_name, "draw": win == 0.0}
        if win < 0:
            body["winner"], body["loser"] = body["loser"], body["winner"]
        try:
            req = Request(
                f"http://{self._league_endpoint}/result",
                data=_json.dumps(body).encode("utf-8"),
                headers={"Content-Type": "application/json"},
                method="POST",
            )
            with urlopen(req, timeout=2.0) as resp:
                resp.read()
            self.remote_results_posted += 1
        except Exception:
            self.remote_result_errors += 1

    def _publish(self, side: _Side, win: float, done: bool) -> None:
        rollout = side.chunk.to_rollout(
            side.obs,
            self.version,
            self.actor_id,
            side.episode_return if done else 0.0,
            win,
            self.cfg.policy.aux_heads,
        )
        if self.obs is not None:
            rollout = self.obs.stamp(rollout, self.actor_id)
        try:
            data = serialize_rollout(self._wire_cast(rollout))
            if self._priority_fn is not None:
                self.broker.publish_experience_prioritized(
                    data, self._priority_fn(rollout)
                )
            else:
                self.broker.publish_experience(data)
            self.rollouts_published += 1
        except BrokerShedError:
            # Admission refusal: drop the chunk and continue the episode.
            # _publish is sync (called mid-tick for whichever side's
            # chunk filled), so the jittered backoff the scripted fleet
            # awaits (runtime/actor.py ShedThrottle) can't be paid here
            # without stalling BOTH sides' env session; the shed itself
            # is already the broker protecting itself, and self-play
            # actors are a tiny minority of the publish load.
            self.rollouts_shed += 1
        except (ConnectionError, OSError) as e:
            _log.warning(
                "selfplay actor %d: publish failed (%s); dropping chunk",
                self.actor_id,
                type(e).__name__,
            )
            # NOT rollouts_shed: a transport failure is no admission
            # refusal, and the conservation ledger's shed cross-check
            # (publish_stats "shed" vs broker refusals) must not see one.
            self.rollouts_failed += 1
        side.state, side.chunk = next_chunk(self.cfg.policy, side.state)

    def _batched_step(self, params, group: list) -> None:
        """ONE step call for a group of sides (B = len(group)): 5v5 mirror
        is one B=10 call per tick on one key, the reference's draw (the
        actor's key advances once per call); each row's net work is its
        B=1 step (make_group_key_step). One device-to-host copy of the
        group's actions, logp and value."""
        obs_b = as_tensors(F.stack([s.obs for s in group]), self.device)
        state_b = _cat([tree_map(lambda x: x.to(self.device), s.state) for s in group])
        state_b, action_b, logp_b, value_b, self.rng = self.step_fn(params, state_b, obs_b, self.rng)
        acts, floats = _to_host(action_b, logp_b, value_b)
        for i, s in enumerate(group):
            s.state = tree_map(lambda x: x[i : i + 1], state_b)
            action = _host_action(acts[i])
            s._step_record = (action, float(floats[i, 0]), float(floats[i, 1]))
            s._action_h = action

    async def run_episode(self) -> float:
        cfg = self.cfg
        self.last_win = None
        self._pick_opponent()
        # also league-mode fallback (empty pool / service unreachable)
        mirror = self._opp_params is None and self._opp_remote is None
        pool = heroes.parse_pool(cfg.hero)
        n = max(1, min(int(getattr(cfg, "team_size", 1)), 5))
        rad_pids = [RADIANT_PLAYER + i for i in range(n)]
        dire_pids = [DIRE_PLAYER + i for i in range(n)]
        config = ds.GameConfig(
            host_timescale=cfg.host_timescale,
            ticks_per_observation=cfg.ticks_per_observation,
            max_dota_time=cfg.max_dota_time,
            seed=self.np_rng.randint(1 << 30),
            hero_picks=[
                ds.HeroPick(
                    team_id=team,
                    hero_name=pool[self.np_rng.randint(len(pool))],
                    control_mode=1,
                )
                for team in (TEAM_RADIANT, TEAM_DIRE)
                for _ in range(n)
            ],
        )
        resp = await self.stub.reset(config)
        # Telemetry: which pool heroes the LIVE side drew this episode
        # (hero-pool runs attribute per-hero returns).
        self.last_heroes = [
            p.hero_name for p in config.hero_picks if p.team_id == TEAM_RADIANT
        ]
        sides: Dict[int, _Side] = {}
        for pid in rad_pids:
            sides[pid] = _Side(pid, TEAM_RADIANT, cfg, self.device)
        for pid in dire_pids:
            sides[pid] = _Side(pid, TEAM_DIRE, cfg, self.device)
        live_team = [sides[p] for p in rad_pids]
        opp_team = [sides[p] for p in dire_pids]
        live = live_team[0]  # reporting anchor (return/win bookkeeping)
        rad_world = resp.world_state
        dire_world = (await self.stub.observe(ds.ObserveRequest(team_id=TEAM_DIRE))).world_state
        for s in sides.values():
            s.world = rad_world if s.team_id == TEAM_RADIANT else dire_world
            s.obs, s.handles = F.featurize_with_handles(s.world, s.player_id)
        if self._opp_remote is not None:
            # Serve-tier sessions for the opponent heroes: client_key is
            # (actor, player) — stable across the fleet — and the model id
            # composes in server-side (compose_store_key), so per-opponent
            # resume state never collides across slots.
            for s in opp_team:
                s.remote_key = self.actor_id * 100 + s.player_id
                s.remote_rng = np.asarray(
                    self.np_rng.randint(0, 1 << 31, size=2), np.uint32
                )

        done = False
        first_tick = True
        while not done:
            if mirror:
                # every controlled hero, both teams, one step call
                self._batched_step(self.params, live_team + opp_team)
            elif self._opp_remote is not None:
                self._batched_step(self.params, live_team)
                ok = await self._remote_opp_step(opp_team, episode_start=first_tick)
                if not ok:
                    # Degrade: the rest of the episode is a mirror for the
                    # opponent team (zero-ish carry restart from whatever
                    # local state the sides hold — a quality dip, not an
                    # abandon). Result will NOT post (_opp_name cleared):
                    # a half-remote game must not move ratings.
                    self.remote_fallbacks += 1
                    self._opp_remote = None
                    self._opp_name = None
                    self._batched_step(self.params, opp_team)
            else:
                # a frozen snapshot, or the live net for the rest of an
                # episode whose remote opponent was lost (the reference
                # steps the lost opponent with no net on the next tick)
                self._batched_step(self.params, live_team)
                opp = self._opp_params if self._opp_params is not None else self.params
                self._batched_step(opp, opp_team)
            first_tick = False

            actions: Dict[int, ds.Action] = {}
            for s in sides.values():
                hero = F.find_hero(s.world, s.player_id)
                if hero is not None:
                    snap = ws.Unit()
                    snap.CopyFrom(hero)
                    s.last_hero = snap
                actions[s.player_id] = build_action(cfg, s._action_h, s.handles, hero, s.player_id)

            # one act() per team, team_id set: a real dotaservice routes
            # orders per team — mixing both teams in one call only happens
            # to work against the fake env (which keys on player_id)
            await self.stub.act(
                ds.Actions(
                    actions=[actions[p] for p in rad_pids],
                    dota_time=live.world.dota_time,
                    team_id=TEAM_RADIANT,
                )
            )
            await self.stub.act(
                ds.Actions(
                    actions=[actions[p] for p in dire_pids],
                    dota_time=live.world.dota_time,
                    team_id=TEAM_DIRE,
                )
            )
            r2 = await self.stub.observe(ds.ObserveRequest(team_id=TEAM_RADIANT))
            if r2.status == ds.Observation.RESOURCE_EXHAUSTED:
                _log.warning("selfplay actor %d: env session lost; abandoning", self.actor_id)
                self.episodes_done += 1
                return live.episode_return
            r3 = await self.stub.observe(ds.ObserveRequest(team_id=TEAM_DIRE))
            done = r2.status == ds.Observation.EPISODE_DONE

            for s in sides.values():
                next_world = (r2 if s.team_id == TEAM_RADIANT else r3).world_state
                next_obs, next_handles = F.featurize_with_handles(next_world, s.player_id)
                rew = R.reward(s.world, next_world, s.player_id, s.last_hero)
                s.episode_return += rew
                action_rec, logp_rec, value_rec = s._step_record
                hero = F.find_hero(s.world, s.player_id)
                s.chunk.obs.append(s.obs)
                s.chunk.actions.append(action_rec)
                s.chunk.logp.append(logp_rec)
                s.chunk.value.append(value_rec)
                s.chunk.rewards.append(rew)
                s.chunk.dones.append(1.0 if done else 0.0)
                if cfg.policy.aux_heads:
                    s.chunk.aux_lh.append(F.norm_last_hits(hero.last_hits) if hero else 0.0)
                    s.chunk.aux_nw.append(F.norm_gold(hero.gold) if hero else 0.0)
                s.world = next_world
                s.obs, s.handles = next_obs, next_handles
                self.steps_done += 1

            if len(live.chunk) >= cfg.rollout_len or done:
                winning = live.world.winning_team
                for s in sides.values():
                    win = 0.0
                    if done and winning:
                        win = 1.0 if winning == s.team_id else -1.0
                    # mirror publishes every hero (2n trajectories/chunk
                    # window); league publishes only the live team's n —
                    # the frozen opponent yields no data
                    publish = s.team_id == TEAM_RADIANT or mirror
                    if publish:
                        self._publish(s, win, done)
                    else:
                        s.state, s.chunk = next_chunk(cfg.policy, s.state)
                    if s is live and done:
                        self.last_win = win
                self.maybe_update_weights()

        if self.league is not None and self._opp_name is not None and self.last_win is not None:
            self.league.record_result(self._opp_name, self.last_win)
        elif self._league_endpoint and self._opp_name is not None:
            self._post_result()
        self.episodes_done += 1
        return live.episode_return

    async def run(self, num_episodes: Optional[int] = None) -> None:
        backoff = 1.0
        while num_episodes is None or self.episodes_done < num_episodes:
            check_weight_freshness(self)  # same kill switch as Actor
            try:
                ret = await self.run_episode()
                backoff = 1.0
            except EnvRpcError as e:
                _log.warning(
                    "selfplay actor %d: env rpc failed (%s); retrying in %.1fs",
                    self.actor_id,
                    e.code(),
                    backoff,
                )
                await reset_env_stub(self)  # drop the dead subchannel
                self.maybe_update_weights()
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2.0, 30.0)
                continue
            _log.info(
                "selfplay actor %d: episode %d return %.2f (version %d, opp %s)",
                self.actor_id,
                self.episodes_done,
                ret,
                self.version,
                self._opp_name or "mirror",
            )
