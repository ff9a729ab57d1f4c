"""The actor (torch twin of dotaclient_tpu/runtime/actor.py): the episode
loop, the vectorized fleet, the key steps they share with the inference
server, and the actor binary.

Per step, the reference's loop: observe → featurize → policy step with
the carried state → act → shaped reward from the world-state delta →
append to the rollout chunk. Every `rollout_len` steps, or at the episode's
end, the chunk ships to the broker with its chunk-start state and the
version it was sampled under (cast to bf16 and trace-stamped as the flags
say, through the publish throttle); fresh weights swap in at chunk
boundaries. The env is a stub: `LocalDotaServiceStub` on an in-process env,
or the gRPC stub the binary dials (the only place `grpc` is imported).

`make_key_actor_step` / `make_batched_key_actor_step` carry the
reference's jax PRNGKey, as its jit step does: `rng, key = split(rng)`,
sample with `key`, return `rng` (ops/threefry.py computes the stream on
the host, bitwise jax's). The actor's key starts at
`PRNGKey(seed * 9973 + actor_id)`, as the reference's does; a remote
client owns its key and the server hands it back advanced.

The batched steps keep the reference's `lax.map` contract: each row runs
as its own B=1 step, in sequence, so a row's state, action, logp and
value are bitwise its single-step result whatever other envs share the
tick (the occupancy invariance partial ticks rely on). A row's inputs are
copied out first, so a row computes from freshly allocated tensors
wherever it sits in the tick. So env slot j of a `VectorActor` publishes,
byte for byte, the frames of a standalone `Actor` with id
`actor_id * M + j`.

`InferenceBatcher` gathers single-row requests from coroutines into
ticks; `apply_weight_frame` holds the weight hot-swap rules subscribers
share.

Boot params are drawn from `torch.Generator().manual_seed(seed)`, as the
port's server draws them, not from jax's init: the first weight frame
replaces them (ROADMAP §C).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from dotaclient_tpu_torch import resolve_device
from dotaclient_tpu_torch.config import ACTOR_UNPORTED, ActorConfig, PolicyConfig, refuse_unported
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.env import heroes
from dotaclient_tpu_torch.env import rewards as R
from dotaclient_tpu_torch.env.service import EnvRpcError, connect_async
from dotaclient_tpu_torch.models import policy as P
from dotaclient_tpu_torch.models.policy import PolicyNet, check_arch
from dotaclient_tpu_torch.ops import action_dist as ad
from dotaclient_tpu_torch.ops import threefry
from dotaclient_tpu_torch.ops.batch import as_tensors, tree_map
from dotaclient_tpu_torch.protos import dotaservice as ds
from dotaclient_tpu_torch.protos import worldstate as ws
from dotaclient_tpu_torch.transport.base import Broker, BrokerShedError, RetryPolicy
from dotaclient_tpu_torch.transport.params import load_named
from dotaclient_tpu_torch.transport.serialize import (
    Rollout,
    RolloutAux,
    deserialize_weights,
    serialize_rollout,
    wire_cast_fn,
)

_log = logging.getLogger(__name__)


# ------------------------------------------------------------ weights


def net_like(template: PolicyNet, named) -> PolicyNet:
    """A new PolicyNet with `template`'s config and device holding the
    (flax name, array) pairs; ValueError when they do not fit."""
    net = PolicyNet(template.cfg, next(template.parameters()).device)
    return load_named(net, named)


def apply_weight_frame(agent, frame: bytes, log_name: str, on_applied=None) -> bool:
    """The weight hot-swap rules (the reference's, for any agent holding
    `params` (a PolicyNet), `version` and `weight_epoch`):

    - a malformed frame, or one that does not fit the net, is logged and
      ignored (a bad broadcast never kills a subscriber);
    - within one learner boot (same boot_epoch) a frame older than the
      agent's version is ignored;
    - a boot_epoch change is a learner restart: resync to its version even
      if lower;
    - the new params go into a new net, so a reader that holds the old
      one keeps it whole. `on_applied(named, version)` runs after a swap,
      and `last_weight_time` (the actor's kill-switch clock) is stamped.
    """
    try:
        named, version, boot_epoch = deserialize_weights(frame)
    except Exception as e:  # truncated frames raise struct.error etc.
        _log.warning("%s: bad weight frame: %s", log_name, e)
        return False
    last_epoch = getattr(agent, "weight_epoch", None)
    if last_epoch is not None and boot_epoch != last_epoch:
        _log.warning("%s: weight boot_epoch %d -> %d — learner restarted, resyncing to v%d",
                     log_name, last_epoch, boot_epoch, version)
    elif version < agent.version:
        _log.warning("%s: ignoring stale weight frame v%d (< v%d, same boot)", log_name, version, agent.version)
        return False
    try:
        agent.params = net_like(agent.params, named)
    except Exception as e:
        _log.warning("%s: weight frame does not fit params (%s); ignoring", log_name, e)
        return False
    agent.version = version
    agent.weight_epoch = boot_epoch
    agent.last_weight_time = time.monotonic()
    if on_applied is not None:
        on_applied(named, version)
    return True


class StaleWeightsError(RuntimeError):
    """The actor's kill switch: no weight frame arrived for longer than
    `max_weight_age_s`. The actor exits non-zero so its supervisor starts
    a fresh one that subscribes again."""


def check_weight_freshness(actor) -> None:
    """The kill-switch check (`actor` carries cfg.max_weight_age_s and
    last_weight_time; 0 disables it)."""
    age = time.monotonic() - actor.last_weight_time
    if 0 < actor.cfg.max_weight_age_s < age:
        raise StaleWeightsError(
            f"actor {actor.actor_id}: no weight update for {age:.0f}s "
            f"(limit {actor.cfg.max_weight_age_s:.0f}s) — exiting for restart"
        )


class ShedThrottle:
    """Publish throttle: honours broker admission control (BrokerShedError)
    and rides out transient broker failures with jittered exponential
    backoff, instead of crashing the actor or hammering the broker.

    A refused or failed chunk is dropped, not queued: by the time the
    broker would take it, it is staler. What matters is that the producer
    slows down. The backoff resets on the first accepted publish. The
    counters feed the broker_shed_* scalars and the producer's ledger
    (attempts = published + shed + failed).

    Backoff is per endpoint against a routing broker (one with
    `route_endpoint`, the fabric): a shed or failure arms a not-before
    stamp for that shard only, paid just before the next publish routed
    there, so one shedding shard never pauses publishes to the others.
    Against a single broker the one ladder pays its backoff at once.
    """

    def __init__(self, retry: Optional[RetryPolicy] = None):
        self.retry = retry if retry is not None else RetryPolicy()
        # endpoint key (None = a single broker) → ladder position /
        # earliest next publish to that endpoint
        self._backoff: dict = {}
        self._not_before: dict = {}
        self.published = 0
        self.shed = 0
        self.failed = 0
        self.throttle_s = 0.0

    def _endpoint_key(self, broker: Broker, data: bytes):
        route = getattr(broker, "route_endpoint", None)
        if route is None:
            return None
        try:
            return route(data)
        except Exception:  # routing must never break publishing
            return None

    async def publish(self, broker: Broker, data: bytes, priority: Optional[float] = None) -> bool:
        """True = accepted; False = shed or failed (chunk dropped, backoff
        paid or armed). A transport failure degrades the actor, never
        kills it. `priority` (the |TD-error| stamp) is forwarded when the
        broker wants it."""
        key = self._endpoint_key(broker, data)
        pending = self._not_before.get(key, 0.0) - time.monotonic()
        if pending > 0:
            self.throttle_s += pending
            await asyncio.sleep(pending)
        try:
            if priority is not None and getattr(broker, "wants_priority", False):
                broker.publish_experience_prioritized(data, priority)
            else:
                broker.publish_experience(data)
        except BrokerShedError as e:
            self.shed += 1
            await self._pay_backoff(getattr(e, "endpoint", key))
            return False
        except (ConnectionError, OSError) as e:
            self.failed += 1
            _log.warning("publish failed (%s: %s); dropping chunk and backing off", type(e).__name__, e)
            await self._pay_backoff(key)
            return False
        self.published += 1
        self._backoff.pop(key, None)
        self._not_before.pop(key, None)
        return True

    async def _pay_backoff(self, key) -> None:
        backoff = self._backoff.get(key, self.retry.backoff_base_s)
        delay = self.retry.sleep_for(backoff)
        self._backoff[key] = self.retry.next_backoff(backoff)
        if key is None:
            self.throttle_s += delay
            await asyncio.sleep(delay)
        else:
            self._not_before[key] = time.monotonic() + delay

    def stats(self) -> dict:
        return {
            "broker_shed_observed_total": float(self.shed),
            "broker_shed_publish_failed_total": float(self.failed),
            "broker_shed_throttle_s": self.throttle_s,
        }


# Discount of the publish-time |TD-error| priority: a ranking key for the
# fabric shards' priority shed, not a loss term.
_PRIORITY_GAMMA = 0.98


def rollout_priority_fn(broker: Broker):
    """The publish-time priority stamp, resolved once at boot: None against
    a broker that does not want one; against the fabric
    (`wants_priority`), the |TD-error| priority of the chunk just built."""
    if not getattr(broker, "wants_priority", False):
        return None
    from dotaclient_tpu_torch.replay import td_error_priority

    def fn(rollout: Rollout) -> float:
        return float(td_error_priority(rollout.rewards, rollout.behavior_value, rollout.dones, _PRIORITY_GAMMA))

    return fn


def connect_env_async(cfg: ActorConfig):
    """The network env stub for cfg.env_addr (gRPC; raises, naming grpc,
    when it is not installed). The valve dialect never gets here: the
    actor refuses it at boot (A.11d)."""
    return connect_async(cfg.env_addr)


async def reset_env_stub(actor) -> None:
    """Drop the env channel after an RPC failure, so the next episode
    dials afresh (a kept channel reuses its dead subchannel, whose own
    reconnect backoff grows far past the actor's retry cadence)."""
    stub = actor._stub
    actor._stub = None
    if stub is not None:
        try:
            await stub.channel.close()
        except Exception:  # a half-dead aio channel may throw on close
            pass


def _check_actor_policy(cfg: ActorConfig) -> None:
    """A transformer's KV cache must hold a whole chunk: it is reset every
    chunk, and a wrap mid-chunk would slide the acting context while the
    learner re-evaluates with the full chunk."""
    if cfg.policy.arch == "transformer" and cfg.policy.tf_context < cfg.rollout_len:
        raise ValueError(
            f"tf_context={cfg.policy.tf_context} < rollout_len={cfg.rollout_len}: "
            f"the KV cache would wrap mid-chunk and acting context would no "
            f"longer match the learner's chunk-local re-eval"
        )


def actor_device(cfg: ActorConfig) -> torch.device:
    """The device of the actor's policy step: the host for platform "cpu",
    else the CUDA device (raises when there is none)."""
    return torch.device("cpu") if cfg.platform == "cpu" else resolve_device(None)


# ----------------------------------------------------------------- key steps


def _cat(trees):
    """Row trees (tuples / NamedTuples of [1, ...] tensors) concatenated
    leaf by leaf into one tree of the first's type."""
    leaves = [torch.cat(x) for x in zip(*trees)]
    return type(trees[0])(*leaves) if hasattr(trees[0], "_fields") else tuple(leaves)


def _stack_rows(rows):
    states, actions, logps, values = zip(*rows)
    return _cat(states), _cat(actions), torch.cat(logps), torch.cat(values)


def _to_host(action, logp, value):
    """One device-to-host copy each: action heads int32 [M, 4] (type,
    move_x, move_y, target) and (logp, value) f32 [M, 2]."""
    acts = torch.stack(tuple(action), 1).to(torch.int32).cpu().numpy()
    floats = torch.stack([logp, value], 1).cpu().numpy()
    return acts, floats


def _row(tree, i: int):
    return tree_map(lambda x: x[i : i + 1].clone(), tree)


def key_row_inputs(cfg: PolicyConfig, keys):
    """Host half of the key step for M rows: each row's `rng, key =
    split(rng)` and the uniforms `sample(key, dist)` draws for a [1]-row
    dist. keys u32 [M, 2] → (keys' u32 [M, 2], uniforms f32 [M, 1, K])."""
    s = threefry.split(keys, 2)
    sizes = (F.N_ACTION_TYPES, cfg.n_move_bins, cfg.n_move_bins, F.MAX_UNITS)
    return s[:, 0], ad.key_uniforms(s[:, 1], (1,), sizes)


def _key_step_row(net, state, obs, u):
    with torch.no_grad():
        new_state, out = net(state, obs)
        action = ad.sample_uniform(out.dist, u)
        logp = ad.log_prob(out.dist, action)
    return new_state, action, logp, out.value


def make_batched_key_actor_step(cfg: PolicyConfig):
    """M-row tick on jax keys: `step(net, state, obs, keys)` with stacked
    per-env (state, obs) rows on the net's device (the state an LSTM (c, h)
    or a transformer KVCache, every leaf batch-leading) and keys u32 [M, 2] →
    (state', action, logp, value) stacked, and keys' u32 [M, 2]. Row i is
    `make_key_actor_step`'s result on row i's inputs, bit for bit: the
    integer stream is hashed per key, and the row's device work sees only
    freshly copied [1, ...] tensors."""
    check_arch(cfg)

    def step(net, state, obs, keys):
        keys = np.asarray(keys, np.uint32).reshape(-1, 2)
        M = obs.unit_feats.shape[0]
        if len(keys) != M:
            raise ValueError(f"batched key step: {M} rows but {len(keys)} keys")
        keys2, u = key_row_inputs(cfg, keys)
        u = torch.from_numpy(u).to(obs.unit_feats.device)  # one copy for the tick
        rows = [_key_step_row(net, *_row((state, obs), i), u[i].clone()) for i in range(M)]
        return (*_stack_rows(rows), keys2)

    return step


def make_group_key_step(cfg: PolicyConfig):
    """The reference's B-row actor step on ONE key, as self-play steps all
    the heroes one net plays in a tick: `rng, key = split(rng)` and
    `sample(key, dist)` over the [B]-row dist, so the uniforms are the
    reference's for that B. The net work runs row by row, each row its own
    B=1 step on freshly copied inputs (as in make_batched_key_actor_step),
    so a row is bitwise the B=1 step on its inputs and uniforms whatever B
    is. `step(net, state, obs, key)` with B stacked rows and key u32[2] →
    (state', action, logp, value) stacked, key'. At B=1 it is
    make_key_actor_step."""
    check_arch(cfg)
    sizes = (F.N_ACTION_TYPES, cfg.n_move_bins, cfg.n_move_bins, F.MAX_UNITS)

    def step(net, state, obs, key):
        B = obs.unit_feats.shape[0]
        s = threefry.split(np.asarray(key, np.uint32), 2)
        u = torch.from_numpy(ad.key_uniforms(s[1], (B,), sizes)).to(obs.unit_feats.device)
        rows = [_key_step_row(net, *_row((state, obs), i), u[i : i + 1].clone()) for i in range(B)]
        return (*_stack_rows(rows), s[0])

    return step


def make_key_actor_step(cfg: PolicyConfig):
    """Single-env step on a jax key, the reference's `make_actor_step`:
    `step(net, state, obs, key)` with obs leaves [1, ...] and key u32[2]
    → (state', action, logp, value, key'), where key' = split(key)[0] and
    the action is sampled with split(key)[1]."""
    batched = make_batched_key_actor_step(cfg)

    def step(net, state, obs, key):
        new_state, action, logp, value, keys2 = batched(net, state, obs, np.asarray(key, np.uint32)[None])
        return new_state, action, logp, value, keys2[0]

    return step


# ---------------------------------------------------------------- batcher


class InferenceBatcher:
    """Batched inference for many single-row requests on one asyncio loop.

    Coroutines submit one (state, obs, key) request each via `step()`;
    the `run()` coroutine gathers them into a tick, firing as soon as
    `capacity` requests are pending and no later than `window_s` after
    the tick's first request, so a slow requester stalls only itself.
    `bundle_fn()` returns the (net, version) to serve with; it is read once
    per tick, so no tick mixes two versions, and every tick gets the next
    tick number.

    `state` is the policy state of one row, batch-leading on the net's
    device (an LSTM (c, h) pair of [1, H], or a KVCache), `obs` an
    unbatched host Observation with f32 float leaves, `key` the
    jax PRNGKey u32[2]. A row resolves to ((state', action, logp, value,
    key'), version, tick): state' on the device, the rest on the host
    (action as int32 [4]: type, move_x, move_y, target), all from one
    device-to-host copy per tick. Rows are bitwise the standalone
    `make_key_actor_step`.

    Partial ticks are not padded. The reference pads to capacity to keep
    one jit signature; here a pad row would cost a full B=1 step (a tick
    runs its rows one by one) and change no result.

    Meters (`stats()`: offered rate, occupancy, gather wait, tick time and
    the `actor_tick_rows_<k>` histogram) are written by `run()`;
    `stats()` takes single reads and may run on another thread.
    """

    # stop() pushes this so a run() blocked on get() wakes even when a
    # task cancel is lost.
    _SENTINEL = object()

    def __init__(self, cfg: PolicyConfig, bundle_fn, capacity: int, window_s: float):
        if capacity < 1:
            raise ValueError(f"InferenceBatcher capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.window_s = window_s
        self._bundle_fn = bundle_fn
        self._step = make_batched_key_actor_step(cfg)
        self._tick_seq = 0
        self._queue: "asyncio.Queue" = asyncio.Queue()
        self._stopped = False
        self._ticks = 0
        self._rows = 0
        self._tick_rows = [0] * (capacity + 1)  # index k: ticks that carried k rows
        self._gather_wait_s = 0.0
        self._jit_s = 0.0
        self._first_tick_t: Optional[float] = None
        self._last_tick_t: Optional[float] = None

    async def step(self, state, obs: F.Observation, key):
        """Submit one row → ((state', action, logp, value, key'), version, tick)."""
        if self._stopped:
            raise RuntimeError("InferenceBatcher is stopped")
        fut = asyncio.get_running_loop().create_future()
        self._queue.put_nowait((state, obs, key, fut))
        return await fut

    def stop(self) -> None:
        """Flag run() down and wake it if it waits on the queue."""
        self._stopped = True
        self._queue.put_nowait(self._SENTINEL)

    async def run(self) -> None:
        """The tick loop: gather → one tick → scatter. In-flight futures are
        failed when it stops, so no requester waits forever."""
        reqs: list = []
        try:
            while not self._stopped:
                first = await self._queue.get()
                if first is self._SENTINEL:
                    break
                reqs = [first]
                t0 = time.monotonic()
                deadline = t0 + self.window_s
                while len(reqs) < self.capacity:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        item = await asyncio.wait_for(self._queue.get(), remaining)
                    except asyncio.TimeoutError:
                        break
                    if item is self._SENTINEL:
                        self._stopped = True
                        break
                    reqs.append(item)
                if self._stopped:
                    break
                self._run_tick(reqs, gather_wait=time.monotonic() - t0)
                reqs = []
                # A tick holds the loop for its whole run. Yield once before
                # gathering the next, so the requesters it served resume
                # (their replies go out) and new requests are read; with
                # requests still queued, get() would otherwise not yield and
                # every reply would wait until the queue ran dry.
                await asyncio.sleep(0)
        finally:
            exc = RuntimeError("InferenceBatcher stopped")
            for *_, fut in reqs:
                if not fut.done():
                    fut.set_exception(exc)
            self._fail_pending(exc)

    def _run_tick(self, reqs, gather_wait: float) -> None:
        K = len(reqs)
        state = _cat([r[0] for r in reqs])
        net, version = self._bundle_fn()  # one tuple read
        obs = as_tensors(F.stack([r[1] for r in reqs]), next(net.parameters()).device)
        keys = np.stack([np.asarray(r[2], np.uint32) for r in reqs])
        self._tick_seq += 1
        t1 = time.monotonic()
        new_state, action, logp, value, keys2 = self._step(net, state, obs, keys)
        acts, floats = _to_host(action, logp, value)
        t2 = time.monotonic()
        out = [(tree_map(lambda x: x[i : i + 1], new_state), acts[i], floats[i, 0], floats[i, 1], keys2[i])
               for i in range(K)]
        for i, (*_, fut) in enumerate(reqs):
            if not fut.cancelled():
                fut.set_result((out[i], version, self._tick_seq))
        self._ticks += 1
        self._rows += K
        self._tick_rows[K] += 1
        self._gather_wait_s += gather_wait
        self._jit_s += t2 - t1
        if self._first_tick_t is None:
            self._first_tick_t = t1
        self._last_tick_t = t2

    def reset_meters(self) -> None:
        """Zero the meters (exclude warm-up ticks from a measured window)."""
        self._ticks = 0
        self._rows = 0
        self._tick_rows = [0] * (self.capacity + 1)
        self._gather_wait_s = 0.0
        self._jit_s = 0.0
        self._first_tick_t = None
        self._last_tick_t = None

    def _fail_pending(self, exc: BaseException) -> None:
        while not self._queue.empty():
            item = self._queue.get_nowait()
            if item is self._SENTINEL:
                continue
            fut = item[3]
            if not fut.done():
                fut.set_exception(exc)

    def stats(self) -> dict:
        """The reference's actor_* scalars: offered rate, mean occupancy,
        mean gather wait, mean tick time (`actor_jit_step_s`, the step plus
        its device-to-host copy), and the occupancy histogram."""
        ticks, rows = self._ticks, self._rows
        first, last = self._first_tick_t, self._last_tick_t
        elapsed = (last - first) if (first is not None and last is not None and last > first) else 0.0
        out = {
            "actor_offered_steps_per_sec": rows / elapsed if elapsed > 0 else 0.0,
            "actor_batch_occupancy": rows / float(max(ticks, 1) * self.capacity),
            "actor_gather_wait_s": self._gather_wait_s / max(ticks, 1),
            "actor_jit_step_s": self._jit_s / max(ticks, 1),
        }
        for k, n in enumerate(list(self._tick_rows)):
            if k:
                out[f"actor_tick_rows_{k}"] = float(n)
        return out


# -------------------------------------------------------------- the actor


def build_action(
    cfg: ActorConfig,
    action: ad.Action,
    handles: np.ndarray,
    hero: Optional[ws.Unit],
    player_id: int,
    batch_index: int = 0,
) -> ds.Action:
    """One batch row of sampled head indices (host ints) as an Action."""
    a = ds.Action(player_id=player_id)
    i = batch_index
    atype = int(action.type[i])
    if atype == F.ACT_MOVE and hero is not None:
        n = cfg.policy.n_move_bins
        grid = (np.arange(n) - n // 2) / max(n // 2, 1)
        a.type = ds.Action.MOVE
        a.move_x = hero.x + float(grid[int(action.move_x[i])]) * cfg.policy.move_step
        a.move_y = hero.y + float(grid[int(action.move_y[i])]) * cfg.policy.move_step
    elif atype == F.ACT_ATTACK:
        a.type = ds.Action.ATTACK
        a.target_handle = int(handles[int(action.target[i])])
    elif atype == F.ACT_CAST:
        a.type = ds.Action.CAST
        a.ability_slot = 0
        a.target_handle = int(handles[int(action.target[i])])
    else:
        a.type = ds.Action.NOOP
    return a


def build_actions_proto(
    cfg: ActorConfig,
    action: ad.Action,
    handles: np.ndarray,
    hero: Optional[ws.Unit],
    team_id: int,
    player_id: int,
    dota_time: float,
) -> ds.Actions:
    """Sampled head indices as the Actions message of one step."""
    a = build_action(cfg, action, handles, hero, player_id)
    return ds.Actions(actions=[a], team_id=team_id, dota_time=dota_time)


def next_chunk(policy_cfg: PolicyConfig, state):
    """Chunk boundary: (state', a fresh chunk). The LSTM carries its state
    across chunks (shipped as the learner's initial carry); the
    transformer family starts an empty KV cache."""
    state = P.reset_between_chunks(policy_cfg, state)
    return state, _Chunk(P.wire_state(policy_cfg, state))


class _Chunk:
    """One rollout chunk between publishes; takes the wire-format (c, h)
    [1, H] pair (models.policy.wire_state)."""

    def __init__(self, initial_state: Tuple[torch.Tensor, torch.Tensor]):
        self.initial_state = tuple(np.asarray(x[0].detach().cpu().numpy(), np.float32) for x in initial_state)
        self.obs: List[F.Observation] = []
        self.actions: List[ad.Action] = []
        self.logp: List[float] = []
        self.value: List[float] = []
        self.rewards: List[float] = []
        self.dones: List[float] = []
        self.aux_lh: List[float] = []
        self.aux_nw: List[float] = []

    def __len__(self) -> int:
        return len(self.actions)

    def to_rollout(
        self,
        bootstrap_obs: F.Observation,
        version: int,
        actor_id: int,
        episode_return: float,
        win: float,
        with_aux: bool,
    ) -> Rollout:
        L = len(self)
        obs = F.stack(self.obs + [bootstrap_obs])
        acts = ad.Action(*(np.asarray([int(getattr(a, f)[0]) for a in self.actions], np.int32) for f in ad.Action._fields))
        aux = None
        if with_aux:
            aux = RolloutAux(
                win=np.full(L, win, np.float32),
                last_hit=np.asarray(self.aux_lh, np.float32),
                net_worth=np.asarray(self.aux_nw, np.float32),
            )
        return Rollout(
            obs=obs,
            actions=acts,
            behavior_logp=np.asarray(self.logp, np.float32),
            behavior_value=np.asarray(self.value, np.float32),
            rewards=np.asarray(self.rewards, np.float32),
            dones=np.asarray(self.dones, np.float32),
            initial_state=self.initial_state,
            version=version,
            actor_id=actor_id,
            episode_return=episode_return,
            aux=aux,
        )


def _host_action(acts: np.ndarray) -> ad.Action:
    """An int32 [4] row (type, move_x, move_y, target) as an Action of [1]
    arrays, the chunk's format."""
    return ad.Action(*(acts[k : k + 1] for k in range(4)))


class Actor:
    """One env session, player 0 on team radiant (2), against the env's
    scripted opponent.

    `stub` is the env: a `LocalDotaServiceStub` on an in-process env, or
    None to dial cfg.env_addr over gRPC on first use (inside the event
    loop). `params` lets a VectorActor share its one net with its env
    slots; otherwise the net is drawn from cfg.seed on `device` (default:
    cfg.platform's). `params=()` builds no net: a subclass that steps
    elsewhere (the remote client) keeps its episode state on the host."""

    # Episode failures run() retries with backoff instead of dying: env
    # RPC outages. A class attribute, so a subclass can extend it.
    _RETRYABLE_EPISODE_ERRORS: tuple = (EnvRpcError,)

    def __init__(self, cfg: ActorConfig, broker: Broker, actor_id: int = 0, stub=None, params=None, device=None):
        refuse_unported(cfg, table=ACTOR_UNPORTED)
        _check_actor_policy(cfg)
        self.cfg = cfg
        self.broker = broker
        self.actor_id = actor_id
        self._stub = stub
        if params is None:
            dev = actor_device(cfg) if device is None else torch.device(device)
            params = P.init_params(cfg.policy, torch.Generator().manual_seed(cfg.seed), dev)
        self.params = params
        self.device = next(params.parameters()).device if isinstance(params, torch.nn.Module) else torch.device("cpu")
        self.version = 0
        self.step_fn = make_key_actor_step(cfg.policy)
        self.rng = threefry.prng_key(cfg.seed * 9973 + actor_id)
        # all host-side randomness (per-episode env seeds) flows from here,
        # so one --seed/--actor_id replays one episode sequence
        self.np_rng = np.random.RandomState(cfg.seed * 1000003 + actor_id)
        self.player_id = 0
        self.team_id = 2
        self.steps_done = 0
        self.episodes_done = 0
        self.rollouts_published = 0
        self.publish_throttle = ShedThrottle(RetryPolicy.from_config(cfg.retry))
        self._wire_cast = wire_cast_fn(cfg.wire.obs_dtype)  # a bad value fails here, at boot
        self._priority_fn = rollout_priority_fn(broker)
        self.obs = self._make_obs_runtime()
        # ±1 result of the last finished episode, 0.0 for a draw, None while
        # one is in flight or after an abandoned one
        self.last_win: Optional[float] = None
        # the kill-switch clock: boot counts as fresh
        self.last_weight_time = time.monotonic()

    @property
    def rollouts_shed(self) -> int:
        """Chunks refused by broker admission control."""
        return self.publish_throttle.shed

    @property
    def rollouts_failed(self) -> int:
        """Chunks dropped on a transport failure."""
        return self.publish_throttle.failed

    def _make_obs_runtime(self):
        """With --obs.enabled, a runtime that trace-stamps each published
        chunk; None otherwise (untraced frames, no extra work). A vector
        fleet's env slots share their owner's."""
        from dotaclient_tpu_torch.obs import ObsRuntime

        return ObsRuntime.create(self.cfg.obs, role=f"actor{self.actor_id}")

    # ------------------------------------------------------------- weights

    def maybe_update_weights(self) -> bool:
        frame = self.broker.poll_weights()
        if frame is None:
            return False
        return apply_weight_frame(self, frame, f"actor {self.actor_id}")

    def check_weight_freshness(self) -> None:
        check_weight_freshness(self)

    # ------------------------------------------------------------- episode

    @property
    def stub(self):
        if self._stub is None:
            self._stub = connect_env_async(self.cfg)
        return self._stub

    def _featurize(self, world):
        """The one featurization point: world → (Observation, handles),
        with the disable_cast ablation applied."""
        obs, handles = F.featurize_with_handles(world, self.player_id)
        if self.cfg.disable_cast:
            obs.action_mask[F.ACT_CAST] = False
        return obs, handles

    async def _policy_step(self, state, obs: F.Observation, chunk_len: int = 0, episode_start: bool = False):
        """One policy step on the current obs → (state', action, logp,
        value), the action as host [1] arrays, logp and value as host
        floats; advances the actor's key. A vector fleet's env slots route
        it through the shared batcher instead, a remote actor over the
        wire. `chunk_len` (steps already in the chunk) and `episode_start`
        say where the loop is: the local paths ignore them, the remote one
        drives the server-resident carry with them."""
        obs_b = as_tensors(F.stack([obs]), self.device)
        state, action, logp, value, self.rng = self.step_fn(self.params, state, obs_b, self.rng)
        acts, floats = _to_host(action, logp, value)
        return state, _host_action(acts[0]), floats[0, 0], floats[0, 1]

    async def run_episode(self) -> float:
        cfg = self.cfg
        self.last_win = None
        pool = heroes.parse_pool(cfg.hero)
        config = ds.GameConfig(
            host_timescale=cfg.host_timescale,
            ticks_per_observation=cfg.ticks_per_observation,
            max_dota_time=cfg.max_dota_time,
            seed=self.np_rng.randint(1 << 30),
            hero_picks=[
                ds.HeroPick(team_id=2, hero_name=pool[self.np_rng.randint(len(pool))], control_mode=1),
                ds.HeroPick(
                    team_id=3,
                    hero_name=pool[self.np_rng.randint(len(pool))],
                    # 0 = passive scripted, 2 = hard scripted
                    control_mode={"scripted": 0, "scripted_hard": 2}.get(cfg.opponent, 1),
                ),
            ],
        )
        resp = await self.stub.reset(config)
        world = resp.world_state
        state, chunk = next_chunk(cfg.policy, P.initial_state(cfg.policy, (1,), self.device))
        last_hero: Optional[ws.Unit] = None
        episode_return = 0.0
        done = False
        obs, handles = self._featurize(world)  # each world is featurized once

        episode_start = True
        while not done:
            state, action, logp, value = await self._policy_step(state, obs, chunk_len=len(chunk),
                                                                 episode_start=episode_start)
            episode_start = False
            hero = F.find_hero(world, self.player_id)
            if hero is not None:
                snap = ws.Unit()
                snap.CopyFrom(hero)
                last_hero = snap
            await self.stub.act(
                build_actions_proto(cfg, action, handles, hero, self.team_id, self.player_id, world.dota_time)
            )
            resp = await self.stub.observe(ds.ObserveRequest(team_id=self.team_id))
            if resp.status == ds.Observation.RESOURCE_EXHAUSTED:
                # session lost (env restart or eviction): abandon the episode
                # and its partial chunk
                _log.warning("actor %d: env session lost; abandoning episode", self.actor_id)
                self.episodes_done += 1
                return episode_return
            next_world = resp.world_state
            next_obs, next_handles = self._featurize(next_world)
            done = resp.status == ds.Observation.EPISODE_DONE
            r = R.reward(world, next_world, self.player_id, last_hero)
            episode_return += r

            chunk.obs.append(obs)
            chunk.actions.append(action)
            chunk.logp.append(float(logp))
            chunk.value.append(float(value))
            chunk.rewards.append(r)
            chunk.dones.append(1.0 if done else 0.0)
            if cfg.policy.aux_heads:
                chunk.aux_lh.append(F.norm_last_hits(hero.last_hits) if hero else 0.0)
                chunk.aux_nw.append(F.norm_gold(hero.gold) if hero else 0.0)
            self.steps_done += 1

            if len(chunk) >= cfg.rollout_len or done:
                win = 0.0
                if done and next_world.winning_team:
                    win = 1.0 if next_world.winning_team == self.team_id else -1.0
                if done:
                    self.last_win = win
                rollout = chunk.to_rollout(next_obs, self.version, self.actor_id, episode_return if done else 0.0,
                                           win, cfg.policy.aux_heads)
                if self.obs is not None:
                    rollout = self.obs.stamp(rollout, self.actor_id)
                priority = self._priority_fn(rollout) if self._priority_fn is not None else None
                if await self.publish_throttle.publish(self.broker, serialize_rollout(self._wire_cast(rollout)),
                                                       priority=priority):
                    self.rollouts_published += 1
                state, chunk = next_chunk(cfg.policy, state)
                self.maybe_update_weights()

            world = next_world
            obs, handles = next_obs, next_handles

        self.episodes_done += 1
        return episode_return

    async def run(self, num_episodes: Optional[int] = None) -> None:
        """The episode loop. An env RPC failure abandons the episode and
        retries with capped backoff (1 s doubling to 30 s): actors outlive
        env instances."""
        backoff = 1.0
        while num_episodes is None or self.episodes_done < num_episodes:
            self.check_weight_freshness()
            try:
                ret = await self.run_episode()
                backoff = 1.0
            except self._RETRYABLE_EPISODE_ERRORS as e:
                _log.warning("actor %d: episode failed (%s: %s); retrying in %.1fs", self.actor_id,
                             type(e).__name__, e.code() if isinstance(e, EnvRpcError) else e, backoff)
                await reset_env_stub(self)
                self.maybe_update_weights()  # stay fresh while waiting
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2.0, 30.0)
                continue
            _log.info("actor %d: episode %d return %.2f (version %d, %d steps)", self.actor_id, self.episodes_done,
                      ret, self.version, self.steps_done)


class _BatchedEnvActor(Actor):
    """One env slot of a VectorActor: the Actor's episode loop with its
    policy step routed through the owner's batcher, and its weights and
    kill-switch clock the owner's (one broker poll and one net per
    process)."""

    def __init__(self, owner: "VectorActor", actor_id: int, stub=None):
        self.owner = owner  # before super().__init__: _make_obs_runtime reads it
        super().__init__(owner.cfg, owner.broker, actor_id=actor_id, stub=stub, params=owner.params)

    def _make_obs_runtime(self):
        return self.owner.obs

    async def _policy_step(self, state, obs: F.Observation, chunk_len: int = 0, episode_start: bool = False):
        (state, acts, logp, value, self.rng), _, _ = await self.owner.batcher.step(state, obs, self.rng)
        return state, _host_action(acts), logp, value

    def maybe_update_weights(self) -> bool:
        """One poll for the fleet, but each slot takes the owner's version
        stamp only here, at its own chunk boundaries: the shared net swaps
        at once for every slot's next tick, so a slot mid-chunk samples
        its tail under the new net while stamping the version its chunk
        started under (staleness over-estimated, never under)."""
        updated = self.owner.maybe_update_weights()
        self.version = self.owner.version
        return updated

    def check_weight_freshness(self) -> None:
        check_weight_freshness(self.owner)


class VectorActor:
    """M env sessions in one process, their policy steps batched into one
    tick (InferenceBatcher).

    Env slot j runs with actor_id `actor_id * M + j`, so its key, env seeds
    and published frames are those of a standalone Actor with that id.
    `stubs` (M in-process env stubs) replaces dialling cfg.env_addr. Its
    slots refuse unported modes as an Actor does. Drive it with `run()`
    (the binary) or `episode_stream()` (ActorPool)."""

    def __init__(self, cfg: ActorConfig, broker: Broker, actor_id: int = 0, envs: Optional[int] = None,
                 params=None, obs_runtime=None, stubs=None, device=None):
        M = int(envs if envs is not None else cfg.envs_per_process)
        if M < 1:
            raise ValueError(f"envs_per_process must be >= 1, got {M}")
        if stubs is not None and len(stubs) != M:
            raise ValueError(f"{len(stubs)} env stubs for {M} env slots")
        self.cfg = cfg
        self.broker = broker
        self.actor_id = actor_id
        if params is None:
            dev = actor_device(cfg) if device is None else torch.device(device)
            params = P.init_params(cfg.policy, torch.Generator().manual_seed(cfg.seed), dev)
        self.params = params
        self.version = 0
        self.last_weight_time = time.monotonic()
        self.last_win: Optional[float] = None
        if obs_runtime is not None:
            self.obs = obs_runtime
        else:
            from dotaclient_tpu_torch.obs import ObsRuntime

            self.obs = ObsRuntime.create(cfg.obs, role=f"vector{actor_id}")
        self.batcher = InferenceBatcher(cfg.policy, lambda: (self.params, self.version), capacity=M,
                                        window_s=cfg.gather_window_s)
        stubs = stubs if stubs is not None else [None] * M
        self.envs = [_BatchedEnvActor(self, actor_id * M + j, stub=stubs[j]) for j in range(M)]

    @classmethod
    def from_actor(cls, actor: Actor, envs: Optional[int] = None) -> "VectorActor":
        """Wrap a built Actor (ActorPool's envs-per-actor mode): its cfg,
        broker, actor_id, net and obs runtime, M env slots."""
        return cls(actor.cfg, actor.broker, actor_id=actor.actor_id, envs=envs, params=actor.params,
                   obs_runtime=actor.obs)

    @property
    def steps_done(self) -> int:
        return sum(e.steps_done for e in self.envs)

    @property
    def episodes_done(self) -> int:
        return sum(e.episodes_done for e in self.envs)

    @property
    def rollouts_published(self) -> int:
        return sum(e.rollouts_published for e in self.envs)

    @property
    def rollouts_shed(self) -> int:
        return sum(e.publish_throttle.shed for e in self.envs)

    @property
    def rollouts_failed(self) -> int:
        return sum(e.publish_throttle.failed for e in self.envs)

    def stats(self) -> dict:
        """The batcher's actor_* gauges, the fleet's broker_shed_* sums and
        the producer ledger (attempted = published + shed + failed, from
        the same per-slot reads)."""
        out = self.batcher.stats()
        shed = failed = published = 0
        throttle_s = 0.0
        for e in self.envs:
            t = e.publish_throttle
            shed += t.shed
            failed += t.failed
            published += e.rollouts_published
            throttle_s += t.throttle_s
        out["broker_shed_observed_total"] = float(shed)
        out["broker_shed_publish_failed_total"] = float(failed)
        out["broker_shed_throttle_s"] = throttle_s
        out["actor_rollouts_published_total"] = float(published)
        out["actor_publish_attempted_total"] = float(published + shed + failed)
        return out

    def maybe_update_weights(self) -> bool:
        """Apply a pending weight frame to the shared net (the batcher
        serves it to every slot's next tick); slots take the new version
        stamp at their own chunk boundaries."""
        frame = self.broker.poll_weights()
        if frame is None:
            return False
        return apply_weight_frame(self, frame, f"vector actor {self.actor_id}")

    def check_weight_freshness(self) -> None:
        check_weight_freshness(self)

    async def _env_loop(self, env: _BatchedEnvActor, results: "asyncio.Queue") -> None:
        """One slot's worker: Actor.run's retry and backoff, reporting each
        finished episode (or a fatal error) to the stream's queue."""
        backoff = 1.0
        while True:
            try:
                self.check_weight_freshness()
                ret = await env.run_episode()
                backoff = 1.0
            except env._RETRYABLE_EPISODE_ERRORS as e:
                _log.warning("vector env %d: episode failed (%s: %s); retrying in %.1fs", env.actor_id,
                             type(e).__name__, e.code() if isinstance(e, EnvRpcError) else e, backoff)
                await reset_env_stub(env)
                self.maybe_update_weights()
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2.0, 30.0)
                continue
            except asyncio.CancelledError:
                raise
            except Exception as e:  # incl. StaleWeightsError: surfaced by the stream
                await results.put((env, e))
                return
            await results.put((env, float(ret)))

    async def episode_stream(self):
        """Async generator of each finished episode's return (any slot).
        Starts the batcher and the M slot workers on the running loop;
        closing the generator stops them all."""
        results: "asyncio.Queue" = asyncio.Queue()
        driver = asyncio.create_task(self.batcher.run())
        workers = [asyncio.create_task(self._env_loop(e, results)) for e in self.envs]
        try:
            while True:
                env, ret = await results.get()
                if isinstance(ret, BaseException):
                    raise ret
                self.last_win = env.last_win
                yield ret
        finally:
            self.batcher.stop()  # before the cancels: a lost cancel cannot leave the driver looping
            for t in workers:
                t.cancel()
            driver.cancel()
            await asyncio.gather(*workers, driver, return_exceptions=True)

    async def run_episodes(self, per_env: int) -> None:
        """Exactly `per_env` episodes on every slot (run()'s budget counts
        the fleet's total, which can land unevenly); slots that finish
        early drop out, so the tail ticks run partial."""
        driver = asyncio.create_task(self.batcher.run())

        async def worker(env):
            for _ in range(per_env):
                await env.run_episode()

        try:
            await asyncio.gather(*(worker(e) for e in self.envs))
        finally:
            self.batcher.stop()
            driver.cancel()
            await asyncio.gather(driver, return_exceptions=True)

    async def run(self, num_episodes: Optional[int] = None) -> None:
        """Run the fleet; `num_episodes` bounds the total finished episodes
        across slots (None = forever). With --obs.enabled and a
        metrics_port, the actor_* gauges export on /metrics."""
        if self.obs is not None:
            self.obs.serve_metrics([self.stats])
        try:
            done = 0
            async for _ in self.episode_stream():
                done += 1
                if num_episodes is not None and done >= num_episodes:
                    return
        finally:
            if self.obs is not None:
                self.obs.close()


def build_actors(cfg: ActorConfig, broker: Broker, make_stub=None) -> list:
    """What the actor binary runs for `cfg`: a list of agents, each with an
    async `run()`, run together on one loop.

    - --serve.endpoint (and no remote league): a RemoteFleet of
      envs_per_process slots stepping on the inference service;
    - --opponent self|league: one SelfPlayActor per env slot (each
      batches its own heroes; slots play different nets, so they share no
      call); with --serve.league and an endpoint, the opponents step on
      the serve tier's league slots;
    - otherwise the Actor, or a VectorActor of envs_per_process slots.

    `make_stub()` gives each env slot an in-process env instead of a
    gRPC dial of cfg.env_addr."""
    refuse_unported(cfg, table=ACTOR_UNPORTED)
    M = max(int(cfg.envs_per_process), 1)
    stub = make_stub if make_stub is not None else (lambda: None)
    remote_league = cfg.opponent == "league" and bool(cfg.serve.league)
    if cfg.serve.endpoint and not remote_league:
        if cfg.opponent in ("self", "league"):
            raise ValueError(
                "--serve.endpoint does not serve mirror/league sessions "
                "directly: live self-play sides step the training params. "
                "League actors ARE supported through the multi-model serve "
                "tier — run the server with --serve.models N, point this "
                "actor at the league service with --serve.league "
                "<host:port> (opponents then step serve-resident slots "
                "via their matched --serve.model id); plain evaluation "
                "fleets pin one slot with --serve.model <id>"
            )
        from dotaclient_tpu_torch.serve.client import RemoteFleet

        fleet = RemoteFleet(cfg, broker, actor_id=cfg.actor_id, envs=M)
        for env in fleet.envs:
            env._stub = stub()
        return [fleet]
    if cfg.opponent in ("self", "league"):
        from dotaclient_tpu_torch.runtime.selfplay import SelfPlayActor

        ids = [cfg.actor_id] if M == 1 else [cfg.actor_id * M + j for j in range(M)]
        return [SelfPlayActor(cfg, broker, actor_id=i, stub=stub()) for i in ids]
    if M > 1:
        return [VectorActor(cfg, broker, actor_id=cfg.actor_id, stubs=[stub() for _ in range(M)])]
    return [Actor(cfg, broker, actor_id=cfg.actor_id, stub=stub())]


def main(argv=None):
    """`python -m dotaclient_tpu_torch.runtime.actor [--flags]`: the
    reference binary's flags and dispatch (build_actors). Dials the env at
    --env_addr over gRPC (so it needs `grpc`, and says so at boot without
    it) and publishes to --broker_url. Unported modes are refused at boot,
    naming their ROADMAP item."""
    from dotaclient_tpu_torch.config import parse_config
    from dotaclient_tpu_torch.env.service import require_grpc
    from dotaclient_tpu_torch.transport.base import connect as broker_connect

    logging.basicConfig(level=logging.INFO)
    cfg = parse_config(ActorConfig(), argv)
    refuse_unported(cfg, table=ACTOR_UNPORTED)
    require_grpc()
    broker = broker_connect(cfg.broker_url, retry=RetryPolicy.from_config(cfg.retry))
    if cfg.chaos.enabled:
        # a gated import: with chaos off the package never loads and the
        # broker is the production object
        from dotaclient_tpu_torch.chaos import wrap_broker

        broker = wrap_broker(broker, cfg.chaos)
    actors = build_actors(cfg, broker)

    async def run_all():
        await asyncio.gather(*(a.run() for a in actors))

    asyncio.run(run_all())


if __name__ == "__main__":
    main()
