"""Actor-side policy step and inference batcher (torch twin of the
inference half of dotaclient_tpu/runtime/actor.py): policy forward +
masked Gumbel-max sample + joint log-prob in one call, gradients off.

`make_key_actor_step` / `make_batched_key_actor_step` carry the
reference's jax PRNGKey, as its jit step does: `rng, key = split(rng)`,
sample with `key`, return `rng` (ops/threefry.py computes the stream on
the host, bitwise jax's). A client owns its key and the server hands it
back advanced.

The batched steps keep the reference's `lax.map` contract: each row runs
as its own B=1 step, in sequence, so a row's state, action, logp and
value are bitwise its single-step result whatever other envs share the
tick (the occupancy invariance partial ticks rely on). A row's inputs are
copied out first, so a row computes from freshly allocated tensors
wherever it sits in the tick.

`InferenceBatcher` gathers single-row requests from coroutines into
ticks; `apply_weight_frame` holds the weight hot-swap rules subscribers
share.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

import numpy as np
import torch

from dotaclient_tpu_torch.config import PolicyConfig
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.models.policy import PolicyNet, check_arch
from dotaclient_tpu_torch.ops import action_dist as ad
from dotaclient_tpu_torch.ops import threefry
from dotaclient_tpu_torch.ops.batch import as_tensors, tree_map
from dotaclient_tpu_torch.transport.params import load_named
from dotaclient_tpu_torch.transport.serialize import deserialize_weights

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
      one keeps it whole. `on_applied(named, version)` runs after a swap.
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
    if on_applied is not None:
        on_applied(named, version)
    return True


# ----------------------------------------------------------------- key steps


def _cat(trees):
    """Row trees (tuples / NamedTuples of [1, ...] tensors) concatenated
    leaf by leaf into one tree of the first's type."""
    leaves = [torch.cat(x) for x in zip(*trees)]
    return type(trees[0])(*leaves) if hasattr(trees[0], "_fields") else tuple(leaves)


def _stack_rows(rows):
    states, actions, logps, values = zip(*rows)
    return _cat(states), _cat(actions), torch.cat(logps), torch.cat(values)


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

    `state` is a (c, h) pair of [1, H] tensors on the batcher's device,
    `obs` an unbatched host Observation with f32 float leaves, `key` the
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
        state = tuple(torch.cat(s) for s in zip(*(r[0] for r in reqs)))
        obs = as_tensors(F.stack([r[1] for r in reqs]), state[0].device)
        keys = np.stack([np.asarray(r[2], np.uint32) for r in reqs])
        net, version = self._bundle_fn()  # one tuple read
        self._tick_seq += 1
        t1 = time.monotonic()
        (c, h), action, logp, value, keys2 = self._step(net, state, obs, keys)
        acts = torch.stack(tuple(action), 1).to(torch.int32).cpu().numpy()
        floats = torch.stack([logp, value], 1).cpu().numpy()
        t2 = time.monotonic()
        out = [((c[i : i + 1], h[i : i + 1]), acts[i], floats[i, 0], floats[i, 1], keys2[i]) for i in range(K)]
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
