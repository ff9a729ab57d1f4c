"""Inference server: continuous batching, resident LSTM carries, weight
hot-swap (torch twin of dotaclient_tpu/serve/server.py).

`python -m dotaclient_tpu_torch.serve.server --serve.port 13380
 --broker_url tcp://broker:13370 --obs.enabled true --obs.metrics_port 9100`
(`--platform cpu` serves on the host; the default is the CUDA device; a
comma-separated `--broker_url` polls the broker fabric's shards). Once
listening it prints one JSON line,
`{"serving": true, "port": P}`, with the bound port (`--serve.port 0`
picks a free one).

One process owns one param tree and serves policy steps to remote actors
over the serve wire (serve/wire.py), byte for byte the reference's:

- **Continuous batching.** Requests from all connections funnel into an
  `InferenceBatcher` (runtime/actor.py: fire at capacity or
  `--serve.gather_window_s` after the tick's first request) that reads
  the slot's (net, version) once per tick. Every row is bitwise the
  standalone key step (`make_key_actor_step`) on the same inputs,
  whatever else shares the tick; partial ticks are not padded.
- **Resident carries.** Each client's (c, h) stays on the serving device
  between its steps, keyed by (connection, client_key). EPISODE_START
  resets it to zeros, WANT_CARRY returns it, a disconnect evicts the
  connection's carries, a step naming an unknown key is answered
  UNKNOWN_CLIENT, a frame that does not parse BAD_REQUEST with the key
  echoed.
- **Sampling.** The client's jax PRNGKey is advanced and sampled with as
  the reference's jit step does (ops/threefry.py), so the returned key
  and the sampled action are the reference server's.
- **Hot-swap.** The (net, version) of each serve slot is one tuple,
  replaced by one assignment under `_swap_lock`; a tick reads it once,
  so no tick mixes two versions. A swap builds a new net, so a tick in
  flight keeps the old one whole. Swaps come from the broker's weight
  fanout (a poll thread applying the actor's `apply_weight_frame` rules),
  from `swap_params` (a co-located publisher), or `swap_model` for the
  frozen slots of `--serve.models N`.
- **Session continuity** (`--serve.handoff_endpoint`, serve/handoff.py):
  on a WANT_CARRY step the carry is written to the shared store before
  the reply goes out (a kill can lose the reply, never the entry); an
  S_RESUME naming a boundary step and the carry's fingerprint restores
  the stored carry, bit for bit, as the client's resident carry on the
  serving device, and the client replays its buffered steps. A store
  failure is counted and serving goes on; without a store S_RESUME is
  answered UNKNOWN_CLIENT.
- **League sync** (`--serve.league_endpoint`, `--serve.models` > 1): a
  `serve-league-sync` thread polls the league service's GET /assignments
  every `--serve.league_sync_s` and installs each changed slot's GET
  /snapshot (base64 arrays under flax names) with `swap_model`. An outage
  is counted and the slots keep serving.
- **Obs** (`--obs.enabled`): /metrics from `stats()` (serve_*, actor_*,
  handoff and league counters), /healthz and /debug/flight.
- **Chaos** (`--chaos.enabled`, `--chaos.seed`, `--chaos.spec`): the
  weights broker wrapped in a ChaosBroker (chaos/), imported only then.
"""

from __future__ import annotations

import asyncio
import json
import logging
import struct
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dotaclient_tpu_torch import resolve_device
from dotaclient_tpu_torch.config import InferenceConfig, refuse_unported
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.models import policy as P
from dotaclient_tpu_torch.ops.batch import as_tensors
from dotaclient_tpu_torch.runtime.actor import InferenceBatcher, apply_weight_frame, net_like
from dotaclient_tpu_torch.serve import wire as W
from dotaclient_tpu_torch.transport.serialize import bf16_bits, bf16_bits_to_f32, is_bf16

_log = logging.getLogger(__name__)


class _ClientConn:
    """Per-connection state: the resident carries this connection owns, each
    carry's episode position (completed steps: the episode_step its store
    entries carry), the serve slot its S_INFO bound it to, and the lock
    serializing its interleaved replies."""

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.lock = asyncio.Lock()
        self.carries: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.steps: Dict[int, int] = {}
        self.model = 0

    async def send(self, mtype: int, payload: bytes) -> None:
        try:
            async with self.lock:
                self.writer.write(W.frame(mtype, payload))
                await self.writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass  # the client left mid-step; _handle evicts


def serve_device(cfg: InferenceConfig) -> torch.device:
    """The device `--platform` names: "" the CUDA device (raises without
    one), "cpu" the host."""
    if cfg.platform not in ("", "cpu"):
        raise ValueError(f"--platform must be '' (the CUDA device) or 'cpu', got {cfg.platform!r}")
    return resolve_device(cfg.platform or None)


class InferenceServer:
    """Asyncio inference service; `start()` runs it in a daemon thread.
    The param tree starts from `cfg.seed` as the port learner's does, so
    the service answers before the first weight broadcast. `carry_store`
    is any object with the CarryStoreClient API (a LocalCarryStore in
    tests); without one, `--serve.handoff_endpoint` builds the TCP client,
    and with neither the handoff module is not imported."""

    def __init__(self, cfg: InferenceConfig, broker=None, device=None, obs_runtime=None, carry_store=None):
        refuse_unported(cfg)
        if cfg.policy.arch != "lstm":
            raise ValueError(f"inference service requires policy.arch='lstm', got {cfg.policy.arch!r}")
        self.cfg = cfg
        self.device = serve_device(cfg) if device is None else torch.device(device)
        self.host = "0.0.0.0"
        self.port = int(cfg.serve.port)
        self.broker = broker
        # apply_weight_frame reads and writes params/version/weight_epoch on
        # this object
        self.params = P.init_params(cfg.policy, torch.Generator().manual_seed(cfg.seed), self.device)
        self.version = 0
        # The hot-swap cells: one (net, version) tuple per serve slot, read
        # once per tick without a lock; the writers (poll thread, swap_params,
        # swap_model) take _swap_lock so their read-modify-writes never tear.
        self._swap_lock = threading.Lock()
        self.models = max(1, int(cfg.serve.models))
        self._bundles: list = [(self.params, self.version)] + [(self.params, 0)] * (self.models - 1)
        self.batchers = [
            InferenceBatcher(cfg.policy, (lambda m=m: self._bundles[m]), cfg.serve.max_batch,
                             cfg.serve.gather_window_s)
            for m in range(self.models)
        ]
        self.model_requests = [0] * self.models
        self.model_evictions = [0] * self.models
        self.model_swaps = [0] * self.models
        self.league_syncs_total = 0
        self.league_sync_errors_total = 0
        self._synced: Dict[int, Tuple[str, int]] = {}  # slot → installed (name, version)
        self._stop_sync = threading.Event()
        self._sync_thread: Optional[threading.Thread] = None
        # loop-thread-written counters; stats() takes single reads
        self.first_request_t: Optional[float] = None
        self.requests_total = 0
        self.unknown_client_total = 0
        self.bad_requests_total = 0
        self.episode_resets_total = 0
        self.evictions_total = 0
        self.weight_swaps_total = 0
        if carry_store is None and cfg.serve.handoff_endpoint:
            carry_store = _store_client(cfg.serve.handoff_endpoint, cfg.serve.handoff_timeout_s)
        self._store = carry_store
        self.handoff_writes_total = 0
        self.handoff_write_errors_total = 0
        self.resumes_total = 0
        self.resume_misses_total = 0
        self.replayed_steps_total = 0
        self._conns: set = set()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._boot_error: Optional[BaseException] = None
        self._stop_poll = threading.Event()
        self._poke = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        self.obs = obs_runtime

    # ------------------------------------------------------------ weights

    @property
    def _bundle(self) -> Tuple[object, int]:
        """Slot 0's cell: the live tree."""
        return self._bundles[0]

    @property
    def batcher(self) -> InferenceBatcher:
        """Slot 0's batcher."""
        return self.batchers[0]

    def _as_net(self, named_or_net):
        return net_like(self.params, named_or_net) if isinstance(named_or_net, list) else named_or_net

    def swap_params(self, named_or_net, version: int) -> None:
        """Swap the live tree: `named_or_net` is (flax name, array) pairs
        (a DTW2 frame's) or a PolicyNet. The new tuple is built fully, then
        published with one assignment; ticks in flight keep theirs."""
        net = self._as_net(named_or_net)
        with self._swap_lock:
            self.params = net
            self.version = int(version)
            self.weight_swaps_total += 1
            self.model_swaps[0] += 1
            self._bundles[0] = (net, int(version))

    def swap_model(self, model_id: int, named_or_net, version: int) -> None:
        """Install a frozen tree into serve slot `model_id` (slot 0 is the
        live tree and goes through swap_params)."""
        m = int(model_id)
        if m == 0:
            self.swap_params(named_or_net, version)
            return
        if not 0 < m < self.models:
            raise ValueError(f"model id {m} not resident (--serve.models {self.models})")
        net = self._as_net(named_or_net)
        with self._swap_lock:
            self.model_swaps[m] += 1
            self._bundles[m] = (net, int(version))

    def poke(self) -> None:
        """Wake the weight-poll thread now: the swap lands at the next tick
        boundary instead of up to weight_poll_s later."""
        self._poke.set()

    def _poll_weights_loop(self) -> None:
        while not self._stop_poll.is_set():
            self._poke.wait(self.cfg.serve.weight_poll_s)
            self._poke.clear()
            if self._stop_poll.is_set():
                return
            try:
                frame = self.broker.poll_weights()
            except Exception as e:  # broker outage: keep serving the current tree
                _log.warning("serve: weight poll failed (%s); retrying", e)
                continue
            if frame is None:
                continue
            # under the lock: apply_weight_frame reads self.version for its
            # staleness rules and replaces params/version
            with self._swap_lock:
                if apply_weight_frame(self, frame, "serve"):
                    self.weight_swaps_total += 1
                    self.model_swaps[0] += 1
                    self._bundles[0] = (self.params, self.version)

    def _league_sync_once(self) -> None:
        """One poll of the league service: fetch the slot map, install each
        slot whose (name, version) changed. Stdlib HTTP: the sync is a wire
        contract (GET /assignments → {"assignments": {slot: {"name",
        "version"}}}, GET /snapshot?name= → {"version", "params": {flax
        name: {"dtype", "shape", "b64"}}})."""
        import base64
        import urllib.request

        ep = str(self.cfg.serve.league_endpoint)
        timeout = max(1.0, float(self.cfg.serve.league_sync_s))
        with urllib.request.urlopen(f"http://{ep}/assignments", timeout=timeout) as resp:
            body = json.loads(resp.read().decode("utf-8", "replace"))
        for slot_s, rec in (body.get("assignments") or {}).items():
            m = int(slot_s)
            if not 0 < m < self.models:
                continue  # a larger league than this server holds slots for
            want = (str(rec.get("name", "")), int(rec.get("version", 0)))
            if self._synced.get(m) == want:
                continue
            with urllib.request.urlopen(f"http://{ep}/snapshot?name={want[0]}", timeout=timeout) as resp:
                snap = json.loads(resp.read().decode("utf-8", "replace"))
            named = [(str(name), np.frombuffer(base64.b64decode(arr["b64"]), dtype=np.dtype(arr["dtype"]))
                      .reshape(arr["shape"])) for name, arr in (snap.get("params") or {}).items()]
            self.swap_model(m, named, int(snap.get("version", want[1])))
            self._synced[m] = want
            self.league_syncs_total += 1
            _log.info("serve: league sync installed %s v%d into slot %d", want[0], want[1], m)

    def _league_sync_loop(self) -> None:
        while not self._stop_sync.wait(float(self.cfg.serve.league_sync_s)):
            try:
                self._league_sync_once()
            except Exception as e:  # league outage: keep serving the current slots
                self.league_sync_errors_total += 1
                _log.warning("serve: league sync failed (%s); retrying", e)

    # ------------------------------------------------------------- serving

    def _zero_state(self):
        return P.initial_state(self.cfg.policy, (1,), self.device)

    @staticmethod
    def _canon_obs(obs: F.Observation) -> F.Observation:
        """bf16 float leaves → f32 (exact); f32 obs pass through."""
        if not is_bf16(obs.global_feats):
            return obs
        up = lambda t: bf16_bits_to_f32(bf16_bits(t))  # noqa: E731
        return obs._replace(global_feats=up(obs.global_feats), hero_feats=up(obs.hero_feats),
                            unit_feats=up(obs.unit_feats))

    async def _step_request(self, conn: _ClientConn, payload: bytes) -> None:
        try:
            req = W.decode_step_request(payload)
        except Exception as e:
            self.bad_requests_total += 1
            _log.warning("serve: bad step request: %s", e)
            # echo the real key when the head parses, so the error reaches
            # the env that sent it
            key = struct.unpack_from("<Q", payload)[0] if len(payload) >= 8 else 0
            await conn.send(W.R_STEP, W.encode_step_response(W.StepResponse(key, W.BAD_REQUEST)))
            return
        self.requests_total += 1
        self.model_requests[conn.model] += 1
        if req.replay:
            self.replayed_steps_total += 1
        if req.episode_start:
            state = self._zero_state()
            self.episode_resets_total += 1
        else:
            state = conn.carries.get(req.client_key)
            if state is None:
                self.unknown_client_total += 1
                await conn.send(W.R_STEP, W.encode_step_response(W.StepResponse(req.client_key, W.UNKNOWN_CLIENT)))
                return
        row, version, tick = await self.batchers[conn.model].step(state, self._canon_obs(req.obs), req.rng)
        if self.first_request_t is None:
            self.first_request_t = time.monotonic()
        new_state, action, logp, value, rng2 = row
        conn.carries[req.client_key] = new_state
        ep_step = 1 if req.episode_start else conn.steps.get(req.client_key, 0) + 1
        conn.steps[req.client_key] = ep_step
        carry = None
        if req.want_carry:
            carry = tuple(x[0].cpu().numpy() for x in new_state)
            if self._store is not None:
                # write-ahead: the entry lands before the reply that vouches
                # for this boundary; a store failure degrades the session to
                # abandon-on-failover and serving goes on. Store keys compose
                # (client_key, model); model 0 is the bare key.
                try:
                    await self._store.put(W.compose_store_key(req.client_key, conn.model), ep_step, version,
                                          carry[0], carry[1])
                    self.handoff_writes_total += 1
                except Exception as e:
                    self.handoff_write_errors_total += 1
                    _log.warning("serve: carry handoff write failed for client %d (%s); session degrades to "
                                 "abandon-on-failover", req.client_key, e)
        resp = W.StepResponse(client_key=req.client_key, status=W.OK, version=version, tick=tick, rng=rng2,
                              action=action, logp=float(logp), value=float(value), carry=carry)
        await conn.send(W.R_STEP, W.encode_step_response(resp))

    async def _resume_request(self, conn: _ClientConn, payload: bytes) -> None:
        """Session continuity: restore the client's boundary carry from the
        store and make it resident on the serving device, bit for bit, so
        the replay steps that follow rebuild its mid-chunk carry. A task
        like S_STEP, so a slow store read holds up no other env of the
        connection. Any refusal (no store, miss, stale, width or
        fingerprint mismatch) answers UNKNOWN_CLIENT: the client abandons
        the episode."""
        try:
            req = W.decode_resume_request(payload)
        except Exception as e:
            self.bad_requests_total += 1
            _log.warning("serve: bad resume request: %s", e)
            key = struct.unpack_from("<Q", payload)[0] if len(payload) >= 8 else 0
            await conn.send(W.R_RESUME, W.encode_resume_response(W.ResumeResponse(key, W.UNKNOWN_CLIENT)))
            return
        entry = None
        if self._store is not None:
            try:
                _, entry = await self._store.get(W.compose_store_key(req.client_key, conn.model), req.boundary_step)
            except Exception as e:
                self.handoff_write_errors_total += 1
                _log.warning("serve: carry handoff read failed: %s", e)
        if entry is not None and entry.c.size != self.cfg.policy.lstm_hidden:
            _log.warning("serve: store entry width %d != lstm_hidden %d; refusing resume", entry.c.size,
                         self.cfg.policy.lstm_hidden)
            entry = None
        if entry is not None:
            from dotaclient_tpu_torch.serve.handoff import carry_fingerprint

            # boundary steps repeat across a client's episodes: only the
            # bytes the client holds may be restored
            if carry_fingerprint(entry.c, entry.h) != req.carry_hash:
                _log.warning("serve: store entry for client %d boundary %d fails the carry fingerprint; refusing "
                             "resume", req.client_key, req.boundary_step)
                entry = None
        if entry is None:
            self.resume_misses_total += 1
            await conn.send(W.R_RESUME, W.encode_resume_response(W.ResumeResponse(req.client_key, W.UNKNOWN_CLIENT)))
            return
        # f32 host → device with no dtype change: the replayed rows stay bitwise
        conn.carries[req.client_key] = tuple(
            torch.from_numpy(np.ascontiguousarray(x, np.float32)[None]).to(self.device) for x in (entry.c, entry.h))
        conn.steps[req.client_key] = int(entry.episode_step)
        self.resumes_total += 1
        await conn.send(W.R_RESUME, W.encode_resume_response(
            W.ResumeResponse(req.client_key, W.OK, int(entry.version), int(entry.episode_step))))

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        conn = _ClientConn(writer)
        self._conns.add(conn)
        tasks: set = set()
        try:
            while True:
                mtype, payload = await W.read_frame(reader)
                if mtype in (W.S_STEP, W.S_RESUME):
                    # one task per request: a connection's envs step
                    # concurrently and the batcher gathers them into a tick
                    handler = self._step_request if mtype == W.S_STEP else self._resume_request
                    t = asyncio.ensure_future(handler(conn, payload))
                    tasks.add(t)
                    t.add_done_callback(tasks.discard)
                elif mtype == W.S_STATS:
                    await conn.send(W.R_STATS, json.dumps(self.stats()).encode())
                elif mtype == W.S_INFO:
                    # inline, before any step task of this connection: the
                    # client awaits R_INFO before it steps
                    info = self.info()
                    try:
                        model = W.decode_info_request(payload)
                    except ValueError as e:
                        self.bad_requests_total += 1
                        info["model_error"] = str(e)
                        model = None
                    if model is not None:
                        if 0 <= model < self.models:
                            conn.model = model
                        else:
                            info["model_error"] = f"model {model} not resident (--serve.models {self.models})"
                    info["model"] = conn.model
                    await conn.send(W.R_INFO, json.dumps(info).encode())
                else:
                    raise ValueError(f"unknown message type {mtype:#x}")
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
            pass  # the client went away; eviction below
        except asyncio.CancelledError:
            pass
        finally:
            self.evictions_total += len(conn.carries)
            self.model_evictions[conn.model] += len(conn.carries)
            conn.carries.clear()
            conn.steps.clear()
            self._conns.discard(conn)
            for t in tasks:
                t.cancel()
            writer.close()

    # ----------------------------------------------------------- lifecycle

    async def _main(self):
        tick_loops = [asyncio.ensure_future(b.run()) for b in self.batchers]
        self._stop_ev = asyncio.Event()
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        await self._stop_ev.wait()
        # stop accepting, fail the batchers' pending futures, cancel the
        # handlers, abort transports so close is immediate
        self._server.close()
        for b in self.batchers:
            b.stop()
        me = asyncio.current_task()
        handlers = [t for t in asyncio.all_tasks() if t is not me]
        for t in handlers:
            t.cancel()
        for c in list(self._conns):
            c.writer.transport.abort()
        if handlers:
            await asyncio.gather(*handlers, return_exceptions=True)
        await self._server.wait_closed()
        for d in tick_loops:
            d.cancel()
        await asyncio.gather(*tick_loops, return_exceptions=True)
        if self._store is not None:
            try:
                await self._store.close()
            except Exception:
                pass

    def _warm(self) -> None:
        """One row step before listening: the first client request does not
        pay the device's first-call set-up."""
        obs = as_tensors(F.stack([F.zeros_observation()]), self.device)
        self.batcher._step(self._bundle[0], self._zero_state(), obs, np.zeros((1, 2), np.uint32))

    def _run(self):
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)
        try:
            self._warm()
            loop.run_until_complete(self._main())
            pending = asyncio.all_tasks(loop)
            for t in pending:
                t.cancel()
            if pending:
                loop.run_until_complete(asyncio.gather(*pending, return_exceptions=True))
        except BaseException as e:
            self._boot_error = e
            self._started.set()
        finally:
            loop.close()

    def start(self) -> "InferenceServer":
        self._thread = threading.Thread(target=self._run, daemon=True, name="serve-server")
        self._thread.start()
        if not self._started.wait(300):
            raise RuntimeError("inference server failed to start (timeout)")
        boot_error = self._boot_error
        if boot_error is not None:
            raise RuntimeError(f"inference server failed to start: {boot_error}") from boot_error
        if self.broker is not None:
            self._poll_thread = threading.Thread(target=self._poll_weights_loop, daemon=True, name="serve-weights")
            self._poll_thread.start()
        if self.models > 1 and str(self.cfg.serve.league_endpoint):
            self._sync_thread = threading.Thread(target=self._league_sync_loop, daemon=True, name="serve-league-sync")
            self._sync_thread.start()
        if self.obs is not None:
            self.obs.serve_metrics([self.stats], health_provider=self._health, device=self.device)
        return self

    def stop(self) -> None:
        self._stop_poll.set()
        self._stop_sync.set()
        self._poke.set()
        loop = self._loop
        if loop is not None and not loop.is_closed():
            try:
                loop.call_soon_threadsafe(self._stop_ev.set)
            except RuntimeError:
                pass
        if self._thread:
            self._thread.join(timeout=10)
        if self._poll_thread:
            self._poll_thread.join(timeout=5)
        if self._sync_thread:
            self._sync_thread.join(timeout=5)
        if self.obs is not None:
            self.obs.close()

    # ------------------------------------------------------------- surface

    def stats(self) -> dict:
        """The batchers' actor_* family (summed over slots) and the serve_*
        counters, the handoff and league ones included."""
        out = dict(self.batcher.stats())
        for b in self.batchers[1:]:
            for k, v in b.stats().items():
                out[k] = out.get(k, 0.0) + v
        conns = list(self._conns)
        out.update({
            "serve_requests_total": float(self.requests_total),
            "serve_unknown_client_total": float(self.unknown_client_total),
            "serve_bad_requests_total": float(self.bad_requests_total),
            "serve_episode_resets_total": float(self.episode_resets_total),
            "serve_evictions_total": float(self.evictions_total),
            "serve_weight_swaps_total": float(self.weight_swaps_total),
            "serve_version": float(self._bundle[1]),
            "serve_clients_connected": float(len(conns)),
            "serve_carries_resident": float(sum(len(c.carries) for c in conns)),
            "serve_handoff_store_writes_total": float(self.handoff_writes_total),
            "serve_handoff_store_errors_total": float(self.handoff_write_errors_total),
            "serve_handoff_resumes_total": float(self.resumes_total),
            "serve_handoff_resume_misses_total": float(self.resume_misses_total),
            "serve_handoff_replayed_steps_total": float(self.replayed_steps_total),
            "serve_models_resident": float(self.models),
            "serve_league_syncs_total": float(self.league_syncs_total),
            "serve_league_sync_errors_total": float(self.league_sync_errors_total),
        })
        load = self.load()
        for k in ("clients", "occupancy", "pending", "capacity"):
            out[f"serve_load_{k}"] = float(load[k])
        if self.models > 1:
            with self._swap_lock:
                for m in range(self.models):
                    out[f"serve_model_requests_total_{m}"] = float(self.model_requests[m])
                    out[f"serve_model_swaps_total_{m}"] = float(self.model_swaps[m])
                    out[f"serve_model_evictions_total_{m}"] = float(self.model_evictions[m])
                    out[f"serve_model_version_{m}"] = float(self._bundles[m][1])
        return out

    def load(self) -> dict:
        """Placement signal (S_INFO "load"): live connections and the mean
        tick occupancy from slot 0's histogram."""
        hist = list(self.batcher._tick_rows)
        rows = sum(k * n for k, n in enumerate(hist))
        ticks = sum(hist[1:])
        occ = (rows / ticks / self.batcher.capacity) if ticks else 0.0
        return {"clients": len(list(self._conns)), "occupancy": round(occ, 4),
                "pending": self.batcher._queue.qsize(), "capacity": self.batcher.capacity}

    def info(self) -> dict:
        """The S_INFO handshake body: what a client must agree with."""
        return {
            "role": "serve",
            "arch": self.cfg.policy.arch,
            "lstm_hidden": self.cfg.policy.lstm_hidden,
            "max_batch": self.cfg.serve.max_batch,
            "gather_window_s": self.cfg.serve.gather_window_s,
            "version": self._bundle[1],
            "models": self.models,
            "load": self.load(),
        }

    def _health(self) -> dict:
        """The /healthz body."""
        return {"ok": True, "role": "serve", "version": self._bundle[1], "clients": len(list(self._conns))}


def _store_client(endpoint: str, timeout_s: float):
    """The carry-store client `--serve.handoff_endpoint` names: one
    host:port, or a comma list sharded by rendezvous hash of the key."""
    from dotaclient_tpu_torch.serve.handoff import CarryStoreClient, ShardedCarryStore

    if "," in endpoint:
        return ShardedCarryStore(endpoint, timeout_s=timeout_s)
    host, sep, port = endpoint.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"--serve.handoff_endpoint must be host:port, got {endpoint!r}")
    return CarryStoreClient(host or "127.0.0.1", int(port), timeout_s=timeout_s)


def main(argv=None):
    from dotaclient_tpu_torch.config import parse_config
    from dotaclient_tpu_torch.obs import ObsRuntime
    from dotaclient_tpu_torch.transport.base import RetryPolicy
    from dotaclient_tpu_torch.transport.base import connect as broker_connect

    logging.basicConfig(level=logging.INFO)
    cfg = parse_config(InferenceConfig(), argv)
    refuse_unported(cfg)
    device = serve_device(cfg)
    broker = broker_connect(cfg.broker_url, retry=RetryPolicy.from_config(cfg.retry))
    if cfg.chaos.enabled:
        # a gated import: with chaos off the package never loads and the
        # broker is the production object
        from dotaclient_tpu_torch.chaos import wrap_broker

        broker = wrap_broker(broker, cfg.chaos)
    obs = ObsRuntime.create(cfg.obs, role="serve")
    server = InferenceServer(cfg, broker, device=device, obs_runtime=obs).start()
    print(json.dumps({"serving": True, "port": server.port}), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    main()
