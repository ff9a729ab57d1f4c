"""Remote-policy actor client (torch twin of dotaclient_tpu/serve/client.py).

`RemotePolicyClient` multiplexes many envs' step requests over ONE
connection to the inference server (replies demultiplex by client_key);
`RemoteActor` is the port's Actor with its `_policy_step` seam routed
over that client — run_episode, chunking, publishing, the kill switch
and the shed throttle are the unchanged local code; `RemoteFleet` drives
M remote env slots on one loop (the VectorActor topology with the
batcher replaced by the server). Every frame is the reference's
(serve/wire.py), so either package's client steps either package's
server.

Resilience: `--serve.endpoint` takes a comma-separated failover list. A
client holds one live connection at a time (the carry lives on one
replica); on connection loss or a reply timeout it abandons the
in-flight episodes (or, with `--serve.resume`, restores them on another
replica from the carry store and replays the partial chunk), marks the
endpoint down for `--serve.cooldown_s`, and reconnects to the next
healthy endpoint through the shared RetryPolicy (jittered backoff).
When every endpoint has been down longer than `--serve.fallback_after_s`
and `--serve.fallback_local` is on, whole episodes step locally against
a net kept warm from the broker's weight fanout (`LocalFallback`) until
an endpoint recovers. Meters: the serve_failover_* / serve_fallback_*
scalars of RemoteFleet.stats().

The client owns featurization, its jax PRNGKey stream (sent with each
request, returned advanced: ops/threefry.py on the server), chunk
assembly, publishing and the version stamps (synced at chunk
boundaries). The server owns the net and the LSTM carry, returned only
on chunk-fill steps (WANT_CARRY), where it becomes the next chunk's
initial state; mid-chunk the actor's state is a stand-in nothing reads.

Differences from the reference by design: the retry tuple holds the
port's EnvRpcError where the reference has grpc's AioRpcError (the port
imports grpc only to dial a network env), and the fallback's boot net is
drawn from torch.Generator().manual_seed(seed).
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from dotaclient_tpu_torch.config import ActorConfig
from dotaclient_tpu_torch.env import featurizer as F
from dotaclient_tpu_torch.env.service import EnvRpcError
from dotaclient_tpu_torch.ops import action_dist as ad
from dotaclient_tpu_torch.ops.batch import as_tensors, tree_map
from dotaclient_tpu_torch.runtime.actor import Actor, _host_action, _to_host, apply_weight_frame, reset_env_stub
from dotaclient_tpu_torch.serve import wire as W
from dotaclient_tpu_torch.transport.base import RetryPolicy

_log = logging.getLogger(__name__)


class RemoteInferenceError(ConnectionError):
    """The inference service failed this step: transport failure,
    timeout, or a lost server-side carry (UNKNOWN_CLIENT). Retryable at
    episode granularity — the actor abandons the episode and starts a
    fresh one, exactly the lost-env-session path. With `--serve.resume`
    armed, RemoteActor first tries to RESUME the episode on a healthy
    replica (session-continuity handshake + partial-chunk replay,
    serve/handoff.py); only a refused or budget-exhausted resume falls
    back to this abandon semantics."""


class SessionResumeRefused(RemoteInferenceError):
    """The server answered a resume handshake with UNKNOWN_CLIENT: no
    store, store miss, or no entry matching the client's boundary.
    Authoritative — retrying cannot help (the entry will not appear), so
    the episode abandons immediately."""


def split_control_scheme(spec: str) -> Optional[str]:
    """`control:<host:port>` → the controller's "host:port", else None.
    Validation is loud (the parse_endpoints discipline): the scheme
    with a malformed address is a boot error, not a silent literal."""
    spec = str(spec).strip()
    if not spec.startswith("control:"):
        return None
    addr = spec[len("control:"):]
    host, sep, port = addr.partition(":")
    if not sep or not port.isdigit() or not 0 < int(port) < 65536:
        raise ValueError(
            f"control endpoint must be control:host:port, got {spec!r}"
        )
    return f"{host or '127.0.0.1'}:{int(port)}"


def parse_endpoints(spec: str):
    """`host:port` or a comma-separated list of them → [(host, port)].

    The config boundary for `--serve.endpoint`: a malformed list must
    fail the actor LOUDLY at boot (ValueError), never degrade into a
    silently-shorter failover rotation. Empty segments (``a:1,,b:2`` or
    a trailing comma) are malformed for the same reason — they are
    almost always a typo'd replica. An empty host defaults to 127.0.0.1
    (the single-endpoint behavior).

    `control:<host:port>` selects DISCOVERY instead of a literal list:
    the client fetches its endpoints from the control plane's GET
    /topology at (re)connect (RemotePolicyClient handles the fetch over
    plain HTTP — the control package is never imported). Here the
    scheme validates and yields an EMPTY list — discovery fills it.
    Rollback is the spec itself: a literal list never consults the
    controller."""
    if split_control_scheme(spec) is not None:
        return []
    parts = str(spec).split(",")
    out = []
    for part in (p.strip() for p in parts):
        if not part:
            raise ValueError(
                f"serve endpoint list has an empty entry: {spec!r} "
                f"(expected host:port[,host:port...])"
            )
        host, sep, port = part.partition(":")
        if not sep or not port:
            raise ValueError(f"serve endpoint must be host:port, got {part!r}")
        try:
            port_n = int(port)
        except ValueError:
            raise ValueError(f"serve endpoint port is not an integer: {part!r}") from None
        if not 0 < port_n < 65536:
            raise ValueError(f"serve endpoint port out of range: {part!r}")
        out.append((host or "127.0.0.1", port_n))
    if not out:
        raise ValueError("serve endpoint list is empty")
    return out



def carry_state(carry):
    """A reply's (c, h) f32 [H] pair as the actor's [1, H] state (host
    tensors: the chunk's initial state is read from it)."""
    c, h = carry
    return (torch.from_numpy(np.array(c, np.float32))[None], torch.from_numpy(np.array(h, np.float32))[None])


def reply_action(res: W.StepResponse) -> ad.Action:
    """A reply's int32 [4] action (type, move_x, move_y, target) as an
    Action of [1] arrays, the chunk's format."""
    a = res.action
    return ad.Action(*(np.asarray([a[k]], np.int32) for k in range(4)))

class RemotePolicyClient:
    """One multiplexed connection to the inference server (at most one
    live replica at a time — affinity; see module docstring for the
    failover rules). All use is single-event-loop asyncio (the actor
    process's loop); `step()` may be in flight for many client_keys at
    once, at most one per key."""

    def __init__(
        self,
        endpoint: str,
        policy_cfg,
        wire_obs_dtype: str = "f32",
        timeout_s: float = 30.0,
        connect_timeout_s: float = 5.0,
        cooldown_s: float = 5.0,
        retry: Optional[RetryPolicy] = None,
        route: str = "order",
        model: int = 0,
    ):
        # Discovery mode (--serve.endpoint control:<host:port>): the
        # endpoint list starts empty and is fetched/refreshed from the
        # controller's GET /topology at every (re)connect. Literal
        # lists (None here) never touch the controller — the literal-list
        # behavior, and the rollback path.
        self._control = split_control_scheme(endpoint)
        self.topology_refreshes = 0
        self.topology_errors = 0
        self.topology_epoch = -1
        self.endpoints = parse_endpoints(endpoint)
        if route not in ("order", "load"):
            raise ValueError(f"serve route must be order|load, got {route!r}")
        # Endpoint placement at (re)connect: "order" = the sticky
        # list-order rotation; "load" = probe every in-rotation
        # candidate's S_INFO load report and dial least-loaded first.
        # Affinity is untouched either way — the pick happens only when
        # a connection is being (re)established.
        self._route = route
        self.route_probes = 0
        self.route_picks = 0
        # Model binding (--serve.model): which resident param slot this
        # connection's sessions step against. 0 sends an EMPTY S_INFO
        # payload — byte-identical to the single-model wire — so legacy
        # servers never see the field at all (DTR1/DTR2 inertness).
        self.model = int(model)
        if not (0 <= self.model <= W.MAX_MODEL_ID):
            raise ValueError(f"serve model id {model} out of range")
        self.lstm_hidden = int(policy_cfg.lstm_hidden)
        if wire_obs_dtype in ("f32", "float32"):
            self._obs_bf16 = False
        elif wire_obs_dtype in ("bf16", "bfloat16"):
            self._obs_bf16 = True
        else:
            raise ValueError(f"wire obs_dtype must be f32|bf16, got {wire_obs_dtype!r}")
        self.timeout_s = timeout_s
        self.connect_timeout_s = connect_timeout_s
        self.cooldown_s = cooldown_s
        self.retry = retry if retry is not None else RetryPolicy()
        # Per-endpoint health: monotonic time before which the endpoint
        # sits out of the rotation. Sticky affinity: _ep is the index the
        # client currently prefers; it only moves on failover.
        self._down_until = [0.0] * len(self.endpoints)
        self._ep = 0
        # First monotonic instant at which the whole tier was known bad
        # — the clock the local-fallback budget runs against. Latched
        # when every endpoint is in cooldown at once AND when a full
        # failover pass fails on every dialable candidate (slow
        # blackholed dials stagger the cooldowns, so the simultaneous
        # condition alone can never fire when cooldown_s <= dial time).
        # Cleared ONLY by a successful connect — cooldown expiry makes
        # an endpoint eligible again, it proves nothing recovered.
        self.all_down_since: Optional[float] = None
        self.failovers = 0
        self.reconnects = 0
        self._reconnect_backoff = self.retry.backoff_base_s
        self._reader = None
        self._writer = None
        self._reader_task: Optional[asyncio.Task] = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._wlock: Optional[asyncio.Lock] = None
        # Connect lock: persists ACROSS teardowns (nulling it with the
        # connection let a sibling env start a second concurrent
        # failover pass while one was mid-dial — two passes would race
        # to commit _reader/_writer and the loser's orphan demux loop
        # could later tear down the winner's healthy connection). It is
        # replaced only when a DIFFERENT event loop drives the client
        # (drivers that asyncio.run() per phase): asyncio primitives
        # bind to their creating loop.
        self._connect_lock: Optional[asyncio.Lock] = None
        self._connect_lock_loop = None
        # close() is TERMINAL: afterwards every step fails fast with
        # RemoteInferenceError instead of reconnecting. This is the
        # teardown backstop for the Python 3.10 wait_for cancel-swallow
        # race (the batcher's stop-flag rule): a worker whose
        # cancel was swallowed must not quietly reconnect and run
        # forever — its next step raises, its loop sees the fleet
        # stopping, and teardown converges.
        self._closed = False
        self.server_info: Optional[dict] = None
        # Bench meters: per-request round-trip latency samples (bounded)
        # + counters. Single-loop access, no locking.
        self.steps = 0
        self.errors = 0
        self.latency_s = collections.deque(maxlen=100_000)

    # --------------------------------------------------- endpoint health

    @property
    def addr(self):
        """(host, port) the client currently prefers (sticky)."""
        if not self.endpoints:
            return ("", 0)  # discovery mode before the first /topology
        return self.endpoints[self._ep]

    def has_healthy_endpoint(self) -> bool:
        """True if any endpoint is in rotation (cooldown expired).
        'Healthy' means ELIGIBLE, not proven — only a successful connect
        proves recovery (and clears all_down_since)."""
        now = time.monotonic()
        return any(t <= now for t in self._down_until)

    def endpoints_down(self) -> int:
        now = time.monotonic()
        return sum(1 for t in self._down_until if t > now)

    def _mark_down(self, idx: int) -> None:
        now = time.monotonic()
        self._down_until[idx] = now + self.cooldown_s
        if self.all_down_since is None and not any(t <= now for t in self._down_until):
            self.all_down_since = now

    # -------------------------------------------------------- discovery

    def _fetch_topology(self) -> list:
        """Blocking GET http://<controller>/topology → the "server"
        tier's [(host, port)]. Plain stdlib HTTP on purpose: the actor
        must never import the control plane's code (inertness — discovery
        is a wire contract, not a code dependency)."""
        import json as _json
        from urllib.request import urlopen

        with urlopen(
            f"http://{self._control}/topology", timeout=self.connect_timeout_s
        ) as resp:
            body = _json.loads(resp.read().decode("utf-8", "replace"))
        self.topology_epoch = int(body.get("epoch", -1))
        eps = []
        for entry in body.get("tiers", {}).get("server", []):
            host, sep, port = str(entry).partition(":")
            if not sep or not port.isdigit():
                raise ValueError(f"malformed /topology endpoint {entry!r}")
            eps.append((host or "127.0.0.1", int(port)))
        return eps

    async def _refresh_topology(self) -> None:
        """Adopt the controller's current server list, preserving the
        sticky endpoint and cooldown clocks by endpoint IDENTITY (a
        rescale must not reset a surviving replica's health state, and
        affinity must not jump replicas just because the list reordered).
        Fetch failure keeps the current list and counts the error."""
        loop = asyncio.get_running_loop()
        try:
            eps = await asyncio.wait_for(
                loop.run_in_executor(None, self._fetch_topology),
                self.connect_timeout_s + 1.0,
            )
        except (Exception, asyncio.TimeoutError):
            self.topology_errors += 1
            return
        if not eps or eps == self.endpoints:
            return
        sticky = self.endpoints[self._ep] if self.endpoints else None
        down = dict(zip(self.endpoints, self._down_until))
        self.endpoints = eps
        self._down_until = [down.get(e, 0.0) for e in eps]
        self._ep = eps.index(sticky) if sticky in eps else 0
        self.topology_refreshes += 1
        _log.info(
            "serve client: adopted topology epoch %d (%d endpoints)",
            self.topology_epoch, len(eps),
        )

    # ------------------------------------------------------- connection

    async def _ensure_connected(self) -> None:
        if self._closed:
            raise RemoteInferenceError("client is closed")
        if self._writer is not None:
            return
        # Serialize connection setup: M envs fire their first steps
        # concurrently, and without the lock each would dial its own
        # socket and clobber the others' reader/writer mid-handshake.
        loop = asyncio.get_running_loop()
        if self._connect_lock is None or self._connect_lock_loop is not loop:
            self._connect_lock = asyncio.Lock()
            self._connect_lock_loop = loop
        async with self._connect_lock:
            if self._writer is not None:
                return  # a sibling env connected while we waited
            if self._closed:
                raise RemoteInferenceError("client is closed")
            if self._control is not None:
                # Discovery refresh at (re)connect, under the connect
                # lock (one fetch per failover pass, not per env). A
                # failed fetch KEEPS the current list — the controller
                # being down must never shrink a working rotation.
                await self._refresh_topology()
                if not self.endpoints:
                    raise RemoteInferenceError(
                        f"no serve endpoints: control plane {self._control} "
                        f"unreachable or serving an empty server tier"
                    )
            # One failover pass: candidates in sticky-first rotation
            # order, restricted to endpoints whose cooldown expired. No
            # inner retry loop — the episode retry loop above this client
            # is the outer loop, and each pass pays at most one jittered
            # backoff sleep per additional candidate (the shared
            # RetryPolicy shape, so a fleet never stampedes a replica).
            now = time.monotonic()
            n = len(self.endpoints)
            candidates = [
                i
                for i in ((self._ep + k) % n for k in range(n))
                if self._down_until[i] <= now
            ]
            if not candidates:
                if self.all_down_since is None:
                    self.all_down_since = now
                raise RemoteInferenceError(
                    f"all {n} serve endpoints down (cooldown {self.cooldown_s}s)"
                )
            if self._route == "load" and len(candidates) > 1:
                candidates = await self._probe_load_order(candidates)
            last_err: Optional[BaseException] = None
            for k, i in enumerate(candidates):
                if k > 0:
                    await asyncio.sleep(self.retry.sleep_for(self._reconnect_backoff))
                    self._reconnect_backoff = self.retry.next_backoff(self._reconnect_backoff)
                if self._closed:
                    raise RemoteInferenceError("client is closed")
                self.reconnects += 1
                try:
                    reader, writer = await asyncio.wait_for(
                        asyncio.open_connection(*self.endpoints[i]),
                        self.connect_timeout_s,
                    )
                except (OSError, asyncio.TimeoutError) as e:
                    self._mark_down(i)
                    last_err = e
                    continue
                try:
                    # Handshake BEFORE the demux loop starts (sequential
                    # read): the server must agree on the carry width or
                    # every response would deframe wrong. The model id
                    # rides this handshake (empty payload ≡ model 0) and
                    # binds the CONNECTION — step frames stay
                    # byte-identical at every model id.
                    writer.write(W.frame(W.S_INFO, W.encode_info_request(self.model)))
                    await writer.drain()
                    mtype, payload = await asyncio.wait_for(
                        W.read_frame(reader), self.connect_timeout_s
                    )
                except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError, ValueError) as e:
                    self._mark_down(i)
                    last_err = e
                    writer.close()
                    continue
                try:
                    self._check_server_info(mtype, payload)
                except ValueError:
                    # policy mismatch is NOT retryable — a config error,
                    # not an outage; fail loudly, don't rotate onward (a
                    # mixed-policy endpoint list is operator error).
                    writer.close()
                    raise
                if self._closed:
                    # close() landed while we were dialing: a swallowed
                    # cancel must not resurrect the connection (the
                    # wait_for rule) — drop the socket and fail fast.
                    writer.close()
                    raise RemoteInferenceError("client is closed")
                if i != self._ep:
                    self.failovers += 1
                    _log.warning(
                        "serve client: failed over %s -> %s",
                        self.endpoints[self._ep],
                        self.endpoints[i],
                    )
                self._ep = i
                self._down_until[i] = 0.0
                self.all_down_since = None
                self._reconnect_backoff = self.retry.backoff_base_s
                self._reader, self._writer = reader, writer
                self._wlock = asyncio.Lock()
                self._reader_task = asyncio.ensure_future(self._read_loop(reader, writer))
                return
            # Every dialable candidate just failed and the rest sit in
            # cooldown: the tier is down NOW, whatever the staggered
            # cooldown clocks say — latch the fallback budget's epoch.
            if self.all_down_since is None:
                self.all_down_since = time.monotonic()
            raise RemoteInferenceError(
                f"connect failed on every healthy endpoint (last: {last_err})"
            )

    async def _probe_load_order(self, candidates):
        """Load-aware placement (--serve.route load): dial every
        in-rotation candidate concurrently, read its S_INFO load report
        (connected clients + tick occupancy from the actor_tick_rows_*
        histogram + pending rows), close the probe sockets, and return
        the candidates least-loaded-first (sticky-rotation position
        tie-breaks, so equal-load behavior degrades to list order).
        The winner pays one extra dial (probe + real connect) — a
        (re)connect-time cost, never a per-step one. Probe failures
        mark the endpoint down like any dial failure; if every probe
        fails the original order is returned and the sequential dial
        loop reports the outage through its usual path."""
        import json

        async def probe(i):
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(*self.endpoints[i]),
                    self.connect_timeout_s,
                )
            except (OSError, asyncio.TimeoutError):
                self._mark_down(i)
                return None
            try:
                writer.write(W.frame(W.S_INFO, b""))
                await writer.drain()
                mtype, payload = await asyncio.wait_for(
                    W.read_frame(reader), self.connect_timeout_s
                )
                info = json.loads(payload) if mtype == W.R_INFO else {}
            except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError, ValueError):
                self._mark_down(i)
                return None
            finally:
                try:
                    writer.close()
                except Exception:
                    pass
            load = info.get("load") or {}
            return (
                float(load.get("clients", 0)),
                float(load.get("occupancy", 0.0)),
                float(load.get("pending", 0)),
                i,
            )

        self.route_probes += len(candidates)
        results = await asyncio.gather(*(probe(i) for i in candidates))
        alive = [r for r in results if r is not None]
        if not alive:
            return candidates
        pos = {i: k for k, i in enumerate(candidates)}
        alive.sort(key=lambda r: (r[0], r[1], r[2], pos[r[3]]))
        self.route_picks += 1
        return [r[3] for r in alive]

    def _check_server_info(self, mtype: int, payload: bytes) -> None:
        import json

        info = json.loads(payload) if mtype == W.R_INFO else {}
        if info.get("lstm_hidden") != self.lstm_hidden or info.get("arch") != "lstm":
            raise ValueError(
                f"inference server policy mismatch: server {info}, client "
                f"expects lstm_hidden={self.lstm_hidden}"
            )
        # Model binding refusal: an out-of-range --serve.model is a
        # CONFIG error (wrong server sizing), not an outage — same
        # fail-loudly-don't-rotate contract as a policy mismatch.
        if info.get("model_error"):
            raise ValueError(
                f"inference server refused model {self.model}: "
                f"{info['model_error']}"
            )
        if self.model and info.get("model") != self.model:
            raise ValueError(
                f"inference server bound model {info.get('model')}, client "
                f"requested {self.model} (pre-multi-model server?)"
            )
        self.server_info = info

    async def _read_loop(self, reader, writer) -> None:
        import struct

        try:
            while True:
                mtype, payload = await W.read_frame(reader)
                # R_STEP and R_RESUME both lead with the u64 client_key
                # demux key; at most one request per key is ever in
                # flight (step OR resume), so one pending map serves
                # both — the awaiting side checks the type it got.
                if mtype not in (W.R_STEP, W.R_RESUME) or len(payload) < 8:
                    raise ValueError(f"unexpected server frame {mtype:#x}")
                (key,) = struct.unpack_from("<Q", payload)
                fut = self._pending.pop(key, None)
                if fut is not None and not fut.done():
                    fut.set_result((mtype, payload))
        except asyncio.CancelledError:
            pass
        except Exception as e:
            if self._writer is not writer:
                # Stale loop: the connection it served was already
                # replaced, and whoever replaced it failed this loop's
                # pending futures — cleaning up here would tear down
                # the SUCCESSOR's healthy connection.
                return
            # The replica died under us (mid-tick kill, RST): take the
            # endpoint out of rotation and drop the connection NOW —
            # synchronous cleanup, since this IS the reader task and
            # cannot await its own cancellation via _teardown — so the
            # very next step() fails over instead of burning one more
            # write+drain against a dead socket.
            exc = RemoteInferenceError(f"server connection lost: {e}")
            if not self._closed:
                self._mark_down(self._ep)
            self._writer = None
            self._reader = None
            self._wlock = None
            self._reader_task = None
            try:
                writer.close()
            except Exception:
                pass
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(exc)
            self._pending.clear()

    async def _teardown(self) -> None:
        if not self._closed and self._writer is not None:
            # A live connection died under us (reply deadline, RST,
            # demux failure): the endpoint serving it is suspect — take
            # it out of rotation so the next connect prefers a sibling.
            # Deliberate close() marks nothing (the endpoints are fine).
            self._mark_down(self._ep)
        task, self._reader_task = self._reader_task, None
        writer, self._writer = self._writer, None
        self._reader = None
        # The write lock dies with its connection; the CONNECT lock
        # survives (see __init__ — cross-loop reuse replaces it there).
        self._wlock = None
        if task is not None:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        if writer is not None:
            try:
                writer.close()
            except Exception:
                pass
        exc = RemoteInferenceError("connection torn down")
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self._pending.clear()

    async def step(
        self,
        client_key: int,
        obs,
        rng,
        episode_start: bool = False,
        want_carry: bool = False,
        replay: bool = False,
    ) -> W.StepResponse:
        await self._ensure_connected()
        # Local snapshots: a SIBLING env's failure can run _teardown()
        # (nulling _wlock/_writer) while this coroutine awaits the lock;
        # operating on the snapshot keeps this step's failure path on
        # the old connection's exceptions (OSError / the pending-future
        # RemoteInferenceError teardown already set) instead of an
        # AttributeError on None that would crash the whole fleet.
        wlock, writer = self._wlock, self._writer
        if wlock is None or writer is None:
            raise RemoteInferenceError("connection torn down")
        if client_key in self._pending:
            raise RuntimeError(f"concurrent steps for client_key {client_key}")
        fut = asyncio.get_running_loop().create_future()
        self._pending[client_key] = fut
        payload = W.encode_step_request(
            client_key, obs, rng, episode_start, want_carry, self._obs_bf16, replay
        )
        t0 = time.perf_counter()
        try:
            async with wlock:
                writer.write(W.frame(W.S_STEP, payload))
                await writer.drain()
            resp_mtype, resp_payload = await asyncio.wait_for(fut, self.timeout_s)
        except RemoteInferenceError:
            self.errors += 1
            raise
        except (OSError, asyncio.TimeoutError) as e:
            self.errors += 1
            self._pending.pop(client_key, None)
            await self._teardown()
            raise RemoteInferenceError(f"step failed: {e}") from e
        if resp_mtype != W.R_STEP:
            self.errors += 1
            await self._teardown()
            raise RemoteInferenceError(
                f"server answered a step with frame {resp_mtype:#x}"
            )
        self.latency_s.append(time.perf_counter() - t0)
        resp = W.decode_step_response(resp_payload, self.lstm_hidden)
        if resp.status == W.UNKNOWN_CLIENT:
            # The connection is healthy; only THIS episode's carry is
            # gone (server restart / eviction). Abandon the episode.
            self.errors += 1
            raise RemoteInferenceError(
                f"server lost the carry for client {client_key} (restart?)"
            )
        if resp.status != W.OK:
            self.errors += 1
            await self._teardown()
            raise RemoteInferenceError(f"server rejected step (status {resp.status})")
        self.steps += 1
        return resp

    async def resume(
        self, client_key: int, boundary_step: int, carry_hash: int = 0
    ) -> W.ResumeResponse:
        """Session-continuity handshake (--serve.resume): ask the
        currently-connected replica to restore this session's carry at
        `boundary_step` from the shared store and make it resident.
        `carry_hash` is serve/handoff.py carry_fingerprint of the
        boundary carry the caller holds — the server refuses an entry
        whose bytes differ (the cross-episode stale-entry guard).
        Raises SessionResumeRefused when the server answers
        UNKNOWN_CLIENT (authoritative — abandon), RemoteInferenceError
        for transport failures (retryable: fail over and re-resume)."""
        await self._ensure_connected()
        wlock, writer = self._wlock, self._writer
        if wlock is None or writer is None:
            raise RemoteInferenceError("connection torn down")
        if client_key in self._pending:
            raise RuntimeError(f"concurrent requests for client_key {client_key}")
        fut = asyncio.get_running_loop().create_future()
        self._pending[client_key] = fut
        try:
            async with wlock:
                writer.write(
                    W.frame(
                        W.S_RESUME,
                        W.encode_resume_request(client_key, boundary_step, carry_hash),
                    )
                )
                await writer.drain()
            resp_mtype, resp_payload = await asyncio.wait_for(fut, self.timeout_s)
        except RemoteInferenceError:
            self.errors += 1
            raise
        except (OSError, asyncio.TimeoutError) as e:
            self.errors += 1
            self._pending.pop(client_key, None)
            await self._teardown()
            raise RemoteInferenceError(f"resume failed: {e}") from e
        if resp_mtype != W.R_RESUME:
            self.errors += 1
            await self._teardown()
            raise RemoteInferenceError(
                f"server answered a resume with frame {resp_mtype:#x}"
            )
        resp = W.decode_resume_response(resp_payload)
        if resp.status != W.OK:
            raise SessionResumeRefused(
                f"server cannot restore session {client_key} at boundary "
                f"{boundary_step} (store miss/stale)"
            )
        return resp

    async def close(self) -> None:
        """Terminal: fails in-flight steps and refuses new ones (build a
        fresh client to reconnect deliberately)."""
        self._closed = True
        await self._teardown()

    def latency_percentiles(self) -> dict:
        """p50/p99 over the retained window (bench artifact payload)."""
        if not self.latency_s:
            return {"p50_ms": 0.0, "p99_ms": 0.0, "samples": 0}
        lat = np.asarray(self.latency_s)
        return {
            "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
            "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3),
            "samples": int(lat.size),
        }


def _client_from_cfg(cfg: ActorConfig) -> RemotePolicyClient:
    """Build the wire client from the --serve.* / --retry.* surface (the
    one place config names map onto client kwargs)."""
    return RemotePolicyClient(
        cfg.serve.endpoint,
        cfg.policy,
        wire_obs_dtype=cfg.wire.obs_dtype,
        timeout_s=cfg.serve.timeout_s,
        connect_timeout_s=cfg.serve.connect_timeout_s,
        cooldown_s=cfg.serve.cooldown_s,
        retry=RetryPolicy.from_config(cfg.retry),
        route=cfg.serve.route,
        model=cfg.serve.model,
    )


class LocalFallback:
    """The graceful-degradation half of `--serve.fallback_local`: a warm
    LOCAL param tree (init'd from cfg.seed, the actor-boot convention)
    refreshed from the broker weight fanout at chunk boundaries, plus
    the one shared B=1 key step that serves every env slot of a process
    when the serve tier is unreachable. One instance per process (fleet
    slots share their owner's): one tree, one compile, one weight poll
    stream. Engagement state lives here too so a fleet engages/disengages
    as a unit and the serve_fallback_* meters read one truth."""

    def __init__(self, cfg: ActorConfig, broker):
        from dotaclient_tpu_torch.models import policy as P
        from dotaclient_tpu_torch.runtime.actor import actor_device, make_key_actor_step

        self.broker = broker
        # apply_weight_frame contract: params/version/weight_epoch/
        # last_weight_time live on this object. The boot net is drawn from
        # torch.Generator().manual_seed(seed), as every port actor's is;
        # the first weight frame replaces it.
        self.device = actor_device(cfg)
        self.params = P.init_params(cfg.policy, torch.Generator().manual_seed(cfg.seed), self.device)
        self.version = 0
        self.weight_epoch = None
        self.last_weight_time = time.monotonic()
        self.step_fn = make_key_actor_step(cfg.policy)
        self.engaged = False
        self.engagements = 0
        self.steps_total = 0
        # Return-to-remote probe pacing clock (see
        # RemoteActor._decide_local_episode): one probe episode per
        # cooldown_s while engaged, fleet-wide (shared instance).
        self.last_probe_t = 0.0

    def poll(self) -> bool:
        """Apply a pending weight-fanout frame to the warm tree (the
        actor hot-swap rules: epoch resync, never-regress)."""
        try:
            frame = self.broker.poll_weights()
        except Exception as e:  # broker outage: keep the current tree warm
            _log.warning("serve-fallback: weight poll failed (%s); retrying", e)
            return False
        if frame is None:
            return False
        return apply_weight_frame(self, frame, "serve-fallback")


class RemoteActor(Actor):
    """The classic Actor with inference served remotely. Everything else
    — featurize, chunking, publish path (including the bf16 wire cast),
    shed throttle, episode/retry loop — is the inherited local code."""

    _RETRYABLE_EPISODE_ERRORS = (EnvRpcError, RemoteInferenceError)

    def __init__(
        self, cfg: ActorConfig, broker, actor_id: int = 0, stub=None, client=None,
        fallback: Optional[LocalFallback] = None,
    ):
        if cfg.policy.arch != "lstm":
            raise ValueError(
                "remote inference requires policy.arch='lstm' (server-side "
                "carry residency)"
            )
        self._owns_client = client is None
        self.remote_policy = client if client is not None else _client_from_cfg(cfg)
        # params=(): the server owns the tree; nothing local ever applies
        # it (maybe_update_weights is overridden) and init_params here
        # would burn a full net init per env slot for nothing. The
        # fallback tree (when configured) lives on LocalFallback, shared
        # fleet-wide — never on self.params.
        super().__init__(cfg, broker, actor_id=actor_id, stub=stub, params=())
        # Graceful degradation: fleet env slots share their owner's
        # LocalFallback (one tree/compile per process); a standalone
        # remote actor owns its own when configured.
        self._fallback = (
            fallback
            if fallback is not None
            else (LocalFallback(cfg, broker) if cfg.serve.fallback_local else None)
        )
        # Mode is decided ONCE per episode (at the episode_start step):
        # mid-episode the true carry lives server-side only, so a
        # mid-episode switch has nothing correct to resume from — the
        # failure path is abandon-and-restart, never migrate.
        self._episode_local = False
        # Episodes abandoned on remote-inference failure (connection
        # loss, reply deadline, UNKNOWN_CLIENT) — the explicit ledger a
        # server kill's cost is reconciled against.
        self.episodes_abandoned = 0
        # Version stamping state (the chunk-boundary rule):
        # responses report the version their TICK was served by;
        # self.version — what chunks are stamped with — syncs to it only
        # at maybe_update_weights (run_episode calls it right after each
        # publish), so a chunk whose tail crossed a hot-swap stamps its
        # chunk-start version: staleness over-estimated, never under-aged.
        self._seen_version = 0
        # The episode's last MATERIALIZED carry: real at episode start
        # (zeros) and after every chunk-fill step (the server returns it
        # there); a stand-in mid-chunk, where nothing consumes it.
        self._episode_state = None
        # Session continuity (--serve.resume, serve/handoff.py): the
        # client-side half of the resume protocol. `_resume_boundary` =
        # completed steps at the last OBSERVED chunk boundary (the
        # write-ahead rule makes every observed boundary durably
        # restorable); `_chunk_obs` buffers the completed steps' obs
        # since that boundary — the replay set that rebuilds the
        # mid-chunk carry bitwise on a fresh replica (carry updates are
        # rng-independent, so replay outputs are discarded and the
        # client's rng never double-advances). All inert when disarmed.
        self._resume_armed = bool(getattr(cfg.serve, "resume", False))
        self._resume_boundary = 0
        self._resume_steps = 0
        self._chunk_obs: list = []
        self.episodes_resumed = 0
        self.resume_replay_steps = 0

    def _decide_local_episode(self) -> bool:
        """Episode-start mode decision for --serve.fallback_local. Local
        once the tier has been down (all_down_since latched) longer than
        the fallback budget. While engaged, return-to-remote PROBES pace
        on their own clock (one per cooldown_s, and only when some
        endpoint's cooldown expired) WITHOUT disengaging: a successful
        probe clears all_down_since and the next decision disengages; a
        failed probe re-marks and fallback resumes — so `engagements`
        counts real outages, not probe cycles. The probe clock is
        deliberately NOT per-endpoint health (slow blackholed dials
        stagger the cooldowns so that some endpoint is almost always
        'eligible' — pacing on that would turn the whole fleet into a
        probe loop and starve the fallback)."""
        fb = self._fallback
        if fb is None:
            return False
        client = self.remote_policy
        since = client.all_down_since
        now = time.monotonic()
        if since is None:
            if fb.engaged:
                fb.engaged = False
                _log.warning(
                    "actor %d: serve fallback DISENGAGED (endpoint recovered)",
                    self.actor_id,
                )
            return False
        if now - since < self.cfg.serve.fallback_after_s:
            return False  # pre-budget: keep trying remote
        if not fb.engaged:
            fb.engaged = True
            fb.engagements += 1
            fb.last_probe_t = now  # first probe one cooldown from engage
            _log.warning(
                "actor %d: serve fallback ENGAGED (all %d endpoints down > %.1fs) "
                "— stepping locally at v%d",
                self.actor_id,
                len(client.endpoints),
                self.cfg.serve.fallback_after_s,
                fb.version,
            )
        elif client.has_healthy_endpoint() and now - fb.last_probe_t >= client.cooldown_s:
            fb.last_probe_t = now
            return False  # probe remote this episode (see docstring)
        # Episode start is a chunk boundary and nothing of this episode
        # exists yet: snap the stamp to the tree that will actually
        # generate it (the chunk-boundary rule's degenerate safe case — a stale
        # _seen_version stamp here could UNDER-age local rows).
        self.version = int(fb.version)
        return True

    async def _local_step(self, state, obs):
        """One B=1 local step against the warm fallback net: bitwise the
        standalone Actor's step for the same (net, state, obs, key),
        because it is that step (make_key_actor_step) on the fallback's
        device."""
        fb = self._fallback
        fb.steps_total += 1
        state = tree_map(lambda x: x.to(fb.device), state)
        obs_b = as_tensors(F.stack([obs]), fb.device)
        state, action, logp, value, self.rng = fb.step_fn(fb.params, state, obs_b, self.rng)
        acts, floats = _to_host(action, logp, value)
        return state, _host_action(acts[0]), floats[0, 0], floats[0, 1]

    async def _policy_step(
        self, state, obs, chunk_len: int = 0, episode_start: bool = False
    ):
        """One remote policy step. `state` in/out is the chunk-boundary
        carry protocol described in the module docstring: the returned
        state is REAL exactly where run_episode consumes it (episode
        start and chunk-fill steps, whose value becomes the next chunk's
        wire initial_state). The one place a stand-in reaches next_chunk
        — an episode that ends mid-chunk — builds a chunk run_episode
        provably discards (the while-not-done loop exits).

        With the local fallback engaged the episode steps locally
        instead: state threading is then the classic Actor's (every
        returned carry real)."""
        if episode_start:
            self._episode_local = self._decide_local_episode()
        if self._episode_local:
            return await self._local_step(state, obs)
        if episode_start:
            self._episode_state = state  # the true zero carry, [1, H] pair
            if self._resume_armed:
                self._resume_boundary = 0
                self._resume_steps = 0
                self._chunk_obs = []
        want_carry = chunk_len + 1 >= self.cfg.rollout_len
        try:
            res = await self.remote_policy.step(
                self.actor_id, obs, self.rng, episode_start=episode_start, want_carry=want_carry
            )
        except RemoteInferenceError as e:
            if not self._resume_armed:
                # This episode is now abandoned (the exception exits
                # run_episode): ledger it explicitly — silence here
                # would make a kill's cost invisible.
                self.episodes_abandoned += 1
                raise
            res = await self._resume_and_retry(obs, episode_start, want_carry, e)
        if self._resume_armed:
            self._resume_steps += 1
            if want_carry:
                # The reply we just received vouches for this boundary
                # — the server's write-ahead already made it durable.
                self._resume_boundary = self._resume_steps
                self._chunk_obs = []
            else:
                self._chunk_obs.append(obs)
        self.rng = res.rng
        if res.version != self._seen_version:
            # A version ADVANCE observed through serving is the weight
            # freshness signal in remote mode (there is no local fanout
            # subscription): the kill switch stays meaningful — a
            # healthy server with a dead weight feed still ages out.
            self._seen_version = int(res.version)
            self.last_weight_time = time.monotonic()
        if res.carry is not None:
            self._episode_state = carry_state(res.carry)
        return self._episode_state, reply_action(res), float(res.logp), float(res.value)

    async def _resume_and_retry(
        self, obs, episode_start: bool, want_carry: bool, first_err: BaseException
    ):
        """The --serve.resume failure path: instead of abandoning the
        episode, re-establish the session on a healthy replica and
        retry the failed step, within `--serve.resume_window_s`.

        One attempt = (1) reconnect — `step`/`resume` dial through
        `_ensure_connected`, failing over under the routing policy; (2)
        for a post-boundary episode, the S_RESUME handshake restores
        the boundary carry from the shared store (exact-match only; a
        refusal is authoritative → abandon); for a pre-first-boundary
        episode the store is not needed — the boundary carry is the
        EPISODE_START zeros, so the first replayed step carries that
        flag; (3) replay the buffered partial-chunk obs (FLAG_REPLAY,
        outputs discarded — the env already acted on the originals, and
        the carry update is rng-independent, so the rebuilt mid-chunk
        carry is bitwise the dead replica's); (4) re-issue the failed
        step as a REAL step — its rng/carry/obs are exactly the
        original attempt's, so the sampled action is bitwise what the
        uninterrupted run would have produced. Transport failures
        anywhere restart the attempt (another failover); the whole
        procedure is idempotent — the store entry only moves at
        boundaries the client has not observed yet."""
        client = self.remote_policy
        deadline = time.monotonic() + self.cfg.serve.resume_window_s
        backoff = 0.05
        err = first_err
        while True:
            if client._closed:
                # Teardown, not an outage: the fleet is closing the
                # client under us. Fail fast WITHOUT ledgering an
                # abandon — the ledger counts kill-caused abandons
                # only, and spinning the resume window here would
                # also stall episode-stream teardown by up to the
                # whole window.
                raise err
            try:
                # Attempt FIRST: a healthy sibling endpoint is usually
                # one dial away, and a pre-attempt sleep would tax every
                # env of every failover (it shows up directly in the
                # restart window's p99). Backoff is paid only
                # between FAILED attempts, below.
                if self._resume_boundary > 0:
                    # Lazy import: the handoff module stays un-imported
                    # until a resume actually runs (the inertness rule).
                    from dotaclient_tpu_torch.serve.handoff import carry_fingerprint

                    fp = carry_fingerprint(
                        self._episode_state[0].numpy(), self._episode_state[1].numpy()
                    )
                    await client.resume(self.actor_id, self._resume_boundary, fp)
                for i, o in enumerate(self._chunk_obs):
                    await client.step(
                        self.actor_id,
                        o,
                        self.rng,
                        episode_start=(self._resume_boundary == 0 and i == 0),
                        replay=True,
                    )
                    self.resume_replay_steps += 1
                res = await client.step(
                    self.actor_id,
                    obs,
                    self.rng,
                    episode_start=episode_start,
                    want_carry=want_carry,
                )
            except SessionResumeRefused:
                # Store miss/stale: the session is unrecoverable — the
                # abandon path still works underneath.
                self.episodes_abandoned += 1
                raise
            except RemoteInferenceError as e:
                err = e
                now = time.monotonic()
                if now >= deadline:
                    self.episodes_abandoned += 1
                    raise err
                await asyncio.sleep(min(backoff, max(0.0, deadline - now)))
                backoff = min(backoff * 2.0, 1.0)
                continue
            self.episodes_resumed += 1
            _log.info(
                "actor %d: episode RESUMED at boundary %d (+%d replayed steps)",
                self.actor_id,
                self._resume_boundary,
                len(self._chunk_obs),
            )
            return res

    def maybe_update_weights(self) -> bool:
        """No broker weight subscription for the SERVED tree — the
        server owns it; this is the chunk-boundary STAMP sync. With the
        local fallback configured it additionally refreshes the warm
        tree from the broker fanout (params swap immediately, stamps
        sync here — the VectorActor immediate-swap/boundary-stamp
        semantics), and in a local episode the stamp tracks the local
        tree's version instead of the last served one."""
        fb = self._fallback
        if fb is not None:
            fb.poll()
            # Fallback weight arrivals count as freshness for the kill
            # switch: a dead serve tier with a live learner fanout must
            # not kill actors that are still generating (locally).
            if fb.last_weight_time > self.last_weight_time:
                self.last_weight_time = fb.last_weight_time
        target = fb.version if (fb is not None and self._episode_local) else self._seen_version
        changed = self.version != target
        self.version = int(target)
        return changed

    async def run(self, num_episodes: Optional[int] = None) -> None:
        try:
            await super().run(num_episodes)
        finally:
            # Standalone use owns its connection; fleet env slots share
            # the owner's (episode_stream closes it once, at the end).
            if self._owns_client:
                await self.remote_policy.close()


class _RemoteEnvActor(RemoteActor):
    """One env slot of a RemoteFleet: shares the owner's wire client and
    ObsRuntime (one connection, one crash-handler chain per process)."""

    def __init__(self, owner: "RemoteFleet", actor_id: int):
        self.owner = owner  # before super().__init__: _make_obs_runtime reads it
        super().__init__(
            owner.cfg,
            owner.broker,
            actor_id=actor_id,
            client=owner.client,
            fallback=owner.fallback,
        )

    def _make_obs_runtime(self):
        return self.owner.obs


class RemoteFleet:
    """M env sessions, one process, one multiplexed connection to the
    inference service — the VectorActor topology with the local batcher
    replaced by the server (which batches across EVERY connected
    process, not just this one). Env slot j runs actor_id
    `actor_id * M + j`, the same id scheme as VectorActor, so frames are
    byte-identical to standalone actors with those ids."""

    def __init__(self, cfg: ActorConfig, broker, actor_id: int = 0, envs: Optional[int] = None, client=None, obs_runtime=None, fallback: Optional[LocalFallback] = None):
        M = int(envs if envs is not None else getattr(cfg, "envs_per_process", 1))
        if M < 1:
            raise ValueError(f"envs must be >= 1, got {M}")
        self.cfg = cfg
        self.broker = broker
        self.actor_id = actor_id
        self.client = client if client is not None else _client_from_cfg(cfg)
        # ONE warm fallback tree per process, shared by every env slot
        # (the VectorActor shared-params topology).
        self.fallback = (
            fallback
            if fallback is not None
            else (LocalFallback(cfg, broker) if cfg.serve.fallback_local else None)
        )
        if obs_runtime is not None:
            self.obs = obs_runtime
        else:
            from dotaclient_tpu_torch.obs import ObsRuntime

            self.obs = ObsRuntime.create(cfg.obs, role=f"remote{actor_id}")
        self.last_win: Optional[float] = None
        self._stopping = False  # teardown flag; see episode_stream
        self.envs = [_RemoteEnvActor(self, actor_id * M + j) for j in range(M)]

    @classmethod
    def from_actor(cls, actor: RemoteActor, envs: Optional[int] = None) -> "RemoteFleet":
        """Wrap a constructed RemoteActor (ActorPool's envs-per-actor
        mode): same cfg/broker/actor_id, shared client + ObsRuntime +
        warm fallback tree (when configured)."""
        return cls(
            actor.cfg,
            actor.broker,
            actor_id=actor.actor_id,
            envs=envs,
            client=actor.remote_policy,
            obs_runtime=actor.obs,
            fallback=actor._fallback,
        )

    # aggregate counters (the VectorActor shape)
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
        shed = failed = abandoned = resumed = replayed = 0
        throttle_s = 0.0
        for e in self.envs:
            t = e.publish_throttle
            shed += t.shed
            failed += t.failed
            throttle_s += t.throttle_s
            abandoned += e.episodes_abandoned
            resumed += e.episodes_resumed
            replayed += e.resume_replay_steps
        c = self.client
        fb = self.fallback
        out = {
            "broker_shed_observed_total": float(shed),
            "broker_shed_publish_failed_total": float(failed),
            "broker_shed_throttle_s": throttle_s,
            # Failover health (serve_failover_* family): endpoint
            # rotation state + the explicit abandoned-episode ledger.
            "serve_failover_endpoints": float(len(c.endpoints)),
            "serve_failover_endpoints_down": float(c.endpoints_down()),
            "serve_failover_total": float(c.failovers),
            "serve_failover_reconnects_total": float(c.reconnects),
            "serve_failover_episodes_abandoned_total": float(abandoned),
            # Local-fallback engagement (serve_fallback_* family): all
            # zero when --serve.fallback_local is off.
            "serve_fallback_engaged": 1.0 if (fb is not None and fb.engaged) else 0.0,
            "serve_fallback_engagements_total": float(fb.engagements) if fb else 0.0,
            "serve_fallback_steps_total": float(fb.steps_total) if fb else 0.0,
            "serve_fallback_version": float(fb.version) if fb else 0.0,
            # Session continuity, CLIENT side (serve_handoff_* family;
            # zero with --serve.resume off): episodes resumed instead
            # of abandoned, and the replay traffic that rebuilt them.
            "serve_handoff_client_resumes_total": float(resumed),
            "serve_handoff_replay_steps_total": float(replayed),
            # Routing tier (serve_route_* family; probes/picks zero
            # under the default list-order policy).
            "serve_route_load_mode": 1.0 if c._route == "load" else 0.0,
            "serve_route_probes_total": float(c.route_probes),
            "serve_route_picks_total": float(c.route_picks),
            # Discovery (serve_topology_* — zero with literal endpoint
            # lists; the control: scheme counts adoptions + fetch fails).
            "serve_topology_refreshes_total": float(c.topology_refreshes),
            "serve_topology_errors_total": float(c.topology_errors),
        }
        # Per-endpoint health gauges (serve_endpoint_* registry family):
        # /metrics shows
        # per configured endpoint index, whether it is in rotation and
        # how long it still sits out.
        now = time.monotonic()
        for i, t in enumerate(c._down_until):
            out[f"serve_endpoint_up_{i}"] = 0.0 if t > now else 1.0
            out[f"serve_endpoint_cooldown_s_{i}"] = round(max(0.0, t - now), 3)
        return out

    async def _env_loop(self, env: _RemoteEnvActor, results: "asyncio.Queue") -> None:
        backoff = 1.0
        while not self._stopping:
            try:
                env.check_weight_freshness()
                ret = await env.run_episode()
                backoff = 1.0
            except env._RETRYABLE_EPISODE_ERRORS as e:
                if self._stopping:
                    return  # teardown: the failure IS the closed client
                # Fallback-aware pacing: once every endpoint is down and
                # the budget has run out, the next episode steps LOCALLY
                # — backing off here would idle an env the fallback
                # exists to keep generating. Before the budget expires,
                # sleep only up to its remainder (the pre-engagement
                # failures are cheap fail-fasts, not reconnect storms).
                delay = backoff
                if self.fallback is not None and isinstance(e, RemoteInferenceError):
                    since = self.client.all_down_since
                    if since is not None:
                        remaining = self.cfg.serve.fallback_after_s - (
                            time.monotonic() - since
                        )
                        if remaining <= 0:
                            continue  # fallback serves the next episode now
                        delay = min(backoff, remaining)
                _log.warning(
                    "remote env %d: episode failed (%s: %s); retrying in %.1fs",
                    env.actor_id,
                    type(e).__name__,
                    e.code() if isinstance(e, EnvRpcError) else e,
                    delay,
                )
                if isinstance(e, EnvRpcError):
                    await reset_env_stub(env)  # drop the dead env subchannel
                await asyncio.sleep(delay)
                backoff = min(backoff * 2.0, 30.0)
                continue
            except asyncio.CancelledError:
                raise
            except BaseException as e:  # incl. StaleWeightsError: surface it
                await results.put((env, e))
                return
            await results.put((env, float(ret)))

    async def episode_stream(self):
        """Async generator yielding each completed episode's return (any
        env); closing it tears the workers and the connection down."""
        results: "asyncio.Queue" = asyncio.Queue()
        workers = [asyncio.create_task(self._env_loop(e, results)) for e in self.envs]
        try:
            while True:
                env, ret = await results.get()
                if isinstance(ret, BaseException):
                    raise ret
                self.last_win = env.last_win
                yield ret
        finally:
            # Stop-flag + close() BEFORE cancel (the teardown
            # lesson): a cancel swallowed by the 3.10 wait_for race
            # leaves its worker alive — but its next wire await now
            # fails fast on the closed client and the loop flag exits
            # it, so the gather below always converges.
            self._stopping = True
            await self.client.close()
            for t in workers:
                t.cancel()
            await asyncio.gather(*workers, return_exceptions=True)

    async def run(self, num_episodes: Optional[int] = None) -> None:
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
