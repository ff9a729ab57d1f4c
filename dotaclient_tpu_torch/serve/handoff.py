"""Session-continuity carry store (own copy of
dotaclient_tpu/serve/handoff.py; the wire is the reference's byte for
byte, so either package's replicas use either package's store).

A store the inference replicas write `(client_key, carry, version,
episode_step)` to at every chunk-boundary step, so a client whose replica
died can present its session (client key, last boundary, carry
fingerprint) to another replica, which restores the boundary carry and
takes the client's replay of its buffered partial chunk (at most one chunk
of recompute, never an abandoned episode):

- **Chunk boundaries are the only durable points**: the carry returned
  there is the only one a client ever consumes.
- **Write-ahead**: the server stores the boundary carry before it sends
  the chunk-fill reply, so any boundary a client has observed is
  restorable; a kill can lose the reply, never the entry.
- **Keep two**: each key keeps its current and previous entry, for the
  client whose chunk-fill reply a kill ate after the write landed (the
  store is then one boundary ahead of it).
- **Exact-match restore**: a resume names its boundary step; only an
  entry of exactly that step is returned, and the server also checks the
  carry fingerprint, since boundary steps repeat across episodes.
- **Atomic replace**: an entry is built whole, then published by one
  tuple assignment under the lock.

Shapes: `CarryStore` in-process, `CarryStoreServer` a framed-TCP service
(`python -m dotaclient_tpu_torch.serve.handoff`, the `carry-store`
Deployment in k8s/inference.yaml; one stdout JSON ready line
`{"serving": true, "port": P}`), `CarryStoreClient` the replica's asyncio
client, `ShardedCarryStore` the same API over a comma list of stores
(rendezvous placement by client key), `LocalCarryStore` over an
in-process store. Entries are f32 vectors to the store; it never builds a
policy and imports no torch unless its obs surface is on.
"""

from __future__ import annotations

import asyncio
import json
import logging
import struct
import threading
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

_log = logging.getLogger(__name__)

# Framing is the serve wire's (u32 payload_len | u8 type), redeclared
# here so the store binary never imports the featurizer/serialize stack.
_LEN = struct.Struct("<I")
_TYPE = struct.Struct("<B")

H_PUT, H_GET, H_STATS = 0x11, 0x12, 0x13
H_PUT_ACK, H_GET_RES, H_STATS_RES = 0x91, 0x92, 0x93

# get/put statuses on the wire
ST_OK, ST_MISS, ST_STALE = 0, 1, 2

_PUT_HEAD = struct.Struct("<QIII")  # key, episode_step, version, hidden
_PUT_ACK = struct.Struct("<QB")
_GET_REQ = struct.Struct("<QI")  # key, boundary_step
_GET_HEAD = struct.Struct("<QBIII")  # key, status, episode_step, version, hidden

MAX_FRAME = 16 * 1024 * 1024


def _frame(mtype: int, payload: bytes) -> bytes:
    return _LEN.pack(len(payload)) + _TYPE.pack(mtype) + payload


async def _read_frame(reader) -> Tuple[int, bytes]:
    hdr = await reader.readexactly(_LEN.size + _TYPE.size)
    (n,) = _LEN.unpack_from(hdr)
    (mtype,) = _TYPE.unpack_from(hdr, _LEN.size)
    if n > MAX_FRAME:
        raise ValueError("frame too large")
    payload = await reader.readexactly(n) if n else b""
    return mtype, payload


def carry_fingerprint(c, h) -> int:
    """u64 discriminator of a boundary carry's exact bytes (crc32 pair —
    fast, not adversarial). The resume handshake sends it alongside
    boundary_step because episode boundaries REPEAT the same step values
    across episodes of one client: if a boundary write FAILED (store
    outage — the degrade path) while a PREVIOUS episode's entry at the
    same step survived, step-only matching would silently restore a
    wrong-episode carry and every subsequent row would diverge bitwise.
    The client holds the true boundary carry (the chunk-fill reply
    delivered it), so the server can insist the stored bytes match."""
    import zlib

    cb = np.ascontiguousarray(c, np.float32).reshape(-1).tobytes()
    hb = np.ascontiguousarray(h, np.float32).reshape(-1).tobytes()
    return (zlib.crc32(cb) << 32) | zlib.crc32(hb)


class CarryEntry(NamedTuple):
    """One durable chunk-boundary snapshot. `episode_step` = completed
    steps when the carry was captured (a multiple of rollout_len);
    `version` = the tick bundle that served the chunk-fill step."""

    episode_step: int
    version: int
    c: np.ndarray  # f32 [H]
    h: np.ndarray  # f32 [H]


class CarryStore:
    """In-process keep-N carry store (N=2 default — see the module
    docstring for why two is load-bearing). Thread-safe: every mutation
    builds the replacement tuple fully, then publishes it with one dict
    assignment under the lock; `get` snapshots the tuple and matches
    outside any mutation window."""

    def __init__(self, keep: int = 2):
        if keep < 2:
            raise ValueError(
                f"carry store keep must be >= 2 (the previous boundary covers "
                f"the lost-chunk-fill-ack resume), got {keep}"
            )
        self.keep = keep
        self._lock = threading.Lock()
        self._entries: Dict[int, Tuple[CarryEntry, ...]] = {}
        # Counters (lock-guarded writes; stats() snapshots under it).
        self.puts = 0
        self.gets = 0
        self.hits = 0
        self.misses = 0
        self.stale = 0

    def put(self, key: int, episode_step: int, version: int, c, h) -> None:
        entry = CarryEntry(
            episode_step=int(episode_step),
            version=int(version),
            c=np.array(c, np.float32, copy=True).reshape(-1),
            h=np.array(h, np.float32, copy=True).reshape(-1),
        )
        with self._lock:
            prev = self._entries.get(key, ())
            if prev and prev[0].episode_step == entry.episode_step:
                # Same-boundary put REPLACES the head entry: a resumed
                # client re-issuing its chunk-fill step re-writes the
                # boundary it is completing, and shifting here would
                # evict the PREVIOUS entry — the one a second kill
                # before the re-issued ack still needs.
                self._entries[key] = (entry,) + prev[1:]
            else:
                self._entries[key] = (entry,) + prev[: self.keep - 1]
            self.puts += 1

    def get(self, key: int, boundary_step: int) -> Tuple[int, Optional[CarryEntry]]:
        """(status, entry): ST_OK with the exact-match entry, ST_MISS
        for an unknown key, ST_STALE when the key exists but no retained
        entry matches `boundary_step` exactly."""
        with self._lock:
            entries = self._entries.get(key)
            self.gets += 1
            if entries is None:
                self.misses += 1
                return ST_MISS, None
            for e in entries:
                if e.episode_step == int(boundary_step):
                    self.hits += 1
                    return ST_OK, e
            self.stale += 1
            return ST_STALE, None

    def evict(self, key: int) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "serve_handoff_store_sessions": float(len(self._entries)),
                "serve_handoff_store_puts_total": float(self.puts),
                "serve_handoff_store_gets_total": float(self.gets),
                "serve_handoff_store_hits_total": float(self.hits),
                "serve_handoff_store_misses_total": float(self.misses),
                "serve_handoff_store_stale_total": float(self.stale),
            }


class CarryStoreServer:
    """Framed-TCP service over one CarryStore — the shared deployment
    shape (`--serve.handoff_endpoint`). Asyncio on a daemon thread, the
    BrokerServer lifecycle pattern: construction binds nothing,
    `start()` blocks until the listener is up (or raises the boot
    error), `stop()` joins the loop so post-stop counters are exact."""

    def __init__(self, port: int = 0, keep: int = 2, store: Optional[CarryStore] = None):
        self.port = int(port)
        self.store = store if store is not None else CarryStore(keep=keep)
        self.requests_total = 0
        self.bad_requests_total = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._boot_error: Optional[BaseException] = None

    async def _handle(self, reader, writer):
        try:
            while True:
                mtype, payload = await _read_frame(reader)
                self.requests_total += 1
                if mtype == H_PUT:
                    if len(payload) < _PUT_HEAD.size:
                        raise ValueError("truncated carry put")
                    key, ep_step, version, hidden = _PUT_HEAD.unpack_from(payload)
                    expect = _PUT_HEAD.size + 2 * 4 * hidden
                    if len(payload) != expect:
                        raise ValueError(f"carry put size {len(payload)} != {expect}")
                    c = np.frombuffer(payload, np.float32, count=hidden, offset=_PUT_HEAD.size)
                    h = np.frombuffer(
                        payload, np.float32, count=hidden, offset=_PUT_HEAD.size + 4 * hidden
                    )
                    self.store.put(key, ep_step, version, c, h)
                    writer.write(_frame(H_PUT_ACK, _PUT_ACK.pack(key, 1)))
                elif mtype == H_GET:
                    if len(payload) != _GET_REQ.size:
                        raise ValueError("bad carry get")
                    key, boundary = _GET_REQ.unpack(payload)
                    status, entry = self.store.get(key, boundary)
                    if entry is None:
                        body = _GET_HEAD.pack(key, status, 0, 0, 0)
                    else:
                        body = (
                            _GET_HEAD.pack(
                                key, status, entry.episode_step, entry.version, entry.c.size
                            )
                            + entry.c.tobytes()
                            + entry.h.tobytes()
                        )
                    writer.write(_frame(H_GET_RES, body))
                elif mtype == H_STATS:
                    body = json.dumps(self.stats()).encode()
                    writer.write(_frame(H_STATS_RES, body))
                else:
                    raise ValueError(f"unknown store message type {mtype:#x}")
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
            pass
        except ValueError as e:
            self.bad_requests_total += 1
            _log.warning("carry store: bad request: %s", e)
        except asyncio.CancelledError:
            pass
        finally:
            writer.close()

    async def _main(self):
        self._stop_ev = asyncio.Event()
        self._server = await asyncio.start_server(self._handle, "0.0.0.0", self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        await self._stop_ev.wait()
        self._server.close()
        me = asyncio.current_task()
        handlers = [t for t in asyncio.all_tasks() if t is not me]
        for t in handlers:
            t.cancel()
        if handlers:
            await asyncio.gather(*handlers, return_exceptions=True)
        await self._server.wait_closed()

    def _run(self):
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(self._main())
        except BaseException as e:
            self._boot_error = e
            self._started.set()
        finally:
            loop.close()

    def start(self) -> "CarryStoreServer":
        self._thread = threading.Thread(target=self._run, daemon=True, name="carry-store")
        self._thread.start()
        if not self._started.wait(30):
            raise RuntimeError("carry store failed to start (timeout)")
        boot_error = self._boot_error  # one read
        if boot_error is not None:
            raise RuntimeError(f"carry store failed to start: {boot_error}") from boot_error
        return self

    def stop(self) -> None:
        loop = self._loop
        if loop is not None and not loop.is_closed():
            try:
                loop.call_soon_threadsafe(self._stop_ev.set)
            except RuntimeError:
                pass
        if self._thread:
            self._thread.join(timeout=10)

    def stats(self) -> dict:
        out = dict(self.store.stats())
        out["serve_handoff_store_requests_total"] = float(self.requests_total)
        out["serve_handoff_store_bad_requests_total"] = float(self.bad_requests_total)
        return out


class StoreUnavailableError(ConnectionError):
    """The carry store RPC failed (dial, timeout, bad reply). The serve
    server degrades: it keeps serving and counts the miss — resume for
    the affected boundary falls back to abandoning the episode."""


class CarryStoreClient:
    """Async store client for the inference server's event loop. One
    connection, RPCs serialized under a lock (request/response framing;
    puts are a few KB at chunk-boundary cadence — contention is not the
    bottleneck at serve scale, and serialization keeps the demux
    trivial). Every op carries `timeout_s`; a failed op tears the
    connection down and raises StoreUnavailableError — the NEXT op
    redials, so a store restart heals without server restarts."""

    def __init__(self, host: str, port: int, timeout_s: float = 2.0):
        self.host, self.port = host, int(port)
        self.timeout_s = float(timeout_s)
        self._reader = None
        self._writer = None
        self._lock: Optional[asyncio.Lock] = None

    def _drop(self):
        w, self._writer = self._writer, None
        self._reader = None
        if w is not None:
            try:
                w.close()
            except Exception:
                pass

    async def _rpc(self, mtype: int, payload: bytes, expect: int) -> bytes:
        if self._lock is None:
            self._lock = asyncio.Lock()
        async with self._lock:
            # Dial UNDER the lock: two concurrent RPCs after a store
            # restart would otherwise both see _writer None, double-dial,
            # and the loser's reassignment would strand the winner's
            # in-flight read on the wrong connection (and leak a socket).
            if self._writer is None:
                try:
                    self._reader, self._writer = await asyncio.wait_for(
                        asyncio.open_connection(self.host, self.port), self.timeout_s
                    )
                except (OSError, asyncio.TimeoutError) as e:
                    raise StoreUnavailableError(f"carry store dial failed: {e}") from e
            try:
                self._writer.write(_frame(mtype, payload))
                await self._writer.drain()
                rtype, rpayload = await asyncio.wait_for(
                    _read_frame(self._reader), self.timeout_s
                )
            except (OSError, asyncio.TimeoutError, asyncio.IncompleteReadError, ValueError) as e:
                self._drop()
                raise StoreUnavailableError(f"carry store rpc failed: {e}") from e
            if rtype != expect:
                self._drop()
                raise StoreUnavailableError(f"carry store replied {rtype:#x}, want {expect:#x}")
            return rpayload

    async def put(self, key: int, episode_step: int, version: int, c, h) -> None:
        c = np.ascontiguousarray(c, np.float32).reshape(-1)
        h = np.ascontiguousarray(h, np.float32).reshape(-1)
        payload = (
            _PUT_HEAD.pack(int(key), int(episode_step), int(version), c.size)
            + c.tobytes()
            + h.tobytes()
        )
        ack = await self._rpc(H_PUT, payload, H_PUT_ACK)
        akey, ok = _PUT_ACK.unpack(ack)
        if akey != int(key) or not ok:
            raise StoreUnavailableError("carry store put not acknowledged")

    async def get(self, key: int, boundary_step: int) -> Tuple[int, Optional[CarryEntry]]:
        res = await self._rpc(
            H_GET, _GET_REQ.pack(int(key), int(boundary_step)), H_GET_RES
        )
        if len(res) < _GET_HEAD.size:
            raise StoreUnavailableError("truncated carry get reply")
        rkey, status, ep_step, version, hidden = _GET_HEAD.unpack_from(res)
        if rkey != int(key):
            raise StoreUnavailableError("carry get reply key mismatch")
        if status != ST_OK:
            return status, None
        expect = _GET_HEAD.size + 2 * 4 * hidden
        if len(res) != expect:
            raise StoreUnavailableError("carry get reply size mismatch")
        c = np.frombuffer(res, np.float32, count=hidden, offset=_GET_HEAD.size).copy()
        h = np.frombuffer(
            res, np.float32, count=hidden, offset=_GET_HEAD.size + 4 * hidden
        ).copy()
        return ST_OK, CarryEntry(episode_step=ep_step, version=version, c=c, h=h)

    async def close(self) -> None:
        self._drop()


def parse_store_endpoints(spec: str) -> list:
    """Parse a comma-separated store endpoint list (`host:port,...`).
    Loud on malformation (the parse_endpoints discipline): a typo'd
    store list must fail at boot, not at first failover."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        host, sep, port = part.rpartition(":")
        if not part or not sep or not port.isdigit():
            raise ValueError(
                f"malformed store endpoint {part!r} in {spec!r} (want host:port[,host:port...])"
            )
        out.append((host or "127.0.0.1", int(port), part))
    return out


def rendezvous_store_order(key: int, endpoints) -> list:
    """The key's shard preference order: endpoint indices by descending
    rendezvous weight. The EXACT formula of transport/fabric.py's
    rendezvous_order, so store placement inherits the same proven
    property: removing an endpoint never re-routes keys between
    survivors, and a key moves only TO an added shard."""
    import zlib

    return sorted(
        range(len(endpoints)),
        key=lambda i: zlib.crc32(f"{key}|{endpoints[i]}".encode()),
        reverse=True,
    )


class ShardedCarryStore:
    """The CarryStoreClient API over N store shards, placed by
    rendezvous hash of client_key (`--serve.handoff_endpoint` grows a
    comma list; one endpoint = the plain single-store path, untouched).

    - **put** goes to the key's rendezvous PRIMARY only. Write-ahead
      and keep-two are per-shard properties and hold unchanged there;
      a failed primary put raises StoreUnavailableError and the server
      degrades exactly as with one store.
    - **get** walks the key's FULL preference order until an exact
      match. After a shard ADD, a pre-reshard boundary still lives on
      its old primary — which stays in the walk, so the resume finds
      it. Reading only the new primary would abandon episodes the walk
      saves.
    - A shard RPC error during the walk skips to the next shard; if no
      exact match surfaced AND any shard errored, the whole get raises
      (the erroring shard may hold the match — a silent MISS here would
      turn a store outage into a wrong abandon verdict).
    """

    def __init__(self, endpoints, timeout_s: float = 2.0, clients=None):
        if isinstance(endpoints, str):
            endpoints = [p[2] for p in parse_store_endpoints(endpoints)]
        self.endpoints = [str(e).strip() for e in endpoints]
        if not self.endpoints:
            raise ValueError("sharded carry store needs at least one endpoint")
        if clients is not None:
            if len(clients) != len(self.endpoints):
                raise ValueError("clients/endpoints length mismatch")
            self.clients = list(clients)
        else:
            self.clients = []
            for ep in self.endpoints:
                host, _, port = ep.rpartition(":")
                self.clients.append(
                    CarryStoreClient(host or "127.0.0.1", int(port), timeout_s=timeout_s)
                )

    def order(self, key: int) -> list:
        return rendezvous_store_order(int(key), self.endpoints)

    async def put(self, key, episode_step, version, c, h) -> None:
        primary = self.order(key)[0]
        await self.clients[primary].put(key, episode_step, version, c, h)

    async def get(self, key, boundary_step):
        last_status = ST_MISS
        errors = 0
        for i in self.order(key):
            try:
                status, entry = await self.clients[i].get(key, boundary_step)
            except StoreUnavailableError:
                errors += 1
                continue
            if status == ST_OK:
                return ST_OK, entry
            if status == ST_STALE:
                last_status = ST_STALE
        if errors:
            raise StoreUnavailableError(
                f"carry get: {errors} of {len(self.clients)} shards unavailable "
                f"and no surviving shard holds boundary {boundary_step}"
            )
        return last_status, None

    async def close(self) -> None:
        for c in self.clients:
            await c.close()


class LocalCarryStore:
    """The CarryStoreClient API over an in-process CarryStore — tests,
    soaks, and co-located single-host deployments skip the wire."""

    def __init__(self, store: Optional[CarryStore] = None, keep: int = 2):
        self.store = store if store is not None else CarryStore(keep=keep)

    async def put(self, key, episode_step, version, c, h) -> None:
        self.store.put(key, episode_step, version, c, h)

    async def get(self, key, boundary_step):
        return self.store.get(key, boundary_step)

    async def close(self) -> None:
        pass


def main(argv=None):
    from dotaclient_tpu_torch.config import HandoffConfig, parse_config

    logging.basicConfig(level=logging.INFO)
    cfg = parse_config(HandoffConfig(), argv)
    server = CarryStoreServer(port=cfg.port, keep=cfg.keep).start()
    obs = None
    if cfg.obs.enabled:
        from dotaclient_tpu_torch.obs import ObsRuntime

        obs = ObsRuntime.create(cfg.obs, role="carry-store")
        obs.serve_metrics([server.stats], device=None)  # no net, no torch: no profiler
    ready = {"serving": True, "port": server.port}
    if cfg.stores:
        # validate + surface the declared shard ring at boot: a ring the
        # serve replicas disagree with shows up here, not as misses
        ready["stores"] = [p[2] for p in parse_store_endpoints(cfg.stores)]
    print(json.dumps(ready), flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        if obs is not None:
            obs.close()


if __name__ == "__main__":
    main()
