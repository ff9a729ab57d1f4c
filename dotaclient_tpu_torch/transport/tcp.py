"""Self-contained TCP experience broker (own copy of
dotaclient_tpu/transport/tcp.py): a bounded drop-oldest experience queue
and a latest-wins weight fanout over one TCP port. The server is
`python -m dotaclient_tpu_torch.transport.tcp_server`; the client
(`TcpBroker`) implements the Broker interface. The bytes on the wire are
the reference's, so either package's client talks to either server.

Framing: every message is  u32 payload_len | u8 type | payload.
  0x01 PUB_EXP   payload = experience frame            → 0x81 ack (legacy:
                 shed by closing the connection)
  0x02 CONSUME   payload = u16 max_items, f32 timeout  → 0x82 reply
  0x03 PUB_W     payload = weight frame                → 0x81 ack
  0x04 GET_W     payload = u32 last_seen_seq           → 0x84 reply
  0x05 DEPTH     no payload                            → 0x85 reply
  0x06 STATS     no payload                            → 0x87 reply
  0x07 PUB_EXP2  payload = experience frame            → 0x81 ack | 0x86 shed
  0x08 PUB_EXPP  payload = f32 priority + frame        → 0x81 ack | 0x86 shed
  0x09 STATS2    no payload                            → 0x88 reply
  0x0A GET_BLOCK DTB1 in-network assembly: not ported (ROADMAP A.10f); the
                 server closes the connection, as an unarmed reference
                 shard does.
  0x81 ack       empty (a client detects a dead broker by the missing ack)
  0x82 reply     u16 count, then per frame u32 len + bytes
  0x84 reply     u32 seq (0 = nothing newer), frame bytes
  0x85 reply     u32 depth, u32 dropped
  0x86 shed      empty: refused at admission, not enqueued
  0x87 reply     u32 x6: depth, dropped, shed, enqueued, popped, reply_lost
  0x88 reply     u32 x8: the six above, evicted_low, priority_mode

Admission control (shed_high/shed_low, 0 = off): from depth >= shed_high
the broker refuses experience publishes until the queue drains to
<= shed_low (hysteresis). With priority admission on, a PUB_EXPP arriving
while shedding evicts the lowest-effective-priority resident (priority
halving every prio_half_life_s of residence) when the newcomer beats it.

The client keeps two connections, one for experience and one for
weights, so a long blocking consume never stalls a weight poll.
"""

from __future__ import annotations

import asyncio
import collections
import socket
import struct
import threading
import time
from typing import List, Optional

from dotaclient_tpu_torch.transport.base import Broker, BrokerShedError, RetryPolicy

_LEN = struct.Struct("<I")
_TYPE = struct.Struct("<B")

PUB_EXP, CONSUME, PUB_W, GET_W, DEPTH, STATS, PUB_EXP2 = 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07
PUB_EXPP, STATS2, GET_BLOCK = 0x08, 0x09, 0x0A
R_ACK, R_CONSUME, R_GET_W, R_DEPTH, R_SHED, R_STATS, R_STATS2 = 0x81, 0x82, 0x84, 0x85, 0x86, 0x87, 0x88

MAX_FRAME = 256 * 1024 * 1024
_POLL_SLICE = 30.0  # max per-request server-side wait when blocking forever

_ASSEMBLY = "DTB1 in-network batch assembly (GET_BLOCK) is not ported yet (ROADMAP A.10f)"


# --------------------------------------------------------------------- server


class BrokerServer:
    """Asyncio broker server; `start()` runs it in a daemon thread."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 13370,
        maxlen: int = 4096,
        shed_high: int = 0,
        shed_low: int = 0,
        priority_shed: bool = False,
        prio_half_life_s: float = 8.0,
        assemble: bool = False,
    ):
        if assemble:
            raise NotImplementedError(_ASSEMBLY)
        if shed_high and shed_low >= shed_high:
            raise ValueError(f"shed_low={shed_low} must be below shed_high={shed_high} (hysteresis band)")
        self.host, self.port, self.maxlen = host, port, maxlen
        self.shed_high, self.shed_low = shed_high, shed_low
        self._shedding = False
        # Priority admission: (priority, enqueue time) per resident, in
        # lockstep with `experience` (one maxlen, so drop-oldest evicts both).
        self.priority_shed = priority_shed
        self.prio_half_life_s = prio_half_life_s
        self._prio_meta: Optional[collections.deque] = collections.deque(maxlen=maxlen) if priority_shed else None
        self.evicted_low = 0
        self.experience: collections.deque = collections.deque(maxlen=maxlen)
        self.dropped = 0
        # Conservation ledger (loop-thread-written): every experience frame a
        # client sent is enqueued or shed; every enqueued frame is popped,
        # dropped, evicted or still resident; a popped frame whose reply
        # failed mid-write is reply_lost.
        self.shed_total = 0
        self.shed_closes = 0
        self.enqueued_total = 0
        self.popped_total = 0
        self.reply_lost_frames = 0
        # The recovery probe (chaos/controller.py): monotonic time of this
        # server's first enqueue, so a restarted broker's recovery reads
        # as restart to first frame landed.
        self.first_enqueue_t: Optional[float] = None
        self.consume_waiters = 0  # handlers parked in the CONSUME wait
        self.weights: Optional[bytes] = None
        self.weights_seq = 0
        self._cond: Optional[asyncio.Condition] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._boot_error: Optional[BaseException] = None
        self._conns: set = set()

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._conns.add(writer)
        try:
            while True:
                hdr = await reader.readexactly(_LEN.size + _TYPE.size)
                (n,) = _LEN.unpack_from(hdr)
                (mtype,) = _TYPE.unpack_from(hdr, _LEN.size)
                if n > MAX_FRAME:
                    raise ValueError("frame too large")
                payload = await reader.readexactly(n) if n else b""
                await self._dispatch(mtype, payload, writer)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except asyncio.CancelledError:
            pass
        finally:
            self._conns.discard(writer)
            writer.close()

    def _admit(self) -> bool:
        """Admission for one experience publish (under the cond), with
        hysteresis between shed_high and shed_low."""
        if not self.shed_high:
            return True
        depth = len(self.experience)
        if not self._shedding and depth >= self.shed_high:
            self._shedding = True
        elif self._shedding and depth <= self.shed_low:
            self._shedding = False
        return not self._shedding

    def _min_priority_index(self, now: float):
        """(index, effective priority) of the lowest-effective-priority
        resident: priority halves every prio_half_life_s of residence."""
        best_i, best_p = -1, float("inf")
        for i, (p, t_enq) in enumerate(self._prio_meta):
            eff = p * 0.5 ** ((now - t_enq) / max(self.prio_half_life_s, 1e-9))
            if eff < best_p:
                best_i, best_p = i, eff
        return best_i, best_p

    def _enqueue(self, frame: bytes, priority: float) -> None:
        if len(self.experience) == self.experience.maxlen:
            self.dropped += 1
        self.experience.append(frame)
        if self._prio_meta is not None:
            self._prio_meta.append((priority, time.monotonic()))
        self.enqueued_total += 1
        if self.first_enqueue_t is None:
            self.first_enqueue_t = time.monotonic()

    async def _dispatch(self, mtype: int, payload: bytes, writer: asyncio.StreamWriter):
        assert self._cond is not None
        if mtype in (PUB_EXP, PUB_EXP2, PUB_EXPP):
            priority = 0.0
            if mtype == PUB_EXPP:
                if len(payload) < 4:
                    raise ValueError("PUB_EXPP payload shorter than its priority prefix")
                (priority,) = struct.unpack_from("<f", payload)
                payload = payload[4:]
            async with self._cond:
                admitted = self._admit()
                if not admitted and mtype == PUB_EXPP and self._prio_meta is not None and self.experience:
                    # evict the lowest-priority resident if the newcomer beats it
                    idx, min_eff = self._min_priority_index(time.monotonic())
                    if idx >= 0 and priority > min_eff:
                        del self.experience[idx]
                        del self._prio_meta[idx]
                        self.evicted_low += 1
                        admitted = True
                if admitted:
                    self._enqueue(payload, priority)
                    self._cond.notify_all()
                else:
                    self.shed_total += 1
            if admitted:
                await self._reply(writer, R_ACK, b"")
            elif mtype in (PUB_EXP2, PUB_EXPP):
                await self._reply(writer, R_SHED, b"")
            else:
                # a legacy client cannot parse 0x86; its reconnect loop's
                # backoff becomes the throttle
                self.shed_closes += 1
                writer.close()
                raise ConnectionResetError("shed: legacy publisher connection closed")
        elif mtype == CONSUME:
            max_items, timeout = struct.unpack("<Hf", payload)
            async with self._cond:
                if not self.experience and timeout > 0:
                    self.consume_waiters += 1
                    try:
                        await asyncio.wait_for(self._cond.wait_for(lambda: len(self.experience) > 0), timeout)
                    except asyncio.TimeoutError:
                        pass
                    finally:
                        self.consume_waiters -= 1
                frames = []
                while self.experience and len(frames) < max_items:
                    frames.append(self.experience.popleft())
                    if self._prio_meta is not None:
                        self._prio_meta.popleft()
                self.popped_total += len(frames)
            out = [struct.pack("<H", len(frames))]
            for f in frames:
                out.append(_LEN.pack(len(f)))
                out.append(f)
            try:
                await self._reply(writer, R_CONSUME, b"".join(out))
            except BaseException:
                # popped frames whose reply never completed leave with this
                # broker, counted (CancelledError is the kill path)
                self.reply_lost_frames += len(frames)
                raise
        elif mtype == GET_BLOCK:
            raise ValueError(_ASSEMBLY)
        elif mtype == STATS:
            await self._reply(writer, R_STATS, struct.pack("<6I", *self._counters()))
        elif mtype == STATS2:
            await self._reply(
                writer,
                R_STATS2,
                struct.pack("<8I", *self._counters(), self.evicted_low, 1 if self.priority_shed else 0),
            )
        elif mtype == PUB_W:
            self.weights_seq += 1
            self.weights = payload
            await self._reply(writer, R_ACK, b"")
        elif mtype == GET_W:
            (seen,) = struct.unpack("<I", payload)
            if self.weights is not None and self.weights_seq > seen:
                await self._reply(writer, R_GET_W, struct.pack("<I", self.weights_seq) + self.weights)
            else:
                await self._reply(writer, R_GET_W, struct.pack("<I", 0))
        elif mtype == DEPTH:
            await self._reply(writer, R_DEPTH, struct.pack("<II", len(self.experience), self.dropped))
        else:
            raise ValueError(f"unknown message type {mtype:#x}")

    def _counters(self):
        return (len(self.experience), self.dropped, self.shed_total, self.enqueued_total, self.popped_total,
                self.reply_lost_frames)

    async def _reply(self, writer: asyncio.StreamWriter, mtype: int, payload: bytes):
        writer.write(_LEN.pack(len(payload)) + _TYPE.pack(mtype) + payload)
        await writer.drain()

    async def _main(self):
        self._cond = asyncio.Condition()
        self._stop_ev = asyncio.Event()
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        self._started.set()
        await self._stop_ev.wait()
        # Stop accepting, cancel every handler (parked in readexactly or the
        # consume wait), abort transports, then wait for the server.
        self._server.close()
        me = asyncio.current_task()
        handlers = [t for t in asyncio.all_tasks() if t is not me]
        for t in handlers:
            t.cancel()
        for w in list(self._conns):
            w.transport.abort()
        if handlers:
            await asyncio.gather(*handlers, return_exceptions=True)
        await self._server.wait_closed()

    def start(self) -> "BrokerServer":
        self._thread = threading.Thread(target=self._run, daemon=True, name="broker-server")
        self._thread.start()
        if not self._started.wait(10):
            raise RuntimeError("broker server failed to start (timeout)")
        boot_error = self._boot_error
        if boot_error is not None:
            raise RuntimeError(f"broker server failed to start: {boot_error}") from boot_error
        return self

    def _run(self):
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)
        try:
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

    def ledger(self) -> dict:
        """Conservation counters; exact after stop(). At any quiescent point
        `enqueued == popped + dropped_oldest + evicted_low + resident`."""
        return {
            "enqueued": self.enqueued_total,
            "popped": self.popped_total,
            "dropped_oldest": self.dropped,
            "shed": self.shed_total,
            "shed_closes": self.shed_closes,
            "reply_lost": self.reply_lost_frames,
            "evicted_low": self.evicted_low,
            "resident": len(self.experience),
        }

    def stop(self):
        loop = self._loop
        if loop is not None and not loop.is_closed():
            try:
                loop.call_soon_threadsafe(self._stop_ev.set)
            except RuntimeError:
                pass  # the loop exited between the check and the call
        if self._thread:
            self._thread.join(timeout=5)


# --------------------------------------------------------------------- client


class _Conn:
    """One blocking framed connection with its own lock. A failed request
    reconnects and resends under the RetryPolicy (jittered capped backoff)
    for up to `retry.window_s` seconds, then raises. A resend after a
    half-written request can at worst duplicate one experience frame; a
    CONSUME whose reply times out may lose the frames popped for it."""

    def __init__(self, addr, connect_timeout: float, retry: Optional[RetryPolicy] = None):
        self.addr = addr
        self.connect_timeout = connect_timeout
        self.retry = retry if retry is not None else RetryPolicy()
        self.lock = threading.Lock()
        self.sock: Optional[socket.socket] = None
        self.generation = -1
        self._connect()  # fail fast at boot: a wrong URL should not retry

    def _connect(self):
        self.sock = socket.create_connection(self.addr, timeout=self.connect_timeout)
        self.generation += 1

    def request(self, mtype: int, payload: bytes, expected_reply: Optional[int],
                read_timeout: float = 10.0) -> Optional[bytes]:
        """Send one request and read its reply, reconnecting on failure.
        `read_timeout` bounds the wait for the reply, so a broker that died
        without a reset still lands in the reconnect path."""
        with self.lock:
            deadline = time.monotonic() + self.retry.window_s
            backoff = self.retry.backoff_base_s
            while True:
                try:
                    if self.sock is None:
                        self._connect()
                    return self._request_once(mtype, payload, expected_reply, read_timeout)
                except BrokerShedError:
                    raise  # the broker is alive; the caller throttles
                except (ConnectionError, OSError):
                    if self.sock is not None:
                        try:
                            self.sock.close()
                        except OSError:
                            pass
                        self.sock = None
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(self.retry.sleep_for(backoff))
                    backoff = self.retry.next_backoff(backoff)

    def _request_once(self, mtype: int, payload: bytes, expected_reply: Optional[int], read_timeout: float):
        # the send gets its own generous bound: a large weight frame into a
        # backpressured but live broker must not die on the reply deadline
        self.sock.settimeout(max(read_timeout, 60.0))
        self.sock.sendall(_LEN.pack(len(payload)) + _TYPE.pack(mtype) + payload)
        if expected_reply is None:
            return None
        self.sock.settimeout(read_timeout)
        hdr = self._recv_exact(_LEN.size + _TYPE.size)
        (n,) = _LEN.unpack_from(hdr)
        (rtype,) = _TYPE.unpack_from(hdr, _LEN.size)
        if rtype == R_SHED and expected_reply == R_ACK:
            if n:
                self._recv_exact(n)  # keep the stream framed
            raise BrokerShedError("broker shed the publish (queue above watermark)")
        if rtype != expected_reply:
            raise ValueError(f"unexpected reply type {rtype:#x}")
        return self._recv_exact(n) if n else b""

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        while n:
            chunk = self.sock.recv(n)
            if not chunk:
                raise ConnectionError("broker connection closed")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def close(self):
        with self.lock:
            if self.sock is not None:
                self.sock.close()


class TcpBroker(Broker):
    """Blocking, thread-safe client of BrokerServer (either package's)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 13370, connect_timeout: float = 10.0,
                 retry: Optional[RetryPolicy] = None):
        self._exp = _Conn((host, port), connect_timeout, retry=retry)
        self._w = _Conn((host, port), connect_timeout, retry=retry)
        self._seen_weights_seq = 0
        self._w_generation = self._w.generation
        self.shed_observed = 0  # publishes refused at admission

    def publish_experience(self, data: bytes) -> None:
        try:
            self._exp.request(PUB_EXP2, data, R_ACK)
        except BrokerShedError:
            self.shed_observed += 1
            raise

    def publish_experience_prioritized(self, data: bytes, priority: float) -> None:
        """PUB_EXPP: publish with an admission priority; a priority-shed
        broker evicts its lowest-priority resident instead of refusing."""
        try:
            self._exp.request(PUB_EXPP, struct.pack("<f", priority) + data, R_ACK)
        except BrokerShedError:
            self.shed_observed += 1
            raise

    def consume_experience(self, max_items: int, timeout: Optional[float] = None) -> List[bytes]:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            wait = _POLL_SLICE if deadline is None else max(0.0, deadline - time.monotonic())
            slice_wait = min(wait, _POLL_SLICE)
            payload = self._exp.request(CONSUME, struct.pack("<Hf", max_items, slice_wait), R_CONSUME,
                                        read_timeout=slice_wait + 10.0)
            (count,) = struct.unpack_from("<H", payload)
            if count or (deadline is not None and time.monotonic() >= deadline):
                break
        off = 2
        frames = []
        for _ in range(count):
            (n,) = _LEN.unpack_from(payload, off)
            off += _LEN.size
            frames.append(payload[off : off + n])
            off += n
        return frames

    def consume_block(self, spec, max_rows: int, timeout: Optional[float] = None) -> bytes:
        raise NotImplementedError(_ASSEMBLY)

    def publish_weights(self, data: bytes) -> None:
        self._w.request(PUB_W, data, R_ACK)

    def poll_weights(self) -> Optional[bytes]:
        # a restarted broker restarts its weight sequence at 1: after a
        # reconnect the high-water mark resets
        if self._w.generation != self._w_generation:
            self._w_generation = self._w.generation
            self._seen_weights_seq = 0
        payload = self._w.request(GET_W, struct.pack("<I", self._seen_weights_seq), R_GET_W)
        (seq,) = struct.unpack_from("<I", payload)
        if seq == 0:
            return None
        self._seen_weights_seq = seq
        return payload[4:]

    def experience_depth(self) -> int:
        depth, _dropped = struct.unpack("<II", self._w.request(DEPTH, b"", R_DEPTH))
        return depth

    def stats(self) -> dict:
        """Broker-side counters (R_STATS)."""
        depth, dropped, shed, enqueued, popped, reply_lost = struct.unpack("<6I", self._w.request(STATS, b"", R_STATS))
        return {"depth": depth, "dropped_oldest": dropped, "shed": shed, "enqueued": enqueued, "popped": popped,
                "reply_lost": reply_lost}

    def stats2(self) -> dict:
        """stats() plus the priority-admission eviction count (R_STATS2)."""
        vals = struct.unpack("<8I", self._w.request(STATS2, b"", R_STATS2))
        keys = ("depth", "dropped_oldest", "shed", "enqueued", "popped", "reply_lost", "evicted_low", "priority_mode")
        return dict(zip(keys, vals))

    def close(self) -> None:
        self._exp.close()
        self._w.close()
