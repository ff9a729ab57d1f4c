"""LIF001/LIF002 good corpus: the sanctioned lease and drain shapes —
must lint clean under every rule. Never imported."""

import queue
import threading


class CleanPacker:
    """Release on the error edge, ownership transfer on success."""

    def __init__(self, ring):
        self._ring = ring

    def _fill(self, slot, items):
        return None

    def pack(self, items):
        slot = self._ring.acquire(timeout=0.2)
        err = self._fill(slot, items)
        if err is not None:
            slot.release()
            raise err
        # returning the slot transfers ownership to the fetcher
        return slot


class EventFencedFetcher:
    """Release only after this copy's event is synchronised."""

    def __init__(self, staging, io):
        self.staging = staging
        self.io = io

    def fetch(self, groups):
        payload = self.io.transfer(groups)
        lease = self.staging.last_batch_lease
        if lease is not None:
            payload[1].synchronize()
            lease.release()
        return payload


class GuardedSyncFetcher:
    """No event means a synchronous copy (a CPU tensor): the guarded
    synchronize dominates the release all the same."""

    def __init__(self, staging, io):
        self.staging = staging
        self.io = io

    def fetch(self, groups):
        out, ready = self.io.transfer(groups)
        lease = self.staging.last_batch_lease
        if ready is not None:
            ready.synchronize()
        if lease is not None:
            lease.release()
        return out


class QueryingReaper:
    """The learner's lease reaper: release a held lease only once its
    copy's event has been observed complete, wait on the oldest when
    every slot is held, and synchronise each event at teardown."""

    def __init__(self):
        self._held = []

    def reap(self, depth):
        if len(self._held) >= depth:
            ready = self._held[0][1]
            if ready is not None:
                ready.synchronize()
        keep = []
        for lease, ready in self._held:
            if ready is None or ready.query():
                lease.release()
            else:
                keep.append((lease, ready))
        self._held = keep

    def release_all(self):
        for lease, ready in self._held:
            if ready is not None:
                ready.synchronize()
            lease.release()
        self._held = []


class FinallyPacker:
    """The idiomatic cleanup shape: a finally-block release covers every
    raise inside the try by construction — must lint clean."""

    def __init__(self, ring):
        self._ring = ring

    def pack(self, items):
        slot = self._ring.acquire(timeout=0.2)
        try:
            if not items:
                raise ValueError("empty batch")
            return list(items)
        finally:
            slot.release()


class NotARingAcquire:
    """A 'ring'-substring lock name is NOT a transfer-ring lease: the
    LIF001 receiver match is anchored to a terminal ring component, so
    this ordinary acquire/release pair must lint clean."""

    def __init__(self):
        self._wiring_lock = threading.Lock()

    def poll(self):
        ok = self._wiring_lock.acquire(timeout=1.0)
        if ok:
            self._wiring_lock.release()
        return ok


class CleanDrainBuffer:
    """Every station visible to drained(): the queue is checked, the
    popper publishes its in-flight locals via a flag under the lock."""

    def __init__(self, broker):
        self.broker = broker
        self._ready = queue.Queue(maxsize=2)
        self._popping = False
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            with self._lock:
                self._popping = True
            frames = self.broker.consume_experience(max_items=4, timeout=0.2)
            if frames:
                self._ready.put(frames)
            with self._lock:
                self._popping = False

    def drained(self):
        with self._lock:
            if self._popping:
                return False
        return self._ready.empty()
