"""LIF001/LIF002 bad corpus: lease leaks, double release, release before
the copy's CUDA event completed, and drain-invisible stations. Never
imported."""

import queue
import threading


class LeakyPacker:
    def __init__(self, ring):
        self._ring = ring

    def pack_leak(self, items):
        # LIF001: the slot is never released nor returned
        slot = self._ring.acquire(timeout=0.2)
        return len(items)

    def pack_raise_leak(self, items):
        slot = self._ring.acquire(timeout=0.2)
        if not items:
            # LIF001: raise on the exception edge with no release before it
            raise ValueError("empty batch")
        slot.release()
        return len(items)

    def pack_double_release(self, items):
        slot = self._ring.acquire(timeout=0.2)
        slot.release()
        # LIF001: straight-line double release — free-queue duplicate
        slot.release()
        return len(items)


class DoubleBufferPacker:
    """Two acquires in one function: the SECOND lease's leak must fire
    even though the first checks out clean."""

    def __init__(self, ring):
        self._ring = ring

    def pack_pair(self, items):
        a = self._ring.acquire(timeout=0.2)
        # LIF001: b is never released nor returned
        b = self._ring.acquire(timeout=0.2)
        a.release()
        return len(items)


class EarlyReleaseFetcher:
    """The early-release shape: the lease goes back at copy dispatch."""

    def __init__(self, staging, io):
        self.staging = staging
        self.io = io

    def fetch(self, groups):
        payload = self.io.transfer(groups)
        lease = self.staging.last_batch_lease
        if lease is not None:
            # LIF001: no event of this copy is fenced before the release
            lease.release()
        return payload


class WrongFenceFetcher:
    """An event IS synchronised, but it is the step's event — not this
    batch's copy event — which orders nothing about the copy the lease
    guards."""

    def __init__(self, staging, io):
        self.staging = staging
        self.io = io

    def fetch(self, groups, step_done):
        out, ready = self.io.transfer(groups)
        lease = self.staging.last_batch_lease
        if lease is not None:
            step_done.synchronize()
            # LIF001: the fence is not THIS copy's event
            lease.release()
        return out


class EagerReaper:
    """The reaper with its query dropped, and a teardown that releases
    every held lease with no event of its copy at all."""

    def __init__(self):
        self._held = []

    def reap(self):
        for lease, ready in self._held:
            # LIF001: released whether or not the copy has completed
            lease.release()
        self._held = []

    def release_all(self):
        for lease, _ in self._held:
            # LIF001: no event of the copy is synchronised
            lease.release()
        self._held = []


class LossyDrainBuffer:
    """The lost-frame drain shape: a station drained() cannot see, and a popper
    holding frames in locals with no in-flight flag."""

    def __init__(self, broker):
        self.broker = broker
        self._ready = queue.Queue(maxsize=2)
        # LIF002: a queue frames can occupy that drained() never checks
        self._side = queue.Queue(maxsize=4)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        # LIF002: pops frames, sets no flag drained() reads — frames in
        # this thread's locals are invisible to the drain
        while not self._stop.is_set():
            frames = self.broker.consume_experience(max_items=4, timeout=0.2)
            if frames:
                self._side.put(frames)

    def drained(self):
        return self._ready.empty()
