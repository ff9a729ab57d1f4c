"""In-process broker (own copy of dotaclient_tpu/transport/memory.py).

Hubs live in this module's own registry: a handle made here and one made
by the reference package under the same `mem://` name never meet. Hand
the learner the reference's broker object to join a JAX actor fleet.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List, Optional, Tuple

from dotaclient_tpu_torch.transport.base import Broker, BrokerShedError

_REGISTRY: Dict[str, "_Hub"] = {}
_REGISTRY_LOCK = threading.Lock()


class _Hub:
    """Shared state for all MemoryBroker handles with the same name."""

    def __init__(self, maxlen: int, shed_high: int = 0, shed_low: int = 0):
        if shed_high and shed_low >= shed_high:
            raise ValueError(f"shed_low={shed_low} must be below shed_high={shed_high}")
        self.lock = threading.Lock()
        self.not_empty = threading.Condition(self.lock)
        self.experience: collections.deque = collections.deque(maxlen=maxlen)
        self.dropped = 0
        # Watermark admission control (0 = off): above shed_high publishes
        # are refused until the depth falls to shed_low.
        self.shed_high, self.shed_low = shed_high, shed_low
        self.shedding = False
        self.shed_total = 0
        self.weights: Optional[Tuple[int, bytes]] = None  # (seq, frame)
        self.weights_seq = 0


def _hub(name: str, maxlen: int, shed_high: int = 0, shed_low: int = 0) -> _Hub:
    with _REGISTRY_LOCK:
        if name not in _REGISTRY:
            _REGISTRY[name] = _Hub(maxlen, shed_high=shed_high, shed_low=shed_low)
        return _REGISTRY[name]


def reset(name: str = "default") -> None:
    """Drop a hub (test isolation)."""
    with _REGISTRY_LOCK:
        _REGISTRY.pop(name, None)


class MemoryBroker(Broker):
    def __init__(self, name: str = "default", maxlen: int = 4096, shed_high: int = 0, shed_low: int = 0):
        self._hub = _hub(name, maxlen, shed_high=shed_high, shed_low=shed_low)
        self._seen_weights_seq = 0
        self.shed_observed = 0

    def publish_experience(self, data: bytes) -> None:
        h = self._hub
        with h.lock:
            if h.shed_high:
                depth = len(h.experience)
                if not h.shedding and depth >= h.shed_high:
                    h.shedding = True
                elif h.shedding and depth <= h.shed_low:
                    h.shedding = False
                if h.shedding:
                    h.shed_total += 1
                    self.shed_observed += 1
                    raise BrokerShedError("broker shed the publish (queue above watermark)")
            if len(h.experience) == h.experience.maxlen:
                h.dropped += 1
            h.experience.append(data)
            h.not_empty.notify()

    def consume_experience(self, max_items: int, timeout: Optional[float] = None) -> List[bytes]:
        h = self._hub
        out: List[bytes] = []
        with h.not_empty:
            if not h.experience:
                h.not_empty.wait(timeout)
            while h.experience and len(out) < max_items:
                out.append(h.experience.popleft())
        return out

    def publish_weights(self, data: bytes) -> None:
        h = self._hub
        with h.lock:
            h.weights_seq += 1
            h.weights = (h.weights_seq, data)

    def poll_weights(self) -> Optional[bytes]:
        h = self._hub
        with h.lock:
            if h.weights is None or h.weights[0] <= self._seen_weights_seq:
                return None
            self._seen_weights_seq = h.weights[0]
            return h.weights[1]

    def experience_depth(self) -> int:
        with self._hub.lock:
            return len(self._hub.experience)
