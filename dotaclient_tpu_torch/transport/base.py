"""Broker abstraction, the actor↔learner boundary (own copy of
dotaclient_tpu/transport/base.py).

Semantics every implementation honours:
- experience: bounded FIFO queue, oldest dropped on overflow (stale
  experience is worthless to PPO; bounding the queue is the backpressure);
- weights: fanout with latest-wins; subscribers poll and only ever see
  the newest frame, never a backlog.

The port has the in-process `mem://<name>` broker. The learner also
accepts any object with the `Broker` surface, so a test can hand it the
reference package's broker and a JAX actor fleet can feed it.
"""

from __future__ import annotations

import abc
from typing import List, Optional


class BrokerShedError(RuntimeError):
    """A publish was refused at admission by an overloaded broker (the
    watermark load-shed). Not a ConnectionError: the connection is
    healthy, and the producer should drop or delay the frame and back off."""


class Broker(abc.ABC):
    @abc.abstractmethod
    def publish_experience(self, data: bytes) -> None: ...

    @abc.abstractmethod
    def consume_experience(self, max_items: int, timeout: Optional[float] = None) -> List[bytes]:
        """Up to `max_items` frames; blocks up to `timeout` (None = forever)
        for the FIRST frame, then drains without waiting."""

    @abc.abstractmethod
    def publish_weights(self, data: bytes) -> None: ...

    @abc.abstractmethod
    def poll_weights(self) -> Optional[bytes]:
        """Latest weight frame if newer than the last one returned to this
        client, else None."""

    def experience_depth(self) -> int:
        """Current queue depth, if the implementation can know it cheaply."""
        return -1

    def close(self) -> None:
        pass


def connect(url: str, **kw) -> Broker:
    """A broker for `url`. Only `mem://<name>` is ported; the network
    clients and the retry policy their reconnect loops share come with
    ROADMAP A.10d."""
    if url.startswith("mem://") and "," not in url:
        from dotaclient_tpu_torch.transport.memory import MemoryBroker

        return MemoryBroker(url[len("mem://") :] or "default", **kw)
    if "," in url or url.startswith(("tcp://", "amqp://")):
        raise NotImplementedError(
            f"broker url {url!r}: only mem:// is ported; the tcp://, amqp:// and fabric "
            f"(comma-separated shard list) clients are ROADMAP A.10d"
        )
    raise ValueError(f"unknown broker url scheme: {url!r}")
