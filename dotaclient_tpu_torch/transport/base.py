"""Broker abstraction, the actor↔learner boundary (own copy of
dotaclient_tpu/transport/base.py).

Semantics every implementation honours:
- experience: bounded FIFO queue, oldest dropped on overflow (stale
  experience is worthless to PPO; bounding the queue is the backpressure);
- weights: fanout with latest-wins; subscribers poll and only ever see
  the newest frame, never a backlog.

Schemes: `mem://<name>` (in-process), `tcp://host:port` (the framework's
own broker, transport/tcp.py; its server is
`python -m dotaclient_tpu_torch.transport.tcp_server`), `amqp://...`
(RabbitMQ through `pika`, transport/rmq.py, the reference deployment's
broker) and a comma-separated list of them, the broker fabric
(transport/fabric.py; a shard is
`python -m dotaclient_tpu_torch.transport.fabric`). The learner also
accepts any object with the `Broker` surface, so a test can hand it the
reference package's broker and a JAX actor fleet can feed it.
"""

from __future__ import annotations

import abc
import random
from dataclasses import dataclass
from typing import List, Optional


class BrokerShedError(RuntimeError):
    """A publish was refused at admission by an overloaded broker (the
    watermark load-shed). Not a ConnectionError: the connection is
    healthy, and the producer should drop or delay the frame and back off."""


@dataclass
class RetryPolicy:
    """Capped exponential backoff with uniform jitter: the tcp client's
    reconnect loop (config.py RetryConfig is its flag surface). `rng` is
    an explicit `random.Random` for deterministic tests; None draws from
    the module's shared stream."""

    window_s: float = 60.0
    backoff_base_s: float = 0.1
    backoff_cap_s: float = 2.0
    jitter: float = 0.5
    rng: Optional[random.Random] = None

    @classmethod
    def from_config(cls, cfg, rng: Optional[random.Random] = None) -> "RetryPolicy":
        """From a RetryConfig (any object with the four fields)."""
        return cls(
            window_s=cfg.window_s,
            backoff_base_s=cfg.backoff_base_s,
            backoff_cap_s=cfg.backoff_cap_s,
            jitter=cfg.jitter,
            rng=rng,
        )

    def sleep_for(self, backoff: float) -> float:
        """The sleep for a nominal backoff: uniform in
        [b*(1-jitter), b*(1+jitter)], floored at 0."""
        if self.jitter <= 0:
            return backoff
        rng = self.rng if self.rng is not None else random
        lo = backoff * (1.0 - self.jitter)
        hi = backoff * (1.0 + self.jitter)
        return max(0.0, lo + (hi - lo) * rng.random())

    def next_backoff(self, backoff: float) -> float:
        return min(backoff * 2.0, self.backoff_cap_s)


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


def connect(url: str, retry: Optional[RetryPolicy] = None, **kw) -> Broker:
    """A broker for `url`. `retry` is the reconnect policy of tcp:// (and
    of amqp://'s op-level retries); mem:// has no connection to retry and
    ignores it. A comma-separated list of urls is the broker fabric
    (transport/fabric.py: N shards behind a rendezvous router with a
    fenced fan-in), imported only then, so a single endpoint never loads
    it."""
    if "," in url:
        from dotaclient_tpu_torch.transport.fabric import FabricBroker, parse_fabric_endpoints

        return FabricBroker(parse_fabric_endpoints(url), retry=retry, **kw)
    if url.startswith("mem://"):
        from dotaclient_tpu_torch.transport.memory import MemoryBroker

        return MemoryBroker(url[len("mem://") :] or "default", **kw)
    if url.startswith("tcp://"):
        from dotaclient_tpu_torch.transport.tcp import TcpBroker

        host, _, port = url[len("tcp://") :].partition(":")
        if retry is not None:
            kw["retry"] = retry
        return TcpBroker(host or "127.0.0.1", int(port or 13370), **kw)
    if url.startswith("amqp://"):
        from dotaclient_tpu_torch.transport.rmq import RmqBroker

        if retry is not None:
            kw["retry"] = retry
        return RmqBroker(url, **kw)
    raise ValueError(f"unknown broker url scheme: {url!r}")
