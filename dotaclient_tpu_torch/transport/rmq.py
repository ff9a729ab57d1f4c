"""RabbitMQ broker (own copy of dotaclient_tpu/transport/rmq.py): the
`amqp://` transport of deployments that run the reference's RabbitMQ
(k8s/rabbitmq.yaml): a durable `experience` queue and a `model` fanout
exchange, with an exclusive queue per weights subscriber.

`pika` is a soft dependency, imported when a broker is built, never when
this module is; without it the constructor stops with an error that names
it and the transports that need nothing.

Failure model: every operation runs under a bounded reconnect-and-retry
loop (transport.base.RetryPolicy, the tcp client's jittered window and
backoff). On a connection reset, a channel close or a publish return the
client tears the connection down, rebuilds the whole topology (queue,
exchange, qos, model binding; the consumer is registered again on the
next consume) and retries the operation until the window expires:

- a failed publish is resent after the reconnect. The client cannot know
  whether the broker enqueued the frame before the stream died, so
  delivery is at least once (a duplicate rollout is harmless to PPO);
- a failed consume drops the client-side unacked buffer (its delivery
  tags died with the channel) and relies on AMQP redelivery: the broker
  requeues unacked deliveries when a channel dies, so no frame is lost;
- a publish return (unroutable: the topology is gone, as after a broker
  that restarted empty) takes the same path, whose re-declaration
  recreates the queue before the resend.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Deque, List, Optional

from dotaclient_tpu_torch.transport.base import Broker, RetryPolicy

_log = logging.getLogger(__name__)

EXPERIENCE_QUEUE = "experience"
MODEL_EXCHANGE = "model"

# pika's exceptions that a reconnect retries, looked up on whichever pika
# is installed
_RETRYABLE_NAMES = (
    "AMQPConnectionError",
    "ConnectionClosed",
    "StreamLostError",
    "ConnectionWrongStateError",
    "AMQPChannelError",
    "ChannelClosed",
    "ChannelClosedByBroker",
    "ChannelWrongStateError",
    "UnroutableError",
)


def _pika():
    try:
        import pika
    except ImportError as e:
        raise ImportError(
            "amqp:// broker URLs require the 'pika' package; use mem:// or tcp:// "
            "(python -m dotaclient_tpu_torch.transport.tcp_server) instead"
        ) from e
    return pika


class RmqBroker(Broker):
    def __init__(self, url: str, prefetch: int = 512, retry: Optional[RetryPolicy] = None):
        pika = _pika()
        self._pika = pika
        self._params = pika.URLParameters(url)
        self._prefetch = prefetch
        self._retry = retry if retry is not None else RetryPolicy()
        self._retryable = tuple(
            getattr(pika.exceptions, n) for n in _RETRYABLE_NAMES if hasattr(pika.exceptions, n)
        ) + (OSError,)
        self._lock = threading.Lock()
        self.reconnects = -1  # the boot connect brings it to 0
        self._connect()  # a wrong URL fails at boot, without retries

    def _connect(self) -> None:
        """(Re)build the connection and the whole topology, leaving the
        client as a fresh one: the unacked buffer is dropped (its delivery
        tags died with the old channel; the broker redelivers) and the
        consumer registration reset."""
        pika = self._pika
        self._conn = pika.BlockingConnection(self._params)
        self._ch = self._conn.channel()
        self._ch.queue_declare(queue=EXPERIENCE_QUEUE, durable=True)
        self._ch.exchange_declare(exchange=MODEL_EXCHANGE, exchange_type="fanout")
        self._ch.basic_qos(prefetch_count=self._prefetch)
        # This subscriber's exclusive queue on the model fanout. A reconnect
        # gets a fresh one: weights published meanwhile are gone, which
        # latest-wins allows (the next publish reaches us).
        res = self._ch.queue_declare(queue="", exclusive=True)
        self._model_queue = res.method.queue
        self._ch.queue_bind(exchange=MODEL_EXCHANGE, queue=self._model_queue)
        # The experience consumer is registered by the first
        # consume_experience: only the learner consumes, and a consumer on
        # an actor-side broker would steal frames. Acks are explicit, on
        # hand-out, so basic_qos(prefetch) bounds what sits unacked in
        # _exp_buf; the rest of a backlog stays on the broker (counted by
        # experience_depth, redelivered if this process dies).
        self._exp_buf: Deque[tuple] = deque()  # (delivery_tag, body)
        self._consuming = False
        self.reconnects += 1

    def _teardown(self) -> None:
        try:
            self._conn.close()
        except Exception:
            pass  # a half-dead connection may raise from close

    def _run_with_reconnect(self, op):
        """Run `op()` (the caller holds self._lock), reconnecting with the
        jittered capped backoff on a retryable failure, for up to the retry
        window; then the failure is raised."""
        deadline = time.monotonic() + self._retry.window_s
        backoff = self._retry.backoff_base_s
        while True:
            try:
                return op()
            except self._retryable as e:
                self._teardown()
                if time.monotonic() >= deadline:
                    raise
                _log.warning("amqp op failed (%s: %s); reconnecting", type(e).__name__, e)
                time.sleep(self._retry.sleep_for(backoff))
                backoff = self._retry.next_backoff(backoff)
                try:
                    self._connect()
                except self._retryable:
                    continue  # still down: the next slice re-checks the deadline

    def _on_experience(self, _ch, method, _props, body) -> None:
        self._exp_buf.append((method.delivery_tag, body))

    def publish_experience(self, data: bytes) -> None:
        def op():
            self._ch.basic_publish(exchange="", routing_key=EXPERIENCE_QUEUE, body=data,
                                   properties=self._pika.BasicProperties(delivery_mode=2))

        with self._lock:
            self._run_with_reconnect(op)

    def consume_experience(self, max_items: int, timeout: Optional[float] = None) -> List[bytes]:
        # The deadline is set outside the retried op, so a reconnect in the
        # middle of the wait resumes the same wait.
        deadline = None if timeout is None else time.monotonic() + timeout

        def op():
            if not self._consuming:
                self._ch.basic_consume(EXPERIENCE_QUEUE, on_message_callback=self._on_experience, auto_ack=False)
                self._consuming = True
            while not self._exp_buf:
                if deadline is None:
                    slice_s = 0.2
                else:
                    slice_s = deadline - time.monotonic()
                    if slice_s <= 0:
                        break
                self._conn.process_data_events(time_limit=min(slice_s, 0.2))  # deliveries call _on_experience
            self._conn.process_data_events(time_limit=0)  # what is prefetched, without waiting
            out: List[bytes] = []
            last_tag = None
            while self._exp_buf and len(out) < max_items:
                last_tag, body = self._exp_buf.popleft()
                out.append(body)
            if last_tag is not None:
                # tags grow per channel and are popped in order: one
                # cumulative ack covers every frame handed out
                self._ch.basic_ack(delivery_tag=last_tag, multiple=True)
            return out

        with self._lock:
            return self._run_with_reconnect(op)

    def publish_weights(self, data: bytes) -> None:
        def op():
            self._ch.basic_publish(exchange=MODEL_EXCHANGE, routing_key="", body=data)

        with self._lock:
            self._run_with_reconnect(op)

    def poll_weights(self) -> Optional[bytes]:
        def op():
            latest = None
            while True:
                _method, _props, body = self._ch.basic_get(self._model_queue, auto_ack=True)
                if body is None:
                    return latest
                latest = body  # drained to the newest: latest wins

        with self._lock:
            return self._run_with_reconnect(op)

    def experience_depth(self) -> int:
        def op():
            # a passive declare counts ready messages only; what sits
            # unacked in our buffer is backlog too
            res = self._ch.queue_declare(queue=EXPERIENCE_QUEUE, durable=True, passive=True)
            return res.method.message_count + len(self._exp_buf)

        with self._lock:
            return self._run_with_reconnect(op)

    def close(self) -> None:
        # _teardown: after a spent retry window the connection is closed
        # already, and pika raises on closing it twice
        with self._lock:
            self._teardown()
