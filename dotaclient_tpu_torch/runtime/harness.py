"""In-process closed-loop harness (own copy of
dotaclient_tpu/runtime/harness.py): N actor threads, each with a private
asyncio loop, around one learner.

`make_actor(i)` builds actor i inside its thread; `on_episode(i, actor,
ret)` observes each finished episode (called from the actor's thread;
synchronize your own state). Threads loop until `stop()`, which joins
them with a bounded timeout so a wedged episode cannot hang teardown.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from typing import Callable, List, Optional

_log = logging.getLogger(__name__)


class ActorPool:
    """N actor threads looping run_episode() until stop().

    With envs per actor above 1 (`envs_per_actor`, else the built actor's
    cfg.envs_per_process), each thread wraps its Actor in a VectorActor
    over that many envs. Actors are appended to `self.actors` as they come
    up. A crashed actor thread logs its traceback and exits; `dead` counts
    them."""

    def __init__(
        self,
        make_actor: Callable[[int], object],
        n_actors: int,
        on_episode: Optional[Callable[[int, object, float], None]] = None,
        envs_per_actor: Optional[int] = None,
    ):
        self._make_actor = make_actor
        self._on_episode = on_episode
        self._envs_per_actor = envs_per_actor
        self._stop = threading.Event()
        self.actors: List[object] = []
        # incremented from N threads: a bare += can lose an update
        self._lock = threading.Lock()
        self.dead = 0
        self._threads = [
            threading.Thread(target=self._run, args=(i,), daemon=True, name=f"actor-{i}")
            for i in range(n_actors)
        ]

    def _maybe_vectorize(self, actor):
        """A VectorActor over the actor when envs per actor exceed 1. Only
        the exact Actor type is wrapped: an env slot or another agent is
        never wrapped twice. A remote actor (serve/client.py) is wrapped in
        a RemoteFleet of that many slots, one at least: the server batches,
        and the fleet's episode loop retries a failed step where a bare
        run_episode would end the thread."""
        M = self._envs_per_actor
        if M is None:
            M = int(getattr(getattr(actor, "cfg", None), "envs_per_process", 1) or 1)
        if getattr(actor, "remote_policy", None) is not None:
            from dotaclient_tpu_torch.serve.client import RemoteFleet

            return RemoteFleet.from_actor(actor, envs=max(M, 1))
        if M <= 1:
            return actor
        from dotaclient_tpu_torch.runtime.actor import Actor, VectorActor

        if type(actor) is not Actor:
            _log.warning("envs_per_actor=%d ignored for %s (only the Actor batches across envs)", M,
                         type(actor).__name__)
            return actor
        return VectorActor.from_actor(actor, envs=M)

    def _run(self, i: int) -> None:
        loop = asyncio.new_event_loop()
        try:
            actor = self._maybe_vectorize(self._make_actor(i))
            with self._lock:
                self.actors.append(actor)

            async def go():
                if hasattr(actor, "episode_stream"):
                    async for ret in actor.episode_stream():
                        if self._on_episode is not None:
                            self._on_episode(i, actor, float(ret))
                        if self._stop.is_set():
                            return
                    return
                while not self._stop.is_set():
                    ret = await actor.run_episode()
                    if self._on_episode is not None:
                        self._on_episode(i, actor, float(ret))

            loop.run_until_complete(go())
        except Exception:
            with self._lock:
                self.dead += 1
            _log.exception("actor thread %d died", i)
        finally:
            loop.close()

    def start(self) -> "ActorPool":
        for t in self._threads:
            t.start()
        return self

    def publish_stats(self) -> dict:
        """The fleet's publish counters: the producer side of a
        conservation ledger (exact once stop() has joined the threads)."""
        published = shed = failed = 0
        with self._lock:
            actors = list(self.actors)
        for a in actors:
            published += int(getattr(a, "rollouts_published", 0))
            shed += int(getattr(a, "rollouts_shed", 0))
            failed += int(getattr(a, "rollouts_failed", 0))
        with self._lock:
            dead = self.dead
        return {"published": published, "shed": shed, "failed": failed, "dead_actors": dead}

    def stop(self, timeout: float = 30.0, raise_on_dead: bool = False) -> None:
        """Signal and join with a bounded per-thread timeout.
        `raise_on_dead=True` raises if any actor thread died."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout)
        with self._lock:
            dead = self.dead
        if raise_on_dead and dead:
            raise RuntimeError(f"{dead} actor thread(s) died during the run (tracebacks in the log)")
