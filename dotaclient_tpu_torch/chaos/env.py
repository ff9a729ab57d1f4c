"""ChaosEnvStub (twin of dotaclient_tpu/chaos/env.py): a fault-injecting
wrapper around an env stub (the dotaservice client surface: reset /
observe / act).

Faults stay inside the env protocol, so the actor's existing degradation
paths are what gets exercised:

- latency:M~J  a seeded added await-sleep per RPC (a slow env server);
- reset:P      observe() returns a RESOURCE_EXHAUSTED observation, the
               session-lost signal the actor handles by abandoning the
               episode (runtime/actor.py run_episode).

The same (seed, spec, op index) determinism as ChaosBroker and the same
grammar; corrupt, dup, shed and kill clauses have no env meaning and are
ignored here. The observation is the port's own message class
(protos/dotaservice.py).
"""

from __future__ import annotations

import asyncio
import threading

from dotaclient_tpu_torch.chaos.schedule import FaultSchedule
from dotaclient_tpu_torch.protos import dotaservice as ds


class ChaosEnvStub:
    """Duck-types the async dotaservice stub (reset/observe/act/channel)."""

    def __init__(self, inner, schedule: FaultSchedule):
        self.inner = inner
        self.schedule = schedule
        self.channel = inner.channel
        self._lock = threading.Lock()
        self._ops = 0
        self.sessions_lost = 0
        self.latency_s = 0.0

    def _next_op(self):
        with self._lock:
            i = self._ops
            self._ops += 1
        return self.schedule.decide(i)

    async def _delay(self, faults) -> None:
        if faults.latency_s > 0:
            with self._lock:
                self.latency_s += faults.latency_s
            await asyncio.sleep(faults.latency_s)

    async def reset(self, request):
        await self._delay(self._next_op())
        return await self.inner.reset(request)

    async def observe(self, request):
        f = self._next_op()
        await self._delay(f)
        if f.reset:
            with self._lock:
                self.sessions_lost += 1
            # protocol-level session loss: the actor abandons the episode
            # and starts a fresh one
            return ds.Observation(status=ds.Observation.RESOURCE_EXHAUSTED)
        return await self.inner.observe(request)

    async def act(self, request):
        await self._delay(self._next_op())
        return await self.inner.act(request)
