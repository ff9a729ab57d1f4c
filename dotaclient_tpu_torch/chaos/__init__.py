"""Seeded fault injection for the actors → broker → staging → learner
pipe (twin of dotaclient_tpu/chaos/). It wraps the production plugin
boundaries (the Broker interface, the env stub) in deterministic
scheduled faults:

- chaos/schedule.py   the `--chaos.spec` grammar and the per-op-index
                      seeded decisions (same seed + spec, same faults at
                      the same op indices);
- chaos/broker.py     ChaosBroker: corrupt/truncate/dup/reset/shed/
                      latency/stall around any Broker;
- chaos/env.py        ChaosEnvStub: env latency and session loss inside
                      the protocol the actor already handles;
- chaos/controller.py broker, learner and inference-server kill/restart
                      (kill@T:D@broker|learner[:term|kill]|server,
                      rolling@T:P@server|broker) with exact
                      per-incarnation conservation ledgers.

Production inertness is a hard contract: the binaries import this
package only under `--chaos.enabled` (the k8s manifests pin it off), so
the off path has no new import and the same wire bytes.

    from dotaclient_tpu_torch.chaos import wrap_broker
    broker = wrap_broker(broker, cfg.chaos)   # cfg.chaos.enabled is True

scripts/chaos_soak.py composes it into the closed-loop degradation soak.
"""

from __future__ import annotations

from dotaclient_tpu_torch.chaos.broker import ChaosBroker
from dotaclient_tpu_torch.chaos.controller import (
    BrokerIncarnations,
    LearnerIncarnations,
    ScheduleRunner,
    ServeIncarnations,
)
from dotaclient_tpu_torch.chaos.env import ChaosEnvStub
from dotaclient_tpu_torch.chaos.schedule import FaultSchedule, OpFaults, TimedEvent

__all__ = [
    "BrokerIncarnations",
    "ChaosBroker",
    "ChaosEnvStub",
    "FaultSchedule",
    "LearnerIncarnations",
    "OpFaults",
    "ScheduleRunner",
    "ServeIncarnations",
    "TimedEvent",
    "wrap_broker",
    "wrap_env_stub",
]


def wrap_broker(broker, chaos_cfg, t0=None):
    """The binaries' broker decorator: parse the spec once, wrap. Callers
    gate on cfg.chaos.enabled before importing this package."""
    if hasattr(broker, "fanin_residual"):
        # A broker fabric (transport/fabric.py) cannot be wrapped:
        # ChaosBroker forwards only the base Broker surface, so it would
        # strip quiesce / consume_residual / fanin_residual (a SIGTERM
        # drain would declare victory over frames stranded in the fan-in
        # queue), fabric_stats, and the per-endpoint routing the actor
        # throttle keys on. Inject faults into single shards instead.
        raise ValueError(
            "chaos cannot wrap a broker fabric (comma --broker_url): the "
            "wrapper would strip the fabric's drain/routing surface — "
            "point chaos at individual shards or use the fabric soak's "
            "shard-kill schedules instead"
        )
    schedule = FaultSchedule.parse(chaos_cfg.spec, seed=chaos_cfg.seed)
    return ChaosBroker(broker, schedule, t0=t0)


def wrap_env_stub(stub, chaos_cfg):
    schedule = FaultSchedule.parse(chaos_cfg.spec, seed=chaos_cfg.seed)
    return ChaosEnvStub(stub, schedule)
