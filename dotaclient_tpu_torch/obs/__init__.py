"""Observability (torch twin of dotaclient_tpu/obs/) for the learner, the
inference server, the carry store and the fabric shards:

- obs/trace.py            per-hop latency histograms of trace-stamped
                          rollout frames (DTR2/DTR3) + the e2e actor→apply
                          scalar;
- obs/flight_recorder.py  bounded ring of recent pipeline events, dumped to
                          JSON on a crash, a staging layout error or SIGTERM,
                          and served live on GET /debug/flight;
- obs/http.py             stdlib /metrics, /healthz (503 once the watchdog
                          trips), GET /debug/flight and POST /profile;
- obs/compute.py          step-phase timer with CUDA-event fences, recompile
                          sentinel, MFU, torch.profiler capture (learner);
- obs/watchdog.py         liveness thread (stall/starvation/NaN/regression
                          → log → dump → 503; learner);
- obs/registry.py         the documented scalar names.

The package imports only stdlib modules: `compute` (torch) and `watchdog`
load on first use of their names, so the stdlib tiers (control/,
obs/fleetd.py) that import `obs` never load torch.

Everything is off by default (`--obs.enabled`): with it off no obs object
exists and the staging, learner, serve and actor paths are the plain ones.
The inference server's runtime (role "serve") serves /metrics from its
stats, /healthz and the flight recorder; an actor's runtime trace-stamps
each chunk it publishes (`stamp`) and serves its actor_* gauges; the
compute observer and the watchdog are attached by the learner only.
"""

from __future__ import annotations

import importlib
import time
from typing import Callable, Dict, List, Optional

from dotaclient_tpu_torch.config import ObsConfig
from dotaclient_tpu_torch.obs.flight_recorder import FlightRecorder
from dotaclient_tpu_torch.obs.http import MetricsHTTPServer
from dotaclient_tpu_torch.obs.trace import PipelineTracer

# name -> submodule, loaded on first access (PEP 562)
_LAZY = {"ComputeObserver": "compute", "ProfileCapture": "compute", "Watchdog": "watchdog"}


def __getattr__(name: str):
    if name in _LAZY:
        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class ObsRuntime:
    """One process's observability bundle: recorder + tracer, then the
    compute observer, the watchdog and the scrape server as attached."""

    def __init__(self, cfg: ObsConfig, role: str):
        self.cfg = cfg
        self.role = role
        self.recorder = FlightRecorder(role, ring_size=cfg.ring_size, dump_dir=cfg.dump_dir)
        self.tracer = PipelineTracer(recorder=self.recorder)
        self.server: Optional[MetricsHTTPServer] = None
        self.compute = None  # ComputeObserver, attached by the learner
        self.watchdog = None  # Watchdog
        self.profiler = None  # ProfileCapture
        self._trace_seq = 0

    @classmethod
    def create(cls, cfg: ObsConfig, role: str) -> Optional["ObsRuntime"]:
        """None when obs is disabled: the disabled path constructs nothing."""
        if not cfg.enabled:
            return None
        rt = cls(cfg, role)
        if cfg.install_handlers:
            rt.recorder.install_handlers()
        return rt

    def stamp(self, rollout, actor_id: int):
        """Trace-stamp an outgoing rollout chunk (the actor's publish path):
        a trace id of the actor (high word) and this process's sequence
        number (low word), the birth time, and a publish event in the
        recorder. serialize_rollout then emits DTR2 (DTR3 when bf16)."""
        self._trace_seq += 1
        trace_id = ((actor_id & 0xFFFFFFFF) << 32) | (self._trace_seq & 0xFFFFFFFF)
        birth = time.time()
        self.recorder.record("publish", t=birth, trace=trace_id, actor=actor_id)
        return rollout._replace(trace_id=trace_id, birth_time=birth)

    def attach_compute(self, flops_per_step: float, peak_flops: Optional[float], overlap: bool = False):
        """The learner's compute bundle: phase timer (cfg.step_phases; in
        overlap mode under the pipelined loop), recompile sentinel factory,
        MFU accounting."""
        from dotaclient_tpu_torch.obs.compute import ComputeObserver

        self.compute = ComputeObserver(flops_per_step, peak_flops, recorder=self.recorder,
                                       step_phases=self.cfg.step_phases, overlap=overlap)
        return self.compute

    def attach_watchdog(self, latest_fn, version_fn, latest_seq_fn=None):
        """Build and start the watchdog when cfg.watchdog.enabled. Call it
        after the checkpoint restore: the restore's version write must be
        the baseline, not the first heartbeat."""
        if not self.cfg.watchdog.enabled:
            return None
        from dotaclient_tpu_torch.obs.watchdog import Watchdog

        self.watchdog = Watchdog(self.cfg.watchdog, latest_fn, version_fn, recorder=self.recorder,
                                 latest_seq_fn=latest_seq_fn).start()
        return self.watchdog

    def serve_metrics(self, sources: List[Callable[[], Dict[str, float]]],
                      health_provider: Optional[Callable[[], Dict]] = None, *,
                      device) -> Optional[MetricsHTTPServer]:
        """Start /metrics when cfg.metrics_port > 0, with the tracer's and
        the watchdog's scalars added to `sources`, /healthz, GET
        /debug/flight and POST /profile, which traces `device`, the one the
        caller's nets run on (captures land in profile_dir, else dump_dir,
        else cwd). `device=None` (a tier that steps no net and never loads
        torch) wires no profiler: POST /profile answers 404."""
        if self.cfg.metrics_port <= 0:
            return None

        def _watchdog_scalars() -> Dict[str, float]:
            wd = self.watchdog  # one read: close() may null it meanwhile
            return wd.scalars() if wd is not None else {}

        if device is not None:
            from dotaclient_tpu_torch.obs.compute import ProfileCapture

            self.profiler = ProfileCapture(self.cfg.profile_dir or self.cfg.dump_dir,
                                           max_seconds=self.cfg.profile_max_seconds, device=device)
        self.server = MetricsHTTPServer(
            self.cfg.metrics_port,
            list(sources) + [self.tracer.scalars, _watchdog_scalars],
            health_provider=health_provider,
            profile_handler=self.profiler.capture if self.profiler is not None else None,
            flight_provider=self.recorder.snapshot,
        ).start()
        return self.server

    def close(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
            self.watchdog = None
        if self.server is not None:
            self.server.stop()
            self.server = None
