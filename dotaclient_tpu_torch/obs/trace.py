"""Rollout pipeline tracing (own copy of dotaclient_tpu/obs/trace.py):
per-hop latency histograms + e2e decompose.

Each published chunk carries a trace id and a birth timestamp on the
wire (transport/serialize.py DTR2 extension); every pipeline stage that
touches it records a hop. The tracer turns hop deltas into per-stage
latency histograms (flattened to scalars via runtime.metrics
.histogram_scalars, so they ride the existing JSONL/TB/scrape stream)
and an end-to-end actor→apply latency that decomposes the coarse
staleness number the learner already logs.

Hop chain (the pipe's stations; the port has no replay reservoir, so its
two stages stay empty):

  publish       actor serializes + hands the chunk to the broker (birth)
  consume       staging consumer receives it off the broker
  staging_admit chunk passed validation/staleness and joined _pending
  replay_admit  would-be-stale chunk retained by the replay reservoir
  replay_reemit reservoir sample mixed the chunk back into a batch
  pack          chunk's batch left the packer
  h2d           learner dispatched the batch's host→device transfer
  apply         learner dispatched the train step consuming the batch

Each hop's histogram measures the delta from the PREVIOUS hop of the
same chunk; `consume` measures from birth, so it covers serialize +
broker queueing + the wire. `h2d` and `apply` are DISPATCH times (the
learner never syncs the device per step — metrics_every governs the
only routine sync), so the residual device time lives in the learner's
existing time_step_s, not here. e2e = apply_dispatch - birth.

Clocks: birth is the PUBLISHING process's time.time(); cross-host skew
therefore biases the `consume` bucket (and e2e) by the skew, exactly
like any wall-clock-stamped distributed trace. Same-host deploys and
the k8s NTP baseline keep this within single-digit ms — noted in the
README Observability section.

Thread model: hops arrive from the staging consumer thread AND the
learner loop thread; one lock guards the histogram state. Every call is
O(#edges) with no allocation beyond the event dict handed to the flight
recorder. The tracer exists only when --obs.enabled — the disabled path
never constructs one.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from dotaclient_tpu_torch.runtime.metrics import histogram_scalars

# Upper edges (milliseconds) of every per-stage latency histogram; the
# last bucket is open-ended. Log-spaced: the pipe's hops span ~0.1ms
# (admit) to multi-second (broker backlog under overload).
LATENCY_EDGES_MS = (1, 3, 10, 30, 100, 300, 1000, 3000, 10000)

STAGES = (
    "publish",
    "consume",
    "staging_admit",
    "replay_admit",
    "replay_reemit",
    "pack",
    "h2d",
    "apply",
)


class TraceRef:
    """One in-flight chunk's trace state as it moves through THIS
    process: identity + birth + the previous hop's timestamp (so each
    stage histograms its own delta, not the cumulative age)."""

    __slots__ = ("trace_id", "birth", "last_t")

    def __init__(self, trace_id: int, birth: float, last_t: Optional[float] = None):
        self.trace_id = trace_id
        self.birth = birth
        self.last_t = birth if last_t is None else last_t


class PipelineTracer:
    """Aggregates hop events into per-stage latency histograms and the
    e2e actor→apply scalar; optionally mirrors every hop into a
    FlightRecorder ring so crash dumps carry the recent trace tail."""

    def __init__(self, recorder=None, edges_ms: Tuple[int, ...] = LATENCY_EDGES_MS):
        self.recorder = recorder
        self.edges_ms = tuple(edges_ms)
        self._lock = threading.Lock()
        # stage -> (bucket counts [len(edges)+1], count, sum_ms)
        self._hist: Dict[str, List[int]] = {}
        self._n: Dict[str, int] = {}
        self._sum_ms: Dict[str, float] = {}
        self._e2e_n = 0
        self._e2e_sum_s = 0.0

    # ------------------------------------------------------------- hops

    def hop(self, stage: str, ref: TraceRef, now: Optional[float] = None) -> None:
        """Record one stage transition for one chunk; advances ref.last_t
        so the next hop measures its own delta."""
        t = time.time() if now is None else now
        delta_ms = max(t - ref.last_t, 0.0) * 1e3
        ref.last_t = t
        b = 0
        edges = self.edges_ms
        while b < len(edges) and delta_ms > edges[b]:
            b += 1
        with self._lock:
            hist = self._hist.get(stage)
            if hist is None:
                hist = self._hist[stage] = [0] * (len(edges) + 1)
                self._n[stage] = 0
                self._sum_ms[stage] = 0.0
            hist[b] += 1
            self._n[stage] += 1
            self._sum_ms[stage] += delta_ms
        if self.recorder is not None:
            self.recorder.record(
                stage, trace=ref.trace_id, ms=round(delta_ms, 3), t=t
            )

    def hop_batch(self, stage: str, refs, now: Optional[float] = None) -> None:
        """One stage transition for every traced chunk of a batch (pack /
        h2d / apply are batch-granular). `refs` may contain None slots
        (untraced rows of a mixed batch)."""
        if not refs:
            return
        t = time.time() if now is None else now
        for ref in refs:
            if ref is not None:
                self.hop(stage, ref, now=t)

    def e2e(self, refs, now: Optional[float] = None) -> None:
        """Close out traced chunks at apply dispatch: actor→apply wall
        seconds from the wire birth stamp."""
        if not refs:
            return
        t = time.time() if now is None else now
        with self._lock:
            for ref in refs:
                if ref is not None and ref.birth > 0:
                    self._e2e_n += 1
                    self._e2e_sum_s += max(t - ref.birth, 0.0)

    # ---------------------------------------------------------- scalars

    def scalars(self) -> Dict[str, float]:
        """Flatten state into MetricsLogger-style scalars. Histogram
        buckets are cumulative counters (Prometheus rate()-able); means
        are cumulative sums/counts. Names: trace_<stage>_ms_le_<edge>,
        trace_<stage>_ms_gt_<last>, trace_<stage>_mean_ms,
        trace_e2e_actor_apply_s."""
        out: Dict[str, float] = {}
        with self._lock:
            for stage, hist in self._hist.items():
                out.update(
                    histogram_scalars(f"trace_{stage}_ms", self.edges_ms, list(hist))
                )
                n = self._n[stage]
                out[f"trace_{stage}_mean_ms"] = self._sum_ms[stage] / max(n, 1)
            if self._e2e_n:
                out["trace_e2e_actor_apply_s"] = self._e2e_sum_s / self._e2e_n
        return out
