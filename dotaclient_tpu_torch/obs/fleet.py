"""Fleet telemetry plane (own copy of dotaclient_tpu/obs/fleet.py):
topology-driven aggregation, a continuous conservation audit, and
alert-triggered flight-recorder fan-in.

`FleetAggregator` scrapes every /metrics surface the control plane knows
about (GET /topology; literal comma-lists are the rollback position),
keeps bounded per-target rings, and derives three layers each poll
window:

1. **Conservation audit** (`ConservationAuditor`): the producer /
   broker-shard / delivery ledger identities evaluated on window deltas
   of the fleet's counter families, accumulated into a per-ledger
   `unaccounted` gauge. Counter resets and scrape outages are
   epoch-fenced: every obs/http.py surface exports `obs_boot_epoch_ms`,
   so a restarted shard re-anchors (its resident frames move to the
   `fenced` gauge — known restart loss) instead of reading as
   unaccounted loss, and a failed scrape freezes the ledger window
   (cumulative counters make the next successful delta span the gap).

2. **SLO rollups**: e2e env-steps/s vs the device-only rate, cross-fleet
   staleness and trace-stage means, pipeline_* device idle, serve request
   rate and occupancy, league match volume.

3. **Alerts → incident fan-in** (`AlertEngine`): `meter,op,thr,for=W`
   clauses evaluated against the fleet_* rollups; a rising firing edge
   snapshots every process's GET /debug/flight ring into one correlated
   incident bundle, indexed by trace_id where events carry one.

Stdlib only (urllib via control/scrape.py): fleetd never loads torch,
numpy or the wire stack. Every meter it emits is in the registry's
`fleet_` family.

Threading: poll_once() runs on the fleetd loop thread; scalars() /
fleet() / health() are read by obs/http.py handler threads. Every
cross-thread read or write goes through self._lock: poll_once computes
into locals and publishes under one short critical section.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.request
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from dotaclient_tpu_torch.control.scrape import scrape_endpoint

_log = logging.getLogger(__name__)

# Scrape order within a poll: each cross-tier identity's upstream tier
# before its downstream one. A frame that moves between two reads then
# counts once downstream and not yet upstream, which reads as
# over-accounted for a window and never as loss, so steady traffic cannot
# hold a loss alert's streak. Tiers not named here are read after these.
SCRAPE_ORDER = ("actor", "broker", "learner")

# Meter exported by every obs/http.py surface: wall-clock ms the surface
# came up. A changed value is a process restart — the counter-reset fence.
BOOT_EPOCH_METER = "obs_boot_epoch_ms"


# --------------------------------------------------------------- ledgers


@dataclass(frozen=True)
class LedgerTerm:
    """One signed term of a conservation identity: the window delta of
    `meter`, summed over every target in `tier`, weighted by `sign`.
    kind="gauge" terms are level-valued (resident frames, queue depth) —
    their window DELTA enters the identity exactly like a counter's, but
    on a fence their last level is the restart's known loss.
    required=False terms contribute zero when the meter is absent
    (mode-dependent families like fanin_*)."""

    meter: str
    tier: str
    sign: float
    kind: str = "counter"  # "counter" | "gauge"
    required: bool = True


@dataclass(frozen=True)
class LedgerSpec:
    name: str
    doc: str
    terms: Tuple[LedgerTerm, ...]

    def tiers(self) -> Tuple[str, ...]:
        return tuple(sorted({t.tier for t in self.terms}))


# The three standing identities (units: wire frames — one serialized
# rollout chunk; the broker enqueues, pops, and the staging intake
# counts exactly these). Meter names are the fleet's EXISTING scrape
# scalars — the registry documents every one.
LEDGERS: Tuple[LedgerSpec, ...] = (
    LedgerSpec(
        name="producer",
        doc="actor publish path: attempted = published + shed + publish-failed",
        terms=(
            LedgerTerm("actor_publish_attempted_total", "actor", +1.0),
            LedgerTerm("actor_rollouts_published_total", "actor", -1.0),
            LedgerTerm("broker_shed_observed_total", "actor", -1.0, required=False),
            LedgerTerm(
                "broker_shed_publish_failed_total", "actor", -1.0, required=False
            ),
        ),
    ),
    LedgerSpec(
        name="shard",
        doc="broker shard: enqueued = popped + dropped + evicted_low + resident",
        terms=(
            LedgerTerm("broker_shard_enqueued_total", "broker", +1.0),
            LedgerTerm("broker_shard_popped_total", "broker", -1.0),
            LedgerTerm("broker_shard_dropped_total", "broker", -1.0, required=False),
            LedgerTerm(
                "broker_shard_evicted_low_total", "broker", -1.0, required=False
            ),
            LedgerTerm(
                "broker_shard_resident", "broker", -1.0, kind="gauge"
            ),
        ),
    ),
    LedgerSpec(
        name="delivery",
        doc=(
            "broker → learner: popped - reply_lost - fence/dup drops - "
            "fan-in queue level - staging intake level = consumed at the "
            "staging intake"
        ),
        terms=(
            LedgerTerm("broker_shard_popped_total", "broker", +1.0),
            LedgerTerm(
                "broker_shard_reply_lost_total", "broker", -1.0, required=False
            ),
            LedgerTerm("fanin_fence_dropped_total", "learner", -1.0, required=False),
            LedgerTerm("fanin_dup_dropped_total", "learner", -1.0, required=False),
            LedgerTerm(
                "fanin_queue_depth", "learner", -1.0, kind="gauge", required=False
            ),
            # the port's learner also exports the frames its staging has
            # popped and not yet counted (the pool mode's intake queue);
            # absent on the reference's surfaces, where it reads 0
            LedgerTerm(
                "obs_staging_intake_frames", "learner", -1.0, kind="gauge",
                required=False,
            ),
            LedgerTerm("wire_frames_obs_bf16_total", "learner", -1.0),
            LedgerTerm(
                "wire_frames_obs_f32_total", "learner", -1.0, required=False
            ),
        ),
    ),
    LedgerSpec(
        name="assembled",
        doc=(
            "in-network batch assembly (--broker.assemble): admitted = "
            "packed + reject + bypassed + dropped + resident — every row "
            "a shard admitted while armed is packed into a block, "
            "dead-lettered (reject), popped wire-form by a classic "
            "consumer (bypassed), evicted, or still resident "
            "(assembled-but-unpopped)"
        ),
        terms=(
            LedgerTerm(
                "broker_assemble_rows_admitted_total", "broker", +1.0,
                required=False,
            ),
            LedgerTerm(
                "broker_assemble_rows_packed_total", "broker", -1.0,
                required=False,
            ),
            LedgerTerm(
                "broker_assemble_rows_reject_total", "broker", -1.0,
                required=False,
            ),
            LedgerTerm(
                "broker_assemble_rows_bypassed_total", "broker", -1.0,
                required=False,
            ),
            LedgerTerm(
                "broker_assemble_rows_dropped_total", "broker", -1.0,
                required=False,
            ),
            LedgerTerm(
                "broker_assemble_rows_resident", "broker", -1.0,
                kind="gauge", required=False,
            ),
        ),
    ),
)


@dataclass
class LedgerState:
    """Mutable per-ledger audit state. `anchors` maps (target_key,
    meter) -> the last CONSUMED value; deltas are computed against it
    and it only advances when a window actually accumulates, so frozen
    windows defer (never drop) counter activity."""

    status: str = "absent"  # ok | alarm | stale | fenced | absent
    unaccounted: float = 0.0
    fenced_frames: float = 0.0
    last_residual: float = 0.0
    windows_audited: int = 0
    windows_frozen: int = 0
    anchors: Dict[Tuple[str, str], float] = field(default_factory=dict)


class ConservationAuditor:
    """Evaluates every LedgerSpec each poll window. Pure state machine:
    the caller hands it the window's scrape outcome and it never does
    I/O, so tests drive it with injected counter sets."""

    def __init__(self, ledgers: Tuple[LedgerSpec, ...] = LEDGERS):
        self.ledgers = ledgers
        self.state: Dict[str, LedgerState] = {l.name: LedgerState() for l in ledgers}

    def observe(
        self,
        samples: Dict[str, Optional[Dict[str, float]]],
        tiers: Dict[str, str],
        fenced: set,
    ) -> None:
        """One poll window. `samples`: target_key -> scalar dict (None =
        scrape failed — the ledger window FREEZES: you cannot certify
        conservation you cannot observe, and cumulative counters make
        the next clean delta span the gap). `tiers`: target_key -> tier.
        `fenced`: target keys that restarted this window (boot-epoch
        change / counter regression) — their anchors re-baseline and
        their gauge levels move to fenced_frames. A target's FIRST
        successful scrape simply baselines (anchors default to current):
        audit-from-first-sight, no freeze."""
        for spec in self.ledgers:
            st = self.state[spec.name]
            involved = [k for k, t in tiers.items() if t in spec.tiers()]
            # -- fence accounting first: a fenced target's gauge level is
            # the restart's known loss, and its anchors re-baseline so a
            # reset counter never reads as negative delta.
            for key in involved:
                if key not in fenced:
                    continue
                cur = samples.get(key)
                for term in spec.terms:
                    if term.tier != tiers[key]:
                        continue
                    akey = (key, term.meter)
                    if term.kind == "gauge" and akey in st.anchors:
                        st.fenced_frames += abs(st.anchors[akey])
                    if cur is not None and term.meter in cur:
                        st.anchors[akey] = cur[term.meter]
                    else:
                        st.anchors.pop(akey, None)
            # -- absence: a required meter no involved target reports
            # (and none ever anchored) means this identity has nothing
            # to audit yet — e.g. a smoke fleet with no broker tier.
            def _meter_known(term: LedgerTerm) -> bool:
                for key in involved:
                    if tiers[key] != term.tier:
                        continue
                    cur = samples.get(key)
                    if cur is not None and term.meter in cur:
                        return True
                    if (key, term.meter) in st.anchors:
                        return True
                return False

            required = [t for t in spec.terms if t.required]
            if not involved or not all(_meter_known(t) for t in required):
                st.status = "absent"
                st.last_residual = 0.0
                continue
            # -- freeze: any involved target unobservable or fenced this
            # window → defer (anchors untouched; cumulative counters make
            # the next clean delta span the gap).
            down = [k for k in involved if samples.get(k) is None]
            if down or any(k in fenced for k in involved):
                st.status = "fenced" if any(k in fenced for k in involved) else "stale"
                st.last_residual = 0.0
                st.windows_frozen += 1
                continue
            # -- clean window: signed sum of per-target deltas. First
            # sight of a meter baselines it (anchor defaults to current →
            # delta 0): audit-from-first-sight, never retroactive.
            residual = 0.0
            consumed: Dict[Tuple[str, str], float] = {}
            for term in spec.terms:
                for key in involved:
                    if tiers[key] != term.tier:
                        continue
                    cur = samples[key]
                    if term.meter not in cur:
                        continue
                    akey = (key, term.meter)
                    value = cur[term.meter]
                    residual += term.sign * (value - st.anchors.get(akey, value))
                    consumed[akey] = value
            st.anchors.update(consumed)
            st.unaccounted += residual
            st.last_residual = residual
            st.windows_audited += 1
            st.status = "ok" if abs(st.unaccounted) < 0.5 else "alarm"

    def forget_target(self, key: str, tier: str) -> None:
        """A target left the topology: its gauge levels are known loss
        (like a fence) and its anchors go away."""
        for spec in self.ledgers:
            st = self.state[spec.name]
            for term in spec.terms:
                akey = (key, term.meter)
                if term.kind == "gauge" and akey in st.anchors:
                    st.fenced_frames += abs(st.anchors[akey])
                st.anchors.pop(akey, None)

    def scalars(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        unacc_pos = unacc_neg = fenced = 0.0
        for name, st in self.state.items():
            out[f"fleet_ledger_{name}_unaccounted"] = st.unaccounted
            out[f"fleet_ledger_{name}_fenced_frames"] = st.fenced_frames
            out[f"fleet_ledger_{name}_ok"] = float(st.status in ("ok", "absent"))
            out[f"fleet_ledger_{name}_windows_audited"] = float(st.windows_audited)
            out[f"fleet_ledger_{name}_windows_frozen"] = float(st.windows_frozen)
            unacc_pos += max(st.unaccounted, 0.0)
            unacc_neg += max(-st.unaccounted, 0.0)
            fenced += st.fenced_frames
        # The headline: frames the fleet cannot account for. Positive =
        # produced-but-vanished (loss); the negative side is its own
        # gauge (over-accounting: duplication or a broken term) so the
        # two failure modes never cancel each other silent.
        out["fleet_unaccounted_frames"] = unacc_pos
        out["fleet_overaccounted_frames"] = unacc_neg
        out["fleet_fenced_frames"] = fenced
        return out

    def report(self) -> Dict:
        return {
            spec.name: {
                "doc": spec.doc,
                "status": self.state[spec.name].status,
                "unaccounted": self.state[spec.name].unaccounted,
                "fenced_frames": self.state[spec.name].fenced_frames,
                "last_residual": self.state[spec.name].last_residual,
                "windows_audited": self.state[spec.name].windows_audited,
                "windows_frozen": self.state[spec.name].windows_frozen,
            }
            for spec in self.ledgers
        }


# ---------------------------------------------------------------- alerts

_OPS: Dict[str, Callable[[float, float], bool]] = {
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
}


@dataclass
class AlertRule:
    meter: str
    op: str
    threshold: float
    for_windows: int
    raw: str

    def breached(self, value: float) -> bool:
        return _OPS[self.op](value, self.threshold)


def parse_alerts(spec: str) -> List[AlertRule]:
    """`meter,op,threshold,for=W` clauses, ';'-joined — the control
    policy's grammar discipline: fail LOUD at parse time, a silently
    dropped clause is an alert that never fires. op in gt|ge|lt|le|eq|ne;
    W >= 1 consecutive breached windows before firing."""
    rules: List[AlertRule] = []
    for raw in (c.strip() for c in spec.split(";")):
        if not raw:
            continue
        parts = [p.strip() for p in raw.split(",")]
        if len(parts) != 4:
            raise ValueError(
                f"alert clause {raw!r}: want meter,op,threshold,for=W "
                f"(got {len(parts)} fields)"
            )
        meter, op, threshold, for_part = parts
        if op not in _OPS:
            raise ValueError(f"alert clause {raw!r}: op {op!r} not in {sorted(_OPS)}")
        if not for_part.startswith("for="):
            raise ValueError(f"alert clause {raw!r}: fourth field must be for=W")
        thr = float(threshold)  # raises ValueError with the bad literal
        w = int(for_part[len("for="):])
        if w < 1:
            raise ValueError(f"alert clause {raw!r}: for=W must be >= 1")
        rules.append(AlertRule(meter, op, thr, w, raw))
    return rules


@dataclass
class _AlertState:
    streak: int = 0
    firing: bool = False
    fired_total: int = 0
    last_value: Optional[float] = None


class AlertEngine:
    """Consecutive-breach alert evaluation. A missing meter FREEZES the
    streak (no advance, no reset) — an aggregator that briefly loses a
    rollup input must neither page nor forgive. fire edges (not-firing →
    firing transitions) are what trigger incident fan-in."""

    def __init__(self, rules: List[AlertRule]):
        self.rules = rules
        self.state: List[_AlertState] = [_AlertState() for _ in rules]

    def evaluate(self, meters: Dict[str, float]) -> List[AlertRule]:
        edges: List[AlertRule] = []
        for rule, st in zip(self.rules, self.state):
            if rule.meter not in meters:
                continue  # freeze
            value = meters[rule.meter]
            st.last_value = value
            if rule.breached(value):
                st.streak += 1
                if st.streak >= rule.for_windows and not st.firing:
                    st.firing = True
                    st.fired_total += 1
                    edges.append(rule)
            else:
                st.streak = 0
                st.firing = False
        return edges

    def report(self) -> List[Dict]:
        return [
            {
                "clause": rule.raw,
                "streak": st.streak,
                "firing": st.firing,
                "fired_total": st.fired_total,
                "last_value": st.last_value,
            }
            for rule, st in zip(self.rules, self.state)
        ]


# --------------------------------------------------------------- targets


@dataclass
class TargetSeries:
    """Bounded per-target time-series ring + fence bookkeeping."""

    tier: str
    endpoint: str
    ring: deque = field(default_factory=lambda: deque(maxlen=64))
    boot_epoch: Optional[float] = None
    last: Optional[Dict[str, float]] = None
    last_ok_t: float = 0.0
    fences: int = 0
    ever_up: bool = False

    @property
    def key(self) -> str:
        return f"{self.tier}/{self.endpoint}"


def fetch_topology_targets(
    control: str, timeout_s: float = 2.0
) -> Optional[Dict[str, List[str]]]:
    """GET /topology on the control plane → {tier: [metrics endpoints]}.
    None on any failure — the caller keeps its current target set
    (discovery can only improve on the literal lists, the same rollback
    semantics serve/client.py uses)."""
    try:
        with urllib.request.urlopen(
            f"http://{control}/topology", timeout=timeout_s
        ) as resp:
            body = json.loads(resp.read().decode("utf-8", "replace"))
    except Exception as e:
        _log.debug("topology fetch from %s failed: %s", control, e)
        return None
    metrics = body.get("metrics")
    if not isinstance(metrics, dict):
        return None
    return {
        str(tier): [str(e) for e in eps]
        for tier, eps in metrics.items()
        if isinstance(eps, (list, tuple))
    }


def snapshot_flight(endpoint: str, timeout_s: float = 2.0) -> Optional[Dict]:
    """GET /debug/flight → the process's bounded crash-ring snapshot;
    None on any failure (a 404 surface simply has no recorder wired)."""
    try:
        with urllib.request.urlopen(
            f"http://{endpoint}/debug/flight", timeout=timeout_s
        ) as resp:
            return json.loads(resp.read().decode("utf-8", "replace"))
    except Exception as e:
        _log.debug("flight snapshot %s failed: %s", endpoint, e)
        return None


# ------------------------------------------------------------ aggregator


class FleetAggregator:
    """The standing aggregation engine behind `python -m
    dotaclient_tpu_torch.obs.fleetd`. Construct with static targets and/or a
    control-plane address; call poll_once() on the loop cadence;
    scalars() is the /metrics source and fleet() the /fleet JSON body.

    I/O is injectable (scrape_fn / topology_fn / flight_fn) so tests
    drive whole chaos scenarios without sockets."""

    def __init__(
        self,
        targets: Optional[Dict[str, List[str]]] = None,
        control: str = "",
        poll_s: float = 2.0,
        window: int = 64,
        stale_s: float = 10.0,
        alerts: str = "",
        bundle_dir: str = "",
        ledgers: Tuple[LedgerSpec, ...] = LEDGERS,
        scrape_fn: Callable[[str], Optional[Dict[str, float]]] = scrape_endpoint,
        topology_fn: Callable[[str], Optional[Dict[str, List[str]]]] = (
            fetch_topology_targets
        ),
        flight_fn: Callable[[str], Optional[Dict]] = snapshot_flight,
        now_fn: Callable[[], float] = time.time,
        recorder=None,
    ):
        self.control = control
        self.poll_s = poll_s
        self.window = max(int(window), 2)
        self.stale_s = stale_s
        self.bundle_dir = bundle_dir
        self._static_targets = {t: list(e) for t, e in (targets or {}).items()}
        self._scrape = scrape_fn
        self._topology = topology_fn
        self._flight = flight_fn
        self._now = now_fn
        self.auditor = ConservationAuditor(ledgers)
        self.alert_engine = AlertEngine(parse_alerts(alerts))
        # fleetd's own FlightRecorder (optional): fences and alert fires
        # land in ITS ring too, so an incident bundle that includes
        # fleetd's own /debug/flight shows the aggregator's view.
        self.recorder = recorder
        self._lock = threading.Lock()
        self._series: Dict[str, TargetSeries] = {}
        self._rate_anchors: Dict[str, Tuple[float, float]] = {}
        self._scalars: Dict[str, float] = {}
        self._report: Dict = {"ok": True, "polls": 0}
        self._incident_paths: deque = deque(maxlen=32)
        self.polls_total = 0
        self.scrape_errors_total = 0
        self.fences_total = 0
        self.incidents_total = 0
        self.topology_refreshes_total = 0
        self.topology_errors_total = 0

    # -- discovery -------------------------------------------------------

    def _discover(self) -> Dict[str, List[str]]:
        desired = {t: list(e) for t, e in self._static_targets.items()}
        if self.control:
            topo = self._topology(self.control)
            if topo is None:
                self.topology_errors_total += 1
            else:
                self.topology_refreshes_total += 1
                for tier, eps in topo.items():
                    merged = desired.setdefault(tier, [])
                    for ep in eps:
                        if ep not in merged:
                            merged.append(ep)
        return desired

    # -- one poll window -------------------------------------------------

    def poll_once(self) -> Dict:
        """Scrape → fence-detect → audit → rollups → alerts → (maybe)
        incident fan-in. Returns the /fleet report it published."""
        now = self._now()
        desired = self._discover()
        desired_keys = {
            f"{tier}/{ep}" for tier, eps in desired.items() for ep in eps
        }
        # Prune targets that left the topology: their resident levels
        # are known (fenced) loss, not unaccounted loss.
        with self._lock:
            series = dict(self._series)
        for key in list(series):
            if key not in desired_keys:
                ts = series.pop(key)
                self.auditor.forget_target(key, ts.tier)
        for tier, eps in desired.items():
            for ep in eps:
                key = f"{tier}/{ep}"
                if key not in series:
                    ts = TargetSeries(tier=tier, endpoint=ep)
                    ts.ring = deque(maxlen=self.window)
                    series[key] = ts

        samples: Dict[str, Optional[Dict[str, float]]] = {}
        tiers: Dict[str, str] = {}
        fenced: set = set()
        rank = {t: i for i, t in enumerate(SCRAPE_ORDER)}
        order = sorted(series, key=lambda k: rank.get(series[k].tier, len(rank)))
        for key in order:
            ts = series[key]
            tiers[key] = ts.tier
            sample = self._scrape(ts.endpoint)
            samples[key] = sample
            if sample is None:
                self.scrape_errors_total += 1
                ts.ring.append((now, None))
                continue
            # Fence detection: a new boot epoch, or any cumulative
            # counter running BACKWARD (a restart racing two polls so
            # fast both epochs were scraped from different incarnations
            # still trips the regression check).
            epoch = sample.get(BOOT_EPOCH_METER)
            regressed = ts.last is not None and any(
                name.endswith("_total")
                and name in ts.last
                and value < ts.last[name] - 1e-9
                for name, value in sample.items()
            )
            if ts.ever_up and (
                regressed
                or (
                    epoch is not None
                    and ts.boot_epoch is not None
                    and abs(epoch - ts.boot_epoch) > 0.5
                )
            ):
                fenced.add(key)
                ts.fences += 1
                self.fences_total += 1
                if self.recorder is not None:
                    self.recorder.record("fence", t=now, target=key)
            ts.boot_epoch = epoch if epoch is not None else ts.boot_epoch
            ts.last = sample
            ts.last_ok_t = now
            ts.ever_up = True
            ts.ring.append((now, sample))

        self.auditor.observe(samples, tiers, fenced)
        self.polls_total += 1
        scalars = self._rollups(now, series, samples)
        scalars.update(self.auditor.scalars())
        edges = self.alert_engine.evaluate(scalars)
        scalars["fleet_alerts_firing"] = float(
            sum(1 for st in self.alert_engine.state if st.firing)
        )
        scalars["fleet_alerts_fired_total"] = float(
            sum(st.fired_total for st in self.alert_engine.state)
        )
        for rule in edges:
            if self.recorder is not None:
                self.recorder.record(
                    "alert_fired",
                    t=now,
                    clause=rule.raw,
                    value=scalars.get(rule.meter),
                )
            self._fan_in_incident(rule, now, series, scalars)
        scalars["fleet_incidents_total"] = float(self.incidents_total)
        report = {
            "ok": all(
                st.status in ("ok", "absent") for st in self.auditor.state.values()
            ),
            "time": now,
            "polls": self.polls_total,
            "targets": {
                key: {
                    "tier": ts.tier,
                    "endpoint": ts.endpoint,
                    "up": samples.get(key) is not None,
                    "stale": ts.ever_up and (now - ts.last_ok_t) > self.stale_s,
                    "boot_epoch_ms": ts.boot_epoch,
                    "fences": ts.fences,
                }
                for key, ts in series.items()
            },
            "ledgers": self.auditor.report(),
            "alerts": self.alert_engine.report(),
            "slo": {
                k: v
                for k, v in scalars.items()
                if not k.startswith("fleet_ledger_")
            },
            "incidents": list(self._incident_paths),
        }
        with self._lock:
            self._series = series
            self._scalars = scalars
            self._report = report
        return report

    # -- derived layers --------------------------------------------------

    def _rollups(
        self,
        now: float,
        series: Dict[str, TargetSeries],
        samples: Dict[str, Optional[Dict[str, float]]],
    ) -> Dict[str, float]:
        out: Dict[str, float] = {
            "fleet_targets": float(len(series)),
            "fleet_targets_up": float(
                sum(1 for s in samples.values() if s is not None)
            ),
            "fleet_polls_total": float(self.polls_total),
            "fleet_scrape_errors_total": float(self.scrape_errors_total),
            "fleet_fences_total": float(self.fences_total),
            "fleet_topology_refreshes_total": float(self.topology_refreshes_total),
            "fleet_topology_errors_total": float(self.topology_errors_total),
        }
        by_tier: Dict[str, List[Dict[str, float]]] = {}
        for key, ts in series.items():
            out[f"fleet_tier_up_{ts.tier}"] = out.get(f"fleet_tier_up_{ts.tier}", 0.0)
            sample = samples.get(key)
            if sample is not None:
                out[f"fleet_tier_up_{ts.tier}"] += 1.0
                by_tier.setdefault(ts.tier, []).append(sample)

        def _vals(tier: str, meter: str) -> List[float]:
            return [s[meter] for s in by_tier.get(tier, []) if meter in s]

        # -- SLO layer 1: e2e vs device-only rate (the host-wall gap).
        e2e = sum(_vals("learner", "env_steps_per_sec"))
        out["fleet_e2e_env_steps_per_sec"] = e2e
        device_only = 0.0
        for s in by_tier.get("learner", []):
            rate = s.get("env_steps_per_sec", 0.0)
            wall = s.get("compute_phase_wall_s", 0.0)
            dev = s.get("compute_phase_device_step_s", 0.0)
            if rate > 0.0 and wall > 0.0 and dev > 0.0:
                device_only += rate * (wall / dev)
        if device_only > 0.0:
            out["fleet_device_only_env_steps_per_sec"] = device_only
            if e2e > 0.0:
                out["fleet_host_wall_gap"] = device_only / e2e
        # -- staleness + trace-stage + pipeline-idle distributions.
        for meter, tag in (
            ("trace_e2e_actor_apply_s", "fleet_staleness_e2e_s"),
            ("pipeline_device_idle_s", "fleet_pipeline_device_idle_s"),
            ("pipeline_overlap_ratio", "fleet_pipeline_overlap_ratio"),
        ):
            vals = [
                s[meter] for ss in by_tier.values() for s in ss if meter in s
            ]
            if vals:
                out[f"{tag}_mean"] = sum(vals) / len(vals)
                out[f"{tag}_max"] = max(vals)
        stage_means: Dict[str, List[float]] = {}
        for ss in by_tier.values():
            for s in ss:
                for name, v in s.items():
                    if name.startswith("trace_") and name.endswith("_mean_ms"):
                        stage_means.setdefault(name, []).append(v)
        for name, vals in stage_means.items():
            out[f"fleet_{name}"] = sum(vals) / len(vals)
        # -- serve / league health rollups.
        occ = _vals("serve", "serve_load_occupancy")
        if occ:
            out["fleet_serve_load_occupancy_mean"] = sum(occ) / len(occ)
        out["fleet_serve_carries_resident"] = sum(
            _vals("serve", "serve_carries_resident")
        )
        for tier, meter, tag in (
            ("serve", "serve_requests_total", "fleet_serve_requests_per_sec"),
            ("league", "league_matches_total", "fleet_league_matches_per_sec"),
        ):
            total = sum(_vals(tier, meter))
            if by_tier.get(tier):
                prev = self._rate_anchors.get(tag)
                self._rate_anchors[tag] = (now, total)
                if prev is not None and now > prev[0] and total >= prev[1]:
                    out[tag] = (total - prev[1]) / (now - prev[0])
        out["fleet_league_matches_total"] = sum(
            _vals("league", "league_matches_total")
        )
        return out

    # -- incident fan-in -------------------------------------------------

    def _fan_in_incident(
        self,
        rule: AlertRule,
        now: float,
        series: Dict[str, TargetSeries],
        scalars: Dict[str, float],
    ) -> Optional[str]:
        """A fired alert snapshots EVERY process's /debug/flight ring
        into one correlated bundle, keyed by trace_id where events carry
        one — the cross-process evidence assembled while it is still in
        memory, not after the processes died."""
        flights: Dict[str, Optional[Dict]] = {}
        trace_index: Dict[str, List[str]] = {}
        for key, ts in series.items():
            snap = self._flight(ts.endpoint)
            flights[key] = snap
            if not snap:
                continue
            for ev in snap.get("events", []) or []:
                tid = ev.get("trace")
                if tid is not None:
                    hit = trace_index.setdefault(str(tid), [])
                    if key not in hit:
                        hit.append(key)
        self.incidents_total += 1
        bundle = {
            "alert": rule.raw,
            "meter": rule.meter,
            "value": scalars.get(rule.meter),
            "fired_at": now,
            "fleet": {k: v for k, v in scalars.items()},
            "flights": flights,
            "trace_index": trace_index,
        }
        safe = "".join(
            c if c.isalnum() or c in "-_" else "_" for c in rule.meter
        )[:48]
        directory = self.bundle_dir or os.getcwd()
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(now))
        path = os.path.join(
            directory, f"incident_{safe}_{stamp}_{self.incidents_total}.json"
        )
        try:
            os.makedirs(directory, exist_ok=True)
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(bundle, f, default=str)
            os.replace(tmp, path)  # never leave a half-written bundle
        except Exception:
            _log.exception("incident bundle write failed (%s)", rule.raw)
            return None
        self._incident_paths.append(path)
        _log.warning(
            "alert %s fired: incident bundle %s (%d flight snapshots)",
            rule.raw,
            path,
            sum(1 for v in flights.values() if v),
        )
        return path

    # -- serving surfaces (read by obs/http.py handler threads) ----------

    def scalars(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._scalars)

    def fleet(self) -> Dict:
        with self._lock:
            return dict(self._report)

    def health(self) -> Dict:
        with self._lock:
            report = self._report
        return {
            "ok": bool(report.get("ok", True)),
            "polls": report.get("polls", 0),
            "ledgers": {
                name: entry.get("status")
                for name, entry in (report.get("ledgers") or {}).items()
            },
        }
