"""Declarative scaling policy: thresholds with hysteresis + cooldowns (own
copy of dotaclient_tpu/control/policy.py).

The --control.policy grammar is ";"-separated clauses:

    tier:meter,high=H,low=L[,min=M][,max=X][,cooldown=C][,step=S]

    server:serve_load_occupancy.mean,high=0.8,low=0.2,min=2,max=8,cooldown=30
    broker:fabric_shard_depth.max,high=6000,low=500,min=2,max=8
    actor:up.sum,high=1e18,low=1,min=4,max=256

One clause = one meter watched for one tier. The decision rule is the
--shed_high/--shed_low watermark discipline applied to topology:

- meter > high  → scale UP by `step`   (clamped to max)
- meter < low   → scale DOWN by `step` (clamped to min)
- low <= meter <= high → HOLD — the hysteresis band. Size it so the
  meter's expected post-scale move lands INSIDE the band: scaling up at
  occupancy 0.8 drops per-replica load by ~1/n, so `low` must sit below
  high*(1 - 1/min) or every scale-up earns an immediate scale-down and
  the controller oscillates (the classic thrash).
- at most one move per tier per `cooldown` seconds — scrapes are
  near-instant but the fleet's response (pod schedule, client
  re-discovery, queue drain) is not; the cooldown makes the controller
  wait for its own last action's effect before judging the meter again.

Every evaluation — moves AND holds — is returned as a record carrying
the meter value and thresholds that justified it; the control loop
ledgers them, so each decision can be checked against its triggering
meters. Unknown/missing meters HOLD loudly (reason
"meter missing"), never default to a number: a scraper outage must
freeze topology, not shrink it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

VALID_TIERS = ("broker", "server", "actor", "store", "learner")


@dataclass(frozen=True)
class PolicyClause:
    tier: str
    meter: str  # aggregated meter name, e.g. "serve_load_occupancy.mean"
    high: float
    low: float
    min: int = 1
    max: int = 8
    cooldown_s: float = 30.0
    step: int = 1


def parse_policy(spec: str) -> List[PolicyClause]:
    """Parse --control.policy; loud ValueError on malformation (the
    parse_endpoints discipline — a typo'd policy must fail the
    controller at boot, never silently observe-only)."""
    clauses: List[PolicyClause] = []
    if not str(spec).strip():
        return clauses
    for raw in str(spec).split(";"):
        raw = raw.strip()
        if not raw:
            raise ValueError(f"policy has an empty clause: {spec!r}")
        head, _, tail = raw.partition(",")
        tier, sep, meter = head.partition(":")
        tier = tier.strip()
        meter = meter.strip()
        if not sep or not meter:
            raise ValueError(f"policy clause needs tier:meter, got {raw!r}")
        if tier not in VALID_TIERS:
            raise ValueError(f"unknown policy tier {tier!r} in {raw!r}")
        kv: Dict[str, float] = {}
        for item in tail.split(",") if tail else []:
            k, s, v = item.strip().partition("=")
            if not s:
                raise ValueError(f"policy clause item needs k=v, got {item!r} in {raw!r}")
            try:
                kv[k.strip()] = float(v)
            except ValueError:
                raise ValueError(f"policy value is not a number: {item!r} in {raw!r}") from None
        unknown = set(kv) - {"high", "low", "min", "max", "cooldown", "step"}
        if unknown:
            raise ValueError(f"unknown policy keys {sorted(unknown)} in {raw!r}")
        if "high" not in kv or "low" not in kv:
            raise ValueError(f"policy clause needs high= and low=: {raw!r}")
        clause = PolicyClause(
            tier=tier,
            meter=meter,
            high=kv["high"],
            low=kv["low"],
            min=int(kv.get("min", 1)),
            max=int(kv.get("max", 8)),
            cooldown_s=float(kv.get("cooldown", 30.0)),
            step=int(kv.get("step", 1)),
        )
        if clause.low >= clause.high:
            raise ValueError(
                f"policy needs low < high (the hysteresis band), got {raw!r}"
            )
        if clause.min < 1 or clause.max < clause.min or clause.step < 1:
            raise ValueError(f"policy bounds need 1 <= min <= max, step >= 1: {raw!r}")
        clauses.append(clause)
    return clauses


class PolicyEngine:
    """Evaluates the clause list against one poll's aggregated meters.
    Holds the per-tier cooldown clocks; injectable `now_fn` so tests drive
    virtual time."""

    def __init__(self, clauses: List[PolicyClause], now_fn: Callable[[], float] = time.monotonic):
        self.clauses = list(clauses)
        self._now = now_fn
        self._last_move: Dict[str, float] = {}

    def evaluate(
        self,
        meters: Dict[str, Dict[str, float]],
        current: Dict[str, int],
    ) -> List[dict]:
        """One record per clause: tier, meter, value, high/low, current,
        target, action ("up"|"down"|"hold"), reason. At most one MOVE
        per tier per call (clause order wins; later clauses for a moved
        tier hold with reason "superseded")."""
        now = self._now()
        out: List[dict] = []
        moved: set = set()
        for cl in self.clauses:
            cur = int(current.get(cl.tier, 0))
            rec = {
                "tier": cl.tier,
                "meter": cl.meter,
                "value": None,
                "high": cl.high,
                "low": cl.low,
                "current": cur,
                "target": cur,
                "action": "hold",
                "reason": "",
            }
            value: Optional[float] = meters.get(cl.tier, {}).get(cl.meter)
            if value is None:
                rec["reason"] = "meter missing"
                out.append(rec)
                continue
            rec["value"] = value
            if cl.tier in moved:
                rec["reason"] = "superseded"
                out.append(rec)
                continue
            if value > cl.high:
                want, direction = min(cur + cl.step, cl.max), "up"
            elif value < cl.low:
                want, direction = max(cur - cl.step, cl.min), "down"
            else:
                rec["reason"] = "in hysteresis band"
                out.append(rec)
                continue
            if want == cur:
                rec["reason"] = f"at {'max' if direction == 'up' else 'min'} bound"
                out.append(rec)
                continue
            last = self._last_move.get(cl.tier)
            if last is not None and (now - last) < cl.cooldown_s:
                rec["reason"] = f"cooldown ({cl.cooldown_s - (now - last):.1f}s left)"
                out.append(rec)
                continue
            rec["target"] = want
            rec["action"] = direction
            rec["reason"] = (
                f"{cl.meter}={value:.6g} {'>' if direction == 'up' else '<'} "
                f"{cl.high if direction == 'up' else cl.low:.6g}"
            )
            self._last_move[cl.tier] = now
            moved.add(cl.tier)
            out.append(rec)
        return out
