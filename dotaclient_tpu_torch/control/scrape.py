"""Meter acquisition for the control loop (own copy of
dotaclient_tpu/control/scrape.py): scrape the fleet's obs surfaces
(obs/http.py /metrics Prometheus text + /healthz JSON) and aggregate per
tier.

Stdlib only (urllib): the controller is a small standing pod and never
loads torch, numpy or the wire stack; it scrapes the same endpoints the
k8s probes and an operator's `curl` hit.

A failed scrape is data, not an error path: the sample is dropped, the
tier's `up` count falls, and the policy sees the reduced aggregate.
"""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

_log = logging.getLogger(__name__)

# The obs/http.py exposition prefix, stripped on parse so policy specs
# name scalars the way the registry does ("serve_load_occupancy", not
# "dotaclient_serve_load_occupancy").
PREFIX = "dotaclient_"


def parse_prometheus_text(text: str, prefix: str = PREFIX) -> Dict[str, float]:
    """The inverse of obs/http.py render_prometheus: `name value` lines
    → {name: float}, comments/TYPE lines skipped, the exposition prefix
    stripped. Unparseable lines are dropped (a scraper must survive a
    surface it half-understands)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name, _, value = line.partition(" ")
        try:
            v = float(value)
        except ValueError:
            continue
        if name.startswith(prefix):
            name = name[len(prefix):]
        out[name] = v
    return out


def scrape_endpoint(endpoint: str, timeout_s: float = 2.0) -> Optional[Dict[str, float]]:
    """GET http://<endpoint>/metrics → scalar dict; None on ANY failure
    (dial, timeout, bad body) — the caller counts it against `up`."""
    try:
        with urllib.request.urlopen(
            f"http://{endpoint}/metrics", timeout=timeout_s
        ) as resp:
            return parse_prometheus_text(resp.read().decode("utf-8", "replace"))
    except Exception as e:
        _log.debug("scrape %s failed: %s", endpoint, e)
        return None


def scrape_health(endpoint: str, timeout_s: float = 2.0) -> Tuple[bool, Dict]:
    """GET http://<endpoint>/healthz → (ok, body). The obs/http.py
    contract: 200 = ok, 503 = a tripped watchdog (the 503 BODY still
    carries the verdict — surface it, the controller ledgers why)."""
    try:
        with urllib.request.urlopen(
            f"http://{endpoint}/healthz", timeout=timeout_s
        ) as resp:
            return True, json.loads(resp.read().decode("utf-8", "replace"))
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read().decode("utf-8", "replace"))
        except Exception:
            body = {}
        return False, body
    except Exception as e:
        _log.debug("healthz %s failed: %s", endpoint, e)
        return False, {}


def aggregate_tier(samples: List[Optional[Dict[str, float]]]) -> Dict[str, float]:
    """Per-tier meter namespace from per-replica scrapes: for every
    scalar any replica reported, `<name>.mean`, `<name>.max`, and
    `<name>.sum` over the replicas that reported it, plus `up` (scrapes
    that succeeded) and `scraped` (scrapes attempted). Policy meters
    name these directly — e.g. `serve_load_occupancy.mean` for tier
    load, `fabric_shard_depth.max` for the deepest broker shard."""
    alive = [s for s in samples if s is not None]
    out: Dict[str, float] = {
        "up": float(len(alive)),
        "scraped": float(len(samples)),
    }
    names = set()
    for s in alive:
        names.update(s)
    for name in names:
        vals = [s[name] for s in alive if name in s]
        out[f"{name}.mean"] = sum(vals) / len(vals)
        out[f"{name}.max"] = max(vals)
        out[f"{name}.sum"] = sum(vals)
    return out
