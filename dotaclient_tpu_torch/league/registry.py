"""Disk-backed snapshot registry with checkpoint-lineage records (own copy
of dotaclient_tpu/league/registry.py; the on-disk layout is the
reference's, so a registry directory written by either package loads in
the other).

Layout under `root` (root="" keeps everything in memory; a restart then
loses the population):

    <root>/<name>.npz    — one frozen param tree per member, flax-named
                           f32 arrays (numpy archive, no pickles)
    <root>/lineage.json  — the lineage ledger: every member ever admitted,
                           with kind, parent, admission sequence and its
                           event history (admit / promote / evict / lost)
    <root>/matches.jsonl — append-only match log (one JSON object per
                           admission or result); replaying it through a
                           fresh rating table rebuilds the leaderboard

Lineage records are never deleted: an evicted member keeps its row
(status "evicted", params file removed). `lineage.json` is rewritten
atomically (tmp + os.replace) after every change; `matches.jsonl` only
appends. The registry holds no ratings and decides no evictions: the
service (league/server.py) does, and calls `evict(name)`.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

NamedParams = List[Tuple[str, np.ndarray]]

_log = logging.getLogger(__name__)

# Lineage statuses: "pool" members are matchable opponents; "candidate"
# members (exploiters) are matchable but gated — they join the pool only
# through promote(); "evicted" members keep their row, lose their params.
POOL, CANDIDATE, EVICTED = "pool", "candidate", "evicted"


class SnapshotRegistry:
    """Thread-safe (one RLock — the HTTP surface is ThreadingHTTPServer)."""

    def __init__(self, root: str = ""):
        self.root = str(root or "")
        self._lock = threading.RLock()
        self._lineage: Dict[str, dict] = {}
        self._params: Dict[str, NamedParams] = {}  # resident members only
        self._seq = 0
        if self.root:
            os.makedirs(self.root, exist_ok=True)
            self._load()

    # ------------------------------------------------------------ disk

    def _npz_path(self, name: str) -> str:
        return os.path.join(self.root, f"{name}.npz")

    def _lineage_path(self) -> str:
        return os.path.join(self.root, "lineage.json")

    def _matches_path(self) -> str:
        return os.path.join(self.root, "matches.jsonl")

    def _persist_lineage(self) -> None:
        if not self.root:
            return
        tmp = self._lineage_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"seq": self._seq, "members": self._lineage}, f, indent=1)
        os.replace(tmp, self._lineage_path())

    def _load(self) -> None:
        path = self._lineage_path()
        if not os.path.exists(path):
            return
        with open(path) as f:
            body = json.load(f)
        self._seq = int(body.get("seq", 0))
        self._lineage = {str(k): dict(v) for k, v in body.get("members", {}).items()}
        for name, rec in self._lineage.items():
            if rec.get("status") not in (POOL, CANDIDATE):
                continue
            if not os.path.exists(self._npz_path(name)):
                # params lost under us (partial rsync, disk cleanup):
                # the member cannot be served — demote, keep the lineage
                rec["status"] = EVICTED
                rec.setdefault("events", []).append({"event": "lost", "seq": self._seq})
                _log.warning("league registry: %s params missing; marked evicted", name)

    # --------------------------------------------------------- mutation

    def admit(
        self,
        name: str,
        version: int,
        named_params: NamedParams,
        kind: str = "snapshot",
        parent: Optional[str] = None,
    ) -> bool:
        """Register a member. Exploiters enter as gated candidates;
        anything else lands straight in the pool. False if the name is
        already on the ledger (re-admission must not reset lineage)."""
        with self._lock:
            if name in self._lineage:
                return False
            self._seq += 1
            frozen = [(str(k), np.array(v, copy=True)) for k, v in named_params]
            status = CANDIDATE if kind == "exploiter" else POOL
            self._lineage[name] = {
                "name": name,
                "version": int(version),
                "kind": str(kind),
                "parent": parent,
                "seq": self._seq,
                "status": status,
                "param_names": [k for k, _ in frozen],
                "events": [{"event": "admit", "seq": self._seq}],
            }
            self._params[name] = frozen
            if self.root:
                np.savez(self._npz_path(name), **dict(frozen))
                self._persist_lineage()
            return True

    def promote(self, name: str) -> bool:
        """Candidate → pool (the exploiter gate passing); lineage event
        "promote". False unless the member is currently a candidate."""
        with self._lock:
            rec = self._lineage.get(name)
            if rec is None or rec.get("status") != CANDIDATE:
                return False
            self._seq += 1
            rec["status"] = POOL
            rec["events"].append({"event": "promote", "seq": self._seq})
            self._persist_lineage()
            return True

    def evict(self, name: str) -> bool:
        """Drop a member's params; its lineage row stays (status
        "evicted")."""
        with self._lock:
            rec = self._lineage.get(name)
            if rec is None or rec.get("status") == EVICTED:
                return False
            self._seq += 1
            rec["status"] = EVICTED
            rec["events"].append({"event": "evict", "seq": self._seq})
            self._params.pop(name, None)
            if self.root:
                try:
                    os.remove(self._npz_path(name))
                except FileNotFoundError:
                    pass
                self._persist_lineage()
            return True

    # ---------------------------------------------------------- queries

    def __len__(self) -> int:
        with self._lock:
            return len(self.pool())

    def members(self, *statuses: str) -> List[str]:
        """Names with any of `statuses` (admission order)."""
        want = set(statuses) or {POOL}
        with self._lock:
            recs = [r for r in self._lineage.values() if r["status"] in want]
            return [r["name"] for r in sorted(recs, key=lambda r: r["seq"])]

    def pool(self) -> List[str]:
        return self.members(POOL)

    def candidates(self) -> List[str]:
        return self.members(CANDIDATE)

    def record(self, name: str) -> Optional[dict]:
        with self._lock:
            rec = self._lineage.get(name)
            return dict(rec) if rec is not None else None

    def params(self, name: str) -> NamedParams:
        """A resident member's frozen tree (memory cache, else disk)."""
        with self._lock:
            rec = self._lineage.get(name)
            if rec is None or rec["status"] == EVICTED:
                raise KeyError(f"{name!r} is not a resident league member")
            cached = self._params.get(name)
            if cached is not None:
                return cached
            with np.load(self._npz_path(name), allow_pickle=False) as z:
                named = [(k, np.array(z[k])) for k in rec["param_names"]]
            self._params[name] = named
            return named

    def lineage(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._lineage.items()}

    # -------------------------------------------------------- match log

    def append_match(self, result: dict) -> None:
        if not self.root:
            return
        with self._lock:
            with open(self._matches_path(), "a") as f:
                f.write(json.dumps(result) + "\n")

    def iter_matches(self) -> List[dict]:
        if not self.root or not os.path.exists(self._matches_path()):
            return []
        with self._lock:
            with open(self._matches_path()) as f:
                return [json.loads(line) for line in f if line.strip()]
