"""The league-service binary (own copy of dotaclient_tpu/league/server.py):
registry + matchmaking + ratings, standing.

    python -m dotaclient_tpu_torch.league.server \\
        --league.dir /data/league --league.slots 3 \\
        --league.policy "prioritized@0.7;exploiter@0.3" \\
        --league.serve_endpoint inference:13380 --league.port 13410

- GET  /match       → {"name", "model", "serve", "role", "policy",
                      "version"}: the caller plays `name`, resident on
                      serve model slot `model` at `serve`; `name: null`
                      = empty pool (the caller plays a mirror).
- POST /result      → {"winner", "loser", "draw"}: TrueSkill ingestion;
                      appends matches.jsonl, drives the exploiter gates.
- GET  /leaderboard → ratings sorted by conservative skill.
- GET  /lineage     → the checkpoint-lineage ledger.
- GET  /assignments → slot → {name, version}; the serve tier's league
                      sync polls it and installs changed slots through
                      GET /snapshot?name=.
- GET  /snapshot?name=X / POST /snapshot → param trees out / in (base64
                      JSON).
- GET  /metrics, /healthz, /debug/flight — the league_* gauges.

Boot replays matches.jsonl through a fresh RatingTable, so ratings and
the exploiter gates are rebuilt exactly from the match log. Matchmaking
draws come from `random.Random(--league.seed)`, as the reference's do, so
one request script gets the reference's answers. Numpy and the standard
library only: nothing here touches the device.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from dotaclient_tpu_torch.config import LeagueConfig, parse_config
from dotaclient_tpu_torch.eval.league import AGENT
from dotaclient_tpu_torch.eval.rating import Rating, RatingTable
from dotaclient_tpu_torch.league.policy import parse_match_policy
from dotaclient_tpu_torch.league.registry import CANDIDATE, SnapshotRegistry
from dotaclient_tpu_torch.obs.flight_recorder import FlightRecorder
from dotaclient_tpu_torch.obs.http import MetricsHTTPServer

_log = logging.getLogger(__name__)


def _encode_named(named) -> Dict[str, dict]:
    """Param tree → the b64 JSON wire form the serve sync decodes
    (serve/server.py _league_sync_once). dict order IS the tree order —
    JSON objects round-trip insertion order."""
    out = {}
    for name, arr in named:
        a = np.ascontiguousarray(arr)
        out[str(name)] = {
            "dtype": a.dtype.name,
            "shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode("ascii"),
        }
    return out


def _decode_named(params: Dict[str, dict]):
    return [
        (
            str(name),
            np.frombuffer(
                base64.b64decode(rec["b64"]), dtype=np.dtype(rec["dtype"])
            ).reshape(rec["shape"]),
        )
        for name, rec in params.items()
    ]


class LeagueService:
    """The standing population. All mutation under one RLock (the HTTP
    surface is ThreadingHTTPServer); the registry locks independently."""

    def __init__(self, cfg: LeagueConfig, registry: Optional[SnapshotRegistry] = None):
        self.cfg = cfg.league
        self.obs_cfg = cfg.obs
        self.registry = registry if registry is not None else SnapshotRegistry(self.cfg.dir)
        self.clauses = parse_match_policy(self.cfg.policy)
        self.table = RatingTable()
        self.table.add(AGENT)
        self._lock = threading.RLock()
        # stdlib RNG on purpose (no numpy state to carry): matchmaking
        # draws are deterministic per --league.seed.
        import random

        self._rng = random.Random(int(self.cfg.seed))
        # Gate bookkeeping: candidate name → [wins vs AGENT, games vs
        # AGENT]; rebuilt bit-for-bit by the boot replay.
        self._gate: Dict[str, List[int]] = {}
        self._slots: Dict[int, str] = {}
        self._last_snap_version: Optional[int] = None
        self.matches_total = 0
        self.match_empty_total = 0
        self.results_total = 0
        self.bad_results_total = 0
        self.snapshots_total = 0
        self.evictions_total = 0
        self.promotions_total = 0
        self.fanout_snapshots_total = 0
        self.fanout_errors_total = 0
        self._http: Optional[MetricsHTTPServer] = None
        self._stop = threading.Event()
        self._fanout_thread: Optional[threading.Thread] = None
        # Crash ring for fleetd's GET /debug/flight fan-in: promotions
        # and gate verdicts are the league's load-bearing events.
        self.recorder = FlightRecorder(
            "league", ring_size=self.obs_cfg.ring_size, dump_dir=self.obs_cfg.dump_dir
        )
        # Boot replay: the match log is the rating service's WAL.
        for rec in self.registry.iter_matches():
            self._ingest(rec, replay=True)
        self._assign_slots()

    # --------------------------------------------------------- population

    def ingest_snapshot(
        self,
        name: str,
        version: int,
        named_params,
        kind: str = "snapshot",
        parent: Optional[str] = None,
    ) -> bool:
        """Admit a member; pool overflow evicts by the eval/league.py
        rule (weakest by mu, never the newest). A fresh member inherits
        the agent's current rating — it IS a frozen agent (or claims to
        beat one)."""
        with self._lock:
            if not self.registry.admit(name, version, named_params, kind=kind, parent=parent):
                return False
            self.snapshots_total += 1
            # Admission rides the match log through the same _ingest path
            # as results: the inherited rating is frozen into the entry as
            # the exact floats used live, so the boot replay seats every
            # member (played or not) and every exploiter gate bit-for-bit.
            inherited = self.table.get(AGENT)
            admit_entry = {
                "admit": name,
                "mu": inherited.mu,
                "sigma": inherited.sigma,
                "kind": str(kind),
            }
            self._ingest(admit_entry, replay=False)
            self.registry.append_match(admit_entry)
            pool = self.registry.pool()
            while len(pool) > int(self.cfg.capacity):
                newest = max(pool, key=lambda n: self.registry.record(n)["seq"])
                weakest = min(
                    (n for n in pool if n != newest),
                    key=lambda n: self.table.get(n).mu,
                )
                self.registry.evict(weakest)
                self.evictions_total += 1
                pool = self.registry.pool()
            self._assign_slots()
            return True

    def maybe_snapshot(self, version: int, named_params) -> bool:
        """Fan-out-fed admission at --league.snapshot_every cadence —
        the eval/league.py gating, version-regression reset included."""
        with self._lock:
            if self._last_snap_version is not None and version < self._last_snap_version:
                self._last_snap_version = None
            if (
                self._last_snap_version is not None
                and version - self._last_snap_version < int(self.cfg.snapshot_every)
            ):
                return False
            if not self.ingest_snapshot(f"v{version}", version, named_params):
                return False
            self._last_snap_version = int(version)
            return True

    def _assign_slots(self) -> None:
        """Map serve model slots 1..slots onto the most recent resident
        members (candidates included — gates need games). STABLE where
        possible: a member already resident on a slot keeps it (the
        serve sync only re-installs changed slots), freed slots refill
        from the newest unassigned members.

        Takes the instance RLock itself (callers already hold it; boot
        doesn't): _slots is mutated in place and read from the HTTP
        threads — both sides stay lexically guarded."""
        with self._lock:
            members = self.registry.members("pool", "candidate")
            want = set(
                sorted(members, key=lambda n: -self.registry.record(n)["seq"])[
                    : max(0, int(self.cfg.slots))
                ]
            )
            self._slots = {s: n for s, n in self._slots.items() if n in want}
            taken = set(self._slots.values())
            free = [s for s in range(1, int(self.cfg.slots) + 1) if s not in self._slots]
            for name in sorted(want - taken, key=lambda n: self.registry.record(n)["seq"]):
                if not free:
                    break
                self._slots[free.pop(0)] = name

    # -------------------------------------------------------- matchmaking

    def match(self, params: Optional[dict] = None) -> dict:
        """One /match draw: clause by weight, opponent under the clause's
        rule, restricted to serve-ASSIGNED members (a match the fleet
        cannot step is not a match)."""
        with self._lock:
            clause = self._draw_clause()
            by_name = {n: s for s, n in self._slots.items()}
            cands = [n for n in self.registry.candidates() if n in by_name]
            pool = [n for n in self.registry.pool() if n in by_name]
            name = None
            role = "opponent"
            if clause.kind == "exploiter" and cands:
                # exploiter-vs-main: seed the newest candidate with the
                # games its promotion gate needs.
                name = max(cands, key=lambda n: self.registry.record(n)["seq"])
                role = "exploiter"
            elif clause.kind == "prioritized" and pool:
                name = self._prioritized_draw(pool)
            elif pool or cands:
                name = self._rng.choice(pool or cands)
            self.matches_total += 1
            if name is None:
                self.match_empty_total += 1
                return {"ok": True, "name": None, "policy": clause.kind}
            return {
                "ok": True,
                "name": name,
                "model": by_name[name],
                "serve": str(self.cfg.serve_endpoint),
                "role": role,
                "policy": clause.kind,
                "version": int(self.registry.record(name)["version"]),
            }

    def _draw_clause(self):
        total = sum(c.weight for c in self.clauses)
        x = self._rng.random() * total
        for c in self.clauses:
            x -= c.weight
            if x <= 0:
                return c
        return self.clauses[-1]

    def _prioritized_draw(self, pool: List[str]) -> str:
        """PFSP-hard over observed results: weight = opponent's win rate
        vs the agent, floored so an unplayed member is still pickable
        (it needs games to be rated at all).

        Takes the RLock itself (match() already holds it): the gate
        ledgers are mutated in place by result ingestion on the HTTP
        threads."""
        weights = []
        with self._lock:
            for n in pool:
                wins, games = self._gate.get(n, [0, 0])
                weights.append((wins / games if games else 0.5) + 0.05)
        total = sum(weights)
        x = self._rng.random() * total
        for n, w in zip(pool, weights):
            x -= w
            if x <= 0:
                return n
        return pool[-1]

    # ------------------------------------------------------------ results

    def result(self, body: bytes) -> dict:
        try:
            rec = json.loads(body.decode("utf-8"))
        except Exception:
            raise ValueError("POST /result wants a JSON body")
        winner = rec.get("winner")
        loser = rec.get("loser")
        if not isinstance(winner, str) or not isinstance(loser, str) or winner == loser:
            self.bad_results_total += 1
            raise ValueError(f"result wants distinct winner/loser names, got {rec!r}")
        entry = {"winner": winner, "loser": loser, "draw": bool(rec.get("draw", False))}
        out = self._ingest(entry, replay=False)
        self.registry.append_match(entry)
        return out

    def _ingest(self, entry: dict, replay: bool) -> dict:
        """Shared by live ingestion and the boot replay — ONE code path
        is what makes the replayed leaderboard bit-for-bit."""
        with self._lock:
            if "admit" in entry:
                # Admission event (written by ingest_snapshot, replayed at
                # boot): seat the member at its frozen inherited rating and
                # open the exploiter gate. Not a result — no counters move.
                name = str(entry["admit"])
                self.table.add(
                    name, rating=Rating(float(entry["mu"]), float(entry["sigma"]))
                )
                if entry.get("kind") == "exploiter":
                    self._gate.setdefault(name, [0, 0])
                return {"ok": True, "promoted": None}
            winner, loser, draw = entry["winner"], entry["loser"], bool(entry["draw"])
            self.table.record(winner, loser, draw=draw)
            self.results_total += 1
            promoted = None
            for cand, opp in ((winner, loser), (loser, winner)):
                gate = self._gate.get(cand)
                if gate is None or opp != AGENT:
                    continue
                gate[1] += 1
                if cand == winner and not draw:
                    gate[0] += 1
                if (
                    gate[1] >= int(self.cfg.gate_games)
                    and gate[0] / gate[1] >= float(self.cfg.gate_winrate)
                    and self.registry.promote(cand)
                ):
                    promoted = cand
                    self.promotions_total += 1
                    if not replay:
                        _log.info(
                            "league: promoted exploiter %s (%d/%d vs %s)",
                            cand, gate[0], gate[1], AGENT,
                        )
                        self.recorder.record(
                            "promotion", name=cand, wins=gate[0], games=gate[1]
                        )
            return {"ok": True, "promoted": promoted}

    # ----------------------------------------------------------- queries

    def leaderboard(self) -> dict:
        with self._lock:
            return {
                "ok": True,
                "leaderboard": [
                    {
                        "name": name,
                        "mu": r.mu,
                        "sigma": r.sigma,
                        "conservative": r.conservative,
                        "games": self.table.games.get(name, 0),
                    }
                    for name, r in self.table.leaderboard()
                ],
            }

    def lineage(self) -> dict:
        return {"ok": True, "lineage": self.registry.lineage()}

    def assignments(self) -> dict:
        with self._lock:
            return {
                "ok": True,
                "assignments": {
                    str(s): {
                        "name": n,
                        "version": int(self.registry.record(n)["version"]),
                    }
                    for s, n in self._slots.items()
                },
            }

    def snapshot_get(self, params: dict) -> dict:
        names = params.get("name") or []
        if not names:
            raise ValueError("GET /snapshot wants ?name=<member>")
        name = str(names[0])
        rec = self.registry.record(name)
        named = self.registry.params(name)  # KeyError → 400
        return {
            "ok": True,
            "name": name,
            "version": int(rec["version"]),
            "params": _encode_named(named),
        }

    def snapshot_post(self, body: bytes) -> dict:
        try:
            rec = json.loads(body.decode("utf-8"))
        except Exception:
            raise ValueError("POST /snapshot wants a JSON body")
        name = rec.get("name")
        if not isinstance(name, str) or not name:
            raise ValueError("snapshot wants a string name")
        named = _decode_named(rec.get("params") or {})
        if not named:
            raise ValueError("snapshot wants a non-empty params tree")
        admitted = self.ingest_snapshot(
            name,
            int(rec.get("version", 0)),
            named,
            kind=str(rec.get("kind", "snapshot")),
            parent=rec.get("parent"),
        )
        return {"ok": True, "admitted": admitted}

    # ---------------------------------------------------------- surfaces

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {
                "league_pool_size": float(len(self.registry.pool())),
                "league_candidates": float(len(self.registry.candidates())),
                "league_slots_assigned": float(len(self._slots)),
                "league_snapshots_total": float(self.snapshots_total),
                "league_evictions_total": float(self.evictions_total),
                "league_promotions_total": float(self.promotions_total),
                "league_matches_total": float(self.matches_total),
                "league_match_empty_total": float(self.match_empty_total),
                "league_results_total": float(self.results_total),
                "league_bad_results_total": float(self.bad_results_total),
                "league_fanout_snapshots_total": float(self.fanout_snapshots_total),
                "league_fanout_errors_total": float(self.fanout_errors_total),
            }

    def health(self) -> dict:
        with self._lock:
            return {
                "ok": True,
                "role": "league",
                "pool": len(self.registry.pool()),
                "candidates": len(self.registry.candidates()),
                "results": self.results_total,
            }

    # --------------------------------------------------------- lifecycle

    @property
    def port(self) -> int:
        return self._http.port if self._http is not None else int(self.cfg.port)

    def start(self) -> "LeagueService":
        self._http = MetricsHTTPServer(
            int(self.cfg.port),
            sources=[self.stats],
            health_provider=self.health,
            json_routes={
                "/leaderboard": self.leaderboard,
                "/lineage": self.lineage,
                "/assignments": self.assignments,
            },
            query_routes={"/match": self.match, "/snapshot": self.snapshot_get},
            post_routes={"/result": self.result, "/snapshot": self.snapshot_post},
            flight_provider=self.recorder.snapshot,
        ).start()
        if str(self.cfg.broker_url):
            self._fanout_thread = threading.Thread(
                target=self._fanout_loop, daemon=True, name="league-fanout"
            )
            self._fanout_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._fanout_thread is not None:
            self._fanout_thread.join(timeout=10)
            self._fanout_thread = None
        if self._http is not None:
            self._http.stop()
            self._http = None

    def _fanout_loop(self) -> None:
        """Registry feed off the learner's weight fanout: poll the weight
        stream the actors subscribe to and admit snapshots at the cadence
        gate. Without --league.broker_url the transport modules are never
        imported here."""
        from dotaclient_tpu_torch.transport.base import connect as broker_connect
        from dotaclient_tpu_torch.transport.serialize import deserialize_weights

        try:
            broker = broker_connect(str(self.cfg.broker_url))
        except Exception:
            self.fanout_errors_total += 1
            _log.exception("league: weight-fanout connect failed; feed disabled")
            return
        while not self._stop.wait(float(self.cfg.poll_s)):
            try:
                frame = broker.poll_weights()
                if frame is None:
                    continue
                named, version, _boot = deserialize_weights(frame)
                if self.maybe_snapshot(int(version), named):
                    self.fanout_snapshots_total += 1
            except Exception:
                self.fanout_errors_total += 1
                _log.exception("league: weight-fanout poll failed")


def main(argv=None):
    from dotaclient_tpu_torch.obs import ObsRuntime

    logging.basicConfig(level=logging.INFO)
    cfg = parse_config(LeagueConfig(), argv)
    service = LeagueService(cfg).start()
    obs = ObsRuntime.create(cfg.obs, role="league")
    if obs is not None and cfg.obs.metrics_port not in (0, int(cfg.league.port)):
        obs.serve_metrics([service.stats])
    print(
        json.dumps(
            {
                "serving": True,
                "port": service.port,
                "pool": len(service.registry.pool()),
                "policy": cfg.league.policy,
            }
        ),
        flush=True,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        service.stop()
        if obs is not None:
            obs.close()


if __name__ == "__main__":
    main()
