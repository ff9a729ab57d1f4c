"""Bounded, staleness-aware, prioritized replay reservoir (own copy of
dotaclient_tpu/replay/reservoir.py; host-side numpy and zlib).

Single-writer contract: `offer`/`sample`/`expire` run on exactly one
thread (the staging consumer); only `stats()` is safe from any thread.
Entries are bucketed by behavior-policy version so expiry is a whole-
bucket drop, prioritized by the PER |TD-error| proxy for |advantage|
decayed by age, bounded by a byte budget with lowest-priority-first
eviction, and optionally spilled in place to zlib-compressed storage once
occupancy crosses a threshold. The sampling stream is
`np.random.default_rng(seed)`, so the same offers draw the same samples
as the reference's reservoir.
"""

from __future__ import annotations

import threading
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from dotaclient_tpu_torch.config import ReplayConfig
from dotaclient_tpu_torch.runtime.metrics import histogram_scalars

# Upper edges of the replayed-frame age histogram (in learner versions);
# the last bucket is open-ended. Exported so metrics consumers and tests
# share one bucketing.
AGE_BUCKET_EDGES = (4, 8, 16, 32)


def td_error_priority(rewards, values, dones, gamma: float) -> float:
    """Mean |one-step TD residual| over the chunk — the standard PER
    proxy for |advantage|, computable host-side from the actor-stamped
    behavior values without a learner forward pass. The final step
    bootstraps from its own value (the true bootstrap value lives in the
    obs tail row and is not shipped as a scalar); the bias is uniform
    across candidates, which is all a *ranking* key needs."""
    r = np.asarray(rewards, np.float32)
    if r.size == 0:
        return 0.0
    v = np.asarray(values, np.float32)
    d = np.asarray(dones, np.float32)
    v_next = np.concatenate([v[1:], v[-1:]])
    delta = r + gamma * v_next * (1.0 - d) - v
    # A diverged actor (NaN/inf values or rewards) must yield a FINITE
    # key: a NaN priority would poison the sampling weights and starve
    # batch formation until the entry expired.
    return float(np.nan_to_num(np.mean(np.abs(delta)), nan=0.0, posinf=1e6, neginf=0.0))


class _Entry:
    __slots__ = (
        "eid", "payload", "version", "priority", "nbytes", "raw_nbytes",
        "uses", "compressed", "spill_exempt", "meta",
    )

    def __init__(
        self, eid: int, payload: Any, version: int, priority: float, nbytes: int,
        meta: Any = None,
    ):
        self.eid = eid
        self.payload = payload
        self.version = version
        self.priority = priority
        self.nbytes = nbytes  # current stored size (shrinks on spill)
        self.raw_nbytes = nbytes
        self.uses = 0
        self.compressed = False
        self.spill_exempt = False  # zlib couldn't shrink it; try only once
        # Opaque caller context carried alongside the payload (the obs
        # pipeline's TraceRef). Never encoded/spilled — it rides the
        # entry object, not the payload bytes.
        self.meta = meta


class ReplayReservoir:
    """Version-bucketed prioritized reservoir over opaque payloads.

    `encode(payload) -> bytes` / `decode(bytes) -> payload` adapt the
    two staging item types: the native packer path stores raw wire-frame
    bytes (encode/decode are identity) while the python path stores
    Rollout objects (encode=serialize_rollout, decode=deserialize_rollout).
    Spill compresses `encode(payload)`; sampling a spilled entry returns
    `decode(decompress(...))` without re-inflating the stored copy.
    """

    def __init__(self, cfg: ReplayConfig, encode: Optional[Callable[[Any], bytes]] = None,
                 decode: Optional[Callable[[bytes], Any]] = None, seed: int = 0):
        if not 0.0 <= cfg.ratio < 1.0:
            raise ValueError(f"replay.ratio={cfg.ratio} must be in [0, 1)")
        if cfg.max_staleness < 1:
            raise ValueError(f"replay.max_staleness={cfg.max_staleness} must be >= 1")
        if cfg.byte_budget <= 0:
            raise ValueError(f"replay.byte_budget={cfg.byte_budget} must be positive")
        self.cfg = cfg
        self._encode = encode if encode is not None else (lambda p: p)
        self._decode = decode if decode is not None else (lambda b: b)
        self._rng = np.random.default_rng(seed)
        # version → {entry_id: _Entry}; consumer-thread-only. _count and
        # _bytes are plain ints maintained by the same single writer so
        # stats() can read them from any thread without iterating the
        # buckets mid-mutation.
        self._buckets: Dict[int, Dict[int, _Entry]] = {}
        self._bytes = 0
        self._count = 0
        self._next_id = 0
        self._stats_lock = threading.Lock()
        self._stats = {
            "admitted": 0,
            "rejected_stale": 0,
            "expired": 0,
            "evicted": 0,
            "retired": 0,
            "sampled": 0,
            "spilled_entries": 0,
            "bytes_spilled": 0,
        }
        self._age_hist = [0] * (len(AGE_BUCKET_EDGES) + 1)

    # ------------------------------------------------------------ queries

    @property
    def occupancy(self) -> int:
        return self._count

    @property
    def occupancy_bytes(self) -> int:
        return self._bytes

    # ---------------------------------------------------------- admission

    def offer(self, payload: Any, version: int, priority: float, nbytes: int,
              current_version: int, meta: Any = None) -> bool:
        """Admit one near-stale item. Returns False (rejected) when the
        item is already past the reservoir's own staleness window —
        the caller counts that as a plain stale drop. `meta` is opaque
        caller context (obs TraceRef) returned with the payload by
        sample()."""
        if current_version - version > self.cfg.max_staleness:
            with self._stats_lock:
                self._stats["rejected_stale"] += 1
            return False
        priority = float(priority)
        if not np.isfinite(priority):  # belt-and-braces vs a caller's own key
            priority = 0.0
        e = _Entry(
            self._next_id, payload, version, max(priority, 0.0), int(nbytes), meta=meta
        )
        self._next_id += 1
        self._buckets.setdefault(version, {})[e.eid] = e
        self._bytes += e.nbytes
        self._count += 1
        with self._stats_lock:
            self._stats["admitted"] += 1
        self._maybe_spill(current_version)
        self._evict_over_budget(current_version)
        return True

    def expire(self, current_version: int) -> int:
        """Drop whole buckets older than the staleness window."""
        cutoff = current_version - self.cfg.max_staleness
        dead = [v for v in self._buckets if v < cutoff]
        n = 0
        for v in dead:
            bucket = self._buckets.pop(v)
            n += len(bucket)
            self._bytes -= sum(e.nbytes for e in bucket.values())
            self._count -= len(bucket)
        if n:
            with self._stats_lock:
                self._stats["expired"] += n
        return n

    # ----------------------------------------------------------- sampling

    def _entries(self) -> List[_Entry]:
        return [e for b in self._buckets.values() for e in b.values()]

    def _effective_priorities(self, entries: List[_Entry], current_version: int) -> np.ndarray:
        """PER-style priority^alpha, exponentially decayed by age so an
        equally-surprising older chunk loses to a fresher one."""
        pri = np.asarray([e.priority for e in entries], np.float64) + 1e-6
        age = np.asarray(
            [max(current_version - e.version, 0) for e in entries], np.float64
        )
        w = pri ** self.cfg.alpha * np.exp2(-age / max(self.cfg.age_half_life, 1e-6))
        # Never hand non-finite weights to rng.choice: a single poisoned
        # entry must not make sample() raise forever (the staging consumer
        # would drain fresh frames on every failed attempt).
        return np.nan_to_num(w, nan=0.0, posinf=1e30, neginf=0.0)

    def sample(self, k: int, current_version: int) -> List[Tuple[Any, int, Any]]:
        """Draw up to k distinct entries, priority-weighted, and return
        [(payload, behavior_version, meta)] — `meta` is whatever the
        offer() caller attached (None by default). Entries stay resident
        (classic PER reuse) until they expire, are evicted, or hit the
        per-entry `max_replays` cap (then retired). Call `expire` first;
        this method assumes the window is already clean."""
        entries = self._entries()
        k = min(k, len(entries))
        if k <= 0:
            return []
        w = self._effective_priorities(entries, current_version)
        total = float(w.sum())
        # Uniform fallback whenever weighted choice can't draw k distinct
        # entries — including the age-decay-underflow case where fewer
        # than k entries carry nonzero weight (rng.choice would raise,
        # and sample() must never raise: the staging consumer has already
        # committed this batch's fresh rows).
        if total <= 0 or int(np.count_nonzero(w)) < k:
            idx = self._rng.choice(len(entries), size=k, replace=False)
        else:
            idx = self._rng.choice(len(entries), size=k, replace=False, p=w / total)
        out = []
        retired = 0
        for i in idx:
            e = entries[int(i)]
            if e.compressed:
                payload = self._decode(zlib.decompress(e.payload))
            else:
                payload = e.payload
            out.append((payload, e.version, e.meta))
            e.uses += 1
            age = max(current_version - e.version, 0)
            b = 0
            while b < len(AGE_BUCKET_EDGES) and age > AGE_BUCKET_EDGES[b]:
                b += 1
            with self._stats_lock:
                self._age_hist[b] += 1
            if self.cfg.max_replays > 0 and e.uses >= self.cfg.max_replays:
                self._remove(e)
                retired += 1
        with self._stats_lock:
            self._stats["sampled"] += len(out)
            self._stats["retired"] += retired
        return out

    # ----------------------------------------------------- budget / spill

    def _remove(self, e: _Entry) -> None:
        bucket = self._buckets.get(e.version)
        if bucket and bucket.pop(e.eid, None) is not None:
            self._bytes -= e.nbytes
            self._count -= 1
            if not bucket:
                del self._buckets[e.version]

    def _evict_over_budget(self, current_version: int) -> None:
        """Lowest-effective-priority-first eviction down to the budget.
        One priority pass + one argsort for the whole burst — not a full
        rescan per evicted entry (this runs on the staging consumer's
        critical path)."""
        if self._bytes <= self.cfg.byte_budget:
            return
        entries = self._entries()
        if not entries:
            return
        w = self._effective_priorities(entries, current_version)
        n_evicted = 0
        for i in np.argsort(w):  # coldest first
            if self._bytes <= self.cfg.byte_budget:
                break
            self._remove(entries[int(i)])
            n_evicted += 1
        if n_evicted:
            with self._stats_lock:
                self._stats["evicted"] += n_evicted

    def _maybe_spill(self, current_version: int) -> None:
        """Compress the coldest entries in place once occupancy crosses
        `spill_threshold` of the budget — buys headroom before eviction
        has to throw priorities away. Skips entries compression cannot
        shrink (already-dense wire bytes compress ~3-5x in practice)."""
        if not self.cfg.spill_compress:
            return
        threshold = self.cfg.spill_threshold * self.cfg.byte_budget
        if self._bytes <= threshold:
            return
        entries = [e for e in self._entries() if not e.compressed and not e.spill_exempt]
        if not entries:
            return
        w = self._effective_priorities(entries, current_version)
        spilled = bytes_spilled = 0
        for i in np.argsort(w):  # coldest first
            if self._bytes <= threshold:
                break
            e = entries[int(i)]
            packed = zlib.compress(self._encode(e.payload), level=1)
            if len(packed) >= e.nbytes:
                # incompressible: never pay this zlib pass for it again
                e.spill_exempt = True
                continue
            self._bytes -= e.nbytes - len(packed)
            bytes_spilled += e.raw_nbytes
            e.payload = packed
            e.nbytes = len(packed)
            e.compressed = True
            spilled += 1
        if spilled:
            with self._stats_lock:
                self._stats["spilled_entries"] += spilled
                self._stats["bytes_spilled"] += bytes_spilled

    # ------------------------------------------------- checkpoint support

    def snapshot(self) -> dict:
        """Consumer-thread-only (single-writer contract): a serializable
        image of the reservoir for the full-state checkpoint — encoded
        payload bytes with their compression state, ABSOLUTE behavior
        versions (so restored staleness stamps are exact, not re-aged),
        priorities and use counts, plus the sampling RNG's bit-generator
        state so the post-restore draw sequence continues the pre-kill
        stream bit-for-bit (the resume soak's bit-exactness depends on
        it). Entry `meta` (obs TraceRefs) is process-local and
        deliberately NOT captured — a restored entry re-enters the trace
        pipeline as untraced."""
        entries = []
        for bucket in self._buckets.values():
            for e in bucket.values():
                payload = e.payload if e.compressed else self._encode(e.payload)
                entries.append(
                    {
                        "payload": bytes(payload),
                        "compressed": e.compressed,
                        "version": int(e.version),
                        "priority": float(e.priority),
                        "uses": int(e.uses),
                        "raw_nbytes": int(e.raw_nbytes),
                        "spill_exempt": bool(e.spill_exempt),
                    }
                )
        return {"entries": entries, "rng_state": self._rng.bit_generator.state}

    def restore(self, snap: dict) -> int:
        """Rebuild entries + RNG stream from a snapshot(). PRE-START
        only: must run before the staging consumer thread exists (the
        learner restores in __init__), so there is no concurrent writer
        to race. Returns the number of entries restored."""
        n = 0
        for rec in snap.get("entries", []):
            if rec["compressed"]:
                payload, nbytes = rec["payload"], len(rec["payload"])
            else:
                payload, nbytes = self._decode(rec["payload"]), rec["raw_nbytes"]
            e = _Entry(
                self._next_id, payload, rec["version"], rec["priority"], nbytes, meta=None
            )
            e.uses = rec["uses"]
            e.compressed = rec["compressed"]
            e.raw_nbytes = rec["raw_nbytes"]
            e.spill_exempt = rec.get("spill_exempt", False)
            self._next_id += 1
            self._buckets.setdefault(e.version, {})[e.eid] = e
            self._bytes += e.nbytes
            self._count += 1
            n += 1
        rng_state = snap.get("rng_state")
        if rng_state is not None:
            self._rng.bit_generator.state = rng_state
        return n

    # ------------------------------------------------------------- stats

    def stats(self) -> Dict[str, float]:
        with self._stats_lock:
            out = dict(self._stats)
            hist = list(self._age_hist)
        out["occupancy"] = self.occupancy
        out["occupancy_bytes"] = self._bytes
        out.update(histogram_scalars("age", AGE_BUCKET_EDGES, hist))
        return out
