"""Metrics sink: JSONL always, TensorBoard when importable (own copy of
dotaclient_tpu/runtime/metrics.py). Scalar names are the reference's, so
training curves of the two learners compare directly."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


def histogram_scalars(prefix: str, edges, counts) -> Dict[str, float]:
    """Flatten a bucketed histogram into scalar names: `{prefix}_le_{edge}`
    per closed bucket plus `{prefix}_gt_{last_edge}` for the open tail.
    `counts` has len(edges)+1 entries; empty `edges` gives {}."""
    if not len(edges):
        return {}
    out = {f"{prefix}_le_{edge}": float(counts[i]) for i, edge in enumerate(edges)}
    out[f"{prefix}_gt_{edges[-1]}"] = float(counts[len(edges)])
    return out


class MetricsLogger:
    def __init__(self, log_dir: str = "", flush_every: int = 20):
        self._tb = None
        self._jsonl = None
        self._flush_every = max(int(flush_every), 1)
        self._writes = 0
        self._closed = False
        # (step, scalars) of the latest window, replaced as one tuple so a
        # reader on another thread never pairs one window's step with
        # another's scalars.
        self._latest_rec: tuple = (-1, {})
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:  # tensorboard is optional: JSONL only
                self._tb = None

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        # A window racing teardown is dropped, not an IO error on a closed file.
        if self._closed:
            return
        clean = {k: float(v) for k, v in scalars.items()}
        self._latest_rec = (step, clean)
        if self._jsonl is not None:
            rec = {"step": step, "time": time.time()}
            rec.update(clean)
            self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(k, v, step)
        self._writes += 1
        if self._writes % self._flush_every == 0:
            self.flush()

    def latest(self) -> Dict[str, float]:
        """A copy of the most recent scalars (empty before the first window)."""
        return dict(self._latest_rec[1])

    def latest_step(self) -> int:
        """Step of the most recent log() (-1 before the first window)."""
        return self._latest_rec[0]

    def flush(self) -> None:
        if self._closed:
            return
        if self._tb is not None:
            self._tb.flush()
        if self._jsonl is not None:
            self._jsonl.flush()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
