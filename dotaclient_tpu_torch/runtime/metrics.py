"""Metrics sink (own copy of dotaclient_tpu/runtime/metrics.py): JSONL and
a TensorBoard event file. Scalar names are the reference's, so training
curves of the two learners compare directly.

The event file is written by the port itself (TFRecord framing of Event
records through protos/event.py), not by `torch.utils.tensorboard`, whose
import brings in `tensorboard`, `google.protobuf` and `grpc`: a learner
process holds none of them.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
from typing import Dict

from dotaclient_tpu_torch.protos.event import Event, Summary, SummaryValue


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def masked_crc32c(data: bytes) -> int:
    """The TFRecord checksum: CRC-32C (Castagnoli), rotated right by 15
    and offset by 0xa282ead8."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


class EventFileWriter:
    """A TensorBoard event file in `log_dir`
    (events.out.tfevents.<time>.<host>.<pid>): the file-version record,
    then one Event per `add_scalars` call carrying each scalar as a
    Summary value."""

    def __init__(self, log_dir: str):
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}"
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        self._write(Event(wall_time=time.time(), file_version="brain.Event:2"))

    def _write(self, event: Event) -> None:
        data = event.SerializeToString()
        head = struct.pack("<Q", len(data))
        self._f.write(head + struct.pack("<I", masked_crc32c(head)) + data + struct.pack("<I", masked_crc32c(data)))

    def add_scalars(self, step: int, scalars: Dict[str, float], wall_time: float) -> None:
        self._write(Event(wall_time=wall_time, step=step, summary=Summary(
            value=[SummaryValue(tag=k, simple_value=v) for k, v in scalars.items()])))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


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
            self._tb = EventFileWriter(log_dir)

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        # A window racing teardown is dropped, not an IO error on a closed file.
        if self._closed:
            return
        clean = {k: float(v) for k, v in scalars.items()}
        self._latest_rec = (step, clean)
        now = time.time()
        if self._jsonl is not None:
            rec = {"step": step, "time": now}
            rec.update(clean)
            self._jsonl.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalars(step, clean, now)
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
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
