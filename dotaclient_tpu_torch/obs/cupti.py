"""Device traces straight from CUPTI's activity API (ctypes), without
kineto: the route POST /profile takes on the card.

torch.profiler hands CUPTI's records to kineto, and on the card a kineto
window can lose every kernel record of a launching thread while CUPTI
itself delivers them all, its dropped-record count 0 on every stream of
the learner (ROADMAP §C has the readings). `ActivityTrace` asks CUPTI for
the kernels
(CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL) and the runtime and driver calls
of every thread over one window, and `chrome_trace` writes them as a
Chrome trace in torch.profiler's event categories ("kernel",
"cuda_runtime", "cuda_driver", `correlation` and `stream` args, thread
names), so `obs/compute.py`'s detector reads either.

CUPTI keeps one set of buffer callbacks per process: `activity_trace()`
registers this module's once (C functions, csrc/cupti_buffers.cc), after
which kineto receives no device records in the process (use one route per
process). A record is read at the offsets of its struct, stable since
CUDA 11 (`CUpti_ActivityAPI`; `CUpti_ActivityKernel4` through CUDA 12's
`CUpti_ActivityKernel9`)."""

from __future__ import annotations

import ctypes
import glob
import json
import os
import sys
import threading
import time
from typing import Dict, NamedTuple, Optional

KIND_DRIVER, KIND_RUNTIME, KIND_KERNEL = 4, 5, 10
_DOMAIN = {KIND_DRIVER: 1, KIND_RUNTIME: 2}  # CUpti_CallbackDomain of each API kind
_CATEGORY = {KIND_DRIVER: "cuda_driver", KIND_RUNTIME: "cuda_runtime"}
FLUSH_FORCED = 1  # CUPTI_ACTIVITY_FLAG_FLUSH_FORCED


class Kernel(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    device: int
    stream: int
    correlation: int


class Call(NamedTuple):
    kind: int  # KIND_RUNTIME or KIND_DRIVER
    name: str
    start_ns: int
    end_ns: int
    process: int
    thread: int
    correlation: int


def _load() -> ctypes.CDLL:
    """The CUPTI library the process loaded, else torch's bundled one,
    else the CUDA toolkit's; OSError when there is none."""
    with open("/proc/self/maps") as maps:
        for line in maps:
            if "libcupti" in line and "/" in line:
                return ctypes.CDLL(line.split()[-1])
    roots = [os.path.join(p, "nvidia", "cuda_cupti", "lib") for p in sys.path if p]
    roots.append("/usr/local/cuda/extras/CUPTI/lib64")
    for root in roots:
        for path in sorted(glob.glob(os.path.join(root, "libcupti.so*"))):
            return ctypes.CDLL(path)
    raise OSError("no CUPTI library: neither loaded, nor torch's nvidia/cuda_cupti, nor the CUDA toolkit's")


_DEMANGLED: Dict[str, str] = {}


def demangle(name: str) -> str:
    """A kernel's C++ name as `c++filt` prints it (CUPTI records the
    mangled one), or the name itself when it does not demangle."""
    if name not in _DEMANGLED:
        out = name
        try:
            cxx = ctypes.CDLL("libstdc++.so.6")
            cxx.__cxa_demangle.restype = ctypes.c_void_p
            status = ctypes.c_int(0)
            ptr = cxx.__cxa_demangle(name.encode(), None, None, ctypes.byref(status))
            if status.value == 0 and ptr:
                out = ctypes.string_at(ptr).decode(errors="replace")
                ctypes.CDLL(None).free(ctypes.c_void_p(ptr))
        except (OSError, AttributeError):
            pass
        _DEMANGLED[name] = out
    return _DEMANGLED[name]


class ActivityTrace:
    """One process's CUPTI activity recorder (see the module doc). CUPTI's
    buffer callbacks are C functions (csrc/cupti_buffers.cc): a Python
    callback would need the interpreter's lock on CUPTI's threads and
    inside CUDA calls, where it can deadlock with a thread that holds the
    lock and waits in a CUDA call. Records are read after the window."""

    def __init__(self, lib: ctypes.CDLL):
        from dotaclient_tpu_torch.ops import _kernels

        self.lib = lib
        self.native = _kernels.load("cupti_buffers")
        self._window_lock = threading.Lock()
        self._names: Dict[tuple, str] = {}
        address = lambda fn: ctypes.cast(fn, ctypes.c_void_p)  # noqa: E731
        self._next_record = address(lib.cuptiActivityGetNextRecord)
        rc = lib.cuptiActivityRegisterCallbacks(address(self.native.dt_cupti_buffer_requested),
                                                address(self.native.dt_cupti_buffer_completed))
        if rc != 0:
            raise RuntimeError(f"cuptiActivityRegisterCallbacks failed (CUptiResult {rc})")

    def _name(self, kind: int, cbid: int) -> str:
        key = (kind, cbid)
        if key not in self._names:
            name = ctypes.c_char_p()
            rc = self.lib.cuptiGetCallbackName(_DOMAIN[kind], ctypes.c_uint32(cbid), ctypes.byref(name))
            self._names[key] = name.value.decode() if rc == 0 and name.value else f"cbid_{cbid}"
        return self._names[key]

    def _read(self, buffer, valid: int, kernels: list, calls: list) -> None:
        cap = valid // 40 + 1  # no record is shorter than CUpti_ActivityAPI's 40 bytes
        u32 = [(ctypes.c_uint32 * cap)() for _ in range(5)]
        u64 = [(ctypes.c_uint64 * cap)() for _ in range(2)]
        names = (ctypes.c_char_p * cap)()
        n = self.native.dt_cupti_parse(self._next_record, buffer, valid, cap, *u32, *u64, names)
        kind, a, b, c, corr = u32
        start, end = u64
        for i in range(n):
            if kind[i] == KIND_KERNEL:
                name = names[i]
                kernels.append(Kernel(name.decode(errors="replace") if name else "", start[i], end[i], a[i], b[i],
                                      corr[i]))
            else:
                calls.append(Call(kind[i], self._name(kind[i], c[i]), start[i], end[i], a[i], b[i], corr[i]))

    def _drain(self):
        """Every completed buffer's records, the buffers freed."""
        kernels, calls = [], []
        buffers, valid = (ctypes.c_void_p * 64)(), (ctypes.c_uint64 * 64)()
        while True:
            n = self.native.dt_cupti_take(buffers, valid, 64)
            if n == 0:
                return kernels, calls
            for i in range(n):
                try:
                    self._read(buffers[i], valid[i], kernels, calls)
                finally:
                    self.native.dt_cupti_release(buffers[i])

    def window(self, seconds: float, before_stop=None):
        """The kernels and runtime / driver calls of every thread over
        `seconds`: CUPTI records from the enable, `before_stop()` runs at
        the end (a device sync, so the window's kernels have run), then the
        kinds are disabled, CUPTI's buffers flushed and read. Returns
        (kernels, calls, CUPTI's dropped-record count)."""
        with self._window_lock:
            self._drain()  # nothing from before the window
            try:
                for kind in (KIND_KERNEL, KIND_RUNTIME, KIND_DRIVER):
                    rc = self.lib.cuptiActivityEnable(kind)
                    if rc != 0:
                        raise RuntimeError(f"cuptiActivityEnable({kind}) failed (CUptiResult {rc})")
                time.sleep(seconds)
                if before_stop is not None:
                    before_stop()
            finally:
                for kind in (KIND_KERNEL, KIND_RUNTIME, KIND_DRIVER):
                    self.lib.cuptiActivityDisable(kind)
                self.lib.cuptiActivityFlushAll(ctypes.c_uint32(FLUSH_FORCED))
            deadline = time.monotonic() + 5.0
            while self.native.dt_cupti_held() > 0 and time.monotonic() < deadline:
                time.sleep(0.005)  # a forced flush hands every buffer back
            kernels, calls = self._drain()
            dropped = ctypes.c_size_t(0)
            self.lib.cuptiActivityGetNumDroppedRecords(None, ctypes.c_uint32(0), ctypes.byref(dropped))
            return kernels, calls, dropped.value


_TRACE: Optional[ActivityTrace] = None
_TRACE_LOCK = threading.Lock()


def activity_trace() -> ActivityTrace:
    """The process's recorder, its CUPTI callbacks registered on first use."""
    global _TRACE
    with _TRACE_LOCK:
        if _TRACE is None:
            _TRACE = ActivityTrace(_load())
        return _TRACE


def thread_names() -> Dict[int, str]:
    """Python's threads by the ids CUPTI records (pthread_self's low 32
    bits) and by their native ids."""
    out = {}
    for t in threading.enumerate():
        if t.ident is not None:
            out[t.ident & 0xFFFFFFFF] = t.name
        if t.native_id is not None:
            out[t.native_id] = t.name
    return out


def chrome_trace(kernels, calls, names: Optional[Dict[int, str]] = None) -> dict:
    """Chrome trace JSON (µs) of a window, in torch.profiler's categories:
    kernels on "stream N" rows of their device, calls on their threads,
    both carrying the `correlation` that pairs them."""
    names = thread_names() if names is None else names
    events = []
    for k in kernels:
        events.append({"ph": "X", "cat": "kernel", "name": demangle(k.name), "pid": k.device, "tid": f"stream {k.stream}",
                       "ts": k.start_ns / 1e3, "dur": (k.end_ns - k.start_ns) / 1e3,
                       "args": {"correlation": k.correlation, "stream": k.stream, "device": k.device}})
    threads = set()
    for c in calls:
        threads.add((c.process, c.thread))
        events.append({"ph": "X", "cat": _CATEGORY[c.kind], "name": c.name, "pid": c.process, "tid": c.thread,
                       "ts": c.start_ns / 1e3, "dur": (c.end_ns - c.start_ns) / 1e3,
                       "args": {"correlation": c.correlation}})
    for pid, tid in sorted(threads):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": names.get(tid, str(tid))}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, kernels, calls) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(kernels, calls), f)
