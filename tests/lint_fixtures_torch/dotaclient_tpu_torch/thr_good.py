"""Known-GOOD corpus for the THR rules: the two sanctioned disciplines.
Never imported — AST only. Must produce ZERO findings."""

import threading


class GuardedCounter:
    """Lock-guarded on both sides: clean."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = {}
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            with self._lock:
                self._counts["seen"] = self._counts.get("seen", 0) + 1

    def stats(self):
        with self._lock:
            return dict(self._counts)


class AtomicTuple:
    """The MetricsLogger._latest_rec pattern: the worker REBINDS one
    fresh tuple; public readers load the attribute exactly once."""

    def __init__(self):
        self._latest = (-1, {})
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = 0
        while True:
            step += 1
            self._latest = (step, {"step": float(step)})

    def latest(self):
        return dict(self._latest[1])

    def latest_step(self):
        return self._latest[0]


class ConsistentOrder:
    """Same nested pair, one order everywhere: no THR002."""

    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def one(self):
        with self._a:
            with self._b:
                return 1

    def two(self):
        with self._a:
            with self._b:
                return 2


class AnnotatedLockGuard:
    """Lock created via ANNOTATED assignment is still the instance lock
    — `self._lock: threading.Lock = threading.Lock()` must register for
    THR001 guard credit exactly like the unannotated form."""

    def __init__(self):
        self._lock: threading.Lock = threading.Lock()
        self._counts = {}
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self):
        while True:
            with self._lock:
                self._counts["n"] = self._counts.get("n", 0) + 1

    def snapshot(self):
        with self._lock:
            return dict(self._counts)
