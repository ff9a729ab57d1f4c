"""Known-BAD corpus for the THR rules. Never imported — AST only.

Each violation is labeled with the rule id the analyzer must report.
"""

import threading


class TornCounter:
    """THR001: worker mutates a dict in place; public stats() iterates it
    unguarded — a reader can see a half-updated snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = {}
        self._total = 0
        self._thread = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            self._counts["seen"] = self._counts.get("seen", 0) + 1  # unguarded mutate
            self._total = self._total + 1

    def stats(self):
        # THR001: unguarded in-place-mutated dict read from a public method
        return {k: v for k, v in self._counts.items()}

    def total_twice(self):
        # THR001: two unguarded reads of a worker-rebound attribute can
        # observe two different values (the check/use tear)
        if self._total > 0:
            return self._total
        return 0

    def total_suppressed_badly(self):
        # GRAFT000: a suppression with an empty reason must not suppress
        return dict(self._counts)  # graftlint: disable=THR001()


class LostUpdateCounter:
    """THR001: multiple workers (Thread under a comprehension) doing a
    plain-assign read-modify-write — `self.n = self.n + 1` loses updates
    exactly like `+=`, so the single-read exemption must not apply."""

    def __init__(self, n):
        self.n = 0
        self._threads = [
            threading.Thread(target=self._run, daemon=True) for _ in range(n)
        ]

    def _run(self):
        self.n = self.n + 1

    def count(self):
        return self.n


class InvertedOrder:
    """THR002: the same lock pair nested in both orders — two threads
    interleaving ab() and ba() deadlock."""

    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def ab(self):
        with self._a:
            with self._b:
                return True

    def ba(self):
        with self._b:
            with self._a:
                return True


class ThreeLockCycle:
    """THR002: no pair is ever reversed, but _a→_b, _b→_c, _c→_a close
    a 3-cycle — a 3-way interleave deadlocks just like the pairwise
    inversion above."""

    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()
        self._c = threading.Lock()

    def ab(self):
        with self._a:
            with self._b:
                return 1

    def bc(self):
        with self._b:
            with self._c:
                return 2

    def ca(self):
        with self._c:
            with self._a:
                return 3
