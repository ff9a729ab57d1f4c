"""THR002 good case, half 2: an UNRELATED class that happens to share
the name SameName nests the opposite way — its locks are distinct
objects from half 1's, so no inversion exists (edges are
module-qualified)."""
import threading


class SameName:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def go(self):
        with self._b:
            with self._a:
                return 2
