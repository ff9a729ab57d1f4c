"""THR002 good case, half 1: class SameName here nests _a then _b."""
import threading


class SameName:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def go(self):
        with self._a:
            with self._b:
                return 1
