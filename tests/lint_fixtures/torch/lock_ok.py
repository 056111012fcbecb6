"""Fixture: lock-discipline NEGATIVE — lock-held-ness propagates through
same-class helper calls and the ``*_locked`` naming convention."""

import threading


class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self.depth = 0
        self.taken = 0

    def tick(self):
        with self._lock:
            self._admit()
            self._sweep_locked()

    def _admit(self):
        # only ever called under tick's lock: effectively lock-held
        self.depth += 1

    def _sweep_locked(self):
        self.taken += 1  # _locked suffix: declared lock-held

    def record(self):
        with self._lock:
            self.depth -= 1
            self.taken = 0
