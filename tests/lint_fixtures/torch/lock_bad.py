"""Fixture: lock-discipline POSITIVE — mixed locked/unlocked mutation."""

import threading


class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self.depth = 0  # __init__ publication: never flagged

    def record(self):
        with self._lock:
            self.depth += 1

    def reset(self):
        self.depth = 0  # VIOLATION: guarded attr assigned outside lock
