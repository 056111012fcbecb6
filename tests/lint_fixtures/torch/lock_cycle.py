"""Fixture: lock-discipline POSITIVE — ABBA acquisition-order cycle."""

import threading


class Pool:
    def __init__(self):
        self._route_lock = threading.Lock()
        self._state_lock = threading.Lock()

    def route(self):
        with self._route_lock:
            with self._state_lock:
                pass

    def rebalance(self):
        with self._state_lock:
            with self._route_lock:  # opposite order: deadlock risk
                pass
