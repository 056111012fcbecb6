"""Fixture (test-classified): sleep-poll NEGATIVE — deadlined loops."""

import time


def test_deadlined_poll():
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        time.sleep(0.01)


def test_timeout_named_bound(timeout_s=5.0):
    t_end = time.monotonic() + timeout_s
    while not done() and time.monotonic() < t_end:
        time.sleep(0.01)
