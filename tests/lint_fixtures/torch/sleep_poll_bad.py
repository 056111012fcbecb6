"""Fixture (test-classified): sleep-poll POSITIVE — polls with no
deadline, one of them suppressed with a justification."""

import time


def test_bad_poll():
    while not done():
        time.sleep(0.01)  # VIOLATION: no deadline in the condition


def test_suppressed_poll():
    while not done():
        # sparkdl-lint: disable=sleep-poll -- fixture demonstrating a justified suppression
        time.sleep(0.01)
