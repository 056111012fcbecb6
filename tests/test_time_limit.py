"""The per-test time limit (the root ``conftest.time_limit``, here as its
fixture): a body that never returns fails with ``TimeoutError`` naming its
test, a body that returns is left alone, and either way the interval timer
is disarmed and the SIGALRM handler from before is back."""

import re
import signal
import threading
import time

import pytest


@pytest.mark.parametrize("body", ["waits_forever", "returns"])
def test_time_limit_fails_a_hung_body_and_restores_the_alarm(
        body, request, time_limit):
    nodeid = request.node.nodeid
    previous = signal.getsignal(signal.SIGALRM)
    start = time.monotonic()
    if body == "waits_forever":
        with pytest.raises(TimeoutError, match=re.escape(nodeid)):
            with time_limit(nodeid, 1, start):
                threading.Event().wait()
        assert time.monotonic() - start < 5
    else:
        with time_limit(nodeid, 1, start):
            pass
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    assert signal.getsignal(signal.SIGALRM) is previous
