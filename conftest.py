"""One thread setting and one time limit per test for every pytest run
from the repository root. pytest loads this file before
``tests/conftest.py`` and any test module, so the setting comes before
anything imports torch."""

import contextlib
import faulthandler
import os
import signal
import time

# torch's intra-op pool takes its size from this variable, and the xdist
# workers and every process they start (TorchRunner's ranks, example and
# fault subprocesses) inherit it, where each would take a thread per core.
os.environ["OMP_NUM_THREADS"] = "2"

import pytest  # noqa: E402

# One test's limit, setup and teardown included: about three times the
# slowest test under six workers (144 s), and above every TorchRunner
# ``timeout_s`` of a test (300 s at most), so a runner's own error comes first.
TEST_TIME_LIMIT_S = 420
_STARTED = pytest.StashKey[float]()
_STDERR_FD = pytest.StashKey[int]()


@contextlib.contextmanager
def time_limit(nodeid, limit_s, started):
    """Dump every thread's stack to stderr and raise ``TimeoutError``
    naming ``nodeid`` in the main thread ``limit_s`` seconds after the
    ``time.monotonic()`` reading ``started``. A block with no time left
    (a teardown after its test ran out) has only the backstop of
    ``pytest_runtest_setup``. Leaving disarms the timer and puts back the
    SIGALRM handler it found, so limits do not nest."""
    left = started + limit_s - time.monotonic()
    if left <= 0:
        yield
        return

    def expire(signum, frame):
        faulthandler.dump_traceback(all_threads=True)
        raise TimeoutError(f"{nodeid} ran past its time limit of {limit_s} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, left)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.fixture(name="time_limit", scope="session")
def time_limit_fixture():
    return time_limit


def pytest_configure(config):
    # fd 2 is the process's own stderr here, the capture's file in a test.
    config.stash[_STDERR_FD] = os.dup(2)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    item.stash[_STARTED] = time.monotonic()
    # Backstop for a wait in C code that never returns to the interpreter:
    # the worker dies with its stacks, and xdist reports the test crashed.
    faulthandler.dump_traceback_later(
        TEST_TIME_LIMIT_S + 60, exit=True, file=item.config.stash[_STDERR_FD])
    with time_limit(item.nodeid, TEST_TIME_LIMIT_S, item.stash[_STARTED]):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with time_limit(item.nodeid, TEST_TIME_LIMIT_S, item.stash[_STARTED]):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    try:
        with time_limit(item.nodeid, TEST_TIME_LIMIT_S,
                        item.stash[_STARTED]):
            return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
