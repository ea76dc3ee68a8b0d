"""A time bound on every test's call.

A test that blocks for good (a reader waiting on a pipe whose writer was
killed mid-message, a rank waiting in a collective that another left) would
otherwise hold its worker until the whole run is cut. ``signal.alarm``
interrupts the call after ``TEST_CALL_LIMIT_S`` seconds: the stacks of every
thread are written to stderr and the test fails with ``TimeoutError``
raised where it was blocked, so its ``finally`` blocks run. The bound is
about twice the slowest test of a full parallel run (174 s), and above
the 240 s that ``tests/torch_dist_helpers.py::Ranks.results`` waits for
its ranks.

SIGALRM reaches only the main thread, where pytest and each pytest-xdist
worker run their tests; elsewhere (or without SIGALRM) the call is not
bounded.
"""

import faulthandler
import signal
import sys
import threading

import pytest

TEST_CALL_LIMIT_S = 360


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    if not hasattr(signal, "SIGALRM") or threading.current_thread() is not threading.main_thread():
        yield
        return

    def expired(signum, frame):
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        raise TimeoutError(f"{item.nodeid} still running after {TEST_CALL_LIMIT_S} s")

    previous = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TEST_CALL_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)
