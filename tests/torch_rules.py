"""The two rules the torch package's tests run under. A test module takes
them with ``pytest_plugins = ('torch_rules',)``, and they hold for that
module's tests only: the JAX package's tests, and the children they start,
run as they always have. ``tests/test_torch_kernels.py`` runs on the card,
where a kernel build may take minutes, and does not take them.

The thread share. Inside an xdist worker, torch's intra-op and inter-op
pools get ``SHARE = max(1, cores // workers)`` threads, and every phase of
a test exports it as ``OMP_NUM_THREADS`` / ``MKL_NUM_THREADS`` to the
children it starts. At torch's default every worker spins a pool as wide as
the machine: six copies of a test, as six workers run them, took 51.5 s
each (test_unet_forward_matches_jax) and 65.2 s each (a CLI child of
test_torch_isolation) at the default, 19.3 s and 20.3 s at one thread.
Outside xdist nothing is pinned. XLA's own threads are left alone: pinning
them slowed the JAX tests 5x.

The time limit. A test's setup, call or teardown that runs past ``LIMIT``
seconds fails with a message naming the test, the phase and the limit, and
the run goes on. A hang inside C code, where the Python handler cannot run,
ends the process after ``LIMIT + 60`` s with a dump of every thread's
stack, so one worker is lost and not the run. A test's ``subprocess``
children keep their own timeouts at most ``LIMIT - 30`` s, so a child's
timeout fires first and reports its stderr.
"""

import contextlib
import faulthandler
import os
import signal

import pytest

LIMIT = 360
THREAD_VARS = ('OMP_NUM_THREADS', 'MKL_NUM_THREADS')
SHARE = (max(1, len(os.sched_getaffinity(0)) // int(os.environ['PYTEST_XDIST_WORKER_COUNT']))
         if 'PYTEST_XDIST_WORKER' in os.environ else None)

if SHARE:
    import torch
    torch.set_num_threads(SHARE)
    torch.set_num_interop_threads(SHARE)


@contextlib.contextmanager
def _ruled(item, phase):
    if __name__ not in getattr(getattr(item, 'module', None), 'pytest_plugins', ()):
        yield
        return

    def expire(signum, frame):
        pytest.fail(f'{item.nodeid} ran past the per-test limit of {LIMIT} s in its {phase}')

    before = {k: os.environ.get(k) for k in THREAD_VARS}
    if SHARE:
        os.environ.update(dict.fromkeys(THREAD_VARS, str(SHARE)))
    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, LIMIT)
    faulthandler.dump_traceback_later(LIMIT + 60, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _ruled(item, 'setup'):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _ruled(item, 'call'):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with _ruled(item, 'teardown'):
        return (yield)
