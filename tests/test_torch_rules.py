"""The two rules of ``torch_rules.py`` that the torch package's tests run
under: each xdist worker's share of the CPU threads, passed on to the
children its tests start, and the time limit on each phase of a test."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

pytest_plugins = ('torch_rules',)

TESTS = pathlib.Path(__file__).resolve().parent


def _takes_the_rules(tree):
    return any(isinstance(n, ast.Assign) and any(getattr(t, 'id', None) == 'pytest_plugins' for t in n.targets)
               and 'torch_rules' in ast.literal_eval(n.value) for n in tree.body)


def test_worker_and_its_children_hold_the_thread_share():
    import torch_rules
    if torch_rules.SHARE is None:
        pytest.skip('the share is set only inside an xdist worker')
    share = max(1, len(os.sched_getaffinity(0)) // int(os.environ['PYTEST_XDIST_WORKER_COUNT']))
    assert (torch_rules.SHARE, torch.get_num_threads(), torch.get_num_interop_threads()) == (share,) * 3
    child = subprocess.run(
        [sys.executable, '-c',
         'import os, torch; print(os.environ["OMP_NUM_THREADS"], os.environ["MKL_NUM_THREADS"],'
         ' torch.get_num_threads())'],
        capture_output=True, text=True, timeout=120, check=True)
    assert child.stdout.split() == [str(share)] * 3


def test_a_test_past_the_limit_fails_and_the_run_goes_on(tmp_path):
    """With the limit at 1 s: a sleeping body and a sleeping fixture each
    fail with the limit's message, the next test passes, and a module that
    does not take the rules sleeps past the limit unharmed."""
    (tmp_path / 'conftest.py').write_text('import torch_rules\ntorch_rules.LIMIT = 1\n')
    (tmp_path / 'test_ruled.py').write_text(
        'import time\n'
        'import pytest\n'
        "pytest_plugins = ('torch_rules',)\n"
        '@pytest.fixture\n'
        'def slow_fixture():\n'
        '    time.sleep(30)\n'
        'def test_sleeps():\n'
        '    time.sleep(30)\n'
        'def test_sleeps_in_setup(slow_fixture):\n'
        '    pass\n'
        'def test_after():\n'
        '    pass\n')
    (tmp_path / 'test_unruled.py').write_text('import time\ndef test_free():\n    time.sleep(1.5)\n')
    env = {k: v for k, v in os.environ.items() if not k.startswith('PYTEST_')}
    env['PYTHONPATH'] = os.pathsep.join(filter(None, [str(TESTS), env.get('PYTHONPATH')]))
    run = subprocess.run(
        [sys.executable, '-m', 'pytest', '-q', '-rfE', '-p', 'no:cacheprovider', '-p', 'no:randomly',
         '-p', 'no:xdist', str(tmp_path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    out = run.stdout
    summary = out.strip().splitlines()[-1]
    assert all(n in summary for n in ('1 failed', '2 passed', '1 error')), out[-3000:]
    assert 'test_ruled.py::test_sleeps ran past the per-test limit of 1 s in its call' in out, out[-3000:]
    assert 'test_ruled.py::test_sleeps_in_setup ran past the per-test limit of 1 s in its setup' in out, out[-3000:]


def _is_slow(decorators):
    return any(isinstance(n, ast.Attribute) and n.attr == 'slow' for d in decorators for n in ast.walk(d))


def _timeouts(node):
    """The values of the ``timeout=`` keywords under ``node``, outside
    functions and classes marked ``slow``."""
    if _is_slow(getattr(node, 'decorator_list', ())):
        return
    if isinstance(node, ast.Call):
        yield from (kw.value for kw in node.keywords if kw.arg == 'timeout')
    for child in ast.iter_child_nodes(node):
        yield from _timeouts(child)


def test_every_child_timeout_fits_inside_the_limit():
    """Each ``timeout=`` in a module under the rules, outside ``slow`` tests,
    is a number, or a module-level name bound to one, of at most LIMIT - 30 s,
    so a child's own timeout fires first and reports its stderr. ``slow``
    counts on a function, its class, or the module's ``pytestmark``."""
    import torch_rules
    over = []
    for path in sorted(TESTS.glob('test_*.py')):
        tree = ast.parse(path.read_text())
        if not _takes_the_rules(tree):
            continue
        names = {t.id: n.value.value for n in tree.body if isinstance(n, ast.Assign)
                 and isinstance(n.value, ast.Constant) for t in n.targets if isinstance(t, ast.Name)}
        if any(_is_slow([n.value]) for n in tree.body if isinstance(n, ast.Assign)
               and any(getattr(t, 'id', None) == 'pytestmark' for t in n.targets)):
            continue
        for timeout in _timeouts(tree):
            value = timeout.value if isinstance(timeout, ast.Constant) else names.get(getattr(timeout, 'id', None))
            if not isinstance(value, (int, float)) or value > torch_rules.LIMIT - 30:
                over.append(f'{path.name}:{timeout.lineno} timeout={ast.unparse(timeout)}')
    assert not over, over


def test_every_test_module_of_the_port_takes_the_rules():
    """Every ``tests/test_torch_*.py`` but the card's kernel tests declares
    ``pytest_plugins = ('torch_rules',)``, and none sets torch's threads or
    ``OMP_NUM_THREADS`` itself."""
    wrong = []
    for path in sorted(TESTS.glob('test_torch_*.py')):
        if path.name == 'test_torch_kernels.py':
            continue
        source = path.read_text()
        if not _takes_the_rules(ast.parse(source)):
            wrong.append(f'{path.name}: no rules')
        if path.name != 'test_torch_rules.py' and ('set_num_threads' in source or 'OMP_NUM_THREADS' in source):
            wrong.append(f'{path.name}: sets threads')
    assert not wrong, wrong
