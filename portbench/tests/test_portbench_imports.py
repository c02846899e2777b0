"""No module under portbench loads JAX or the JAX package, and the plain
references load nothing of the program under test; top-level module names
(before the first dot) compared whole."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from portbench import harness

PY = sorted(glob.glob(os.path.join(harness.PB, '**', '*.py'), recursive=True))
FOREIGN = {'jax', 'jaxlib', 'flax', 'meshdiffusion_tpu'}
PROGRAM = 'meshdiffusion_tpu_torch'


def _loaded_after(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    out = subprocess.run([sys.executable, '-c', code + '\nimport sys, json\n'
                          'print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))'],
                         capture_output=True, text=True, env=env, cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _imports(path: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


@pytest.mark.parametrize('path', PY, ids=lambda p: os.path.relpath(p, harness.PB))
def test_no_module_names_jax(path):
    names = _imports(path)
    assert not names & FOREIGN, names & FOREIGN
    if os.sep + 'reference' + os.sep in path:
        assert PROGRAM not in names


def test_importing_every_module_loads_no_jax():
    mods = [os.path.relpath(p, harness.ROOT)[:-3].replace(os.sep, '.') for p in PY
            if os.sep + 'layer_metrics' + os.sep not in p and not p.endswith('run.py')]
    code = ('import importlib\nfrom portbench import harness\n'
            + ''.join(f'importlib.import_module({m!r})\n' for m in mods)
            + ''.join(f'harness.reader({os.path.basename(p)[:-3]!r})\n' for p in PY
                      if os.sep + 'layer_metrics' + os.sep in p))
    assert not _loaded_after(code) & FOREIGN


def test_reference_loads_nothing_of_the_program():
    refs = [os.path.relpath(p, harness.ROOT)[:-3].replace(os.sep, '.') for p in PY
            if os.sep + 'reference' + os.sep in p]
    loaded = _loaded_after(''.join(f'import {m}\n' for m in refs))
    assert PROGRAM not in loaded and not loaded & FOREIGN


def test_foreign_modules_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, 'jaxlib_like', sys)
    monkeypatch.setitem(sys.modules, 'meshdiffusion_tpu_torch_like', sys)
    assert 'jaxlib_like' not in harness.foreign_modules()
    monkeypatch.setitem(sys.modules, 'meshdiffusion_tpu.config', sys)
    assert 'meshdiffusion_tpu.config' in harness.foreign_modules()
