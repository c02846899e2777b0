"""Short runs of `gen64-b1` on the card, untraced and traced (they skip where there is none)."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


@pytest.mark.cuda
@pytest.mark.parametrize('trace', [0, 1])
def test_gen64_b1_runs_correct_on_the_card(card, trace):
    out = subprocess.run([sys.executable, 'portbench/run.py', '--workload', 'gen64-b1',
                          '--seed', '4294967311', '--seconds', '12', '--trace', str(trace)],
                         capture_output=True, text=True, cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line['correct'] and line['device']['platform'] == 'gpu'
    assert list(line)[-1] == 'checks'
    if trace:
        assert 0 < line['device']['busy_s'] <= line['device']['window_s']
