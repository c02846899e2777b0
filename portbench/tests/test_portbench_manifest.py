"""BENCHMARK.json and the files it names: the contract's names, units and
keys, and every metric's cells."""

import json
import os
import re

import pytest

from portbench import harness

M = json.load(open(os.path.join(harness.ROOT, 'BENCHMARK.json')))
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in M['workloads']]


def reports(metric, cell):
    return cell in metric.get('workloads', CELLS)


def test_top_level_keys_and_paths():
    assert set(M) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                      'end_to_end', 'per_layer'}
    assert M['paths'] == ['portbench'] and M['command'][1] == 'portbench/run.py'
    assert 1 <= M['run_seconds'] <= 51 and isinstance(M['run_seconds'], int)
    full = 2 + 14 * 24
    assert full * (M['run_seconds'] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units():
    names = ([c['name'] for c in M['configs']] + CELLS
             + [m['name'] for m in M['end_to_end'] + M['per_layer']])
    assert len(names) == len(set(names))
    for n in names + [w['traffic'] for w in M['workloads']]:
        assert NAME.match(n), n
    for m in M['end_to_end'] + M['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source', 'layer', 'moves',
                          'workloads'}
    for m in M['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace') and 0.01 <= m['bound'] <= 0.25


@pytest.mark.parametrize('cell', CELLS)
def test_cell_files_and_metrics(cell):
    c = harness.Cell.load(cell, M)
    assert os.path.exists(os.path.join(harness.PB, 'drivers', c.driver + '.py'))
    e2e = {m['name'] for m in c.end_to_end}
    assert 'setup_s' in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m['moves'] in e2e, (m['name'], m['moves'])
        assert callable(harness.reader(m['name']))
    assert set(c.limits) >= {'eps_rel_l2', 'update_rel_err', 'prior_max_abs'}


def test_every_metric_and_config_is_used():
    for m in M['end_to_end'] + M['per_layer']:
        assert any(reports(m, c) for c in CELLS), m['name']
        assert set(m.get('workloads', [])) <= set(CELLS)
    for m in M['per_layer']:
        moved = {x['name']: x for x in M['end_to_end']}[m['moves']]
        assert all(reports(moved, c) for c in CELLS if reports(m, c))
    used = {w['config'] for w in M['workloads']}
    assert used == {c['name'] for c in M['configs']}
    assert sum(w['chips'] == 4 for w in M['workloads']) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize('conf', [c['name'] for c in M['configs']])
def test_config_file_is_the_preset(conf):
    """Every number of the configuration file is the port's preset's, and
    the file names its source."""
    from meshdiffusion_tpu_torch.config import get_config
    entry = {c['name']: c for c in M['configs']}[conf]
    f = json.load(open(os.path.join(harness.ROOT, entry['file'])))
    assert f['source'] == entry['source'] and f['reduced'] == entry['reduced'] == []
    preset = get_config(f['preset'])
    for sec in ('model', 'data', 'sampling', 'eval', 'gpu'):
        for k, v in f[sec].items():
            pv = preset[sec][k]
            assert (list(pv) if isinstance(pv, tuple) else pv) == v, (sec, k)
