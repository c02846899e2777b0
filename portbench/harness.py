"""What every driver shares: the cell's files, the caches, the result line.

Everything a cell needs is found by name. ``BENCHMARK.json`` (at the root
of the checkout) names the cell's configuration and traffic mix and lists
the metrics; ``configs/<config>.json`` holds the configuration as it is
run, ``traffic/<traffic>.json`` the traffic mix's parameters (its
``driver`` names ``drivers/<driver>.py``), ``limits/<cell>.json`` the
limits of the cell's correctness numbers, and ``layer_metrics/<metric>.py``
the reader of each per-layer metric. A cell, a mix or a metric is added by
adding files and an entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

PB = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PB)
CACHE = os.path.join(PB, '.cache')
# top-level module names that may not be loaded in a run's process
FOREIGN = ('jax', 'jaxlib', 'flax', 'meshdiffusion_tpu')


def setup_env() -> None:
    """Fixed cache directories inside the checkout, set before torch or
    Triton is imported: Triton's kernel cache, the CUDA JIT cache, torch's
    extension builds, and ``XDG_CACHE_HOME``, under which the port caches
    the generated 128 tet grid. (The port's nvcc library is built at its own
    fixed place in the checkout, ``meshdiffusion_tpu_torch/_build/``.)"""
    for var, sub in (('TRITON_CACHE_DIR', 'triton'), ('CUDA_CACHE_PATH', 'nv'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions'), ('XDG_CACHE_HOME', 'xdg')):
        os.environ[var] = os.path.join(CACHE, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``workloads`` with its files."""
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    @property
    def driver(self) -> str:
        return self.traffic['driver']

    @staticmethod
    def load(name: str, manifest: Optional[dict] = None) -> 'Cell':
        m = manifest or _json(ROOT, 'BENCHMARK.json')
        entry = {w['name']: w for w in m['workloads']}.get(name)
        if entry is None:
            raise SystemExit(f'no workload {name!r} in BENCHMARK.json')
        conf = {c['name']: c for c in m['configs']}[entry['config']]

        def mine(metric):
            return name in metric.get('workloads', [name])
        return Cell(name=name, chips=entry['chips'], config_name=entry['config'],
                    config=_json(ROOT, conf['file']), traffic_name=entry['traffic'],
                    traffic=_json(PB, 'traffic', entry['traffic'] + '.json'),
                    limits=_json(PB, 'limits', name + '.json'),
                    end_to_end=[x for x in m['end_to_end'] if mine(x)],
                    per_layer=[x for x in m['per_layer'] if mine(x)])


def reader(metric: str):
    """The ``read(window)`` function of ``layer_metrics/<metric>.py``."""
    path = os.path.join(PB, 'layer_metrics', metric + '.py')
    spec = importlib.util.spec_from_file_location('portbench.layer_metrics.' + metric, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def foreign_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FOREIGN`."""
    return sorted(n for n in list(sys.modules) if n.split('.')[0] in FOREIGN)


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver measured in one run."""
    measured: Dict[str, float]            # end-to-end values by metric name
    checks: List[Check]
    attempted: int
    failed: int
    memory_peak_bytes: int
    layer_ctx: object = None              # what the readers read in a --trace 1 run; its
                                          # ``window`` is the profiled trace.Window


def result(cell: Cell, out: Outcome, trace: bool, device_kind: str) -> dict:
    """The result line: the cell's end-to-end metrics (``--trace 0``) or its
    per-layer ones (``--trace 1``), each reader that found something to
    read, and the compared numbers last."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = reader(m['name'])(out.layer_ctx)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        for m in cell.end_to_end:
            # a metric 'x.y' that the driver does not measure by that name is its 'x'
            name = m['name'] if m['name'] in out.measured else m['name'].split('.')[0]
            metrics[m['name']] = {'value': out.measured[name], 'unit': m['unit']}
    device = {'platform': 'gpu', 'kind': device_kind, 'count': cell.chips,
              'memory_peak_bytes': out.memory_peak_bytes}
    line = {'correct': all(c.ok for c in out.checks), 'attempted': out.attempted,
            'failed': out.failed, 'metrics': metrics, 'device': device}
    if trace:
        window = out.layer_ctx.window
        device['busy_s'] = window.busy_s()
        device['window_s'] = window.window_s
        line['breakdown'] = window.breakdown()
    line['checks'] = {c.name: {'value': c.value, 'limit': c.limit} for c in out.checks}
    return line


def emit(line: dict, checks: List[Check]) -> None:
    print(json.dumps(line), flush=True)
    for c in checks:
        print(f'check {c.name} = {c.value!r} (limit {c.limit!r}): '
              f'{"ok" if c.ok else "FAILED"}', file=sys.stderr, flush=True)
