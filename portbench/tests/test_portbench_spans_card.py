"""The program's spans against the profiler's own records on the card (they
skip where there is none). Each cell runs in this process as
``portbench/run.py`` runs it, and its line is the harness's own: the
port's own kernels are launched inside the span of the wrapper that
launches them (matched to their launch records by correlation id), the
idle split by layer adds up to the window's idle time, every metric that
reads the spans gives a number, an untraced run leaves the recorder's
buffer empty, and Triton's compiles were counted."""

import importlib
import time

import pytest
import torch

from portbench import harness, spans as S, trace as trace_mod

SEED = 4294967311

# the wrapper spans inside which each own kernel may be launched
WRAPPER_OF = {
    'gn_silu_conv3d_kernel': ('ops.gn_silu_conv3d',),
    'splitk_reduce_kernel': ('ops.gn_silu_conv3d',),
    'gn_stats_kernel': ('ops.gn_silu_conv3d', 'ops.gn_affine'),
    '_gn_silu_apply_kernel': ('ops.groupnorm_silu',),
    '_ancestral_kernel': ('ops.ancestral_update',),
}
SPAN_METRICS = ('idle_ops_ms', 'idle_unet_ms', 'idle_sampler_ms', 'launches_per_forward',
                'rebuilds_per_step')


class _KeepIds(trace_mod.Window):
    """The driver's window, also keeping every record's correlation id:
    [(name, on the device, start_ns, end_ns, id)]."""

    def __init__(self, prof, steps: int):
        super().__init__(prof, steps)
        from torch.autograd import DeviceType
        self.ids = [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns(),
                     e.start_ns() + e.duration_ns(), e.correlation_id())
                    for e in prof.profiler.kineto_results.events()]


def _run(workload: str, seed: int, trace: bool):
    """(cell, outcome, result line) of one run of ``workload``, with the
    recorder's buffer emptied before it."""
    from meshdiffusion_tpu_torch.utils import trace as program
    harness.setup_env()
    torch.set_num_threads(4)
    cell = harness.Cell.load(workload)
    driver = importlib.import_module(f'portbench.drivers.{cell.driver}')
    program.clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trace_mod, 'Window', _KeepIds)
        out = driver.run(cell, seed=seed, seconds=12, trace=trace,
                         device=torch.device('cuda', 0), t_start=time.perf_counter())
    return cell, out, harness.result(cell, out, trace, torch.cuda.get_device_name(0))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


@pytest.mark.cuda
@pytest.mark.parametrize('workload', ['gen64-b1', 'gen64-b4', 'gen128-b7'])
def test_spans_share_the_device_trace_clock(card, workload):
    from meshdiffusion_tpu_torch.utils import trace as program
    cell, out, line = _run(workload, SEED, trace=True)
    assert line['correct'], line['checks']
    w = out.layer_ctx.window
    sp = [s for s in program.spans() if s.t1 is not None and s.t1 > w.t0 and s.t0 < w.t1]
    assert sp and program.dropped() == 0

    # every metric that reads the spans gives a number
    names = {m['name'].split('.')[0]: m['name'] for m in cell.per_layer
             if m['name'].split('.')[0] in SPAN_METRICS}
    assert set(names) == set(SPAN_METRICS)
    for name in names.values():
        assert line['metrics'][name]['value'] >= 0, name

    # the own kernels' launch records lie inside their wrapper's span
    host = {c: (s, e) for n, dev, s, e, c in w.ids if not dev and 'Launch' in n}
    inside = total = 0
    for n, dev, s, _, c in w.ids:
        allowed = next((v for k, v in WRAPPER_OF.items() if k in n), None)
        if not dev or allowed is None or not w.t0 <= s <= w.t1 or c not in host:
            continue
        ls, le = host[c]
        total += 1
        inside += any(x.name in allowed and x.t0 <= ls and le <= x.t1 for x in sp)
    assert total >= w.steps and inside >= 0.99 * total, (inside, total)

    # the idle split partitions the window's idle time
    idle_ns = (w.t1 - w.t0) - sum(e - s for s, e in w.busy_intervals())
    split = S.idle_by_layer(w, sp)
    assert set(split) <= {'ops', 'unet', 'sampler', 'outside'}
    assert sum(split.values()) == idle_ns
    ms = sum(line['metrics'][names[k]]['value'] for k in
             ('idle_ops_ms', 'idle_unet_ms', 'idle_sampler_ms'))
    total_ms = ms * out.layer_ctx.forwards + split.get('outside', 0) * 1e-6
    assert abs(total_ms - idle_ns * 1e-6) <= 1e-3 * idle_ns * 1e-6


@pytest.mark.cuda
def test_untraced_run_records_nothing_and_compiles_are_counted(card):
    from meshdiffusion_tpu_torch.utils import trace as program
    _, _, line = _run('gen64-b1', SEED + 1, trace=False)
    assert line['correct'], line['checks']
    assert program.spans() == [] and program.instants() == []
    counts = program.counts()
    assert counts.get('rebuild.triton', 0) >= 2 and counts.get('rebuild.nvcc', 0) >= 1, counts
