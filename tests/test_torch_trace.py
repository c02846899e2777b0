"""The port's span-and-counter recorder (``utils/trace.py``) on the CPU: it
records nothing with no profiler running, shares kineto's clock, nests the
generation path's spans sampler step > U-Net forward > ResnetBlock >
kernel wrapper, and counts weight repacks and launch plans where they
happen."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from meshdiffusion_tpu_torch import ops
from meshdiffusion_tpu_torch.diffusion.sampling import get_pc_sampler
from meshdiffusion_tpu_torch.diffusion.vpsde import VPSDE
from meshdiffusion_tpu_torch.models import layers
from meshdiffusion_tpu_torch.models.unet3d import UNet3D
from meshdiffusion_tpu_torch.ops import gn_silu_conv
from meshdiffusion_tpu_torch.utils import trace

pytest_plugins = ('torch_rules',)

R = 8


@pytest.fixture
def clean():
    trace.clear()
    yield
    trace.clear()


def _tiny_sampler(steps: int = 2):
    """A two-level U-Net at nf 32 on an 8^3 grid, fp32, and the ancestral PC
    sampler over ``steps`` steps."""
    torch.manual_seed(0)
    model = UNet3D(image_size=R, nf=32, ch_mult=(1, 2), num_res_blocks=1,
                   attn_resolutions=(4,), dropout=0.0).eval()
    shape = (1, R, R, R, 4)
    sampler = get_pc_sampler(VPSDE(0.1, 2.0, steps + 1), shape)
    gen = torch.Generator().manual_seed(0)

    def noise(name, shape, i=-1, j=0):
        return torch.randn(shape, generator=gen)

    def run():
        with torch.inference_mode():
            return sampler(lambda x, t: model(x, t), noise)
    return model, run


def test_off_records_nothing(clean):
    """With no profiler running a sampler run records no span and no
    instant, a decorated function hands back its result itself, and a
    counter still counts."""
    assert not torch.autograd._profiler_enabled()
    _, run = _tiny_sampler()
    run()
    assert trace.spans() == [] and trace.instants() == []

    obj = object()
    f = trace.span('test.f')(lambda x: x)
    assert f(obj) is obj
    before = trace.counts().get('test.count', 0)
    trace.count('test.count', 2)
    assert trace.counts()['test.count'] == before + 2 and trace.instants() == []


def test_span_brackets_the_kineto_event(clean):
    """The spans' clock is kineto's: a span around an add brackets the
    profiler's ``aten::add`` event, and the add's instant lies inside."""
    a = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span('test.add'):
            a + 1
            trace.count('test.instant')
    (s,) = [s for s in trace.spans() if s.name == 'test.add']
    adds = [e for e in prof.profiler.kineto_results.events() if e.name() == 'aten::add']
    assert adds
    for e in adds:
        assert s.t0 <= e.start_ns() and e.start_ns() + e.duration_ns() <= s.t1
    (x,) = [x for x in trace.instants() if x.name == 'test.instant']
    assert s.t0 <= x.t <= s.t1 and x.n == 1


def test_generation_spans_nest(clean):
    """Two sampler steps under the profiler: sampler.step > unet.forward >
    unet.resblock > ops.gn_silu_conv3d, one unet.resblock a ResnetBlock and
    one unet.attn an AttnBlock a forward, every span's parent set, and the
    step index carried down."""
    model, run = _tiny_sampler(steps=2)
    blocks = sum(isinstance(m, layers.ResnetBlockDDPM) for m in model.modules())
    attns = sum(isinstance(m, layers.AttnBlock) for m in model.modules())
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    sp = trace.spans()
    assert all(s.t1 is not None and s.t0 <= s.t1 for s in sp)
    steps = [k for k, s in enumerate(sp) if s.name == 'sampler.step']
    assert [sp[k].attrs for k in steps] == [{'i': 0}, {'i': 1}]
    assert all(sp[k].parent == -1 and sp[k].step == sp[k].attrs['i'] for k in steps)

    def chain(k):
        names = []
        while k >= 0:
            names.append(sp[k].name)
            assert sp[sp[k].parent].t0 <= sp[k].t0 and sp[k].t1 <= sp[sp[k].parent].t1 \
                if sp[k].parent >= 0 else True
            k = sp[k].parent
        return names
    for step in (0, 1):
        mine = [k for k, s in enumerate(sp) if s.step == step]
        names = [sp[k].name for k in mine]
        assert names.count('unet.forward') == 1
        assert names.count('unet.resblock') == blocks
        assert names.count('unet.attn') == attns
        assert names.count('ops.gn_silu_conv3d') == 2 * blocks
        assert names.count('ops.ancestral_update') == 1
        assert names.count('ops.groupnorm_silu') == 1
        conv = [k for k in mine if sp[k].name == 'ops.gn_silu_conv3d']
        assert all(chain(k) == ['ops.gn_silu_conv3d', 'unet.resblock', 'unet.forward',
                                'sampler.step'] for k in conv)
        assert chain([k for k in mine if sp[k].name == 'ops.ancestral_update'][0]) == \
            ['ops.ancestral_update', 'sampler.step']


def test_rebuild_pack_counts_weight_updates(clean):
    """``rebuild.pack`` (and ``rebuild.dhwio``) rise by one when the weight
    changes in place (its version bumps), not on an unchanged call; under
    the profiler the bump also leaves an instant."""
    conv = layers.Conv3D(32, 32, 3)

    def pack():
        conv.packed()
        return trace.counts().get('rebuild.pack', 0), trace.counts().get('rebuild.dhwio', 0)
    first = pack()
    assert pack() == first
    with torch.no_grad():
        conv.weight.add_(1.0)
    with profile(activities=[ProfilerActivity.CPU]):
        assert pack() == (first[0] + 1, first[1] + 1)
        assert pack() == (first[0] + 1, first[1] + 1)
    assert sorted(x.name for x in trace.instants()) == ['rebuild.dhwio', 'rebuild.pack']


def test_nin_cast_weight_counts_weight_updates(clean):
    """A NIN's compute-dtype weight (what ``ops.nin_residual`` reads) is
    kept between calls and rebuilt, counted as ``rebuild.pack``, only when
    the weight changes in place."""
    nin = layers.NIN(64, 32, dtype=torch.bfloat16)
    nin.reset_parameters_ddpm()

    def cast():
        w = nin.cast_weight()
        return w, trace.counts().get('rebuild.pack', 0)
    (w0, n0), (w1, n1) = cast(), cast()
    assert w1 is w0 and n1 == n0 and w0.dtype == torch.bfloat16 and w0.is_contiguous()
    with torch.no_grad():
        nin.W.mul_(2.0)
    with profile(activities=[ProfilerActivity.CPU]):
        w2, n2 = cast()
    assert n2 == n0 + 1 and torch.equal(w2, nin.W.detach().to(torch.bfloat16))
    assert [x.name for x in trace.instants()] == ['rebuild.pack']


def test_rebuild_plan_counts_plan_cache_misses(clean):
    """``rebuild.plan`` counts the conv kernel's and the statistics
    kernel's launch plans made, not those read from their caches."""
    def plans():
        return trace.counts().get('rebuild.plan', 0)
    shape = (3, 5, 7, 9, 64, 128, 132)
    gn_silu_conv._plan.cache_clear()
    n = plans()
    gn_silu_conv._plan(*shape)
    gn_silu_conv._plan(*shape)
    assert plans() == n + 1
    from meshdiffusion_tpu_torch.ops import groupnorm
    groupnorm._gn_plan.cache_clear()
    groupnorm._gn_plan(4096, 128, 32, 2, 132)
    groupnorm._gn_plan(4096, 128, 32, 2, 132)
    assert plans() == n + 2


def test_kernel_wrappers_keep_their_names_and_counters():
    """Every kernel wrapper is a span (``ops.<name>``) and keeps its name
    and its ``launches`` counter."""
    counts = ops.launch_counts()
    assert set(counts) == {'ancestral_update', 'gn_affine', 'groupnorm_silu', 'gn_silu_conv3d',
                           'tile_zmin', 'gn_silu_conv3d_halo', 'gn_moments', 'nin_residual',
                           'dit_attention', 'moe_experts', 'qk_norm_rope'}
    for fn in ops.KERNEL_WRAPPERS:
        assert callable(fn.__wrapped__) and isinstance(fn.launches, int)


def test_span_closes_on_exception_and_buffer_is_bounded(clean, monkeypatch):
    """A span left by an exception still closes and gives the step back;
    past the buffer's capacity spans are dropped and counted."""
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with trace.span('test.outer', i=7):
                with trace.span('test.inner'):
                    raise ValueError
        with trace.span('test.after'):
            pass
    outer, inner, after = trace.spans()
    assert outer.step == inner.step == 7 and inner.parent == 0
    assert inner.t1 is not None and outer.t1 >= inner.t1
    assert after.parent == -1 and after.step == -1
    monkeypatch.setattr(trace, 'CAPACITY', 3)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with trace.span('test.full'):
                pass
    assert len(trace.spans()) == 3 and trace.dropped() == 2


def test_rebuild_triton_counts_from_tritons_compile_hook(monkeypatch):
    """``rebuild.triton`` is counted on Triton's compile path: its
    post-compile hook, set once, counts each compile and calls the hook
    that was there before; a Triton without the hook counts nothing."""
    import sys
    import types

    from meshdiffusion_tpu_torch.ops import _build
    before = []
    runtime = types.SimpleNamespace(jit_post_compile_hook=lambda **kw: before.append(kw))
    monkeypatch.setitem(sys.modules, 'triton', types.SimpleNamespace(
        knobs=types.SimpleNamespace(runtime=runtime)))
    monkeypatch.setattr(_build, '_triton_watched', False)

    def n():
        return trace.counts().get('rebuild.triton', 0)
    start = n()
    _build.watch_triton_compiles()
    hook = runtime.jit_post_compile_hook
    _build.watch_triton_compiles()
    assert runtime.jit_post_compile_hook is hook and n() == start
    hook(key='k', fn=None)
    hook(key='k2', fn=None)
    assert n() == start + 2 and [kw['key'] for kw in before] == ['k', 'k2']

    monkeypatch.setitem(sys.modules, 'triton', types.SimpleNamespace())
    monkeypatch.setattr(_build, '_triton_watched', False)
    _build.watch_triton_compiles()
    assert n() == start + 2
