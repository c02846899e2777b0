"""The frozen counts against what the reference and the port compute: the
FLOPs of a forward against ``torch.utils.flop_counter`` over both at a tiny
width, the kernel calls against the port's own calls."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import weights
from portbench.counts import kernels, unet as unet_counts
from portbench.reference import unet as ref_unet
from portbench.tests.tiny import tiny_config

from portbench import harness


def _cfg(name):
    return tiny_config(harness.Cell.load(name).config)


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize('cell', ['gen64-b1', 'gen128-b7'])
def test_forward_flops_match_flop_counter(cell):
    cfg = _cfg(cell)
    a = ref_unet.arch(cfg)
    R, B = a['R'], 2
    _, p = weights.make(a, 7, 'cpu')
    x = torch.randn(B, a['C'], R, R, R)
    mask = torch.ones(R, R, R)
    counted = _flops(lambda: ref_unet.forward(p, a, x, torch.tensor([3.0, 9.0]), mask))
    assert unet_counts.walk(a, B)['flops'] == counted


def _port_model(cfg, B, dtype='float32'):
    from portbench.drivers.gen import port_config
    from meshdiffusion_tpu_torch.models import create_model
    config = port_config(cfg, B)
    config.gpu.compute_dtype = dtype
    return create_model(config, 'cpu').eval()


@pytest.mark.parametrize('cell', ['gen64-b1', 'gen128-b7'])
def test_kernel_calls_and_flops_match_the_port(cell, monkeypatch):
    """At a tiny width on the CPU, the port's model makes the K3 and
    GroupNorm+SiLU calls the walk lists (shapes, x's dtype, widths) and
    computes the FLOPs it counts."""
    from meshdiffusion_tpu_torch import ops
    cfg = _cfg(cell)
    a = ref_unet.arch(cfg)
    R, B = a['R'], 2
    model = _port_model(cfg, B, 'bfloat16')
    k3, head = [], []
    real_k3, real_head = ops.gn_silu_conv3d, ops.groupnorm_silu

    def rec_k3(x, *args, **kw):
        k3.append((tuple(x.shape), str(x.dtype).split('.')[-1], args[2].shape[-1]))
        return real_k3(x, *args, **kw)

    def rec_head(x, *args, **kw):
        head.append((tuple(x.shape), str(x.dtype).split('.')[-1]))
        return real_head(x, *args, **kw)
    monkeypatch.setattr(ops, 'gn_silu_conv3d', rec_k3)
    monkeypatch.setattr(ops, 'groupnorm_silu', rec_head)
    x = torch.randn(B, R, R, R, a['C'])
    mask = torch.ones(1, R, R, R, 1)
    with torch.no_grad():
        counted = _flops(lambda: model(x, torch.tensor([3.0, 9.0]), mask))
    walk = unet_counts.walk(a, B)
    assert k3 == walk['k3']
    assert [(s, d) for s, d, _ in k3] + head == walk['gn_stats']
    assert walk['flops'] == counted


def test_cost_counts_by_hand():
    f, b = kernels.gn_silu_conv3d_cost((1, 4, 4, 4, 64), 'float32', 128)
    assert f == 2 * 64 * 27 * 64 * 128
    assert b == 64 * 64 * 4 + 27 * 64 * 128 * 2 + 64 * 128 * 2 + 2 * 64 * 4 + 128 * 4
    f, b = kernels.gn_affine_cost((2, 8, 8, 8, 32), 'bfloat16')
    assert (f, b) == (3 * 2 * 512 * 32, 2 * 512 * 32 * 2 + 2 * 2 * 32 * 4 + 2 * 32 * 4)
    # res64 at batch 1: the (1, 64^3, 128) bf16 -> 128 conv is compute-bound
    t = kernels.gn_silu_conv3d_bound_s((1, 64, 64, 64, 128), 'bfloat16', 128)
    assert t == pytest.approx(2 * 64 ** 3 * 27 * 128 * 128 / 989e12)
