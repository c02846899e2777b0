"""The port's NCSN blocks, normalizations and naive resampling against the
JAX package, on the CPU, channels-last: every block with seeded weights in
the shapes of JAX's flax tree, carried across by
``utils.convert.ncsn_block_state_from_jax`` / ``normalization_state_from_jax``
and loaded with ``strict=True``; ``get_normalization``'s classes and errors;
the naive up- and downsampling exactly (integer-valued inputs, so that the
means are exact). Tolerance: fp32 rtol 2e-4 / atol 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from meshdiffusion_tpu.models import ncsn_blocks as JB
from meshdiffusion_tpu.models import normalization as JN
from meshdiffusion_tpu.models import up_or_down_sampling as JU
from meshdiffusion_tpu_torch.config import get_config
from meshdiffusion_tpu_torch.models import ncsn_blocks as B
from meshdiffusion_tpu_torch.models import normalization as N
from meshdiffusion_tpu_torch.models import up_or_down_sampling as U
from meshdiffusion_tpu_torch.utils.convert import (ncsn_block_state_from_jax,
                                                   normalization_state_from_jax)

pytest_plugins = ('torch_rules',)

RTOL, ATOL = 2e-4, 2e-5


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _weights(jmod, full, dyn, seed):
    """Seeded weights in the shapes of ``jmod``'s flax tree (read with
    ``eval_shape`` of its init on the arguments ``full(dyn)``, so that no
    init is compiled): kernels N(0, 1/fan_in),
    scales 1 + N(0, 0.05^2), everything else N(0, 0.05^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        n = rng.standard_normal(s.shape).astype(np.float32)
        if name == 'kernel':
            return n / np.sqrt(np.prod(s.shape[:-1]))
        return (1.0 if name in ('gamma', 'alpha', 'scale', 'embed') else 0.0) + 0.05 * n
    shapes = jax.eval_shape(lambda k, *d: jmod.init(k, *full(d)), jax.random.key(0), *dyn)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _both(jmod, pmod, convert, args, seed=0):
    """JAX's module (seeded weights, jitted apply) and the port's with the
    same weights, on the same numpy inputs ``args`` (arrays or lists of
    arrays; other arguments pass as they are)."""
    jargs = [[jnp.asarray(a) for a in x] if isinstance(x, list) else
             jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in args]
    dyn = [x for x in jargs if not isinstance(x, tuple)]
    static = {i: x for i, x in enumerate(jargs) if isinstance(x, tuple)}

    def full(dyn):
        full = list(dyn)
        for i, x in sorted(static.items()):
            full.insert(i, x)
        return full
    params = _weights(jmod, full, dyn, seed)
    want = np.asarray(jax.jit(lambda p, *d: jmod.apply(p, *full(d)))(params, *dyn))
    pmod.load_state_dict(convert(params), strict=True)
    pargs = [[torch.from_numpy(a) for a in x] if isinstance(x, list) else
             torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in args]
    with torch.no_grad():
        got = pmod(*pargs).numpy()
    assert got.shape == want.shape
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('factor', [2, 4])
def test_naive_resampling_exact(factor):
    x = np.random.default_rng(factor).integers(-50, 50, (2, 8, 8, 8, 3)).astype(np.float32)
    for jfn, pfn in ((JU.naive_upsample_3d, U.naive_upsample_3d),
                     (JU.naive_downsample_3d, U.naive_downsample_3d)):
        want = np.asarray(jfn(jnp.asarray(x), factor))
        np.testing.assert_array_equal(pfn(torch.from_numpy(x), factor).numpy(), want)


@pytest.mark.parametrize('bias', [True, False])
def test_instance_norms_match_jax(bias):
    C = 6
    x = 3.0 * _x((2, 4, 5, 6, C), 1) + np.arange(C, dtype=np.float32)   # channel shifts
    _both(JN.InstanceNorm3d(bias=bias), N.InstanceNorm3d(C, bias=bias),
          normalization_state_from_jax, [x])
    _both(JN.InstanceNorm3dPlus(bias=bias), N.InstanceNorm3dPlus(C, bias=bias),
          normalization_state_from_jax, [x], seed=1)
    y = np.array([3, 0], np.int32)
    _both(JN.ConditionalInstanceNorm3dPlus(num_classes=5, bias=bias),
          N.ConditionalInstanceNorm3dPlus(C, num_classes=5, bias=bias),
          normalization_state_from_jax, [x, y], seed=2)
    # the conditional norm's initial embedding is JAX's
    cond = N.ConditionalInstanceNorm3dPlus(C, num_classes=5, bias=bias)
    init = JN.ConditionalInstanceNorm3dPlus(num_classes=5, bias=bias).init(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_array_equal(cond.embed.detach().numpy(),
                                  np.asarray(init['params']['embed']))


def test_get_normalization_classes_and_errors():
    cfg, jcfg = get_config('res64'), get_config('res64')
    table = {('InstanceNorm', False): (N.InstanceNorm3d, JN.InstanceNorm3d),
             ('InstanceNorm++', False): (N.InstanceNorm3dPlus, JN.InstanceNorm3dPlus),
             ('InstanceNorm++', True): (N.ConditionalInstanceNorm3dPlus,
                                        JN.ConditionalInstanceNorm3dPlus)}
    for (name, conditional), (port_cls, jax_cls) in table.items():
        cfg.model.normalization = jcfg.model.normalization = name
        assert N.get_normalization(cfg, conditional) is port_cls
        assert JN.get_normalization(jcfg, conditional) is jax_cls
    for name, conditional, exc in (('InstanceNorm', True, NotImplementedError),
                                   ('GroupNorm', True, NotImplementedError),
                                   ('BatchNorm', False, ValueError)):
        cfg.model.normalization = jcfg.model.normalization = name
        with pytest.raises(exc) as want:
            JN.get_normalization(jcfg, conditional)
        with pytest.raises(exc, match=str(want.value).replace('+', r'\+')):
            N.get_normalization(cfg, conditional)
    # GroupNorm: 32 groups, eps 1e-6, against flax's as the JAX factory builds it
    cfg.model.normalization = jcfg.model.normalization = 'GroupNorm'
    gn = N.get_normalization(cfg)(64)
    assert (gn.num_groups, gn.eps) == (32, 1e-6)
    x = 2.0 * _x((2, 4, 4, 4, 64), 3) + 1.0
    _both(JN.get_normalization(jcfg)(), gn, normalization_state_from_jax, [x])


def test_crp_and_rcu_blocks_match_jax():
    C = 8
    x = _x((2, 6, 6, 6, C), 4)
    for maxpool in (True, False):
        _both(JB.CRPBlock(C, maxpool=maxpool), B.CRPBlock(C, maxpool=maxpool),
              ncsn_block_state_from_jax, [x])
    _both(JB.RCUBlock(C, n_blocks=2, n_stages=2), B.RCUBlock(C, 2, 2),
          ncsn_block_state_from_jax, [x], seed=1)
    _both(JB.RCUBlock(C, n_blocks=1, n_stages=3, act=jax.nn.elu),
          B.RCUBlock(C, 1, 3, act=F.elu), ncsn_block_state_from_jax, [x], seed=2)


def test_msf_and_refine_blocks_match_jax():
    """Fusion to (6, 6, 6) of an input at that size, a coarser one (linear
    upsampling) and a finer one (jax.image.resize's antialiased
    downsampling, along unequal axes); RefineBlocks of two inputs (end) and
    of one."""
    a = _x((1, 6, 6, 6, 8), 5)
    b = _x((1, 3, 3, 3, 12), 6)
    c = _x((1, 12, 9, 6, 4), 7)
    _both(JB.MSFBlock(10), B.MSFBlock((8, 12, 4), 10), ncsn_block_state_from_jax,
          [[a, b, c], (6, 6, 6)])
    _both(JB.RefineBlock(8, end=True), B.RefineBlock((8, 12), 8, end=True),
          ncsn_block_state_from_jax, [[a, b], (6, 6, 6)], seed=1)
    _both(JB.RefineBlock(8, maxpool=False), B.RefineBlock((8,), 8, maxpool=False),
          ncsn_block_state_from_jax, [[a], (6, 6, 6)], seed=2)


def test_pooled_convs_match_jax():
    x = _x((1, 4, 8, 8, 6), 8)
    for kernel in (3, 2):
        _both(JB.ConvMeanPool(10, kernel=kernel), B.ConvMeanPool(6, 10, kernel),
              ncsn_block_state_from_jax, [x])
        _both(JB.MeanPoolConv(10, kernel=kernel, use_bias=False),
              B.MeanPoolConv(6, 10, kernel, use_bias=False), ncsn_block_state_from_jax, [x])
