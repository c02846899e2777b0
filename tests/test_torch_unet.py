"""The PyTorch port's U-Net, config, VPSDE tables and weight layout against
the JAX package, on the CPU in float32.

Weights come from the flax model's ``init`` (every leaf then perturbed with
seeded noise, so that the zero-initialised convs carry signal) and are
carried into the port by ``utils.convert.from_jax_params``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshdiffusion_tpu.config import get_config as jax_get_config
from meshdiffusion_tpu.models import create_model as jax_create_model
from meshdiffusion_tpu.utils.torch_convert import convert_model_state
from meshdiffusion_tpu_torch.config import get_config, apply_overrides
from meshdiffusion_tpu_torch.models import create_model
from meshdiffusion_tpu_torch.utils.convert import from_jax_params

pytest_plugins = ('torch_rules',)

R = 16


def tiny_configs(name):
    """The same tiny architecture for both packages (the ``_tiny_config`` of
    tests/test_torch_parity.py), fp32 compute."""
    out = []
    for cfg in (jax_get_config('res64' if name == 'ddpm_res64' else 'res128'),
                get_config('res64' if name == 'ddpm_res64' else 'res128')):
        cfg.model.name = name
        cfg.model.nf = 32
        cfg.model.ch_mult = (1, 2)
        cfg.model.num_res_blocks = 1
        cfg.model.num_res_blocks_first = 2
        cfg.model.attn_resolutions = (8,)
        cfg.model.dropout = 0.0
        cfg.data.image_size = R
        out.append(cfg)
    out[0].tpu.compute_dtype = 'float32'
    out[1].gpu.compute_dtype = 'float32'
    return out


@functools.lru_cache(maxsize=None)
def jax_params(name, seed=0, noise=0.05):
    """The tiny flax model and its init, every leaf perturbed by seeded noise."""
    model = jax_create_model(tiny_configs(name)[0])
    x0 = jnp.zeros((1, R, R, R, 4))
    params = jax.jit(model.init)({'params': jax.random.key(seed)}, x0, jnp.zeros((1,)),
                                 jnp.ones((1, R, R, R, 1)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda p: np.asarray(p, np.float32)
        + noise * rng.standard_normal(p.shape).astype(np.float32), params)
    return model, params


@pytest.mark.parametrize('name', ['ddpm_res64', 'ddpm_res128'])
def test_unet_forward_matches_jax(name):
    _, pcfg = tiny_configs(name)
    jmodel, params = jax_params(name)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, R, R, R, 4)).astype(np.float32)
    labels = np.array([3.0, 500.0], np.float32)
    mask = (rng.random((1, R, R, R, 1)) > 0.3).astype(np.float32)
    apply = jax.jit(lambda p, *a: jmodel.apply(p, *a, train=False))
    want = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mask)))

    model = create_model(pcfg, device='cpu')
    model.load_state_dict(from_jax_params(params, pcfg), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(labels),
                    torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == x.shape
    assert np.abs(want).max() > 0.1      # the comparison carries signal
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def _forwards(name, params, dtypes):
    """The tiny U-Net's outputs (float64 numpy) in each compute dtype of
    ``dtypes``, JAX's (jitted) and the port's, on the same weights and the
    inputs of :func:`test_unet_forward_matches_jax`."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, R, R, R, 4)).astype(np.float32)
    labels = np.array([3.0, 500.0], np.float32)
    mask = (rng.random((1, R, R, R, 1)) > 0.3).astype(np.float32)
    out = {}
    for dt in dtypes:
        jcfg, pcfg = tiny_configs(name)
        jcfg.tpu.compute_dtype = pcfg.gpu.compute_dtype = dt
        jmodel = jax_create_model(jcfg)
        apply = jax.jit(lambda p, *a: jmodel.apply(p, *a, train=False))
        out['jax', dt] = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(labels),
                                          jnp.asarray(mask)), np.float64)
        model = create_model(pcfg, device='cpu')
        model.load_state_dict(from_jax_params(params, pcfg), strict=True)
        with torch.no_grad():
            got = model(torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(mask))
        assert got.dtype == torch.float32 and got.shape == x.shape
        out['port', dt] = got.double().numpy()
    return out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize('name', ['ddpm_res64', 'ddpm_res128'])
def test_unet_bf16_forward_matches_jax(name):
    """The card's compute dtype, bf16 (``gpu.compute_dtype``, JAX's
    ``tpu.compute_dtype``), in both packages on the same weights.

    * Every tensor drawn from normal(0, 0.02), the weights ``chip_smoke.py``
      holds the card's bf16 forward to its plain version with: the outputs
      within relative L2 1e-2, that bound.
    * The weights of :func:`test_unet_forward_matches_jax` (the DDPM init
      perturbed, unit GroupNorm scales), whose bf16 rounding error is larger
      (1-2 %) and differs between the packages' rounding points (JAX's
      default plain blocks round the GroupNorm to bf16 before SiLU and sum
      three bf16 2D convs a 3^3 conv; the port, as JAX's fused kernel does,
      rounds once after the fp32 SiLU and conv): the port's bf16 output no
      farther from the fp32 forward (JAX's, which the port's fp32 forward
      matches within the fp32 tolerance) than JAX's bf16 output is."""
    _, params = jax_params(name)
    g = np.random.default_rng(7)
    flat = jax.tree.map(lambda p: g.normal(0.0, 0.02, p.shape).astype(np.float32), params)
    out = _forwards(name, flat, ('bfloat16',))
    rel = _rel(out['port', 'bfloat16'], out['jax', 'bfloat16'])
    assert np.abs(out['jax', 'bfloat16']).max() > 0.01
    out = _forwards(name, params, ('bfloat16', 'float32'))
    truth = out['jax', 'float32']
    port_err, jax_err = (_rel(out[k, 'bfloat16'], truth) for k in ('port', 'jax'))
    print(f'{name} bf16 forward: port vs JAX relative L2 {rel:.3e} (normal(0, 0.02) '
          f'weights); perturbed DDPM weights: port vs JAX '
          f'{_rel(out["port", "bfloat16"], out["jax", "bfloat16"]):.3e}, each against the fp32 '
          f'forward: port {port_err:.3e}, JAX {jax_err:.3e}')
    assert 0.0 < rel <= 1e-2, rel
    assert 0.0 < port_err <= jax_err, (port_err, jax_err)


def test_remat_blocks_config_off_matches_on():
    """``gpu.remat_blocks`` False (no checkpoint around the ResnetBlocks in
    the train forward) against True, fp32 on the same weights: the same loss
    and gradients, bit for bit (the JAX package's
    ``test_model.py::test_remat_blocks_parity``)."""
    _, params = jax_params('ddpm_res64')
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, R, R, R, 4)).astype(np.float32))
    labels = torch.tensor([3.0, 500.0])
    mask = torch.ones((1, R, R, R, 1))
    out = []
    for remat in (True, False):
        _, pcfg = tiny_configs('ddpm_res64')
        pcfg = apply_overrides(pcfg, [('gpu.remat_blocks', str(remat))])
        model = create_model(pcfg, device='cpu')
        assert model.remat_blocks is remat
        model.load_state_dict(from_jax_params(params, pcfg), strict=True)
        loss = (model(x, labels, mask, train=True) ** 2).sum()
        loss.backward()
        out.append((loss.detach(), {k: p.grad for k, p in model.named_parameters()}))
    assert torch.equal(out[0][0], out[1][0]) and out[0][0] > 0
    assert len(out[0][1]) > 50
    for k, g in out[0][1].items():
        torch.testing.assert_close(g, out[1][1][k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize('name', ['ddpm_res64', 'ddpm_res128'])
def test_weight_layout_round_trip(name):
    """The port's state_dict is the reference torch layout: the JAX
    package's own converter maps it onto the flax tree bit for bit, and
    from_jax_params of a flax-initialised tree loads with strict=True."""
    jcfg, pcfg = tiny_configs(name)
    _, params = jax_params(name)
    model = create_model(pcfg, device='cpu')
    model.load_state_dict(from_jax_params(params, pcfg), strict=True)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = convert_model_state(sd, jcfg)
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_want) == len(flat_got)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), leaf)


@pytest.mark.parametrize('name', ['ddpm_res64', 'ddpm_res128'])
def test_full_width_parameter_count(name):
    """The full-width presets build the same parameter tree as the JAX
    model (checked by shape, from the flax abstract init)."""
    jcfg = jax_get_config('res64' if name == 'ddpm_res64' else 'res128')
    pcfg = get_config('res64' if name == 'ddpm_res64' else 'res128')
    Rf = jcfg.data.image_size
    shapes = jax.eval_shape(lambda: jax_create_model(jcfg).init(
        {'params': jax.random.key(0)}, jnp.zeros((1, Rf, Rf, Rf, 4)), jnp.zeros((1,)),
        jnp.ones((1, Rf, Rf, Rf, 1))))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    model = create_model(pcfg, device='meta')
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_config_tree_matches_jax():
    """Same sections and keys as the JAX config, with ``gpu`` (compute_dtype,
    tet_root, remat_blocks and the mesh's mesh_data_axis, mesh_spatial_axis
    and allow_device_idle: each a key of JAX's ``tpu``, with its value; and
    dist_backend, 'nccl') in place of ``tpu`` and no ``sampling.segment_steps``."""
    def keys(c, prefix=''):
        out = set()
        for k, v in c.items():
            out |= keys(v, prefix + k + '.') if hasattr(v, 'items') else {prefix + k}
        return out

    for preset in ('res64', 'res128', 'default'):
        jc, pc = jax_get_config(preset), get_config(preset)
        jk = {k for k in keys(jc) if not k.startswith('tpu.')} - {'sampling.segment_steps'}
        gpu = {'gpu.compute_dtype', 'gpu.tet_root', 'gpu.mesh_data_axis', 'gpu.mesh_spatial_axis',
               'gpu.allow_device_idle', 'gpu.remat_blocks'}
        assert keys(pc) - gpu - {'gpu.dist_backend'} == jk
        assert {k for k in keys(pc) if k.startswith('gpu.')} == gpu | {'gpu.dist_backend'}
        for k in gpu:
            assert pc.gpu[k[4:]] == jc.tpu[k[4:]], k
        assert pc.gpu.dist_backend == 'nccl'
        for k in jk:
            node_j, node_p = jc, pc
            for p in k.split('.'):
                node_j, node_p = node_j[p], node_p[p]
            assert node_j == node_p, k
    cfg = apply_overrides(get_config('res64'), [('model.num_scales', '10'),
                                                ('model.beta_max', '2.0'),
                                                ('model.ch_mult', '(1,2)')])
    assert (cfg.model.num_scales, cfg.model.beta_max, cfg.model.ch_mult) == (10, 2.0, (1, 2))


def test_vpsde_tables_bit_equal():
    from meshdiffusion_tpu.diffusion.vpsde import VPSDE as JaxVPSDE
    from meshdiffusion_tpu_torch.diffusion.vpsde import VPSDE
    for args in ((0.1, 20.0, 1000), (0.1, 2.0, 8)):
        j, p = JaxVPSDE(*args), VPSDE(*args)
        for name in ('discrete_betas', 'alphas', 'alphas_cumprod', 'sqrt_alphas_cumprod',
                     'sqrt_1m_alphas_cumprod'):
            np.testing.assert_array_equal(getattr(p, name), getattr(j, name))
        np.testing.assert_array_equal(p.timesteps(), j.timesteps())
        t = np.array([0.3, 0.9], np.float32)
        jm, js = j.marginal_coeffs(jnp.asarray(t))
        pm, ps = p.marginal_coeffs(torch.from_numpy(t))
        np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=1e-6)
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-6)


def test_cached_conv_weights_follow_the_parameters():
    """The ResnetBlock convs keep their weights in the kernel layout between
    calls; changing the parameters (load_state_dict, in-place init) must
    change the forward exactly as a freshly built model would."""
    _, pcfg = tiny_configs('ddpm_res64')
    _, params_a = jax_params('ddpm_res64', seed=0)
    _, params_b = jax_params('ddpm_res64', seed=1)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, R, R, R, 4))
                         .astype(np.float32))
    labels = torch.tensor([7.0])
    model = create_model(pcfg, device='cpu')
    fresh = create_model(pcfg, device='cpu')
    with torch.no_grad():
        model.load_state_dict(from_jax_params(params_a, pcfg))
        model(x, labels)
        model.load_state_dict(from_jax_params(params_b, pcfg))
        fresh.load_state_dict(from_jax_params(params_b, pcfg))
        torch.testing.assert_close(model(x, labels), fresh(x, labels), rtol=0, atol=0)
