"""The port's unconditional ancestral sampler (the slice's sampling loop)
against the JAX package's, with the JAX noise replayed through the port's
injectable noise source, on the CPU in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from meshdiffusion_tpu.diffusion.sampling import StepTables as JaxStepTables
from meshdiffusion_tpu.diffusion.sampling import get_pc_sampler as jax_pc_sampler
from meshdiffusion_tpu.diffusion.vpsde import VPSDE as JaxVPSDE
from meshdiffusion_tpu_torch.diffusion.sampling import StepTables, get_sampling_fn
from meshdiffusion_tpu_torch.diffusion.vpsde import VPSDE
from meshdiffusion_tpu_torch.models import create_model
from meshdiffusion_tpu_torch.utils.convert import from_jax_params

from test_torch_unet import R, jax_params, tiny_configs

pytest_plugins = ('torch_rules',)


def replayed_jax_noise(seed, shape, n_steps):
    """The normals the JAX uncond sampler draws: one split for the prior
    (sampling.py:385-386), then three per step, the third for the predictor
    (:316)."""
    key = jax.random.key(seed)
    key, pkey = jax.random.split(key)
    out = {-1: np.asarray(jax.random.normal(pkey, shape, dtype=jnp.float32))}
    for i in range(n_steps):
        key, _, pk = jax.random.split(key, 3)
        out[i] = np.asarray(jax.random.normal(pk, shape, dtype=jnp.float32))
    return out


def test_step_tables_equal():
    for args in ((0.1, 20.0, 1000), (0.1, 2.0, 8)):
        j, p = JaxStepTables.build(JaxVPSDE(*args)), StepTables.build(VPSDE(*args))
        for f in ('t', 'labels', 'beta', 'alpha', 'sqrt_beta', 'inv_sqrt_1m_beta', 'std',
                  'marg_coeff', 'marg_std'):
            np.testing.assert_array_equal(getattr(p, f), getattr(j, f))


def test_uncond_sampler_matches_jax():
    """Tiny res64 model, N=8 (7 steps), beta_max=2.0: at beta_max=20 and
    small N the betas exceed 1 and the tables turn NaN. Tolerance rtol 1e-3,
    atol 1e-4: the port's update computes 1/sqrt(1-beta) in fp32 (as the
    Pallas kernel does) where the JAX sampler multiplies by its
    float64-built table, one fp32 ulp apart per step, and the U-Nets'
    fp32 sums differ in order."""
    jcfg, pcfg = tiny_configs('ddpm_res64')
    N, B, seed = 8, 2, 3
    for c in (jcfg, pcfg):
        c.model.num_scales, c.model.beta_max = N, 2.0
    jmodel, params = jax_params('ddpm_res64')
    shape = (B, R, R, R, 4)
    mask = (np.random.default_rng(5).random((1, R, R, R, 1)) > 0.3).astype(np.float32)

    jsde = JaxVPSDE(beta_max=2.0, N=N)
    jsampler = jax_pc_sampler(jsde, shape, grid_mask=jnp.asarray(mask))
    want, nfe_j = jsampler(lambda p, x, l: jmodel.apply(p, x, l, jnp.asarray(mask), train=False),
                           jax.random.key(seed), params=params)
    want = np.asarray(want)

    model = create_model(pcfg, device='cpu')
    model.load_state_dict(from_jax_params(params, pcfg), strict=True)
    tmask = torch.from_numpy(mask)
    noise = replayed_jax_noise(seed, shape, N - 1)
    sampler = get_sampling_fn(pcfg, VPSDE(beta_max=2.0, N=N), shape, grid_mask=tmask)
    with torch.no_grad():
        got, nfe = sampler(lambda x, l: model(x, l, tmask),
                           lambda name, shp, i=-1, j=0: torch.from_numpy(np.array(noise[i])))
    got = got.numpy()
    assert nfe == nfe_j
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got * (1 - mask), 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
