"""The port's samplers against the JAX package's, on the CPU in float32,
with the JAX noise replayed through the port's named noise source: each
PC predictor (corrector ``none``), each corrector (predictor
``ancestral_sampling``), trajectory capture, the conditional inpainting
sampler (``freeze_iters`` inside and beyond N) and DDIM (a given ``x0``,
with and without a partial).

The sampler math is held with a cheap analytic epsilon model that both
frameworks run, eps = tanh(0.7 x + 1e-3 label), so that each JAX scan
compiles in seconds; one conditional run goes through the tiny U-Net with
weights carried over by ``from_jax_params``. N = 8, beta_max = 2.0 (at
beta_max 20 and small N the betas exceed 1). Tolerance fp32 rtol 2e-4 /
atol 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshdiffusion_tpu.diffusion import sampling as JS
from meshdiffusion_tpu.diffusion.vpsde import VPSDE as JaxVPSDE
from meshdiffusion_tpu_torch.diffusion import sampling as PS
from meshdiffusion_tpu_torch.diffusion.vpsde import VPSDE
from meshdiffusion_tpu_torch.models import create_model
from meshdiffusion_tpu_torch.utils.convert import from_jax_params

from test_torch_unet import R as UNET_R, jax_params, tiny_configs

pytest_plugins = ('torch_rules',)

RTOL, ATOL = 2e-4, 2e-5
N, B, R, SEED = 8, 2, 8, 11
SHAPE = (B, R, R, R, 4)


def jax_eps(x, labels):
    return jnp.tanh(0.7 * x + 1e-3 * labels[:, None, None, None, None])


def port_eps(x, labels):
    return torch.tanh(0.7 * x + 1e-3 * labels[:, None, None, None, None])


def grid_mask(r=R, seed=5):
    return (np.random.default_rng(seed).random((1, r, r, r, 1)) > 0.3).astype(np.float32)


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, dtype=jnp.float32))


def _corrector_draws(out, key, i, n_steps, shape):
    """The corrector's inner draws (sampling.py:179, :203): one split of its
    key a step."""
    for j in range(n_steps):
        key, nk = jax.random.split(key)
        out[('corrector', i, j)] = _normal(nk, shape)


def jax_draws(seed, shape, steps, kind='uncond', n_steps=1):
    """Every normal the JAX sampler draws, keyed (name, i, j): the prior
    (:385 uncond, :415 cond, :545 DDIM), the cond init (:415-423), each
    corrector inner step, the predictor (:316, :353) and the cond replace
    noise (:353, drawn at :360)."""
    key = jax.random.key(seed)
    p_shape = (1,) + tuple(shape[1:4])
    out = {}
    if kind == 'cond':
        key, pkey, ikey = jax.random.split(key, 3)
        out[('init', -1, 0)] = _normal(ikey, p_shape)
    else:
        key, pkey = jax.random.split(key)
    out[('prior', -1, 0)] = _normal(pkey, shape)
    if kind == 'ddim':
        return out
    for i in range(steps):
        if kind == 'cond':
            key, ck, pk, nk = jax.random.split(key, 4)
            out[('replace', i, 0)] = _normal(nk, p_shape)
        else:
            key, ck, pk = jax.random.split(key, 3)
        _corrector_draws(out, ck, i, n_steps, shape)
        out[('predictor', i, 0)] = _normal(pk, shape)
    return out


def replay(draws):
    """A port noise source handing out the JAX draws by name."""
    def noise(name, shape, i=-1, j=0):
        a = draws[(name, i, j)]
        assert a.shape == tuple(shape), (name, i, j, a.shape, shape)
        return torch.from_numpy(a.copy())
    return noise


def _both_pc(predictor='ancestral_sampling', corrector='none', n_steps=1, **kw):
    mask = grid_mask()
    jsampler = JS.get_pc_sampler(JaxVPSDE(beta_max=2.0, N=N), SHAPE, predictor=predictor,
                                 corrector=corrector, n_steps=n_steps, snr=0.16,
                                 grid_mask=jnp.asarray(mask), **kw)
    psampler = PS.get_pc_sampler(VPSDE(beta_max=2.0, N=N), SHAPE, predictor=predictor,
                                 corrector=corrector, n_steps=n_steps, snr=0.16,
                                 grid_mask=torch.from_numpy(mask), **kw)
    return mask, jsampler, psampler


@pytest.mark.parametrize('predictor,corrector,n_steps', [
    ('ancestral_sampling', 'none', 1), ('euler_maruyama', 'none', 1),
    ('reverse_diffusion', 'none', 1), ('none', 'none', 1),
    ('ancestral_sampling', 'langevin', 2), ('ancestral_sampling', 'ald', 2)])
def test_pc_sampler_matches_jax(predictor, corrector, n_steps):
    """Unconditional PC sampling, one predictor or corrector at a time
    against get_pc_sampler; the corrector with two inner steps."""
    mask, jsampler, psampler = _both_pc(predictor, corrector, n_steps)
    want, nfe_j = jsampler(jax_eps, jax.random.key(SEED))
    got, nfe = psampler(port_eps, replay(jax_draws(SEED, SHAPE, N - 1, n_steps=n_steps)))
    want = np.asarray(want)
    assert nfe == nfe_j and np.abs(want).max() > 0.1
    np.testing.assert_array_equal(got.numpy() * (1 - mask), 0.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_trajectory_matches_jax():
    """return_traj with traj_start 2, every 2: steps 2, 4, 6 of the 7 give
    the clipped x0 predictions in slots 0..2; each costs the port one more
    forward, counted in nfe."""
    _, jsampler, psampler = _both_pc(return_traj=True, traj_start=2, traj_every=2)
    want, nfe_j = jsampler(jax_eps, jax.random.key(SEED))
    got, nfe = psampler(port_eps, replay(jax_draws(SEED, SHAPE, N - 1)))
    want = np.asarray(want)
    assert got.shape == want.shape == (3,) + SHAPE
    assert nfe == nfe_j + 3
    assert all(np.abs(want[k]).max() > 0.1 for k in range(3))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def _partial(seed=7):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, (1, R, R, R, 1)).astype(np.float32)
    m = (rng.random((1, R, R, R, 1)) > 0.5).astype(np.float32)
    return p, m


@pytest.mark.parametrize('freeze_iters', [5, None])
def test_cond_sampler_matches_jax(freeze_iters):
    """Conditional inpainting of channel 0: the replace runs while
    i < freeze_iters and i != N-1 (5: inside N; None: N + 10, beyond)."""
    mask, jsampler, psampler = _both_pc()
    p, m = _partial()
    want, nfe_j = jsampler(jax_eps, jax.random.key(SEED), partial=jnp.asarray(p),
                           partial_mask=jnp.asarray(m), freeze_iters=freeze_iters)
    got, nfe = psampler(port_eps, replay(jax_draws(SEED, SHAPE, N, kind='cond')),
                        partial=torch.from_numpy(p), partial_mask=torch.from_numpy(m),
                        freeze_iters=freeze_iters)
    want = np.asarray(want)
    assert nfe == nfe_j and np.abs(want).max() > 0.1
    np.testing.assert_array_equal(got.numpy() * (1 - mask), 0.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('with_partial', [False, True])
def test_ddim_matches_jax(with_partial):
    """DDIM from a given x0 over a 10-step quad schedule, x0 prediction
    returned (denoise), with and without a partial re-imposed."""
    mask = grid_mask()
    sde_j, sde_p = JaxVPSDE(beta_max=2.0, N=N), VPSDE(beta_max=2.0, N=N)
    kw = dict(denoise=True, num_steps=10)
    jsampler = JS.get_ddim_sampler(sde_j, SHAPE, grid_mask=jnp.asarray(mask), **kw)
    psampler = PS.get_ddim_sampler(sde_p, SHAPE, grid_mask=torch.from_numpy(mask), **kw)
    x0 = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    p, m = _partial() if with_partial else (None, None)
    want, nfe_j = jsampler(jax_eps, jax.random.key(SEED), x0=jnp.asarray(x0),
                           partial=None if p is None else jnp.asarray(p),
                           partial_mask=None if m is None else jnp.asarray(m))
    got, nfe = psampler(port_eps, None, x0=torch.from_numpy(x0),
                        partial=None if p is None else torch.from_numpy(p),
                        partial_mask=None if m is None else torch.from_numpy(m))
    want = np.asarray(want)
    assert nfe == nfe_j and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_ddim_prior_draw_matches_jax():
    """Without x0 the DDIM sampler starts from its prior draw (:545)."""
    mask = grid_mask()
    jsampler = JS.get_ddim_sampler(JaxVPSDE(beta_max=2.0, N=N), SHAPE,
                                   grid_mask=jnp.asarray(mask), num_steps=10)
    psampler = PS.get_ddim_sampler(VPSDE(beta_max=2.0, N=N), SHAPE,
                                   grid_mask=torch.from_numpy(mask), num_steps=10)
    want, _ = jsampler(jax_eps, jax.random.key(SEED))
    got, _ = psampler(port_eps, replay(jax_draws(SEED, SHAPE, 0, kind='ddim')))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_ddim_schedule_equal():
    for sched, n in (('quad', 100), ('uniform', 50)):
        np.testing.assert_array_equal(PS.ddim_schedule(VPSDE(N=1000), sched, n),
                                      JS.ddim_schedule(JaxVPSDE(N=1000), sched, n))


def test_cond_sampler_through_unet_matches_jax():
    """The conditional sampler over the tiny res64 U-Net (weights from the
    JAX init through from_jax_params), batch 1, freeze_iters 5."""
    jcfg, pcfg = tiny_configs('ddpm_res64')
    jmodel, params = jax_params('ddpm_res64')
    shape = (1, UNET_R, UNET_R, UNET_R, 4)
    mask = grid_mask(UNET_R)
    rng = np.random.default_rng(8)
    p = np.sign(rng.uniform(-1, 1, (1,) + shape[1:4] + (1,))).astype(np.float32)
    m = (rng.random((1,) + shape[1:4] + (1,)) > 0.5).astype(np.float32)
    jsampler = JS.get_pc_sampler(JaxVPSDE(beta_max=2.0, N=N), shape, grid_mask=jnp.asarray(mask))
    want, _ = jsampler(lambda pr, x, l: jmodel.apply(pr, x, l, jnp.asarray(mask), train=False),
                       jax.random.key(SEED), partial=jnp.asarray(p), partial_mask=jnp.asarray(m),
                       freeze_iters=5, params=params)
    model = create_model(pcfg, device='cpu')
    model.load_state_dict(from_jax_params(params, pcfg), strict=True)
    tmask = torch.from_numpy(mask)
    psampler = PS.get_pc_sampler(VPSDE(beta_max=2.0, N=N), shape, grid_mask=tmask)
    with torch.no_grad():
        got, _ = psampler(lambda x, l: model(x, l, tmask),
                          replay(jax_draws(SEED, shape, N, kind='cond')),
                          partial=torch.from_numpy(p), partial_mask=torch.from_numpy(m),
                          freeze_iters=5)
    want = np.asarray(want)
    assert np.isfinite(got.numpy()).all() and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
