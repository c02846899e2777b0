"""The port's likelihood (probability-flow ODE, Hutchinson divergence)
against the JAX package's, on the CPU in float32: the drift and the
divergence estimate of a tiny U-Net with the same Hutchinson vector, and
whole ``likelihood_fn`` runs on the analytic standard-normal model of
``tests/test_likelihood.py``, with JAX's noise injected and with the
port's own. The JAX package takes the divergence forward-mode
(``jax.jvp``), the port reverse-mode: the same estimate summed in another
order, so it is held at rtol 1e-3; the drift at fp32's rtol 2e-4 /
atol 2e-5, the atol scaled by the factor 0.5 beta(t) / std(t) that
multiplies the U-Net's output in the drift."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshdiffusion_tpu.diffusion.likelihood import get_drift_fn as jax_get_drift_fn
from meshdiffusion_tpu.diffusion.likelihood import get_likelihood_fn as jax_get_likelihood_fn
from meshdiffusion_tpu.diffusion.vpsde import VPSDE as JaxVPSDE
from meshdiffusion_tpu_torch.diffusion.likelihood import (get_drift_and_div_fn,
                                                          get_likelihood_fn)
from meshdiffusion_tpu_torch.diffusion.vpsde import VPSDE
from meshdiffusion_tpu_torch.models import create_model
from meshdiffusion_tpu_torch.utils.convert import from_jax_params

from test_torch_unet import R, jax_params, tiny_configs

pytest_plugins = ('torch_rules',)


def test_drift_and_divergence_match_jax():
    """Tiny res64 U-Net (weights carried over), one sample, Rademacher eps
    from JAX's key, at t = 1e-3, 0.5 and 1."""
    _, pcfg = tiny_configs('ddpm_res64')
    jmodel, params = jax_params('ddpm_res64')
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, R, R, R, 4)).astype(np.float32)
    mask = (rng.random((1, R, R, R, 1)) > 0.3).astype(np.float32)
    eps = np.asarray(jax.random.rademacher(jax.random.key(3), x.shape).astype(jnp.float32))
    jsde, sde = JaxVPSDE(), VPSDE()

    jdrift = jax_get_drift_fn(jsde, lambda xx, lab: jmodel.apply(
        params, xx, lab, jnp.asarray(mask), train=False))

    @jax.jit
    def jax_drift_and_div(xx, t):
        drift, jvp = jax.jvp(lambda z: jdrift(z, t), (xx,), (jnp.asarray(eps),))
        return drift, jnp.sum(jvp * eps, axis=(1, 2, 3, 4))

    model = create_model(pcfg, device='cpu')
    model.load_state_dict(from_jax_params(params, pcfg), strict=True)
    model.requires_grad_(False)
    tmask = torch.from_numpy(mask)
    drift_and_div = get_drift_and_div_fn(sde, lambda xx, lab: model(xx, lab, tmask))
    for t in (1e-3, 0.5, 1.0):
        want_d, want_div = (np.asarray(a) for a in jax_drift_and_div(
            jnp.asarray(x), jnp.full((1,), t, jnp.float32)))
        got_d, got_div = drift_and_div(torch.from_numpy(x), torch.full((1,), t),
                                       torch.from_numpy(eps.copy()))
        assert np.abs(want_d).max() > 0.1
        # the drift is the U-Net's output times 0.5 beta(t) / std(t) (6.0 at
        # t = 1e-3, where std is 0.01) plus a term computed alike on both
        # sides: the U-Net's own fp32 tolerance, atol 2e-5, scales with it
        scale = 0.5 * (sde.beta_0 + t * (sde.beta_1 - sde.beta_0)) / \
            sde.sqrt_1m_alphas_cumprod[int(np.float32(t) * (sde.N - 1))]
        np.testing.assert_allclose(got_d.numpy(), want_d, rtol=2e-4, atol=2e-5 * max(1.0, scale))
        np.testing.assert_allclose(got_div.numpy(), want_div, rtol=1e-3)


def _std_normal_models():
    """eps_hat(x, t) = std_t * x: the optimal model of N(0, I) data."""
    jsde, sde = JaxVPSDE(N=1000), VPSDE(N=1000)
    js1m = jnp.asarray(jsde.sqrt_1m_alphas_cumprod)
    ps1m = torch.as_tensor(sde.sqrt_1m_alphas_cumprod)

    def jax_model(x, labels):
        return js1m[labels.astype(jnp.int32)].reshape((-1, 1, 1, 1, 1)) * x

    def port_model(x, labels):
        return ps1m[labels.long()].reshape((-1, 1, 1, 1, 1)) * x
    return jsde, sde, jax_model, port_model


@pytest.mark.parametrize('kind', ['Rademacher', 'Gaussian'])
def test_likelihood_fn_matches_jax_with_its_noise(kind):
    jsde, sde, jax_model, port_model = _std_normal_models()
    data = np.random.default_rng(0).normal(size=(2, 4, 4, 4, 2)).astype(np.float32)
    key = jax.random.key(5)
    want = jax_get_likelihood_fn(jsde, jax_model, kind, rtol=1e-4, atol=1e-4)(key, data)
    eps = (jax.random.rademacher(key, data.shape).astype(jnp.float32) if kind == 'Rademacher'
           else jax.random.normal(key, data.shape))
    got = get_likelihood_fn(sde, port_model, kind, rtol=1e-4, atol=1e-4, device='cpu')(
        lambda name, shape, i=-1, j=0: torch.from_numpy(np.array(eps)), data)
    assert got[2] == want[2] > 0
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-4, atol=2e-5)


def test_bpd_of_standard_normal_data():
    """tests/test_likelihood.py's analytic case on the port, with its own
    seeded Rademacher noise: bits/dim near the standard normal's entropy
    in bits, 0.5 log2(2 pi e), plus the reference's offset 8."""
    _, sde, _, port_model = _std_normal_models()
    lk = get_likelihood_fn(sde, port_model, rtol=1e-4, atol=1e-4, device='cpu')
    data = np.random.default_rng(0).normal(size=(2, 4, 4, 4, 2)).astype(np.float32)
    bpd, z, nfe = lk(0, data)
    assert z.shape == data.shape and nfe > 0
    np.testing.assert_allclose(bpd, 0.5 * np.log2(2 * np.pi * np.e) + 8.0, atol=0.25)
    bpd2, z2, _ = lk(0, data)
    np.testing.assert_array_equal(z, z2)
    np.testing.assert_array_equal(bpd, bpd2)
    with pytest.raises(NotImplementedError):
        get_likelihood_fn(sde, port_model, 'Bernoulli', device='cpu')(0, data)


def test_drift_and_div_refuses_a_trainable_model():
    """The network's parameters are constants of the ODE: a model_fn whose
    parameters require grad is refused at the first evaluation, and the same
    model frozen gives eps^T J eps of its linear map."""
    sde = VPSDE()
    lin = torch.nn.Linear(2, 2, bias=False)
    drift_and_div = get_drift_and_div_fn(sde, lambda x, lab: lin(x))
    x, t, eps = torch.ones((1, 2, 2, 2, 2)), torch.full((1,), 0.5), torch.ones((1, 2, 2, 2, 2))
    with pytest.raises(ValueError, match='requires_grad_'):
        drift_and_div(x, t, eps)
    lin.requires_grad_(False)
    drift_and_div = get_drift_and_div_fn(sde, lambda x, lab: lin(x))
    _, div = drift_and_div(x, t, eps)
    beta = sde.beta_0 + 0.5 * (sde.beta_1 - sde.beta_0)
    std = float(sde.sqrt_1m_alphas_cumprod[int(0.5 * (sde.N - 1))])
    # d drift / dx = -0.5 beta (I - W / std) on every voxel's 2 channels
    want = 8 * float((-0.5 * beta * (torch.eye(2) - lin.weight / std)).sum())
    np.testing.assert_allclose(float(div[0]), want, rtol=1e-5)
