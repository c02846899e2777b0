"""Numerical parity against the reference PyTorch model.

Builds the REFERENCE torch model (imported read-only from /root/reference,
CPU) with a tiny config, converts its state_dict through
``utils.torch_convert``, and checks the flax forward matches the torch
forward to fp32 tolerance. Also round-trips a full saved checkpoint
({model, ema, step}) through ``load_torch_checkpoint``.

Skipped automatically when the reference mount is absent.
"""

import os
import sys

import numpy as np
import pytest

pytest_plugins = ('torch_rules',)

REFERENCE = '/root/reference'
pytestmark = pytest.mark.skipif(not os.path.isdir(REFERENCE),
                                reason='reference repo not mounted')

R = 16  # tiny grid so torch-CPU forward is fast


def _tiny_config(name):
    from meshdiffusion_tpu.config import get_config
    cfg = get_config('res64' if name == 'ddpm_res64' else 'res128')
    cfg.model.name = name
    cfg.model.nf = 32
    cfg.model.ch_mult = (1, 2)
    cfg.model.num_res_blocks = 1
    cfg.model.num_res_blocks_first = 2   # res128 hardcodes 2 at level 0
    cfg.model.attn_resolutions = (8,)
    cfg.model.dropout = 0.0
    cfg.data.image_size = R
    cfg.tpu.compute_dtype = 'float32'
    return cfg


def _build_torch(name, cfg, seed=0):
    import torch
    torch.manual_seed(seed)
    sys.path.insert(0, REFERENCE)
    try:
        import importlib
        mod = importlib.import_module(f'lib.diffusion.models.{name.replace("ddpm_", "ddpm_")}')
        cls = getattr(mod, 'DDPMRes64' if name == 'ddpm_res64' else 'DDPMRes128')
        model = cls(cfg)
        model.eval()
        return model
    finally:
        sys.path.remove(REFERENCE)


def _forward_pair(name):
    import jax
    import jax.numpy as jnp
    import torch

    cfg = _tiny_config(name)
    tmodel = _build_torch(name, cfg)

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, R, R, R)).astype(np.float32)
    labels = np.array([3.0, 500.0], np.float32)
    mask = (rng.random((1, 1, R, R, R)) > 0.3).astype(np.float32)

    with torch.no_grad():
        tmodel.mask.data[:] = torch.from_numpy(mask)
        t_out = tmodel(torch.from_numpy(x), torch.from_numpy(labels)).numpy()

    from meshdiffusion_tpu.models import create_model
    from meshdiffusion_tpu.utils.torch_convert import convert_model_state
    jmodel = create_model(cfg)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    params = convert_model_state(sd, cfg)

    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    maskj = jnp.asarray(np.moveaxis(mask, 1, -1))
    j_out = jmodel.apply(params, xj, jnp.asarray(labels), maskj, train=False)
    j_out = np.moveaxis(np.asarray(j_out), -1, 1)
    return t_out, j_out


def test_res64_forward_parity():
    t_out, j_out = _forward_pair('ddpm_res64')
    assert t_out.shape == j_out.shape
    np.testing.assert_allclose(j_out, t_out, rtol=2e-4, atol=2e-5)


def test_res128_forward_parity():
    t_out, j_out = _forward_pair('ddpm_res128')
    assert t_out.shape == j_out.shape
    np.testing.assert_allclose(j_out, t_out, rtol=2e-4, atol=2e-5)


def test_full_checkpoint_roundtrip(tmp_path):
    """Save a reference-format checkpoint (model+EMA+step, DataParallel
    prefix) and load through load_torch_checkpoint."""
    import jax
    import jax.numpy as jnp
    import torch

    cfg = _tiny_config('ddpm_res64')
    tmodel = _build_torch('ddpm_res64', cfg)

    sys.path.insert(0, REFERENCE)
    try:
        from lib.diffusion.models.ema import ExponentialMovingAverage
    finally:
        sys.path.remove(REFERENCE)
    ema = ExponentialMovingAverage(tmodel.parameters(), decay=0.999)
    # a couple of param perturbations + EMA updates so shadow != params
    with torch.no_grad():
        for p in tmodel.parameters():
            if p.requires_grad:
                p.add_(torch.randn_like(p) * 0.01)
    ema.update(tmodel.parameters())

    ckpt = {
        'model': {f'module.{k}': v for k, v in tmodel.state_dict().items()},
        'ema': ema.state_dict(),
        'optimizer': None,
        'step': 1234,
    }
    path = tmp_path / 'checkpoint_1234.pth'
    torch.save(ckpt, path)

    from meshdiffusion_tpu.models import create_model
    from meshdiffusion_tpu.diffusion import losses as L
    from meshdiffusion_tpu.utils.torch_convert import load_torch_checkpoint

    jmodel = create_model(cfg)
    x0 = jnp.zeros((1, R, R, R, 4))
    mask = jnp.ones((1, R, R, R, 1))
    params = jmodel.init({'params': jax.random.key(0)}, x0, jnp.zeros((1,)), mask)
    tx = L.get_optimizer(cfg)
    state = L.TrainState.create(params, tx, jax.random.key(0))

    state = load_torch_checkpoint(str(path), cfg, state)
    assert int(state.step) == 1234
    assert int(state.ema_num_updates) == 1

    # EMA params differ from live params and match torch's shadow of temb_0
    shadow0 = ema.shadow_params[4].numpy()  # pos_w, pos_b, mask_w, mask_b, am0.w
    got = np.asarray(state.ema_params['params']['temb_0']['kernel']).T
    np.testing.assert_allclose(got, shadow0, rtol=1e-6)

    live = np.asarray(state.params['params']['temb_0']['kernel']).T
    assert np.abs(live - shadow0).max() > 1e-5


def test_res128_dormant_pos_layer_skipped():
    """res128 torch checkpoints contain pos_layer params that our model
    doesn't have; conversion must drop them and keep EMA order aligned."""
    import torch

    cfg = _tiny_config('ddpm_res128')
    tmodel = _build_torch('ddpm_res128', cfg)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    assert 'pos_layer.weight' in sd

    from meshdiffusion_tpu.utils.torch_convert import (convert_model_state,
                                                       convert_ema_state)
    params = convert_model_state(sd, cfg)
    assert 'pos_layer' not in params['params']

    shadow = [p.detach().numpy() for p in tmodel.parameters() if p.requires_grad]
    ema_params = convert_ema_state(shadow, sd, cfg)
    assert 'pos_layer' not in ema_params['params']
    np.testing.assert_allclose(
        np.asarray(ema_params['params']['mask_layer']['conv']['bias']),
        sd['mask_layer.bias'], rtol=1e-6)
