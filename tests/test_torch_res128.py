"""The res128 preset end to end against the JAX package, on the CPU at a
tiny width: the preset's architecture (ch_mult (1, 1, 2, 4, 4, 4), two
ResnetBlocks a level, the 5^3 stem, no coordinate layer) at nf 32 on a
generated 32 tet grid (six levels need R >= 32), float32. The port runs
``evaler.uncond_gen`` for 2 steps from a reference-format checkpoint (its
EMA weights); the JAX package runs its sampler, ``get_sampling_fn`` as its
``uncond_gen`` calls it, on the same weights through
``convert_model_state`` (its ``evaler._setup`` would spend ~35 s in an
unjitted flax init first) and its own grid mask, its key splits replayed
into the port's noise source; each package generates its own 32 grid (a
``tmp_path`` HOME holds both caches). Then both extract that sample on
their grid: faces exactly equal, vertices at fp32 tolerance.

Tolerance of the sample: rtol 1e-3 / atol 1e-4, as
``tests/test_torch_sampler.py`` holds the same sampler: the port's update
takes 1/sqrt(1 - beta) in fp32 where JAX multiplies by a float64-built
table, and this U-Net is three levels deeper than that test's; one forward
alone already differs by up to 4.5e-5 on outputs up to 11 (fp32 sums in
another order), past fp32's atol 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from meshdiffusion_tpu.config import get_config as jax_get_config
from meshdiffusion_tpu.diffusion import sampling as JS
from meshdiffusion_tpu.diffusion.vpsde import VPSDE as JaxVPSDE
from meshdiffusion_tpu.extract import extract_grid as jax_extract_grid
from meshdiffusion_tpu.geometry.tet_grid import TetGrid as JaxTetGrid
from meshdiffusion_tpu.models import create_model as jax_create_model
from meshdiffusion_tpu.utils.torch_convert import convert_model_state
from meshdiffusion_tpu_torch.config import get_config
from meshdiffusion_tpu_torch.diffusion import evaler as PE
from meshdiffusion_tpu_torch.extract import extract_grid
from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid
from meshdiffusion_tpu_torch.models import create_model
from meshdiffusion_tpu_torch.utils.checkpoint import EMA, save_checkpoint

from test_torch_sampler import replayed_jax_noise

pytest_plugins = ('torch_rules',)

R, NF, STEPS = 32, 32, 2


def tiny_res128(cfg, ckpt):
    cfg.data.image_size = R
    cfg.model.nf = NF
    cfg.model.num_scales = STEPS + 1
    cfg.model.beta_max = 2.0
    cfg.model.dropout = 0.0
    cfg.eval.batch_size = 1
    cfg.eval.ckpt_path = str(ckpt)
    return cfg


def test_res128_uncond_gen_and_extract_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv('HOME', str(tmp_path))
    monkeypatch.delenv('XDG_CACHE_HOME', raising=False)
    ckpt = tmp_path / 'ckpt.pth'
    jcfg = tiny_res128(jax_get_config('res128'), ckpt)
    pcfg = tiny_res128(get_config('res128'), ckpt)
    assert tuple(pcfg.model.ch_mult) == (1, 1, 2, 4, 4, 4) and pcfg.model.num_res_blocks == 2
    jcfg.tpu.compute_dtype = pcfg.gpu.compute_dtype = 'float32'
    pcfg.eval.eval_dir = str(tmp_path / 'port')

    # seeded weights, every tensor perturbed so the zero-initialised convs carry signal
    g = torch.Generator().manual_seed(0)
    model = create_model(pcfg, device='cpu', generator=g)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    save_checkpoint(str(ckpt), {'model': model, 'ema': EMA(model), 'optimizer': None,
                                'step': 0}, pcfg)

    TetGrid.load.cache_clear()
    JaxTetGrid.load.cache_clear()
    try:
        jmodel = jax_create_model(jcfg)
        params = convert_model_state({k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
        jmask = jnp.asarray(JaxTetGrid.load(R).grid_mask())[None, ..., None]
        jsde = JaxVPSDE(beta_max=2.0, N=STEPS + 1)
        sampler = JS.get_sampling_fn(jcfg, jsde, (1, R, R, R, 4), eps=1e-3, grid_mask=jmask)
        want, _ = sampler(lambda p, x, lab: jmodel.apply(p, x, lab, jmask, train=False),
                          jax.random.key(jcfg.seed), params=params)
        want = np.array(np.moveaxis(np.asarray(want), -1, 1))
        noise = replayed_jax_noise(pcfg.seed, (1, R, R, R, 4), STEPS)
        monkeypatch.setattr(PE, '_noise', lambda config, seed, device:
                            lambda name, shape, i=-1, j=0: torch.from_numpy(noise[i].copy()))
        got = np.load(PE.uncond_gen(pcfg, idx='u', device='cpu'))
        assert got.shape == want.shape == (1, 4, R, R, R)
        mask = TetGrid.load(R).grid_mask()
        assert mask.sum() == (R - 1) ** 3
        np.testing.assert_array_equal(got[0] * (1 - mask), 0.0)
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)

        jv, jf = jax_extract_grid(want[0], JaxTetGrid.load(R), str(tmp_path / 'jax.obj'),
                                  remesh=False)
        v, f = extract_grid(want[0], TetGrid.load(R), str(tmp_path / 'port.obj'),
                            remesh=False, device='cpu')
        assert len(f) > 1000
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
    finally:
        TetGrid.load.cache_clear()
        JaxTetGrid.load.cache_clear()
