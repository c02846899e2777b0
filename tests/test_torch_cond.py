"""The conditional-generation chain of the port against the JAX package's,
on the CPU in float32: ``extract_visibility`` (the dict's ``vis`` and
``vis_rast``, exact, on the fixture of ``tests/test_torch_singleview.py``),
and, as ``tests/test_cond_chain.py`` drives JAX's: a
single-view dict ``{sdf, deform, vis, vis_rast}`` in the reference format
-> ``load_partial_grids`` -> the conditional sampler over a tiny U-Net
restored from a reference-format ``.pth`` (EMA weights) -> the saved
channel-first ``.npy``. Both sides run ``evaler.cond_gen`` on the tiny
8^3 tet grid (JAX's through its ``TetGrid.load``, the port's through
``gpu.tet_root``) with JAX's noise replayed. Tolerance fp32 rtol 2e-4 /
atol 2e-5; inside ``vis`` the SDF channel keeps the partial's sign at more
than 0.6 of the vertices, as the JAX test asks."""

import jax.numpy as jnp
import numpy as np
import torch

from meshdiffusion_tpu.config import get_config as jax_get_config
from meshdiffusion_tpu.diffusion import evaler as JE
from meshdiffusion_tpu.fitting import singleview as JSV
from meshdiffusion_tpu_torch.config import get_config
from meshdiffusion_tpu_torch.diffusion import evaler as PE
from meshdiffusion_tpu_torch.fitting import singleview as SV
from meshdiffusion_tpu_torch.utils.convert import fit_state_from_jax

from test_torch_checkpoint import reference_pth
from test_torch_samplers import jax_draws, replay
from test_torch_singleview import ANGLE, ITERS, sv  # noqa: F401  (sv: the fixture)

pytest_plugins = ('torch_rules',)


def test_extract_visibility_matches_jax(sv):
    """vis and vis_rast of the frozen sphere state seen from the fixed
    view (one-layer render with the visible-tet test), exact."""
    jst = sv['jstate']
    sdf = np.where(sv['sphere'] > 0, 1.0, -1.0).astype(np.float32)
    jst = jst.replace(sdf=jnp.asarray(sdf))
    jfit2 = JSV.SingleViewFitter(grid=sv['jtg'], scale=1.0, deform_scale=3.0, total_iter=ITERS)
    pfit2 = SV.SingleViewFitter(grid=sv['tg'], scale=1.0, deform_scale=3.0, total_iter=ITERS)
    want = JSV.extract_visibility(jfit2, jst, sv['jren'], ANGLE, raster_K=1024)
    with torch.no_grad():
        got = SV.extract_visibility(pfit2, fit_state_from_jax(jst), sv['pren'], ANGLE,
                                    raster_K=1024)
    assert set(got) == set(want) == {'sdf', 'deform', 'vis', 'vis_rast'}
    for k in ('vis', 'vis_rast', 'sdf', 'deform'):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert got['vis'].dtype == torch.float32 and got['vis_rast'].dtype == torch.bool
    V = sv['tg'].num_verts
    assert 0 < got['vis'].sum() < V
    assert bool((got['vis_rast'] >= (got['vis'] > 0)).all())
    assert got['vis_rast'].sum() > got['vis'].sum()


def test_cond_gen_chain_matches_jax(tmp_path, tiny_tet_grid, monkeypatch):
    tg = tiny_tet_grid
    R = tg.resolution
    import meshdiffusion_tpu.diffusion.trainer as JT
    for mod in (JE, JT):
        monkeypatch.setattr(mod.TetGrid, 'load', staticmethod(lambda res, root=None: tg))
    np.savez(tmp_path / f'{R}_tets_cropped.npz', vertices=tg.verts, indices=tg.indices)

    sdf = np.sign(0.3 - np.linalg.norm(tg.verts, axis=1)).astype(np.float32)
    sdf[sdf == 0] = 1.0
    vis = (tg.verts[:, 2] > 0).astype(np.float32)            # the front half seen
    torch.save({'sdf': torch.from_numpy(sdf), 'deform': torch.zeros(tg.num_verts, 3),
                'vis': torch.from_numpy(vis), 'vis_rast': torch.from_numpy(vis > 0)},
               tmp_path / 'dmtet.pt')
    # the tiny res64 weights (attention at the second level, as at R 16)
    reference_pth(tmp_path / 'ckpt.pth', 'ddpm_res64')

    cfgs = (jax_get_config('res64'), get_config('res64'))
    for cfg in cfgs:
        cfg.data.image_size = R
        cfg.model.nf = 32
        cfg.model.ch_mult = (1, 2)
        cfg.model.num_res_blocks = 1
        cfg.model.attn_resolutions = (R // 2,)
        cfg.model.num_scales = 8
        cfg.model.beta_max = 2.0
        cfg.model.dropout = 0.0
        cfg.eval.batch_size = 1
        cfg.eval.ckpt_path = str(tmp_path / 'ckpt.pth')
        cfg.eval.partial_dmtet_path = str(tmp_path / 'dmtet.pt')
        cfg.eval.tet_path = ''
        cfg.eval.freeze_iters = 7
    jcfg, pcfg = cfgs
    jcfg.tpu.compute_dtype = 'float32'
    jcfg.eval.eval_dir = str(tmp_path / 'jax')
    pcfg.gpu.compute_dtype = 'float32'
    pcfg.gpu.tet_root = str(tmp_path)
    pcfg.eval.eval_dir = str(tmp_path / 'port')

    want = np.load(JE.cond_gen(jcfg, save_fname='cc'))
    shape = (1, R, R, R, 4)
    monkeypatch.setattr(PE, '_noise', lambda config, seed, device: replay(
        jax_draws(config.seed, shape, config.model.num_scales, kind='cond')))
    got = np.load(PE.cond_gen(pcfg, save_fname='cc', device='cpu'))
    assert got.shape == want.shape == (1, 4, R, R, R)
    assert np.isfinite(got).all() and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    c = tg.vert_grid_coords
    seen = vis > 0
    agree = (np.sign(got[0, 0, c[seen, 0], c[seen, 1], c[seen, 2]]) == sdf[seen]).mean()
    assert agree > 0.6, agree
