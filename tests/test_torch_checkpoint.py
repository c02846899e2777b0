"""The port's checkpoints and conditioning inputs against the JAX package,
on the CPU in float32.

* A reference-format ``.pth`` (the DataParallel ``module.`` prefix, a
  non-parameter buffer, an EMA shadow list of distinct values in the
  reference's ``parameters()`` order, and for res128 the dormant
  ``pos_layer`` in the model and the EMA list), built here from JAX's own
  ``torch_convert`` walk, is read by the JAX package's ``evaler._setup``
  (``load_torch_checkpoint``) and by the port's; the two EMA forwards agree
  at rtol 2e-4 / atol 2e-5, for the res64 and res128 tiny configs.
* The port's ``save_checkpoint`` -> ``restore_checkpoint`` round trip is
  exact, and JAX's loader reads what the port saved.
* ``load_partial_grids`` gives bit-equal grids from ``.pt`` and ``.npz``,
  with and without ``eval.tet_path``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshdiffusion_tpu.diffusion import evaler as JE
from meshdiffusion_tpu.utils import torch_convert as TC
from meshdiffusion_tpu_torch.diffusion import evaler as PE
from meshdiffusion_tpu_torch.models import create_model
from meshdiffusion_tpu_torch.utils import checkpoint as CK
from meshdiffusion_tpu_torch.utils.convert import from_jax_params

from test_torch_unet import R, jax_params, tiny_configs

pytest_plugins = ('torch_rules',)

RTOL, ATOL = 2e-4, 2e-5


def reference_order(jcfg, sd):
    """The reference model's parameters() order, from the JAX package's
    walk (torch_convert.convert_ema_state): pos_layer, mask_layer, then
    all_modules."""
    walk = list(TC.module_walk(jcfg))
    stems = [w for w in walk if w[1] in ('pos_layer', 'mask_layer')]
    rest = [w for w in walk if w[1] not in ('pos_layer', 'mask_layer')]
    keys = []
    for prefix, _, kind in stems + rest:
        entries = TC._resblock_params(sd, prefix) if kind == 'resblock' else TC._KIND_PARAMS[kind]
        keys += [f'{prefix}.{suffix}' for suffix, _, _ in entries]
    return keys


def reference_pth(path, name, seed=0):
    """A checkpoint as the reference's trainer writes it, from the tiny JAX
    init: {'model' ('module.'-prefixed, with the mask buffer and, in res128,
    the dormant pos_layer), 'ema', 'optimizer', 'step'}."""
    jcfg, pcfg = tiny_configs(name)
    _, params = jax_params(name)
    sd = dict(from_jax_params(params, pcfg))
    if name == 'ddpm_res128':
        sd['pos_layer.weight'] = torch.randn(32, 3, 5, 5, 5)
        sd['pos_layer.bias'] = torch.randn(32)
    order = reference_order(jcfg, sd)
    assert set(order) == set(sd)
    g = torch.Generator().manual_seed(seed)
    shadow = [sd[k] + 0.01 * torch.randn(sd[k].shape, generator=g) for k in order]
    model = {'module.' + k: sd[k] for k in order}
    model['module.mask'] = torch.ones(1, 1, R, R, R)
    torch.save({'model': model, 'ema': {'decay': 0.9999, 'num_updates': 7,
                                       'shadow_params': shadow},
                'optimizer': None, 'step': 1234}, path)
    return dict(zip(order, shadow))


def _configs(name, tmp_path, ckpt):
    jcfg, pcfg = tiny_configs(name)
    mask = (np.random.default_rng(2).random((R, R, R)) > 0.3).astype(np.float32)
    np.save(tmp_path / 'mask.npy', mask)
    for c in (jcfg, pcfg):
        c.eval.ckpt_path = str(ckpt)
        c.data.grid_mask_path = str(tmp_path / 'mask.npy')
    return jcfg, pcfg


def _forwards(name, tmp_path, ckpt):
    """The EMA forward of JAX's and the port's eval setup on one input."""
    jcfg, pcfg = _configs(name, tmp_path, ckpt)
    jfn, jparams = JE._setup(jcfg)[:2]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, R, R, R, 4)).astype(np.float32)
    labels = np.array([3.0, 500.0], np.float32)
    want = np.asarray(jax.jit(jfn)(jparams, jnp.asarray(x), jnp.asarray(labels)))
    pfn = PE._setup(pcfg, 'cpu')[0]
    with torch.no_grad():
        got = pfn(torch.from_numpy(x), torch.from_numpy(labels)).numpy()
    return got, want


@pytest.mark.parametrize('name', ['ddpm_res64', 'ddpm_res128'])
def test_reference_pth_gives_jax_ema_forward(name, tmp_path):
    ckpt = tmp_path / 'checkpoint.pth'
    shadow = reference_pth(ckpt, name)
    got, want = _forwards(name, tmp_path, ckpt)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the port's eval model holds the shadow values, bit for bit
    _, pcfg = tiny_configs(name)
    model = create_model(pcfg, device='cpu')
    assert CK.load_eval_weights(str(ckpt), model, pcfg) == 1234
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), shadow[k]), k
    assert ('pos_layer.weight' in dict(model.named_parameters())) == (name == 'ddpm_res64')


@pytest.mark.parametrize('name', ['ddpm_res64', 'ddpm_res128'])
def test_save_restore_round_trip(name, tmp_path):
    """save_checkpoint -> restore_checkpoint restores the model, the EMA
    (shadow, count, decay), Adam's state and the step exactly; JAX's
    loader reads the saved file to the same EMA forward."""
    _, pcfg = tiny_configs(name)
    model = create_model(pcfg, device='cpu', generator=torch.Generator().manual_seed(0))
    ema = CK.EMA(model, decay=0.999)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for v in ema.shadow.values():
            v.add_(0.05 * torch.randn(v.shape, generator=g))
    ema.num_updates = 3
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model(torch.randn(1, R, R, R, 4, generator=g), torch.tensor([5.0])).square().mean().backward()
    opt.step()
    path = CK.save_checkpoint(str(tmp_path / 'ck.pth'), {'model': model, 'ema': ema,
                                                         'optimizer': opt, 'step': 42}, pcfg)
    raw = torch.load(path, weights_only=True)
    assert all(k.startswith('module.') for k in raw['model'])
    assert ('module.pos_layer.weight' in raw['model']) and \
        len(raw['ema']['shadow_params']) == len(raw['model'])

    model2 = create_model(pcfg, device='cpu', generator=torch.Generator().manual_seed(9))
    ema2 = CK.EMA(model2)
    opt2 = torch.optim.Adam(model2.parameters(), lr=1e-3)
    state = CK.restore_checkpoint(path, {'model': model2, 'ema': ema2, 'optimizer': opt2,
                                         'step': 0}, pcfg)
    assert state['step'] == 42 and ema2.num_updates == 3 and ema2.decay == 0.999
    for (k, a), (_, b) in zip(model.state_dict().items(), model2.state_dict().items()):
        assert torch.equal(a, b), k
    for k in ema.shadow:
        assert torch.equal(ema.shadow[k], ema2.shadow[k]), k
    s1, s2 = opt.state_dict()['state'], opt2.state_dict()['state']
    assert s1.keys() == s2.keys() and all(
        torch.equal(s1[i][n], s2[i][n]) for i in s1 for n in ('exp_avg', 'exp_avg_sq', 'step'))

    got, want = _forwards(name, tmp_path, path)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.abs(want).max() > 0.1


def test_restore_missing_path_and_orbax_dir(tmp_path, caplog):
    """A missing path warns and returns the state as it was; an orbax
    directory of the JAX package raises a clear error."""
    _, pcfg = tiny_configs('ddpm_res64')
    model = create_model(pcfg, device='cpu')
    state = {'model': model, 'ema': None, 'optimizer': None, 'step': 5}
    assert CK.restore_checkpoint(str(tmp_path / 'none.pth'), state, pcfg) is state
    assert 'No checkpoint found' in caplog.text
    (tmp_path / 'orbax').mkdir()
    with pytest.raises(ValueError, match='orbax'):
        CK.load_eval_weights(str(tmp_path / 'orbax'), model, pcfg)


@pytest.mark.parametrize('fmt', ['pt', 'npz'])
@pytest.mark.parametrize('with_tet_path', [False, True])
def test_load_partial_grids_bit_equal(fmt, with_tet_path, tmp_path, tiny_tet_grid):
    """The single-view dict scattered onto the grid: the bundled 64 grid's
    vertex map, or ``eval.tet_path``'s (the tiny 8^3 grid)."""
    from meshdiffusion_tpu.config import get_config as jax_get_config
    from meshdiffusion_tpu_torch.config import get_config
    from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid
    if with_tet_path:
        res, verts = tiny_tet_grid.resolution, tiny_tet_grid.verts
        np.savez(tmp_path / 'tets.npz', vertices=verts, indices=tiny_tet_grid.indices)
    else:
        res, verts = 64, TetGrid.load(64).verts
    rng = np.random.default_rng(4)
    sdf = rng.uniform(-1, 1, len(verts)).astype(np.float32)
    vis = (rng.random(len(verts)) > 0.5).astype(np.float32)
    path = tmp_path / f'dmtet.{fmt}'
    if fmt == 'pt':
        torch.save({'sdf': torch.from_numpy(sdf), 'deform': torch.zeros(len(verts), 3),
                    'vis': torch.from_numpy(vis), 'vis_rast': torch.from_numpy(vis > 0)}, path)
    else:
        np.savez(path, sdf=sdf, vis=vis)
    grids = []
    for cfg in (jax_get_config('res64'), get_config('res64')):
        cfg.data.image_size = res
        cfg.eval.partial_dmtet_path = str(path)
        cfg.eval.tet_path = str(tmp_path / 'tets.npz') if with_tet_path else ''
        grids.append(cfg)
    want = [np.asarray(a) for a in JE.load_partial_grids(grids[0])]
    got = [t.numpy() for t in PE.load_partial_grids(grids[1])]
    for g, w in zip(got, want):
        assert g.shape == (1, res, res, res, 1) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert got[1].sum() == vis.sum()
