"""The port's training pipeline against the JAX package, on the CPU.

* The grid dataset, its Python loader and the native C++ loader against
  the JAX package's: bit-equal with augmentation off, the augmentation's
  semantics, the train-split filter, legacy ``.pt`` grids.
* ``train(max_steps=6, device='cpu')`` at the tiny shape of
  tests/test_trainer.py runs steps 0..6, then resumes from the preemption
  snapshot of step 4 to 8; ``metrics.jsonl`` is finite; the last snapshot
  is read by the port's ``load_eval_weights`` and by the JAX package's
  ``load_torch_checkpoint`` (through its ``evaler._setup``), which give the
  same EMA weights.
* Two faults of the port against the JAX package, repaired: a ``.pth``
  checkpoint path that does not exist raises in both (it sampled from
  random weights), and ``fit_dmtets`` skips a mesh whose ``tets/`` dict
  exists as the ``.npz`` the JAX package writes.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from meshdiffusion_tpu.config import get_config as jax_get_config
from meshdiffusion_tpu.data.dataset import ShapeNetDMTetDataset as JaxDataset
from meshdiffusion_tpu.diffusion import evaler as JE
from meshdiffusion_tpu.main import main as jax_main
from meshdiffusion_tpu.native import NativeGridLoader as JaxNativeLoader
from meshdiffusion_tpu_torch.config import get_config
from meshdiffusion_tpu_torch.data.dataset import GridLoader, ShapeNetDMTetDataset
from meshdiffusion_tpu_torch.diffusion import evaler as PE
from meshdiffusion_tpu_torch.diffusion.trainer import train
from meshdiffusion_tpu_torch.main import main as port_main
from meshdiffusion_tpu_torch.models import create_model
from meshdiffusion_tpu_torch.native import NativeGridLoader, native_available
from meshdiffusion_tpu_torch.utils.checkpoint import load_eval_weights
from meshdiffusion_tpu_torch.utils.convert import from_jax_params

pytest_plugins = ('torch_rules',)

R = 8


def make_mask(r=R):
    m = np.ones((r, r, r), np.float32)
    m[-1] = 0.0
    m[:, 0, :3] = 0.0
    return m


@pytest.fixture()
def grid_files(tmp_path):
    """Six (4, 7, 7, 7) grids (padded to 8 by the loaders) and their meta list."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        g = rng.normal(size=(4, 7, 7, 7)).astype(np.float32)
        g[1:, :2] = 0.0                        # empty cells: no deform jitter there
        p = tmp_path / f'grid_{i:05d}.npy'
        np.save(p, g)
        paths.append(str(p))
    meta = tmp_path / 'meta.json'
    meta.write_text(json.dumps(paths))
    return paths, str(meta)


def test_dataset_and_loaders_match_jax_without_aug(grid_files):
    paths, meta = grid_files
    jd = JaxDataset(meta, make_mask(), aug=False)
    pd = ShapeNetDMTetDataset(meta, make_mask(), aug=False)
    assert len(pd) == len(jd) == 6
    for i in range(6):
        np.testing.assert_array_equal(pd[i], jd[i])
        assert pd[i].shape == (R, R, R, 4)
    assert native_available()
    idx = np.asarray([0, 3, 5, 3])
    pn = NativeGridLoader(paths, make_mask(), batch_size=4, aug=False)
    jn = JaxNativeLoader(paths, make_mask(), batch_size=4, aug=False)
    try:
        got = pn.load_indices(idx)
        np.testing.assert_array_equal(got, jn.load_indices(idx))
        for slot, i in enumerate(idx):
            np.testing.assert_array_equal(got[slot], pd[i])
        with pytest.raises(ValueError, match='outside'):
            pn.load_indices(np.asarray([6]))
    finally:
        pn.close()
        jn.close()
    loader = GridLoader(pd, batch_size=4, num_workers=2, seed=0)
    try:
        b1, b2 = next(loader), next(loader)
    finally:
        loader.close()
    assert b1.shape == b2.shape == (4, R, R, R, 4)
    rows = {pd[i].tobytes() for i in range(6)}
    assert all(s.tobytes() in rows for s in np.concatenate([b1, b2]))


def _check_aug(sample, raw, mask):
    """sdf is the sign times the mask, every nonempty cell's deform moved by
    one offset a channel within +-0.005 * R/r, empty cells and the padding
    untouched, everything masked."""
    r = raw.shape[-1]
    m = mask[:r, :r, :r]
    np.testing.assert_array_equal(sample[:r, :r, :r, 0], np.where(raw[0] < 0, -1.0, 1.0) * m)
    nonempty = (np.abs(raw[1:]).sum(0) != 0) & (m > 0)
    d = sample[:r, :r, :r, 1:] - np.moveaxis(raw[1:], 0, -1) * m[..., None]
    assert np.abs(d[~nonempty]).max() < 1e-7
    offs = d[nonempty]                                      # (n, 3)
    assert np.abs(offs).max() <= 0.005 * R / r * 1.01
    np.testing.assert_allclose(offs, np.broadcast_to(offs[0], offs.shape), atol=1e-6)
    assert np.abs(offs[0]).min() > 0
    assert not sample[r:].any() and not sample[:, r:].any() and not sample[:, :, r:].any()


def test_aug_semantics(grid_files):
    paths, meta = grid_files
    pd = ShapeNetDMTetDataset(meta, make_mask(), aug=True, seed=1)
    a, b = pd[1], pd[1]
    assert not np.array_equal(a, b)              # a new jitter a draw
    for s in (a, b):
        _check_aug(s, np.load(paths[1]), make_mask())
    pn = NativeGridLoader(paths, make_mask(), batch_size=2, aug=True, seed=1)
    try:
        batch = pn.load_indices(np.asarray([1, 1]))
    finally:
        pn.close()
    assert not np.array_equal(batch[0], batch[1])
    for s in batch:
        _check_aug(s, np.load(paths[1]), make_mask())


def test_filter_and_pt_grids(grid_files, tmp_path):
    paths, meta = grid_files
    flt = tmp_path / 'train_ids.json'
    flt.write_text(json.dumps([1, 4]))
    pd = ShapeNetDMTetDataset(meta, make_mask(), filter_meta_path=str(flt))
    jd = JaxDataset(meta, make_mask(), filter_meta_path=str(flt))
    assert pd.fpath_list == jd.fpath_list == [paths[1], paths[4]]
    pts = []
    for i, p in enumerate(paths[:2]):
        pts.append(str(tmp_path / f'pt_{i:05d}.pt'))
        torch.save(torch.from_numpy(np.load(p)).double(), pts[-1])
    (tmp_path / 'meta_pt.json').write_text(json.dumps(pts))
    pt = ShapeNetDMTetDataset(str(tmp_path / 'meta_pt.json'), make_mask(), extension='pt')
    npy = ShapeNetDMTetDataset(meta, make_mask())
    for i in range(2):
        np.testing.assert_array_equal(pt[i], npy[i])


def test_grid_mask_from_npy_and_pt(tmp_path):
    """``data.grid_mask_path`` as .npy or as a torch .pt (the reference's
    grid_mask_{R}.pt) gives JAX's mask."""
    from meshdiffusion_tpu.diffusion.trainer import load_grid_mask as jax_load_grid_mask
    mask = make_mask()
    np.save(tmp_path / 'mask.npy', mask)
    torch.save(torch.from_numpy(mask)[None], tmp_path / 'mask.pt')
    for name in ('mask.npy', 'mask.pt'):
        jcfg, pcfg = jax_get_config('res64'), get_config('res64')
        for cfg in (jcfg, pcfg):
            cfg.data.image_size = R
            cfg.data.grid_mask_path = str(tmp_path / name)
        got = PE.load_grid_mask(pcfg)
        assert got.dtype == np.float32 and got.shape == (R, R, R)
        np.testing.assert_array_equal(got, jax_load_grid_mask(jcfg))
        np.testing.assert_array_equal(got, mask)


def tiny_train_configs(tmp_path):
    """Eight random 8^3 grids, an all-ones mask, and the tiny configuration
    of tests/test_trainer.py for both packages (the port's trains, JAX's
    reads the snapshot)."""
    rng = np.random.default_rng(0)
    paths = []
    for i in range(8):
        g = rng.normal(size=(4, R, R, R)).astype(np.float32)
        g[0] = np.sign(g[0])
        paths.append(str(tmp_path / f'grid_{i:05d}.npy'))
        np.save(paths[-1], g)
    (tmp_path / 'meta.json').write_text(json.dumps(paths))
    np.save(tmp_path / 'mask.npy', np.ones((R, R, R), np.float32))
    out = []
    for cfg in (jax_get_config('res64'), get_config('res64')):
        cfg.data.image_size = R
        cfg.data.meta_path = str(tmp_path / 'meta.json')
        cfg.data.filter_meta_path = ''
        cfg.data.grid_mask_path = str(tmp_path / 'mask.npy')
        cfg.data.num_workers = 2
        cfg.model.nf = 32
        cfg.model.ch_mult = (1, 2)
        cfg.model.num_res_blocks = 1
        cfg.model.attn_resolutions = (4,)
        cfg.model.num_scales = 10
        cfg.model.beta_max = 2.0
        cfg.training.batch_size = 2
        cfg.training.iter_size = 2
        cfg.training.log_freq = 2
        cfg.training.snapshot_freq = 100
        cfg.training.snapshot_freq_for_preemption = 4
        cfg.training.train_dir = str(tmp_path / 'run')
        cfg.optim.lr = 1e-3
        cfg.optim.warmup = 0
        out.append(cfg)
    out[0].tpu.compute_dtype = 'float32'
    out[1].gpu.compute_dtype = 'float32'
    return out


def test_train_resume_and_snapshot_read_by_both(tmp_path):
    jcfg, pcfg = tiny_train_configs(tmp_path)
    run = pcfg.training.train_dir
    state = train(pcfg, max_steps=6, device='cpu')
    assert state.step == 7 and state.ema.num_updates == 7        # steps 0..6
    meta = os.path.join(run, 'checkpoints-meta', 'checkpoint.pth')
    assert torch.load(meta, weights_only=True)['step'] == 5       # written at step 4
    state2 = train(pcfg, max_steps=8, device='cpu')               # resumes at step 5
    assert state2.step == 9 and state2.ema.num_updates == 9
    assert sorted(os.listdir(os.path.join(run, 'checkpoints'))) == \
        ['checkpoint_7.pth', 'checkpoint_9.pth']
    lines = [json.loads(line) for line in open(os.path.join(run, 'metrics.jsonl'))]
    assert [line['step'] for line in lines] == [0, 2, 4, 6, 6, 8]
    assert all(line['tag'] == 'training_loss' and np.isfinite(line['value']) for line in lines)

    last = os.path.join(run, 'checkpoints', 'checkpoint_9.pth')
    model = create_model(pcfg, device='cpu')
    assert load_eval_weights(last, model, pcfg) == 9
    for k, p in model.named_parameters():
        assert torch.equal(p, state2.ema.shadow[k]), k
    jcfg.eval.ckpt_path = last
    jparams, _, _, _, jstate = JE._setup(jcfg)[1:]
    assert int(jstate.step) == 9 and int(jstate.ema_num_updates) == 9
    want = from_jax_params(jax.tree.map(np.asarray, jparams), pcfg)
    for k, p in model.named_parameters():
        assert torch.equal(p, want[k]), k


def test_missing_pth_raises_in_both(tmp_path):
    jcfg, pcfg = tiny_train_configs(tmp_path)
    missing = str(tmp_path / 'no_such_checkpoint.pth')
    for cfg in (jcfg, pcfg):
        cfg.eval.ckpt_path = missing
    with pytest.raises(FileNotFoundError):
        JE._setup(jcfg)
    with pytest.raises(FileNotFoundError):
        PE._setup(pcfg, device='cpu')


def test_fit_dmtets_skips_an_npz_dict_in_both(tmp_path, monkeypatch):
    """A mesh whose ``tets/dmt_dict_00000.npz`` exists is not fitted again
    by either package; without it, both fit it."""
    import meshdiffusion_tpu.fitting.fit as jax_fit
    import meshdiffusion_tpu_torch.fitting.fit as port_fit
    calls = []
    for mod in (jax_fit, port_fit):
        monkeypatch.setattr(mod, 'fit_one_mesh', lambda *a, _m=mod.__name__, **k: calls.append(_m))
    out = tmp_path / 'fit'
    (out / 'tets').mkdir(parents=True)
    done = out / 'tets' / 'dmt_dict_00000.npz'
    np.savez(done, sdf=np.zeros(3, np.float32))
    args = ['--mode', 'fit_dmtets', '--meta_path', str(tmp_path / 'mesh.obj'), '--out_dir', str(out)]
    port_main(args + ['--device', 'cpu'])
    jax_main(args)
    assert calls == []
    os.remove(done)
    port_main(args + ['--device', 'cpu'])
    jax_main(args)
    assert calls == [port_fit.__name__, jax_fit.__name__]
