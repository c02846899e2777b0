"""The port's dataset conversion tools against the JAX package's, on the
CPU: ``tet_to_grid`` exact; ``convert_folder`` writing byte-identical
``.npy`` and ``.pt`` grids from ``.npz`` and ``.pt`` dicts, with the job
sharding and the skip-if-missing rule; ``save_grid_mask`` and
``save_meta`` byte-identical; the CLI with ``--device cpu``."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshdiffusion_tpu.data import convert as JC
from meshdiffusion_tpu.geometry.tet_grid import TetGrid as JaxTetGrid
from meshdiffusion_tpu_torch.data import convert as PC
from meshdiffusion_tpu_torch.data.dataset import ShapeNetDMTetDataset
from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid

pytest_plugins = ('torch_rules',)


def fitted_dict(tg, seed):
    rng = np.random.default_rng(seed)
    return {'sdf': rng.uniform(-1, 1, tg.num_verts).astype(np.float32),
            'deform': rng.uniform(-1.5, 1.5, (tg.num_verts, 3)).astype(np.float32)}


def test_tet_to_grid_matches_jax():
    tg, jtg = TetGrid.load(64), JaxTetGrid.load(64)
    d = fitted_dict(tg, 0)
    want = np.asarray(jtg.tet_to_grid(jnp.asarray(d['sdf']), jnp.asarray(d['deform'])))
    got = tg.tet_to_grid(torch.from_numpy(d['sdf']), torch.from_numpy(d['deform'])).numpy()
    assert got.shape == (64, 64, 64, 4) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # and back: the sign and the clipped deform at every vertex
    sdf, deform = tg.grid_to_tet(torch.from_numpy(got))
    np.testing.assert_array_equal(sdf.numpy(), np.where(d['sdf'] >= 0, 1.0, -1.0))
    np.testing.assert_array_equal(deform.numpy(), np.clip(d['deform'], -1, 1))


def _write_dicts(src, tg, which):
    """dmt_dict_{i} for i in ``which``: even i as the port's fit writes .pt,
    odd i as the JAX package's .npz."""
    for i in which:
        d = fitted_dict(tg, i)
        if i % 2 == 0:
            torch.save({k: torch.from_numpy(v) for k, v in d.items()},
                       src / f'dmt_dict_{i:05d}.pt')
        else:
            np.savez(src / f'dmt_dict_{i:05d}.npz', **d)


def _bytes(paths):
    return [open(p, 'rb').read() for p in paths]


@pytest.mark.parametrize('fmt', ['npy', 'pt'])
def test_convert_folder_byte_identical(tmp_path, fmt):
    """From .pt and .npz dicts, with a gap at 3: the unbounded scan stops
    there; a shard (index 1, split 3 -> 3, 4, 5) skips the missing 3."""
    tg = TetGrid.load(64)
    src = tmp_path / 'tets'
    src.mkdir()
    _write_dicts(src, tg, (0, 1, 2, 4, 5))
    for kw in ({}, {'index': 1, 'split_size': 3}):
        want = JC.convert_folder(str(src), str(tmp_path / 'jax'), 64, out_format=fmt, **kw)
        got = PC.convert_folder(str(src), str(tmp_path / 'port'), 64, out_format=fmt,
                                device='cpu', **kw)
        names = [os.path.basename(p) for p in got]
        assert names == [os.path.basename(p) for p in want]
        assert names == ([f'grid_0000{i}.{fmt}' for i in (0, 1, 2)] if not kw
                         else [f'grid_0000{i}.{fmt}' for i in (4, 5)])
        assert _bytes(got) == _bytes(want)
    g = (np.load(got[0]) if fmt == 'npy' else torch.load(got[0]).numpy())
    assert g.shape == (4, 64, 64, 64) and g.dtype == np.float32


def test_grid_mask_and_meta_byte_identical(tmp_path):
    a = PC.save_grid_mask(64, str(tmp_path / 'port_mask.npy'))
    b = JC.save_grid_mask(64, str(tmp_path / 'jax_mask.npy'))
    assert _bytes([a]) == _bytes([b])
    np.testing.assert_array_equal(np.load(a), TetGrid.load(64).grid_mask())
    data = tmp_path / 'grids'
    data.mkdir()
    for name in ('grid_00002.npy', 'grid_00000.npy', 'grid_00001.pt', 'notes.txt'):
        (data / name).write_bytes(b'')
    a = PC.save_meta(str(data), str(tmp_path / 'port.json'))
    b = JC.save_meta(str(data), str(tmp_path / 'jax.json'))
    assert _bytes([a]) == _bytes([b])
    assert [os.path.basename(p) for p in json.load(open(a))] == \
        ['grid_00000.npy', 'grid_00001.pt', 'grid_00002.npy']


def test_cli_cpu_chain_feeds_the_dataset(tmp_path):
    """tets-to-3dgrid --device cpu -> save-meta -> get-tet-mask, then the
    port's training dataset reads the grid back."""
    tg = TetGrid.load(64)
    src = tmp_path / 'tets'
    src.mkdir()
    _write_dicts(src, tg, (0,))
    written = PC.main(['tets-to-3dgrid', '-res', '64', '-s', str(src), '-t',
                       str(tmp_path / 'grids'), '--device', 'cpu'])
    assert [os.path.basename(p) for p in written] == ['grid_00000.npy']
    meta = PC.main(['save-meta', '--data-dir', str(tmp_path / 'grids'), '--out',
                    str(tmp_path / 'meta.json')])
    mask = PC.main(['get-tet-mask', '--resolution', '64', '--out', str(tmp_path / 'mask.npy')])
    assert json.load(open(meta)) == written
    ds = ShapeNetDMTetDataset(meta, np.load(mask), aug=False)
    assert len(ds) == 1
    x = np.asarray(ds[0])
    want = np.moveaxis(np.load(written[0]), 0, -1)
    assert x.shape == want.shape == (64, 64, 64, 4)
    np.testing.assert_array_equal(x[..., 0], np.where(want[..., 0] >= 0, 1.0, -1.0))
    np.testing.assert_array_equal(x[..., 1:], want[..., 1:])
