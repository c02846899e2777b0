"""The port's tet-grid generation and structure against the JAX package's,
on the CPU: ``generate_tet_grid`` and ``crop_tets`` bit-equal, the
``TetGrid`` arrays of ``from_arrays`` equal (the 1-D edge key against
JAX's ``np.unique(axis=0)``, the parity swap included), ``TetGrid.load``
generating, caching and rereading a grid, and the port's own 64 asset
equal to the JAX package's. R stays at 32 or below; the 128 grid is built
on the card's host (``chip_smoke.py``)."""

import os

import numpy as np
import pytest

from meshdiffusion_tpu.geometry import generate_tets as JG
from meshdiffusion_tpu.geometry.tet_grid import TetGrid as JaxTetGrid
from meshdiffusion_tpu_torch.geometry import generate_tets as PG
from meshdiffusion_tpu_torch.geometry import tet_grid as PT
from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid

pytest_plugins = ('torch_rules',)

FIELDS = ('verts', 'indices', 'unique_edges', 'tet_edge_to_unique', 'vert_grid_coords')


def assert_grids_equal(got, want):
    assert got.resolution == want.resolution
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize('R', [8, 16, 32])
def test_generate_and_crop_bit_equal(R):
    (v, t), (jv, jt) = PG.generate_tet_grid(R), JG.generate_tet_grid(R)
    assert v.dtype == jv.dtype and t.dtype == jt.dtype
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(t, jt)
    assert (len(v), len(t)) == ((R - 1) ** 3, 6 * (R - 2) ** 3)
    for a, b in zip(PG.crop_tets(v, t), JG.crop_tets(jv, jt)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_from_arrays_matches_jax_generated_32():
    v, t = PG.generate_tet_grid(32)
    got, want = TetGrid.from_arrays(32, v, t), JaxTetGrid.from_arrays(32, v, t)
    assert_grids_equal(got, want)
    assert got.num_edges == want.num_edges
    # Kuhn cubes are half positively, half negatively oriented: the swap ran
    assert not np.array_equal(got.indices, t)


def test_from_arrays_matches_jax_tiny_fixture(tiny_tet_grid):
    jtg = tiny_tet_grid
    # its tets are already positively oriented; a copy with every other tet
    # flipped makes both packages swap them back
    flipped = jtg.indices.copy()
    flipped[::2, 2], flipped[::2, 3] = jtg.indices[::2, 3], jtg.indices[::2, 2]
    for idx in (jtg.indices, flipped):
        assert_grids_equal(TetGrid.from_arrays(jtg.resolution, jtg.verts, idx),
                           JaxTetGrid.from_arrays(jtg.resolution, jtg.verts, idx))


def test_load_generates_caches_and_rereads(tmp_path, monkeypatch):
    monkeypatch.setenv('HOME', str(tmp_path))
    monkeypatch.delenv('XDG_CACHE_HOME', raising=False)
    R = 24
    cache = PT.cache_path(R)
    assert cache == str(tmp_path / '.cache' / 'meshdiffusion_tpu_torch' / f'tetgrid_gen_{R}.npz')
    TetGrid.load.cache_clear()
    try:
        generated = TetGrid.load(R, str(tmp_path / 'no_assets'))
        assert os.path.exists(cache)
        TetGrid.load.cache_clear()
        reread = TetGrid.load(R, str(tmp_path / 'no_assets'))
        assert reread is not generated
        assert_grids_equal(reread, generated)
        assert_grids_equal(generated, JaxTetGrid.from_arrays(R, *JG.generate_tet_grid(R)))
        assert reread.grid_mask().sum() == (R - 1) ** 3
    finally:
        TetGrid.load.cache_clear()


def test_cache_write_failure_is_ignored_generation_failure_raises(tmp_path, monkeypatch):
    """As in the JAX package, a cache that cannot be written is skipped;
    a generation that fails is not."""
    blocker = tmp_path / 'cache_is_a_file'
    blocker.write_text('')
    monkeypatch.setenv('XDG_CACHE_HOME', str(blocker))
    TetGrid.load.cache_clear()
    try:
        tg = TetGrid.load(12, str(tmp_path))
        assert tg.num_verts == 11 ** 3 and not os.path.exists(PT.cache_path(12))
        TetGrid.load.cache_clear()

        def broken(resolution):
            raise MemoryError('no room for the lattice')
        monkeypatch.setattr(PG, 'generate_tet_grid', broken)
        with pytest.raises(MemoryError):
            TetGrid.load(14, str(tmp_path))
    finally:
        TetGrid.load.cache_clear()


def test_bundled_64_asset_is_the_ports_own_copy():
    """The port reads its 64 grid from its own assets, equal array for array
    to the JAX package's file."""
    ours = os.path.join(PT.DEFAULT_TET_DIR, '64_tets_cropped.npz')
    assert os.path.normpath(PT.DEFAULT_TET_DIR).endswith(os.path.join('meshdiffusion_tpu_torch',
                                                                       'assets'))
    theirs = os.path.join(os.path.dirname(JG.__file__), '..', 'assets', '64_tets_cropped.npz')
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    assert_grids_equal(TetGrid.load(64), JaxTetGrid.load(64))
