"""The port's grid -> mesh extraction against the JAX package, on the
bundled 64 tet grid, on the CPU: marching tets faces exactly equal, vertex
positions to fp32 tolerance; Laplacian smoothing; the whole extract_grid
without remeshing; and the grid mask."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshdiffusion_tpu.extract import extract_dir as jax_extract_dir
from meshdiffusion_tpu.extract import extract_grid as jax_extract_grid
from meshdiffusion_tpu.extract import make_grid_to_mesh as jax_grid_to_mesh
from meshdiffusion_tpu.geometry.marching_tets import compact_mesh as jax_compact_mesh
from meshdiffusion_tpu.geometry.smoothing import laplacian_smooth as jax_smooth
from meshdiffusion_tpu.geometry.tet_grid import TetGrid as JaxTetGrid
from meshdiffusion_tpu_torch.extract import extract_dir, extract_grid, make_grid_to_mesh
from meshdiffusion_tpu_torch.geometry.marching_tets import compact_mesh
from meshdiffusion_tpu_torch.geometry.obj_io import read_obj
from meshdiffusion_tpu_torch.geometry.smoothing import laplacian_smooth
from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid

R = 64


def sphere_grid(rng):
    """Channels-last (R, R, R, 4): an SDF sphere (with exact zeros on a
    shell, which must map to +1) and a small random deformation."""
    c = (np.arange(R) - (R - 1) / 2) / R
    d = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2 + c[None, None, :] ** 2)
    sdf = (d - 0.3).astype(np.float32)
    sdf[np.abs(sdf) < 2e-3] = 0.0
    deform = 0.3 * rng.standard_normal((R, R, R, 3)).astype(np.float32)
    return np.concatenate([sdf[..., None], deform], -1)


def random_grid(rng):
    return rng.standard_normal((R, R, R, 4)).astype(np.float32)


@pytest.fixture(scope='module')
def grids():
    return TetGrid.load(R), JaxTetGrid.load(R)


@pytest.mark.parametrize('make', [sphere_grid, random_grid])
@pytest.mark.parametrize('unnormalized', [False, True])
def test_marching_tets_matches_jax(grids, make, unnormalized):
    tg, jtg = grids
    g = make(np.random.default_rng(0))
    jv, jf = jax_compact_mesh(jax_grid_to_mesh(jtg, unnormalized_sdf=unnormalized)(
        jnp.asarray(g)))
    out = make_grid_to_mesh(tg, unnormalized_sdf=unnormalized)(torch.from_numpy(g))
    v, f = compact_mesh(out)
    assert len(f) > 100
    assert f.shape == jf.shape and v.shape == jv.shape
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-6)


def test_tet_grid_tables_equal(grids):
    tg, jtg = grids
    for name in ('verts', 'indices', 'unique_edges', 'tet_edge_to_unique',
                 'vert_grid_coords'):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jtg, name))
    np.testing.assert_array_equal(tg.grid_mask(), jtg.grid_mask())
    assert (tg.num_verts, tg.num_tets) == (30512, 159330)


def test_laplacian_smooth_matches_jax(grids):
    tg, jtg = grids
    v, f = compact_mesh(make_grid_to_mesh(tg)(torch.from_numpy(
        sphere_grid(np.random.default_rng(1)))))
    mask = np.random.default_rng(2).random(len(f)) > 0.1
    want = np.asarray(jax_smooth(jnp.asarray(v), jnp.asarray(f.astype(np.int32)), steps=3,
                                 face_mask=jnp.asarray(mask)))
    got = laplacian_smooth(torch.from_numpy(v), torch.from_numpy(f), steps=3,
                           face_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_extract_grid_matches_jax(grids, tmp_path):
    """Marching tets + smoothing + .obj, without the (host-numpy, copied)
    remesh; faces exact, vertices to fp32 tolerance."""
    tg, jtg = grids
    g = np.moveaxis(sphere_grid(np.random.default_rng(3)), -1, 0)
    jv, jf = jax_extract_grid(g, jtg, str(tmp_path / 'jax.obj'), remesh=False)
    v, f = extract_grid(g, tg, str(tmp_path / 'port.obj'), remesh=False, device='cpu')
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
    rv, rf = read_obj(str(tmp_path / 'port.obj'))
    np.testing.assert_array_equal(rf, f)
    np.testing.assert_allclose(rv, v, atol=1e-6)


def test_extract_dir_matches_jax(tmp_path):
    """Trajectory extraction: every .npy of a directory, in name order, to
    time{k:03d}/mesh/; here two single-sample batches on the 64 grid, no
    remesh or smoothing, faces exact."""
    rng = np.random.default_rng(4)
    samples = tmp_path / 'traj'
    samples.mkdir()
    for t in range(2):
        np.save(samples / f'0_time{t:03d}.npy', np.moveaxis(sphere_grid(rng), -1, 0)[None])
    kw = dict(num_smooth_steps=0, remesh=False)
    want = jax_extract_dir(str(samples), str(tmp_path / 'jax'), **kw)
    got = extract_dir(str(samples), str(tmp_path / 'port'), device='cpu', **kw)
    assert [os.path.relpath(p, tmp_path / 'port') for p in got] == \
        [os.path.relpath(p, tmp_path / 'jax') for p in want] == \
        ['time000/mesh/000000.obj', 'time001/mesh/000000.obj']
    for a, b in zip(got, want):
        (v, f), (jv, jf) = read_obj(a), read_obj(b)
        assert len(f) > 100
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
