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

pytest_plugins = ('torch_rules',)

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


def _tiny_mesh(tiny_tet_grid):
    """A sphere through the port's marching tets on the tiny 8^3 fixture
    grid, at extraction's mesh scale 2.1."""
    from meshdiffusion_tpu_torch.geometry.marching_tets import marching_tets
    tg = TetGrid.from_arrays(8, tiny_tet_grid.verts, tiny_tet_grid.indices)
    sdf = (0.3 - np.linalg.norm(tg.verts, axis=1)).astype(np.float32)
    v, f = compact_mesh(marching_tets(tg, torch.from_numpy(tg.verts * 2.1), torch.from_numpy(sdf)))
    assert len(f) > 50
    return np.asarray(v, np.float32), np.asarray(f, np.int64)


def test_render_viz_matches_jax(tiny_tet_grid, tmp_path, monkeypatch):
    """The sanity render of one mesh at 64^2: the triangle-id image of its
    camera exactly equal (each package's rasterize_select), the visible
    triangle set exact, ``shaded`` and the image handed to the PNG writer at
    fp32 tolerance (rtol 2e-4 / atol 2e-5). JAX's render and selection run
    under ``jax.jit``, as its fitting driver runs them: one compile, where
    op by op each of ~700 ops compiles on its own."""
    import jax
    import meshdiffusion_tpu.render.render as JR
    import meshdiffusion_tpu.render.utils as JU
    from meshdiffusion_tpu.extract import render_viz as jax_render_viz
    from meshdiffusion_tpu.render import ops as JO
    from meshdiffusion_tpu.render.rasterize import rasterize_select as jax_select
    from meshdiffusion_tpu_torch.extract import render_viz, viz_camera
    from meshdiffusion_tpu_torch.render import ops as PO
    from meshdiffusion_tpu_torch.render import utils as PU
    from meshdiffusion_tpu_torch.render.rasterize import rasterize_select

    v, f = _tiny_mesh(tiny_tet_grid)
    res, angle = (64, 64), 7
    seen = {}
    jax_render = JR.render_mesh

    def render_jitted(m, mvp, campos, light, *args, **kw):
        seen['jax_out'] = jax.jit(lambda a, b: jax_render(m, a, b, light, *args, **kw))(
            mvp, campos)
        return seen['jax_out']
    monkeypatch.setattr(JR, 'render_mesh', render_jitted)
    monkeypatch.setattr(JU, 'save_image', lambda path, img: seen.setdefault('jax_img', img))
    jax_render_viz(v, f, str(tmp_path / 'jax.png'), angle_ind=angle, display_res=res)
    images = []
    monkeypatch.setattr(PU, 'save_image', lambda path, img: images.append(img))
    out = render_viz(v, f, str(tmp_path / 'port.png'), angle_ind=angle, display_res=res,
                     device='cpu')
    want = seen['jax_out']

    mvp, _ = viz_camera(angle, res)
    jt = jax.jit(lambda vc, tri: jax_select(vc, tri, res)[0])(
        JO.xfm_points(jnp.asarray(v)[None], jnp.asarray(mvp))[0],
        jnp.asarray(f.astype(np.int32)))
    pt = rasterize_select(PO.xfm_points(torch.from_numpy(v)[None], torch.from_numpy(mvp)),
                          torch.from_numpy(f), res)[0]
    assert int((np.asarray(jt) >= 0).sum()) > 200
    np.testing.assert_array_equal(pt[0].numpy(), np.asarray(jt))
    np.testing.assert_array_equal(out['rast_triangle_mask'].numpy(),
                                  np.asarray(want['rast_triangle_mask']))
    np.testing.assert_allclose(out['shaded'].numpy(), np.asarray(want['shaded']),
                               rtol=2e-4, atol=2e-5)
    img, jimg = images[0], np.asarray(seen['jax_img'])
    assert img.shape == jimg.shape == (64, 64, 3) and img.std() > 0.05
    np.testing.assert_allclose(img, jimg, rtol=2e-4, atol=2e-5)


def test_save_image_same_bytes(tmp_path):
    from meshdiffusion_tpu.render.utils import save_image as jax_save_image
    from meshdiffusion_tpu_torch.render.utils import save_image
    rng = np.random.default_rng(0)
    for k, img in enumerate((rng.uniform(-0.2, 1.2, (17, 9, 3)).astype(np.float32),
                             rng.integers(0, 256, (5, 7, 4)).astype(np.uint8),
                             rng.uniform(0, 1, (6, 4)),
                             rng.uniform(0, 1, (3, 8, 1)))):
        save_image(str(tmp_path / f'p{k}.png'), img)
        jax_save_image(str(tmp_path / f'j{k}.png'), img)
        a, b = (open(tmp_path / f'{s}{k}.png', 'rb').read() for s in 'pj')
        assert a == b and a.startswith(b'\x89PNG')


def test_render_viz_grows_capacities_until_nothing_drops(tmp_path, caplog):
    """A mesh denser than the first render's capacities (a marched sphere of
    ~1,900 faces in the four 32x32 tiles of a 64^2 image, past raster_K
    256): the sanity render is redone with grown capacities, ends with no
    overflow, and shows the triangles of one render at ample capacities."""
    import logging
    from meshdiffusion_tpu_torch.extract import render_viz, viz_camera
    from meshdiffusion_tpu_torch.geometry.generate_tets import generate_tet_grid
    from meshdiffusion_tpu_torch.geometry.marching_tets import marching_tets
    from meshdiffusion_tpu_torch.render import ops as PO
    from meshdiffusion_tpu_torch.render.rasterize import rasterize_select
    tg = TetGrid.from_arrays(24, *generate_tet_grid(24))
    sdf = (0.3 - np.linalg.norm(tg.verts, axis=1)).astype(np.float32)
    v, f = compact_mesh(marching_tets(tg, torch.from_numpy(tg.verts * 2.1), torch.from_numpy(sdf)))
    res = (64, 64)
    with caplog.at_level(logging.INFO, logger='meshdiffusion_tpu_torch'):
        out = render_viz(v, f, str(tmp_path / 'v.png'), display_res=res, device='cpu')
    rec = [r for r in caplog.records if hasattr(r, 'viz_renders')][-1]
    assert rec.viz_renders >= 2 and not any(rec.viz_overflow.values())
    mvp, _ = viz_camera(25, res)
    v_clip = PO.xfm_points(torch.from_numpy(v)[None], torch.from_numpy(mvp))
    ample = rasterize_select(v_clip, torch.from_numpy(f), res, K=len(f), Kg=len(f),
                             live_cap=len(f))
    assert int(ample[1].max()) == int(ample[2].max()) == int(ample[3].max()) == 0
    visible = torch.zeros(len(f), dtype=torch.bool)
    visible[ample[0][ample[0] >= 0]] = True
    assert torch.equal(out['rast_triangle_mask'], visible)
