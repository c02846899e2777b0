"""The port's renderer against the JAX package, on the CPU: the environment
light (mip chain, diffuse irradiance, cubemap fetch), the shading ops,
and the whole two-layer ``render_mesh`` of a marching-tets sphere, dense
and with ``shade_cap`` compaction, buffers and gradients.

Tolerance: fp32 rtol 2e-4 / atol 2e-5 (ROADMAP's fp32 tolerance) for
buffers; triangle ids and masks exactly equal; gradients rtol 2e-4 with an
atol of 2e-4 of the gradient's largest magnitude (sums of scatters taken
in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshdiffusion_tpu.geometry.marching_tets import compact_mesh as jax_compact
from meshdiffusion_tpu.geometry.marching_tets import marching_tets as jax_marching_tets
from meshdiffusion_tpu.render import light as JL
from meshdiffusion_tpu.render import mesh as JM
from meshdiffusion_tpu.render import ops as JO
from meshdiffusion_tpu.render import utils as JU
from meshdiffusion_tpu.render.material import default_material as jax_material
from meshdiffusion_tpu.render.render import render_mesh as jax_render_mesh
from meshdiffusion_tpu_torch.fitting.fit import default_material
from meshdiffusion_tpu_torch.render import light as L
from meshdiffusion_tpu_torch.render import mesh as M
from meshdiffusion_tpu_torch.render import ops as O
from meshdiffusion_tpu_torch.render import utils as U
from meshdiffusion_tpu_torch.render.render import render_mesh

pytest_plugins = ('torch_rules',)

RTOL, ATOL = 2e-4, 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_grad(got, want):
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=2e-4 * np.abs(want).max())


def test_light_matches_jax():
    """build_mips (avg-pool chain to 16) + the diffuse matmul, then
    bilinear cubemap fetches in random directions."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0.1, 2.0, (6, 64, 64, 3)).astype(np.float32)
    jl = JL.EnvironmentLight(jnp.asarray(base))
    jl.build_mips()
    pl = L.EnvironmentLight(_t(base))
    pl.build_mips()
    np.testing.assert_allclose(pl.diffuse.numpy(), np.asarray(jl.diffuse), rtol=RTOL, atol=ATOL)
    dirs = rng.normal(size=(500, 3)).astype(np.float32)
    dirs[:6] = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)   # face centres
    want = JU.sample_cubemap(jl.diffuse, jnp.asarray(dirs))
    got = U.sample_cubemap(pl.diffuse, _t(dirs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    c = L.create_trainable_env_rnd(32, scale=0.0, bias=0.5)
    assert (c.base == 0.5).all() and c.base.shape == (6, 32, 32, 3)


def test_shading_ops_match_jax():
    rng = np.random.default_rng(1)
    pos, nrm, geo = (rng.normal(size=(40, 3)).astype(np.float32) for _ in range(3))
    view = rng.normal(size=(1, 3)).astype(np.float32) * 3
    want = JO.prepare_shading_normal(*(jnp.asarray(a) for a in (pos, view)), None,
                                     jnp.asarray(nrm), None, jnp.asarray(geo))
    got = O.prepare_shading_normal(_t(pos), _t(view), None, _t(nrm), None, _t(geo))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    pert, tng = (rng.normal(size=(40, 3)).astype(np.float32) for _ in range(2))
    want = JO.prepare_shading_normal(*(jnp.asarray(a) for a in (pos, view, pert, nrm, tng, geo)))
    got = O.prepare_shading_normal(*(_t(a) for a in (pos, view, pert, nrm, tng, geo)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    img, ref = (rng.uniform(0, 3, size=(2, 8, 8, 3)).astype(np.float32) for _ in range(2))
    for loss, tm in (('l1', 'log_srgb'), ('mse', 'none'), ('smape', 'none'), ('relmse', 'none')):
        w = JO.image_loss(jnp.asarray(img), jnp.asarray(ref), loss, tm)
        g = O.image_loss(_t(img), _t(ref), loss, tm)
        np.testing.assert_allclose(float(g), float(w), rtol=RTOL)
    pts, mtx = rng.normal(size=(2, 30, 3)).astype(np.float32), rng.normal(size=(2, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(O.xfm_points(_t(pts), _t(mtx)).numpy(),
                               np.asarray(JO.xfm_points(jnp.asarray(pts), jnp.asarray(mtx))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(O.xfm_vectors(_t(pts), _t(mtx)).numpy(),
                               np.asarray(JO.xfm_vectors(jnp.asarray(pts), jnp.asarray(mtx))),
                               rtol=RTOL, atol=ATOL)


@pytest.fixture(scope='module')
def scene(tiny_tet_grid):
    """A marching-tets sphere, two cameras, a random light."""
    tg = tiny_tet_grid
    sdf = 0.35 - np.linalg.norm(tg.verts, axis=1).astype(np.float32)
    v, f = jax_compact(jax_marching_tets(tg, jnp.asarray(tg.verts), jnp.asarray(sdf)))
    v, f = np.asarray(v, np.float32), np.asarray(f, np.int32)
    proj = JU.perspective(np.deg2rad(45), 1.0, 0.1, 1000.0)
    mvs = [JU.translate(0, 0, -2.0) @ JU.rotate_x(-0.4),
           JU.translate(0.05, 0, -1.8) @ JU.rotate_y(0.7) @ JU.rotate_x(0.3)]
    mvp = np.stack([proj @ mv for mv in mvs]).astype(np.float32)
    campos = np.stack([np.linalg.inv(mv)[:3, 3] for mv in mvs]).astype(np.float32)
    base = np.random.default_rng(2).uniform(0.2, 1.5, (6, 32, 32, 3)).astype(np.float32)
    return v, f, mvp, campos, base


def _jax_render(scene, v_pos, res, shade_cap):
    """Op by op, not jitted: under jit XLA fuses (and contracts into FMAs)
    more, which moves a few AA'd pixels at near-ties."""
    v, f, mvp, campos, base = scene
    lgt = JL.EnvironmentLight(jnp.asarray(base))
    lgt.build_mips()
    m = JM.auto_normals(JM.Mesh(v_pos=v_pos, t_pos_idx=jnp.asarray(f), material=jax_material()))
    return jax_render_mesh(m, jnp.asarray(mvp), jnp.asarray(campos), lgt, res, num_layers=2,
                           raster_K=128, shade_cap=shade_cap)


def _port_render(scene, v_pos, res, shade_cap, remat=False):
    v, f, mvp, campos, base = scene
    lgt = L.EnvironmentLight(_t(base))
    lgt.build_mips()
    m = M.auto_normals(M.Mesh(v_pos=v_pos, t_pos_idx=_t(f).long(), material=default_material()))
    return render_mesh(m, _t(mvp), _t(campos), lgt, res, num_layers=2, raster_K=128,
                       shade_cap=shade_cap, remat=remat)


def _scalar(out, w):
    return sum((out[k] * w[k]).sum() for k in ('shaded', 'depth', 'depth_second'))


@pytest.mark.parametrize('shade_cap', [None, 100])
def test_render_mesh_matches_jax(scene, shade_cap):
    """Every buffer of the two-layer render of two views, and the gradient
    of a fixed scalar of shaded, depth and depth_second w.r.t. v_pos. The
    cap of 100 is below the views' coverage, so the compact path also
    reports its overflow as JAX does."""
    res = (48, 48)
    v = scene[0]
    rng = np.random.default_rng(3)
    wts = {k: rng.normal(size=(2,) + res + (c,)).astype(np.float32)   # rgb|depth, then alpha
           for k, c in (('shaded', 4), ('depth', 2), ('depth_second', 2))}

    def jax_fn(vp):
        out = _jax_render(scene, vp, res, shade_cap)
        return _scalar(out, {k: jnp.asarray(a) for k, a in wts.items()}), out
    # one op-by-op pass gives JAX's buffers and its gradient
    (_, want), jg = jax.value_and_grad(jax_fn, has_aux=True)(jnp.asarray(v))
    got = _port_render(scene, _t(v), res, shade_cap)
    assert set(got) == set(want) - {'visible_tet_mask'}
    for k, w in want.items():
        w, g = np.asarray(w), got[k].detach().numpy()
        assert g.shape == w.shape, k
        if w.dtype.kind in 'biu':
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=k)
    assert np.asarray(want['mask']).mean() > 0.05
    if shade_cap is not None:
        assert int(got['shade_overflow']) > 0

    vt = _t(v).requires_grad_()
    _scalar(_port_render(scene, vt, res, shade_cap, remat=True), {k: _t(a) for k, a in wts.items()}) \
        .backward()
    _close_grad(vt.grad.numpy(), jg)
