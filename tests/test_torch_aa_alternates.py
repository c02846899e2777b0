"""The port's edge-AA alternates against the JAX package, on the CPU: the
single-view ``antialias`` (dense over every pair), the dense all-views
``antialias_views(impl='flat')``, ``uv_derivatives`` and
``uv_derivatives_analytic``, and ``render_mesh`` under each value of
``MESHDIFFUSION_AA_IMPL``. The cases are those of tests/test_rasterize.py
(edges only, the area derivative, no gradient where the colour is
constant, the views against a per-view loop), each held against JAX's
image and its gradients with respect to v_clip and colour.

Both sides AA the same rasterization (JAX's ids, validity and z), so the
comparison sees the AA alone. Tolerance: fp32 rtol 2e-4 / atol 2e-5 for
images; gradients rtol 2e-4 with an atol of 2e-4 of the gradient's
largest magnitude (scatters summed in another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshdiffusion_tpu.render import rasterize as JR
from meshdiffusion_tpu_torch.render import rasterize as R

pytest_plugins = ('torch_rules',)

RTOL, ATOL = 2e-4, 2e-5


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def _close_grad(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=2e-4 * max(np.abs(want).max(), 1e-6))


def two_triangles():
    """tests/test_rasterize.py's scene: the second triangle in front."""
    v = np.array([
        [-0.5, -0.5, 0.5, 1.0], [0.5, -0.5, 0.5, 1.0], [0.0, 0.6, 0.5, 1.0],
        [-0.2, -0.2, 0.0, 1.0], [0.6, -0.2, 0.0, 1.0], [0.2, 0.5, 0.0, 1.0],
    ], np.float32)
    return v, np.array([[0, 1, 2], [3, 4, 5]], np.int32)


@functools.lru_cache(maxsize=None)
def _jax_rasterize(res):
    return jax.jit(lambda v, f: JR.rasterize(v, f, res)[0])


def _jax_rast(v, f, res):
    return _jax_rasterize(res)(jnp.asarray(v), jnp.asarray(f))


def _port_rast(jr):
    """JAX's rasterization of one view as the port's RasterOut."""
    return R.RasterOut(tri_id=_t(jr.tri_id, torch.int64), bary=None, zbuf=_t(jr.zbuf),
                       valid=_t(jr.valid))


def _antialias_both(v, f, jr, color, wgt):
    """JAX's antialias (jitted) and the port's on one view: the images and
    the gradients of sum(img * wgt) with respect to v_clip and colour."""
    def jloss(c, vc):
        img = JR.antialias(c, jr, vc, jnp.asarray(f))
        return jnp.sum(img * wgt), img
    (_, want), (jgc, jgv) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(color), jnp.asarray(v))
    ct, vt = _t(color).requires_grad_(), _t(v).requires_grad_()
    got = R.antialias(ct, _port_rast(jr), vt, _t(f, torch.int64))
    (got * _t(wgt)).sum().backward()
    return (got.detach().numpy(), ct.grad.numpy(), vt.grad.numpy()), (want, jgc, jgv)


def test_antialias_softens_edges_only():
    """The hard coverage of two triangles through the single-view AA: the
    image and both gradients as JAX's; edge pixels blended, by at most the
    pair difference, interior pixels untouched."""
    v, f = two_triangles()
    res = (32, 32)
    jr = _jax_rast(v, f, res)
    hard = np.asarray(jr.valid, np.float32)[..., None]
    wgt = np.random.default_rng(0).normal(size=res + (1,)).astype(np.float32)
    got, want = _antialias_both(v, f, jr, hard, wgt)
    for g, w in zip(got[1:], want[1:]):
        _close_grad(g, w)
    soft = got[0]
    _close(soft, want[0])
    diff = np.abs(soft - hard)[..., 0]
    assert 0.05 < diff.max() <= 1.0 + 1e-5
    tri = np.asarray(jr.tri_id)
    interior = np.ones_like(tri, bool)
    interior[1:] &= tri[1:] == tri[:-1]
    interior[:-1] &= tri[:-1] == tri[1:]
    interior[:, 1:] &= tri[:, 1:] == tri[:, :-1]
    interior[:, :-1] &= tri[:, :-1] == tri[:, 1:]
    np.testing.assert_array_equal(soft[interior], hard[interior])


def test_antialias_gradient_matches_area_derivative():
    """Moving a vertical silhouette edge (both its vertices) or the apex:
    the coverage sum's gradient as JAX's and within 20 % of the shoelace
    area derivative (tests/test_rasterize.py's contract)."""
    f = np.array([[0, 1, 2]], np.int32)
    res = (64, 64)
    H, W = res
    v0 = np.array([[-0.513, -0.507, 0.0, 1.0], [-0.513, 0.493, 0.0, 1.0],
                   [0.5, 0.013, 0.0, 1.0]], np.float32)
    ypx = (v0[:, 1] * 0.5 + 0.5) * H
    jr = _jax_rast(v0, f, res)
    cover = np.asarray(jr.valid, np.float32)[..., None]
    _, (_, _, jgv) = _antialias_both(v0, f, jr, cover, np.ones(res + (1,), np.float32))
    vt = _t(v0).requires_grad_()
    R.antialias(_t(cover), _port_rast(jr), vt, _t(f, torch.int64)).sum().backward()
    g = vt.grad.numpy()
    _close_grad(g, jgv)
    area = 0.5 * (ypx[1] - ypx[0]) * (W / 2.0)        # px^2 per NDC unit of x
    for got, want in ((g[0, 0] + g[1, 0], -area), (g[2, 0], area)):
        assert abs(got - want) / abs(want) < 0.2, (got, want)


def test_antialias_gradient_zero_when_static():
    """A constant image: no coverage gradient, as in JAX."""
    v, f = two_triangles()
    res = (24, 24)
    jr = _jax_rast(v, f, res)
    img = np.full(res + (3,), 0.5, np.float32)
    got, want = _antialias_both(v, f, jr, img, np.ones(res + (3,), np.float32))
    _close(got[0], want[0])
    np.testing.assert_allclose(got[2], 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(want[2]), 0.0, atol=1e-5)


def test_antialias_views_flat_and_per_view_match_jax():
    """Three jittered views: the dense all-views AA ('flat') and the
    single-view AA on each view, against JAX's flat and vmapped AA (values,
    and the gradients of sum(img^2) w.r.t. colour and v_clip); and flat
    against the port's compact path on the same views."""
    rng = np.random.default_rng(3)
    B, res = 3, (24, 24)
    v, f = two_triangles()
    jit_v = rng.normal(0, 0.03, (B,) + v.shape).astype(np.float32)
    jit_v[..., 3] = 0.0
    vc = v[None] + jit_v
    rasts = [_jax_rast(vc[b], f, res) for b in range(B)]
    tri = np.stack([np.asarray(r.tri_id) for r in rasts])
    valid = np.stack([np.asarray(r.valid) for r in rasts])
    zbuf = np.stack([np.asarray(r.zbuf) for r in rasts])
    col = rng.normal(0, 1, (B,) + res + (4,)).astype(np.float32)
    fj = jnp.asarray(f)

    def jflat(c, v_):
        img, over = JR.antialias_views(c, jnp.asarray(tri), jnp.asarray(valid),
                                       jnp.asarray(zbuf), v_, fj, impl='flat')
        return jnp.sum(img ** 2), (img, over)

    def jvmap(c, v_):
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *rasts)
        img = jax.vmap(lambda cb, rb, vb: JR.antialias(cb, rb, vb, fj))(c, stacked, v_)
        return jnp.sum(img ** 2), (img, jnp.zeros((), jnp.int32))

    args = (_t(tri, torch.int64), _t(valid), _t(zbuf))
    ft = _t(f, torch.int64)

    def pflat(c, v_):
        return R.antialias_views(c, *args, v_, ft, impl='flat')

    def pviews(c, v_):
        return torch.stack([R.antialias(c[b], R.RasterOut(tri_id=args[0][b], bary=None,
                                                          zbuf=args[2][b], valid=args[1][b]),
                                        v_[b], ft) for b in range(B)]), torch.zeros(())

    for jfn, pfn in ((jflat, pflat), (jvmap, pviews)):
        (_, (want, jover)), (jgc, jgv) = jax.jit(jax.value_and_grad(
            jfn, argnums=(0, 1), has_aux=True))(jnp.asarray(col), jnp.asarray(vc))
        ct, vt = _t(col).requires_grad_(), _t(vc).requires_grad_()
        img, over = pfn(ct, vt)
        (img ** 2).sum().backward()
        assert int(over) == int(jover) == 0
        _close(img.detach().numpy(), want)
        _close_grad(ct.grad.numpy(), jgc)
        _close_grad(vt.grad.numpy(), jgv)
        assert np.abs(np.asarray(jgv)).max() > 1e-3     # coverage gradients flowed
    compact, over = R.antialias_views(_t(col), *args, _t(vc), ft, impl='compact', budget=4096)
    assert int(over) == 0
    np.testing.assert_allclose(compact.numpy(), pflat(_t(col), _t(vc))[0].numpy(), atol=1e-5,
                               rtol=1e-5)


def test_uv_derivatives_match_jax():
    """The forward-difference estimate on a random uv image, and the
    analytic rast_db equivalent on tests/test_rasterize.py's perspective
    triangle (distinct w a vertex), against JAX's; the analytic one also
    against central differences of the interpolated uv inside the
    triangle."""
    texc = np.random.default_rng(4).uniform(size=(20, 24, 2)).astype(np.float32)
    np.testing.assert_array_equal(R.uv_derivatives(_t(texc)).numpy(),
                                  np.asarray(JR.uv_derivatives(jnp.asarray(texc))))

    v = np.array([[-0.9, -0.8, 0.2, 1.4], [0.95, -0.7, 0.1, 0.8], [0.0, 0.9, 0.3, 1.1]],
                 np.float32)
    v = v * np.array([[1.4], [0.8], [1.1]], np.float32)
    f = np.array([[0, 1, 2]], np.int32)
    uv = np.array([[0.1, 0.2], [0.9, 0.15], [0.45, 0.95]], np.float32)
    res = (64, 64)
    jr = _jax_rast(v, f, res)
    want = np.asarray(jax.jit(lambda u, r, vv: JR.uv_derivatives_analytic(
        u, r, vv, jnp.asarray(f), res))(jnp.asarray(uv), jr, jnp.asarray(v)))
    got = R.uv_derivatives_analytic(_t(uv), _port_rast(jr), _t(v), _t(f, torch.int64), res)
    got = got.numpy()
    valid = np.asarray(jr.valid)
    assert valid.sum() > 200 and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    texc = np.asarray(JR.interpolate(jnp.asarray(uv), jr, jnp.asarray(f)))
    inner = valid.copy()
    inner[1:] &= valid[:-1]
    inner[:-1] &= valid[1:]
    inner[:, 1:] &= valid[:, :-1]
    inner[:, :-1] &= valid[:, 1:]
    m = inner[1:-1, 1:-1]
    dx = (texc[:, 2:] - texc[:, :-2]) * 0.5
    dy = (texc[2:] - texc[:-2]) * 0.5
    for col, fd in ((0, dx[1:-1][..., 0]), (2, dx[1:-1][..., 1]), (1, dy[:, 1:-1][..., 0]),
                    (3, dy[:, 1:-1][..., 1])):
        np.testing.assert_allclose(got[1:-1, 1:-1][m][:, col], fd[m], rtol=0.05, atol=2e-4)


@pytest.fixture(scope='module')
def sphere_scene(tiny_tet_grid):
    """A marching-tets sphere on the 8^3 grid, two cameras, a random light."""
    from meshdiffusion_tpu.geometry.marching_tets import compact_mesh, marching_tets
    from meshdiffusion_tpu.render import utils as JU
    tg = tiny_tet_grid
    sdf = 0.35 - np.linalg.norm(tg.verts, axis=1).astype(np.float32)
    v, f = compact_mesh(marching_tets(tg, jnp.asarray(tg.verts), jnp.asarray(sdf)))
    proj = JU.perspective(np.deg2rad(45), 1.0, 0.1, 1000.0)
    mvs = [JU.translate(0, 0, -1.2) @ JU.rotate_x(-0.4),
           JU.translate(0.05, 0, -1.1) @ JU.rotate_y(0.7) @ JU.rotate_x(0.3)]
    mvp = np.stack([proj @ mv for mv in mvs]).astype(np.float32)
    campos = np.stack([np.linalg.inv(mv)[:3, 3] for mv in mvs]).astype(np.float32)
    base = np.random.default_rng(2).uniform(0.2, 1.5, (6, 16, 16, 3)).astype(np.float32)
    return np.asarray(v, np.float32), np.asarray(f, np.int32), mvp, campos, base


@pytest.mark.parametrize('impl', ['compact', 'flat', 'vmap'])
def test_render_mesh_aa_impl_matches_jax(sphere_scene, monkeypatch, impl):
    """``render_mesh`` of two views at 32^2 under MESHDIFFUSION_AA_IMPL =
    ``impl`` in both packages: the AA'd shaded and normal images, the
    aa_overflow (0 but for compact), and the gradient of a fixed scalar of
    the shaded image with respect to v_pos."""
    from meshdiffusion_tpu.render import light as JL
    from meshdiffusion_tpu.render import mesh as JM
    from meshdiffusion_tpu.render.material import default_material as jax_material
    from meshdiffusion_tpu.render.render import render_mesh as jax_render_mesh
    from meshdiffusion_tpu_torch.fitting.fit import default_material
    from meshdiffusion_tpu_torch.render import light as L
    from meshdiffusion_tpu_torch.render import mesh as M
    from meshdiffusion_tpu_torch.render.render import render_mesh
    monkeypatch.setenv('MESHDIFFUSION_AA_IMPL', impl)
    v, f, mvp, campos, base = sphere_scene
    res = (32, 32)
    wgt = np.random.default_rng(5).normal(size=(2,) + res + (4,)).astype(np.float32)

    def jax_fn(vp):
        lgt = JL.EnvironmentLight(jnp.asarray(base))
        lgt.build_mips()
        m = JM.auto_normals(JM.Mesh(v_pos=vp, t_pos_idx=jnp.asarray(f),
                                    material=jax_material()))
        out = jax_render_mesh(m, jnp.asarray(mvp), jnp.asarray(campos), lgt, res, num_layers=1,
                              raster_K=128)
        return jnp.sum(out['shaded'] * wgt), out
    (_, want), jg = jax.jit(jax.value_and_grad(jax_fn, has_aux=True))(jnp.asarray(v))

    lgt = L.EnvironmentLight(_t(base))
    lgt.build_mips()
    vt = _t(v).requires_grad_()
    m = M.auto_normals(M.Mesh(v_pos=vt, t_pos_idx=_t(f, torch.int64),
                              material=default_material()))
    got = render_mesh(m, _t(mvp), _t(campos), lgt, res, num_layers=1, raster_K=128)
    (got['shaded'] * _t(wgt)).sum().backward()
    for k in ('shaded', 'normal', 'mask'):
        _close(got[k].detach().numpy(), want[k])
    assert int(got['aa_overflow']) == int(want['aa_overflow']) == 0
    assert np.asarray(want['mask']).mean() > 0.05
    _close_grad(vt.grad.numpy(), jg)
