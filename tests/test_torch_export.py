"""The port's baked-texture export against the JAX package, on the CPU:
the UV atlas (``parametrize``, a copy of JAX's host numpy, bit-equal), the
seam dilation, ``render_uv`` (the UV charts rasterized at z = 0, where the
z-test's tie rule picks every texel) and ``export_baked`` (the .obj, its
.mtl and the kd / ks / normal maps, read back by the port's loader).

Tolerances: the atlas, vertex positions, texture coordinates, face lists
and coverage masks exactly; baked values fp32 rtol 2e-4 / atol 2e-5;
8-bit PNG maps within one step of 255.

The JAX package's ``save_mtl`` converts the whole kd mip chain to sRGB,
so it writes ``texture_kd_{level}.png`` while its .mtl names
``texture_kd.png``; the port writes that one file from the base level
(``test_export_baked_matches_jax`` compares it with JAX's level 0)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshdiffusion_tpu.fitting import export as JE
from meshdiffusion_tpu.fitting import fit as JF
from meshdiffusion_tpu.geometry import uv_unwrap as JUV
from meshdiffusion_tpu.geometry.marching_tets import compact_mesh, marching_tets
from meshdiffusion_tpu.render import mesh as JM
from meshdiffusion_tpu.render import mlptexture as JMLP
from meshdiffusion_tpu.render import render as JR
from meshdiffusion_tpu_torch.fitting import export as E
from meshdiffusion_tpu_torch.fitting import fit as F
from meshdiffusion_tpu_torch.geometry import uv_unwrap as UV
from meshdiffusion_tpu_torch.geometry.obj_io import read_obj
from meshdiffusion_tpu_torch.render import mesh as M
from meshdiffusion_tpu_torch.render import mlptexture as MLP
from meshdiffusion_tpu_torch.render import obj as Obj
from meshdiffusion_tpu_torch.render import utils as U
from meshdiffusion_tpu_torch.render.render import render_uv
from meshdiffusion_tpu_torch.utils.convert import mlp_texture_state_from_jax

pytest_plugins = ('torch_rules',)

RTOL, ATOL = 2e-4, 2e-5
RES = (64, 64)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope='module')
def meshes(tiny_tet_grid):
    """Two marching-tets meshes on the tiny grid: a smooth sphere and a
    noisy blob (staircase charts that overlap and get bisected)."""
    jtg = tiny_tet_grid
    r = np.linalg.norm(jtg.verts, axis=1)
    noise = 0.08 * np.random.default_rng(0).normal(size=len(r))
    out = {}
    for name, sdf in (('sphere', 0.3 - r), ('blob', 0.32 - r + noise)):
        v, f = compact_mesh(marching_tets(jtg, jnp.asarray(jtg.verts),
                                          jnp.asarray(sdf.astype(np.float32))))
        out[name] = (np.asarray(v, np.float32), np.asarray(f, np.int32))
    return out


SMALL_HASH = dict(num_levels=4, log2_hashmap_size=14, desired_resolution=64)


@pytest.fixture
def material(monkeypatch):
    """JAX's neural material over the meshes' box with a smooth, non-trivial
    table (every level N(0, 0.3^2)), and the port's with the same weights.
    Both packages' hash grid is cut to 4 levels of 2^14 entries, 16 -> 64
    cells a side: the JAX package traces its encoder level by level and
    corner by corner, so at 16 x 2^19 a bake spends most of its time
    tracing it (``test_torch_textured.py`` holds the full-size encoder)."""
    monkeypatch.setattr(JMLP, 'HashEncoder', functools.partial(JMLP.HashEncoder, **SMALL_HASH))
    monkeypatch.setattr(MLP, 'HashEncoder', functools.partial(MLP.HashEncoder, **SMALL_HASH))
    aabb = (np.full(3, -0.45, np.float32), np.full(3, 0.45, np.float32))
    module, params = JF.make_mlp_material(aabb)
    table = params['params']['encoder']['table']
    table = table + 0.3 * jax.random.normal(jax.random.key(2), table.shape)
    params = {'params': {**params['params'], 'encoder': {'table': table}}}
    mat = F.make_mlp_material(aabb, device='cpu')
    mat.load_state_dict({**mat.state_dict(), **mlp_texture_state_from_jax(params)})
    return JMLP.BoundTexture3D(module, params), mat


@pytest.mark.parametrize('name', ['sphere', 'blob'])
def test_parametrize_matches_jax(meshes, name):
    """The atlas bit for bit: vertex mapping, faces and uvs."""
    v, f = meshes[name]
    want = JUV.parametrize(v, f)
    got = UV.parametrize(v, f)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (got[2] >= 0).all() and (got[2] <= 1).all() and len(got[0]) > len(v)


def test_dilate_texels_matches_jax(rng):
    img = rng.uniform(0, 1, (40, 30, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, (40, 30)) > 0.8
    np.testing.assert_array_equal(E.dilate_texels(img, mask), JE.dilate_texels(img, mask))


def _uv_meshes(v, f):
    """Both packages' meshes with the atlas's texture coordinates."""
    vmap, tf, uvs = JUV.parametrize(v, f)
    jm = JM.auto_normals(JM.Mesh(v_pos=jnp.asarray(v), t_pos_idx=jnp.asarray(f)))
    jm = JM.Mesh.combine(jm, v_tex=jnp.asarray(uvs), t_tex_idx=jnp.asarray(tf.astype(np.int32)))
    pm = M.auto_normals(M.Mesh(v_pos=_t(v), t_pos_idx=_t(f).long()))
    pm = M.Mesh.combine(pm, v_tex=_t(uvs), t_tex_idx=_t(tf.astype(np.int64)))
    return jm, pm


@pytest.fixture
def jax_tile_kernel(monkeypatch):
    """JAX's rasterizer through its Pallas z-test in interpret mode, as on
    the TPU, whose tie-break (the first group of 8 candidates, then the
    smallest id) the port's z-test keeps; on the CPU JAX otherwise takes
    its scan, which keeps the first candidate."""
    import functools
    import meshdiffusion_tpu.render.rasterize as JRa
    monkeypatch.setattr(JRa, '_rasterize_tiles',
                        functools.partial(JRa._rasterize_tiles, use_pallas=True))


def _uv_ids(jm, pm, res):
    """Each package's texel -> triangle id image of the mesh's atlas at
    ``res`` (z = 0 everywhere, the bake's rasterization)."""
    from meshdiffusion_tpu.render.rasterize import rasterize as jrast
    from meshdiffusion_tpu_torch.render.rasterize import rasterize as prast
    F_ = int(pm.t_tex_idx.shape[0])

    def clip(uv, lib):
        c = uv * 2.0 - 1.0
        return lib.cat([c, c[:, :1] * 0, c[:, :1] * 0 + 1], -1) if lib is torch else \
            jnp.concatenate([c, c[:, :1] * 0, c[:, :1] * 0 + 1], -1)
    want = jax.jit(lambda: jrast(clip(jm.v_tex, jnp), jm.t_tex_idx, res, live_cap=F_)[0])()
    assert int(want.bin_overflow) == 0 and int(want.global_overflow) == 0
    got = prast(clip(pm.v_tex, torch), pm.t_tex_idx, res, K=1024, live_cap=F_)[0]
    return got.tri_id.numpy(), np.asarray(want.tri_id)


def _on_an_edge(ids, uvs, tf, res, ys, xs):
    """Whether each texel centre (xs, ys) lies on an edge (within 1e-4 of
    a pixel, in float64) of one of the triangles ``ids`` names there."""
    out = []
    for y, x, t in zip(ys, xs, ids):
        p = np.array([x + 0.5, y + 0.5])
        on = False
        for tri in t:
            if tri < 0:
                continue
            q = uvs[tf[tri]].astype(np.float64) * np.array([res[1], res[0]])
            for i in range(3):
                a, b = q[i], q[(i + 1) % 3]
                e = b - a
                dist = abs(e[0] * (p[1] - a[1]) - e[1] * (p[0] - a[0])) / np.hypot(*e)
                on |= dist < 1e-4
        out.append(on)
    return np.array(out)


def _agreeing(got_ids, want_ids, pm, res):
    """The texels where both packages pick the same triangle. Everywhere
    else the texel centre lies on an edge of a triangle involved (where
    fp32 rounding of the edge functions decides coverage and which of two
    neighbours wins), and they are under 2 % of the covered texels."""
    diff = np.argwhere(got_ids != want_ids)
    uvs, tf = pm.v_tex.numpy(), pm.t_tex_idx.numpy()
    on = _on_an_edge(np.stack([got_ids[tuple(diff.T)], want_ids[tuple(diff.T)]], 1), uvs, tf,
                     res, diff[:, 0], diff[:, 1])
    assert on.all(), diff[~on][:5]
    assert len(diff) < 0.02 * (want_ids >= 0).sum(), len(diff)
    return got_ids == want_ids


def test_render_uv_matches_jax(meshes, material, jax_tile_kernel):
    """The UV-space bake of the blob at 128^2 (where JAX's first binning
    drops nothing), every candidate tied at z = 0: the texel -> triangle
    choice equal to JAX's except where a texel centre lies on a triangle
    edge, coverage and values at fp32 tolerance on the texels where both
    chose the same triangle. (The sphere's bake at 64^2 is held in
    ``test_export_baked_matches_jax``.)"""
    jmat, pmat = material
    res = (128, 128)
    jm, pm = _uv_meshes(*meshes['blob'])
    got_ids, want_ids = _uv_ids(jm, pm, res)
    same = _agreeing(got_ids, want_ids, pm, res)
    want = jax.jit(lambda: JR.render_uv(jm, res, jmat))()
    with torch.no_grad():
        got = render_uv(pm, res, pmat)
    np.testing.assert_array_equal(got[0].numpy()[..., 0], (got_ids >= 0).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(want[0])[..., 0], (want_ids >= 0).astype(np.float32))
    assert 0.2 < float(want[0].mean()) < 0.95
    for a, b, what in zip(got[1:], want[1:], ('kd', 'ks', 'normal')):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same], rtol=RTOL, atol=ATOL,
                                   err_msg=what)


def test_render_uv_drops_nothing(meshes, material):
    """The blob's atlas at 64^2 overflows the first binning (K 256; the
    JAX package keeps that binning and drops triangles): the port's bake
    regrows it and covers every texel a binning at K 1024 covers."""
    _, pmat = material
    _, pm = _uv_meshes(*meshes['blob'])
    from meshdiffusion_tpu_torch.render.rasterize import rasterize as prast
    uv = pm.v_tex * 2 - 1
    clip = torch.cat([uv, uv[:, :1] * 0, uv[:, :1] * 0 + 1], -1)
    F_ = int(pm.t_tex_idx.shape[0])
    first = prast(clip, pm.t_tex_idx, (64, 64), live_cap=F_)[0]
    ample = prast(clip, pm.t_tex_idx, (64, 64), K=1024, live_cap=F_)[0]
    assert int(first.bin_overflow) > 0 and int(ample.bin_overflow) == 0
    with torch.no_grad():
        mask = render_uv(pm, (64, 64), pmat)[0]
    np.testing.assert_array_equal(mask[..., 0].numpy(), ample.valid.float().numpy())


def test_export_baked_matches_jax(meshes, material, jax_tile_kernel, tmp_path, monkeypatch):
    """export_baked of the sphere at 64^2: the .obj's positions, texture
    coordinates and faces equal JAX's, its normals to fp32 tolerance; the
    .mtl's lines; the ks and normal maps within one 8-bit step of JAX's,
    and the kd map of JAX's level 0, at the texels where both bakes chose
    the same triangle; then the port's load_obj reads the export back, its
    kd map non-uniform."""
    jmat, pmat = material
    v, f = meshes['sphere']
    jm = JM.auto_normals(JM.Mesh(v_pos=jnp.asarray(v), t_pos_idx=jnp.asarray(f)))
    pm = M.auto_normals(M.Mesh(v_pos=_t(v), t_pos_idx=_t(f).long()))
    # JAX's bake with its UV render jitted (op by op each op compiles on its own)
    monkeypatch.setattr(JE, 'render_uv', lambda mesh, res, tex: jax.jit(
        lambda: JR.render_uv(mesh, res, tex))())
    jout = JE.export_baked(jm, jmat, str(tmp_path / 'j'), texture_res=RES)
    with torch.no_grad():
        out = E.export_baked(pm, pmat, str(tmp_path / 'p'), texture_res=RES)
    rows = {}
    for who, path in (('p', out), ('j', jout)):
        with open(path) as fh:
            lines = fh.read().splitlines()
        rows[who] = {tag: [ln for ln in lines if ln.split()[:1] == [tag]]
                     for tag in ('v', 'vt', 'vn', 'f', 'usemtl', 'mtllib')}
    for tag in ('v', 'vt', 'f', 'usemtl', 'mtllib'):
        assert rows['p'][tag] == rows['j'][tag], tag
    vn = [np.array([[float(x) for x in ln.split()[1:]] for ln in rows[w]['vn']]) for w in 'pj']
    np.testing.assert_allclose(vn[0], vn[1], rtol=RTOL, atol=ATOL)
    with open(tmp_path / 'p' / 'mesh.mtl') as a, open(tmp_path / 'j' / 'mesh.mtl') as b:
        assert a.read() == b.read()
    _, pmu = _uv_meshes(v, f)
    got_ids, want_ids = _uv_ids(*_uv_meshes(v, f), RES)
    same = _agreeing(got_ids, want_ids, pmu, RES) & (got_ids >= 0)
    for mine, theirs in (('texture_ks.png', 'texture_ks.png'), ('texture_n.png', 'texture_n.png'),
                         ('texture_kd.png', 'texture_kd_0.png')):
        a = U.load_image(str(tmp_path / 'p' / mine))
        b = U.load_image(str(tmp_path / 'j' / theirs))
        assert a.shape == b.shape == RES + (3,)
        assert np.abs(a - b)[same].max() <= 1 / 255 + 1e-6, mine
    assert not os.path.exists(tmp_path / 'j' / 'texture_kd.png')
    back = Obj.load_mesh(out, device='cpu')
    kd = back.material['kd'].data
    assert kd.shape == (1,) + RES + (3,) and float(kd.std()) > 1e-2
    verts, faces = read_obj(out)
    np.testing.assert_array_equal(faces, f)
    np.testing.assert_array_equal(back.t_pos_idx.numpy(), f)
