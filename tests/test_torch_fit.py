"""The port's DMTet fitting against the JAX package, on the CPU, on the
tiny tet grid (n = 8) at 48^2 and batch 2: the fitting losses, the GT
target render, one ``tick`` of each pass (losses and the sdf / deform
gradients), and whole fit steps (Adam + maintenance) where shrink and
carve fire. Both sides start from the JAX ``init_state`` (through
``fit_state_from_jax``), see the same cameras (the same numpy Generator
calls) and the same surface samples (the JAX draws replayed).

Tolerances: losses and buffers fp32 rtol 2e-4 / atol 2e-5; gradients rtol
2e-4 with an atol of 2e-4 of the gradient's largest magnitude (scatters
summed in another order); the state after a step atol 1e-6 in pass 1,
where Adam's first step moves each value by about lr * sign(g) = 1e-2, and
3e-6 after pass 2's second step (lr 1e-4): Adam divides by sqrt(v) + 1e-8,
so an element whose gradient is near 1e-8 and differs in its last bits
moves by a few percent of that lr differently."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshdiffusion_tpu.fitting import fit as JF
from meshdiffusion_tpu.fitting.dataset import TargetRenderer as JTargetRenderer
from meshdiffusion_tpu.fitting.geometry import DMTetFitter as JFitter
from meshdiffusion_tpu.fitting.geometry import FixedTopoFitter as JFixed
from meshdiffusion_tpu.geometry import fit_losses as JL
from meshdiffusion_tpu.geometry.marching_tets import compact_mesh, marching_tets
from meshdiffusion_tpu.render import light as JLight
from meshdiffusion_tpu.render import mesh as JM
from meshdiffusion_tpu_torch.fitting import fit as F
from meshdiffusion_tpu_torch.fitting.dataset import TargetRenderer
from meshdiffusion_tpu_torch.fitting.geometry import DMTetFitter, FixedTopoFitter
from meshdiffusion_tpu_torch.geometry import fit_losses as L
from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid
from meshdiffusion_tpu_torch.render import light as PLight
from meshdiffusion_tpu_torch.render import mesh as PM
from meshdiffusion_tpu_torch.utils.convert import fit_state_from_jax

pytest_plugins = ('torch_rules',)

RTOL, ATOL = 2e-4, 2e-5
RES, BATCH, ITERS = (48, 48), 2, 500


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_grad(got, want):
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=2e-4 * np.abs(want).max())


def replay(*draws):
    """A port ``uniform`` source handing out the given arrays in order."""
    it = iter(draws)

    def uniform(shape):
        a = np.asarray(next(it))
        assert a.shape == tuple(shape), (a.shape, shape)
        return _t(a)
    return uniform


def jax_sample_draws(key, num):
    """The two uniform draws of JAX's sample_points(..., key)."""
    k_face, k_uv = jax.random.split(key)
    return jax.random.uniform(k_face, (num,)), jax.random.uniform(k_uv, (num, 2))


def jax_tick_draws(key):
    """The prediction-sample draws inside JAX's tick(..., key)."""
    return jax_sample_draws(jax.random.split(key)[1], 50000)


# ------------------------------------------------------------------ losses

def test_sample_points_matches_jax():
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(60, 3)).astype(np.float32)
    faces = rng.integers(0, 60, (90, 3)).astype(np.int32)
    mask = rng.random(90) > 0.3
    key = jax.random.key(4)
    want = JL.sample_points(jnp.asarray(verts), jnp.asarray(faces), 3000, key,
                            face_mask=jnp.asarray(mask))
    got = L.sample_points(_t(verts), _t(faces).long(), 3000, replay(*jax_sample_draws(key, 3000)),
                          face_mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(L.face_areas(_t(verts), _t(faces).long()).numpy(),
                               np.asarray(JL.face_areas(jnp.asarray(verts), jnp.asarray(faces))),
                               rtol=1e-5, atol=1e-6)


def test_chamfer_value_and_grads_match_jax():
    """Chunked (chunk 128 < both sizes) so several chunks and the ragged
    last one are exercised; the custom backward against JAX's."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(700, 3)).astype(np.float32)
    b = (rng.normal(size=(900, 3)) * 1.2).astype(np.float32)
    (want, ga), gb = (lambda r: ((r[0], r[1][0]), r[1][1]))(
        jax.value_and_grad(lambda x, y: JL.chamfer_distance(x, y, 128), argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(b)))
    at, bt = _t(a).requires_grad_(), _t(b).requires_grad_()
    got = L.chamfer_distance(at, bt, 128)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _close_grad(at.grad.numpy(), ga)
    _close_grad(bt.grad.numpy(), gb)


def test_sdf_reg_and_laplacian_match_jax():
    rng = np.random.default_rng(2)
    sdf = rng.normal(size=200).astype(np.float32)
    edges = rng.integers(0, 200, (600, 2)).astype(np.int32)
    verts = rng.normal(size=(200, 3)).astype(np.float32)
    for jfn, pfn, x in ((JL.sdf_reg_loss, L.sdf_reg_loss, sdf),
                        (JL.laplacian_uniform, L.laplacian_uniform, verts)):
        want, g = jax.value_and_grad(jfn)(jnp.asarray(x), jnp.asarray(edges))
        xt = _t(x).requires_grad_()
        got = pfn(xt, _t(edges).long())
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        _close_grad(xt.grad.numpy(), g)


def test_marching_tets_carries_gradients(tiny_tet_grid):
    """The port's marching tets is differentiable in the vertex positions
    and the SDF (the fit's geometry gradient), as JAX's is: the gradient of
    a fixed scalar of the crossing-edge vertices against jax.grad."""
    from meshdiffusion_tpu_torch.geometry.marching_tets import marching_tets as port_mt
    jtg = tiny_tet_grid
    tg = TetGrid.from_arrays(jtg.resolution, jtg.verts, jtg.indices)
    rng = np.random.default_rng(3)
    v = (jtg.verts + 0.01 * rng.normal(size=jtg.verts.shape)).astype(np.float32)
    sdf = (0.3 - np.linalg.norm(v, axis=1) + 0.05 * rng.normal(size=len(v))).astype(np.float32)
    w = rng.normal(size=(jtg.unique_edges.shape[0], 3)).astype(np.float32)

    def jloss(vp, s):
        out = marching_tets(jtg, vp, s)
        return jnp.sum(out.verts * w * out.vert_mask[:, None])
    jgv, jgs = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(v), jnp.asarray(sdf))
    vt, st = _t(v).requires_grad_(), _t(sdf).requires_grad_()
    out = port_mt(tg, vt, st)
    (out.verts * _t(w) * out.vert_mask[:, None]).sum().backward()
    _close_grad(vt.grad.numpy(), jgv)
    _close_grad(st.grad.numpy(), jgs)


# --------------------------------------------------------- ticks and steps

@pytest.fixture(scope='module')
def fit_setup(tiny_tet_grid):
    """GT sphere, both renderers, both fitters, the JAX initial state and
    one target of two views for both sides (the port's own GT render, with
    JAX's surface samples)."""
    jtg = tiny_tet_grid
    tg = TetGrid.from_arrays(jtg.resolution, jtg.verts, jtg.indices)
    sdf = 0.3 - np.linalg.norm(jtg.verts, axis=1).astype(np.float32)
    v, f = compact_mesh(marching_tets(jtg, jnp.asarray(jtg.verts), jnp.asarray(sdf)))
    v, f = np.asarray(v, np.float32), np.asarray(f, np.int32)

    jref = JM.Mesh(v_pos=jnp.asarray(v), t_pos_idx=jnp.asarray(f))
    lo, hi = JM.aabb(jref.v_pos)
    jref = JM.auto_normals(JM.center_by_reference(jref, (np.asarray(lo), np.asarray(hi)), 1.0))
    jref.material = JF.default_material()
    jenv = JLight.create_trainable_env_rnd(512, scale=0.0, bias=0.5)
    jenv.build_mips()
    jren = JTargetRenderer(ref_mesh=jref, envlight=jenv, cam_radius=2.0, train_res=RES,
                           num_surface_samples=1000)

    pref = PM.Mesh(v_pos=_t(v), t_pos_idx=_t(f).long())
    pref = PM.auto_normals(PM.center_by_reference(pref, PM.aabb(pref.v_pos), 1.0))
    pref.material = F.default_material()
    penv = PLight.create_trainable_env_rnd(512, scale=0.0, bias=0.5)
    penv.build_mips()
    pren = TargetRenderer(ref_mesh=pref, envlight=penv, cam_radius=2.0, train_res=RES,
                          num_surface_samples=1000)

    cfg = JF.FitConfig(iter=ITERS, batch=BATCH, train_res=RES, dmtet_grid=jtg.resolution,
                       mesh_scale=1.0, surface_samples=1000, raster_K=1024, cam_radius=2.0)
    pcfg = F.FitConfig(iter=ITERS, batch=BATCH, train_res=RES, dmtet_grid=jtg.resolution,
                       mesh_scale=1.0, surface_samples=1000, raster_K=1024, cam_radius=2.0)
    jfit = JFitter(grid=jtg, scale=1.0, total_iter=ITERS)
    pfit = DMTetFitter(grid=tg, scale=1.0, total_iter=ITERS)
    jstate = jfit.init_state(jax.random.key(1))
    jtarget = jren.random_target(BATCH, np.random.default_rng(0), jax.random.key(2))
    ptarget = pren.random_target(BATCH, np.random.default_rng(0))
    ptarget['spts'] = _t(jtarget['spts'])
    return dict(jtg=jtg, tg=tg, jren=jren, pren=pren, cfg=cfg, pcfg=pcfg, jfit=jfit,
                pfit=pfit, jstate=jstate, jtarget=jtarget, ptarget=ptarget)


def _pass2(s, jstate):
    """Pass-2 fitters, frozen states, init vertices and mesh edges, both sides."""
    jfit2 = JFixed(grid=s['jtg'], scale=1.0, deform_scale=3.0, total_iter=ITERS)
    pfit2 = FixedTopoFitter(grid=s['tg'], scale=1.0, deform_scale=3.0, total_iter=ITERS)
    jst2 = jfit2.freeze(jstate.replace(deform=jstate.deform * 2.0 / 3.0))
    pst2 = fit_state_from_jax(jst2)
    jinit = jax.lax.stop_gradient(jfit2.get_mesh(jst2).v_pos)
    occ = np.asarray(jst2.sdf) > 0
    ue = s['jtg'].unique_edges
    crossing = occ[ue[:, 0]] ^ occ[ue[:, 1]]
    adj = np.asarray(JF._mt_vertex_edges(s['jtg']))
    np.testing.assert_array_equal(F._mt_vertex_edges(s['tg']), adj)
    edges = adj[crossing[adj[:, 0]] & crossing[adj[:, 1]]]
    assert len(edges) > 100
    return jfit2, pfit2, jst2, pst2, jinit, edges


def test_target_render_matches_jax(fit_setup):
    """The GT target of two random cameras (the same numpy calls)."""
    jt, pt = fit_setup['jtarget'], fit_setup['ptarget']
    np.testing.assert_array_equal(pt['mvp'].numpy(), np.asarray(jt['mvp']))
    np.testing.assert_array_equal(pt['campos'].numpy(), np.asarray(jt['campos']))
    for k in ('img', 'img_second', 'depth', 'depth_second', 'mask', 'mask_cont', 'normal'):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(jt[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert np.asarray(jt['mask']).mean() > 0.05


@pytest.mark.parametrize('pass_idx', [0, 1])
def test_tick_matches_jax(fit_setup, pass_idx):
    """img_loss, reg_loss and the sdf and deform gradients of one tick
    (pass 1: DMTetFitter.tick, pass 2: FixedTopoFitter.tick_fixed), at
    iteration 120, with shade_cap H*W/4 as the fit step uses."""
    s = fit_setup
    it, key = 120, jax.random.key(3)
    cap = RES[0] * RES[1] // 4
    caps = dict(raster_K=1024, aa=True, shade_cap=cap)
    lossfn, lossfn_p = JF.make_image_loss('logl1'), F.make_image_loss('logl1')
    jmat = JF.default_material()
    tgt = {k: v for k, v in s['jtarget'].items() if not k.startswith('_')}
    if pass_idx == 0:
        jfit, pfit, jst = s['jfit'], s['pfit'], s['jstate']
        pst = fit_state_from_jax(jst)

        def jtick(geo):
            return jfit.tick(jst.replace(**geo), jmat, s['jren'].envlight, tgt,
                             jnp.float32(it), key, lossfn, **caps)[:2]

        def ptick(st, uniform):
            return pfit.tick(st, F.default_material(), s['pren'].envlight, s['ptarget'], it,
                             uniform, lossfn_p, **caps)[:2]
    else:
        jfit, pfit, jst, pst, jinit, edges = _pass2(s, s['jstate'])

        def jtick(geo):
            return jfit.tick_fixed(jst.replace(**geo), jinit, jmat, s['jren'].envlight, tgt,
                                   jnp.float32(it), key, lossfn, jnp.asarray(edges), **caps)[:2]

        def ptick(st, uniform):
            return pfit.tick_fixed(st, _t(jinit), F.default_material(), s['pren'].envlight,
                                   s['ptarget'], it, uniform, lossfn_p, _t(edges).long(), **caps)[:2]

    (_, (jimg, jreg)), jg = jax.jit(jax.value_and_grad(
        lambda g: (lambda r: (r[0] + r[1], r))(jtick(g)), has_aux=True))(
            {'sdf': jst.sdf, 'deform': jst.deform})
    st = pst.replace(sdf=pst.sdf.requires_grad_(), deform=pst.deform.requires_grad_())
    img, reg = ptick(st, replay(*jax_tick_draws(key)))
    (img + reg).backward()
    np.testing.assert_allclose(img.item(), float(jimg), rtol=RTOL)
    np.testing.assert_allclose(reg.item(), float(jreg), rtol=RTOL)
    _close_grad(st.deform.grad.numpy(), jg['deform'])
    _close_grad(st.sdf.grad.numpy(), jg['sdf'])


def _compare_state(pst, jst, atol):
    for k in ('sdf', 'deform', 'sdf_ema', 'sdf_buffer'):
        np.testing.assert_allclose(getattr(pst, k).detach().numpy(), np.asarray(getattr(jst, k)),
                                   rtol=0, atol=atol, err_msg=k)
    assert int(pst.buf_len) == int(jst.buf_len) and int(pst.buf_ptr) == int(jst.buf_ptr)


SMALL_HASH = dict(num_levels=4, log2_hashmap_size=14, desired_resolution=64)


def _materials(monkeypatch):
    """JAX's neural material over the GT's box, every hash level N(0, 0.3^2)
    (a material that varies over the shape), and the port's with the same
    weights. Both packages' hash grid is cut to 4 levels of 2^14 entries,
    16 -> 64 cells a side: the JAX package traces its encoder level by
    level and corner by corner, so at 16 x 2^19 the step's trace takes most
    of the test (``test_torch_textured.py`` holds the full-size encoder)."""
    import functools
    from meshdiffusion_tpu.render import mlptexture as JMLP
    from meshdiffusion_tpu_torch.render import mlptexture as PMLP
    from meshdiffusion_tpu_torch.utils.convert import mlp_texture_state_from_jax
    monkeypatch.setattr(JMLP, 'HashEncoder', functools.partial(JMLP.HashEncoder, **SMALL_HASH))
    monkeypatch.setattr(PMLP, 'HashEncoder', functools.partial(PMLP.HashEncoder, **SMALL_HASH))
    aabb = (np.full(3, -0.5, np.float32), np.full(3, 0.5, np.float32))
    module, params = JF.make_mlp_material(aabb)
    table = params['params']['encoder']['table']
    table = table + 0.3 * jax.random.normal(jax.random.key(3), table.shape)
    params = {'params': {**params['params'], 'encoder': {'table': table}}}
    mat = F.make_mlp_material(aabb, device='cpu')
    mat.load_state_dict({**mat.state_dict(), **mlp_texture_state_from_jax(params)})
    return module, params, mat


def jax_shade_draws(key, batch, shape):
    """The neural material's jitter draws inside JAX's tick(..., key): one
    normal draw a view from the split of the shading key."""
    return [np.asarray(jax.random.normal(k, shape))
            for k in jax.random.split(jax.random.split(key)[0], batch)]


@pytest.mark.parametrize('pass_idx,its,learn_light,textured', [
    (0, (220,), False, False), (0, (300,), False, False), (1, (0, 1), False, False),
    (0, (220,), True, False), (0, (220,), True, True), (1, (0, 1), False, True)])
def test_fit_step_matches_jax(fit_setup, monkeypatch, pass_idx, its, learn_light, textured):
    """Whole fit steps from a fresh Adam: loss, backward, Adam (lr from
    its own update count: pass 2 warms up from 0), then shrink -> carve ->
    clamp -> EMA. Pass 1 at iteration 220 (carve fires) and 300 (shrink
    and carve fire); pass 2 two steps (the sdf gradient zeroed); and pass 1
    with ``learn_light``: the light's cubemap is a second Adam's leaf, its
    gradient x64, clamped at 0 (compared after the step like the state).
    ``textured`` (normal_only False): the candidate is shaded by the neural
    material (its jitter draws JAX's), whose parameters a third Adam
    updates on the material schedule with the encoder's gradient / 8:
    every parameter after the steps, and Adam's first moment of the table
    (where the / 8 shows, as Adam's update itself hardly changes under a
    gradient's scale), against JAX's."""
    import dataclasses
    s = fit_setup
    cfg, pcfg = s['cfg'], s['pcfg']
    mat_module = jparams = mat = jopt_m = popt_m = None
    if textured:
        cfg = dataclasses.replace(cfg, normal_only=False)
        pcfg = dataclasses.replace(pcfg, normal_only=False)
        mat_module, jparams, mat = _materials(monkeypatch)
    if pass_idx == 0:
        jfit, pfit, jst = s['jfit'], s['pfit'], s['jstate']
        pst = fit_state_from_jax(jst)
        jstep, tx, tx_m = JF.make_fit_step(jfit, cfg, s['jren'], mat_module, 0)[:3]
        pstep = F.make_fit_step(pfit, pcfg, s['pren'], 0, mat=mat)
    else:
        jfit, pfit, jst, pst, jinit, edges = _pass2(s, s['jstate'])
        jstep, tx, tx_m = JF.make_fit_step(jfit, cfg, s['jren'], mat_module, 1, jinit,
                                           jnp.asarray(edges))[:3]
        pstep = F.make_fit_step(pfit, pcfg, s['pren'], 1, _t(jinit), _t(edges).long(), mat=mat)
    if textured:
        jopt_m = tx_m.init(jparams)
        popt_m = torch.optim.Adam(mat.parameters(), lr=0.0)
        table0 = mat.encoder.table.detach().numpy().copy()
    opt = tx.init({'sdf': jst.sdf, 'deform': jst.deform})
    pst = pst.replace(sdf=pst.sdf.requires_grad_(), deform=pst.deform.requires_grad_())
    popt = torch.optim.Adam([pst.sdf, pst.deform], lr=0.0)
    jlight = plight = jopt_l = popt_l = None
    if learn_light:
        # a random start: the GT's own constant light would shade the
        # candidate exactly like the target, leaving the light a gradient
        # of rounding noise
        light0 = np.random.default_rng(6).uniform(0.2, 0.8, (6, 64, 64, 3)).astype(np.float32)
        jlight = jnp.asarray(light0)
        jopt_l = JF.make_fit_step(jfit, cfg, s['jren'], None, 0)[3].init(jlight)
        plight = _t(light0).requires_grad_()
        popt_l = torch.optim.Adam([plight], lr=0.0)
    before = np.asarray(jst.sdf).copy()
    cap = (RES[0] * RES[1] // 4, 3)
    for i, it in enumerate(its):
        key = jax.random.key(10 + i)
        jst, jparams, jlight, opt, jopt_m, jopt_l, jm = jstep(
            jst, jparams, jlight, opt, jopt_m, jopt_l, s['jtarget'], jnp.asarray(it, jnp.float32),
            key)
        pst, pm = pstep(pst, plight, popt, popt_l, s['ptarget'], it,
                        replay(*jax_tick_draws(key)), popt_m,
                        replay(*jax_shade_draws(key, BATCH, cap)))
        np.testing.assert_allclose(float(pm['total']), float(jm['total']), rtol=RTOL)
        for k in ('raster_overflow', 'raster_overflow_global', 'raster_overflow_live',
                  'shade_overflow', 'aa_overflow'):
            assert int(pm[k]) == int(jm[k]), k
    _compare_state(pst, jst, 1e-6 if pass_idx == 0 else 3e-6)
    if learn_light:
        moved = np.abs(np.asarray(jlight) - light0).max()
        assert moved > 1e-3, moved
        np.testing.assert_allclose(plight.detach().numpy(), np.asarray(jlight), rtol=0, atol=1e-6)
    if textured:
        # the MLP's weights as the state; the table, whose gradient entries
        # sum many pixels' contributions with cancellation (and many lie
        # within Adam's eps, where its step rests on their last bits), by
        # relative L2 of its update and of Adam's first moment, which
        # carries the / 8 (an unscaled gradient would be 700 % off)
        for i in range(3):
            np.testing.assert_allclose(getattr(mat, f'dense_{i}').weight.detach().numpy().T,
                                       np.asarray(jparams['params'][f'dense_{i}']['kernel']),
                                       rtol=0, atol=1e-6)
        t_got = mat.encoder.table.detach().numpy() - table0
        t_want = np.asarray(jparams['params']['encoder']['table']) - table0
        assert np.linalg.norm(t_want) > 0.1 or pass_idx == 1
        assert np.linalg.norm(t_got - t_want) <= 1e-3 * np.linalg.norm(t_want)
        mu = popt_m.state[mat.encoder.table]['exp_avg'].numpy()
        mu_want = np.asarray(jopt_m[0].mu['params']['encoder']['table'])
        assert np.linalg.norm(mu - mu_want) <= 2e-4 * np.linalg.norm(mu_want)
        assert F._count(popt_m) == len(its)
    if pass_idx == 0:
        assert (np.asarray(jst.sdf) == np.float32(1e-2)).sum() > 10     # carved
    else:
        np.testing.assert_array_equal(np.asarray(jst.sdf), before)     # topology frozen
    assert F._count(popt) == len(its)


def test_fit_step_flat_aa_matches_jax(fit_setup, monkeypatch):
    """A pass-1 step (iteration 220) with the dense all-views edge AA,
    MESHDIFFUSION_AA_IMPL=flat, in both packages: the same checks as
    :func:`test_fit_step_matches_jax`; aa_overflow is 0 on both sides, so
    the fit driver's aa_budget regrow stays idle."""
    monkeypatch.setenv('MESHDIFFUSION_AA_IMPL', 'flat')
    test_fit_step_matches_jax(fit_setup, monkeypatch, 0, (220,), False, False)
