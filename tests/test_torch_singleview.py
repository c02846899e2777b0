"""The port's single-view fitting against the JAX package, on the CPU, on
the tiny tet grid (n = 8) at 48^2: ``knn_dist``, ``tet_centers``,
``visible_tets``, the GT-surface bootstrap and the occluded carve (sdf
exact), one ``SingleViewFitter.tick`` (losses and gradients), one whole
single-view step from a fresh Adam either side of the deform freeze
(iterations 50 and 150), and ``extract_visibility``'s ``vis`` and
``vis_rast`` (exact). Both sides start from the JAX ``init_state`` and see
the JAX target's surface samples; the fixed view is the validation pose
``rotate_camera(angle_ind)``, bit-equal on both sides.

Tolerances as ``tests/test_torch_fit.py``: losses fp32 rtol 2e-4;
gradients rtol 2e-4 with an atol of 2e-4 of the gradient's largest
magnitude. The state after one step: Adam's first step moves a value by
lr g / (|g| + 1e-8), lr = 1e-2, which turns a gradient difference dg into
lr 1e-8 dg / |g|^2: at iteration 150 one sdf gradient is 5.4e-7 (the
largest 0.19), where gradients 1e-9 apart move it 4e-6 apart, and a few
deform gradients are near 1e-8, where the step is ill-conditioned. So
after one step, values whose JAX gradient is at least 1e-5 (1e-8 then
weighs under 1e-3 of it) are held at atol 1e-5; after 99 and 100, deform so (its first gradient was zero, so
its second step is well-conditioned), the sdf, whose gradients may flip
sign and cancel in Adam's mean, only at 2 lr a step as every value is
(both are Adam steps); the sign snapshot (sdf_ema) exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from meshdiffusion_tpu.fitting import fit as JF
from meshdiffusion_tpu.fitting import singleview as JSV
from meshdiffusion_tpu.fitting.dataset import TargetRenderer as JTargetRenderer
from meshdiffusion_tpu.geometry import fit_losses as JL
from meshdiffusion_tpu.geometry.marching_tets import compact_mesh, marching_tets
from meshdiffusion_tpu.render import light as JLight
from meshdiffusion_tpu.render import mesh as JM
from meshdiffusion_tpu.render.render import visible_tets as jax_visible_tets
from meshdiffusion_tpu_torch.fitting import fit as F
from meshdiffusion_tpu_torch.fitting import singleview as SV
from meshdiffusion_tpu_torch.fitting.dataset import TargetRenderer
from meshdiffusion_tpu_torch.geometry import fit_losses as L
from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid
from meshdiffusion_tpu_torch.render import light as PLight
from meshdiffusion_tpu_torch.render import mesh as PM
from meshdiffusion_tpu_torch.render.render import visible_tets
from meshdiffusion_tpu_torch.utils.convert import fit_state_from_jax

from test_torch_fit import _close_grad, _t, jax_tick_draws, replay

pytest_plugins = ('torch_rules',)

RTOL = 2e-4
RES, ITERS, ANGLE = (48, 48), 500, 10


def test_knn_dist_matches_jax():
    """k = 1 and 3 over chunks of 128 with a ragged, padded last one."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(700, 3)).astype(np.float32)
    q = rng.normal(size=(300, 3)).astype(np.float32)
    for k in (1, 3):
        want = np.asarray(JL.knn_dist(jnp.asarray(pts), jnp.asarray(q), k=k, chunk=128))
        got = L.knn_dist(_t(pts), _t(q), k=k, chunk=128).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope='module')
def sv(tiny_tet_grid):
    """GT sphere, both renderers (display_res = train_res), both fitters,
    the JAX initial state and the fixed view's target of both sides (the
    port's own GT render, with JAX's surface samples)."""
    jtg = tiny_tet_grid
    tg = TetGrid.from_arrays(jtg.resolution, jtg.verts, jtg.indices)
    sphere = 0.3 - np.linalg.norm(jtg.verts, axis=1).astype(np.float32)
    v, f = compact_mesh(marching_tets(jtg, jnp.asarray(jtg.verts), jnp.asarray(sphere)))
    v, f = np.asarray(v, np.float32), np.asarray(f, np.int32)

    jref = JM.Mesh(v_pos=jnp.asarray(v), t_pos_idx=jnp.asarray(f))
    lo, hi = JM.aabb(jref.v_pos)
    jref = JM.auto_normals(JM.center_by_reference(jref, (np.asarray(lo), np.asarray(hi)), 1.0))
    jref.material = JF.default_material()
    jenv = JLight.create_trainable_env_rnd(512, scale=0.0, bias=0.5)
    jenv.build_mips()
    jren = JTargetRenderer(ref_mesh=jref, envlight=jenv, cam_radius=2.0, train_res=RES,
                           display_res=RES, num_surface_samples=1000)

    pref = PM.Mesh(v_pos=_t(v), t_pos_idx=_t(f).long())
    pref = PM.auto_normals(PM.center_by_reference(pref, PM.aabb(pref.v_pos), 1.0))
    pref.material = F.default_material()
    penv = PLight.create_trainable_env_rnd(512, scale=0.0, bias=0.5)
    penv.build_mips()
    pren = TargetRenderer(ref_mesh=pref, envlight=penv, cam_radius=2.0, train_res=RES,
                          display_res=RES, num_surface_samples=1000)

    jfit = JSV.SingleViewFitter(grid=jtg, scale=1.0, total_iter=ITERS)
    pfit = SV.SingleViewFitter(grid=tg, scale=1.0, total_iter=ITERS)
    jstate = jfit.init_state(jax.random.key(1))
    jcam, pcam = jren.rotate_camera(ANGLE), pren.rotate_camera(ANGLE)
    jtarget = jren.render_target(jnp.asarray(jcam[1]), jnp.asarray(jcam[2]), jax.random.key(2))
    ptarget = pren.render_target(pcam[1], pcam[2])
    ptarget['spts'] = _t(jtarget['spts'])
    return dict(jtg=jtg, tg=tg, jref=jref, pref=pref, jren=jren, pren=pren, jfit=jfit,
                pfit=pfit, jstate=jstate, jcam=jcam, pcam=pcam, jtarget=jtarget,
                ptarget=ptarget, sphere=sphere)


def test_rotate_camera_and_tet_centers_match_jax(sv):
    for a, b in zip(sv['pcam'], sv['jcam']):
        np.testing.assert_array_equal(a, b)
    pst = fit_state_from_jax(sv['jstate'])
    np.testing.assert_allclose(sv['pfit'].tet_centers(pst).numpy(),
                               np.asarray(sv['jfit'].tet_centers(sv['jstate'])),
                               rtol=1e-6, atol=1e-7)
    for k in ('img', 'depth', 'mask_cont'):
        np.testing.assert_allclose(sv['ptarget'][k].numpy(), np.asarray(sv['jtarget'][k]),
                                   rtol=RTOL, atol=2e-5, err_msg=k)


def test_visible_tets_matches_jax(sv):
    """The 15x15 min-depth window test on the target's depth image, empty
    pixels at 100: visible where no surface is nearer or the whole window
    is empty."""
    jt, (_, mvp, campos) = sv['jtarget'], sv['jcam']
    centers = np.asarray(sv['jfit'].tet_centers(sv['jstate']))
    depth = np.asarray(jt['depth'])
    valid = np.asarray(jt['mask'])[..., 0] > 0
    want = np.asarray(jax_visible_tets(jnp.asarray(centers), jnp.asarray(mvp),
                                       jnp.asarray(campos), jnp.asarray(depth),
                                       jnp.asarray(valid), RES))
    got = visible_tets(_t(centers), _t(mvp), _t(campos), _t(depth), _t(valid), RES).numpy()
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(got, want)


def test_bootstrap_and_carve_match_jax(sv):
    """init_with_gt_surface (chunks of 64 over the GT face centres, so the
    strictly-smaller merge across chunks runs) and carve_occluded at
    iteration 220 (it fires) against JAX: the sdf exact."""
    jfit, pfit, jst = sv['jfit'], sv['pfit'], sv['jstate']
    jref, pref = sv['jref'], sv['pref']
    campos = sv['jcam'][2][0]
    want = jfit.init_with_gt_surface(jst, jref.v_pos, jref.t_pos_idx, jnp.asarray(campos))
    got = pfit.init_with_gt_surface(fit_state_from_jax(jst), pref.v_pos, pref.t_pos_idx,
                                    _t(campos), chunk=64)
    assert pref.t_pos_idx.shape[0] > 64
    flipped = (np.asarray(want.sdf) != np.asarray(jst.sdf)).sum()
    assert flipped > 10, flipped
    np.testing.assert_array_equal(got.sdf.numpy(), np.asarray(want.sdf))

    jt = sv['jtarget']
    target = {'mvp': _t(jt['mvp']), 'img': _t(jt['img']), 'mask_cont': _t(jt['mask_cont'])}
    for it in (220, 221):
        want_c = jfit.carve_occluded(want, jt, jnp.float32(it))
        got_c = pfit.carve_occluded(got, target, it)
        np.testing.assert_array_equal(got_c.sdf.numpy(), np.asarray(want_c.sdf))
    carved = (np.asarray(jfit.carve_occluded(want, jt, jnp.float32(220)).sdf)
              != np.asarray(want.sdf)).sum()
    assert carved > 0, carved


def test_tick_matches_jax(sv):
    """img_loss, reg_loss and the sdf and deform gradients of one
    single-view tick at iteration 120 (raster_K 1024: no overflow)."""
    jfit, pfit, jst = sv['jfit'], sv['pfit'], sv['jstate']
    it, key = 120, jax.random.key(3)
    lossfn = JF.make_image_loss('logl1')
    tgt = dict(sv['jtarget'])

    def jtick(geo):
        img, reg, _ = jfit.tick(jst.replace(**geo), JF.default_material(), sv['jren'].envlight,
                                tgt, jnp.float32(it), key, lossfn, raster_K=1024)
        return img + reg, (img, reg)
    (_, (jimg, jreg)), jg = jax.jit(jax.value_and_grad(jtick, has_aux=True))(
        {'sdf': jst.sdf, 'deform': jst.deform})
    pst = fit_state_from_jax(jst)
    st = pst.replace(sdf=pst.sdf.requires_grad_(), deform=pst.deform.requires_grad_())
    img, reg, bufs = pfit.tick(st, F.default_material(), sv['pren'].envlight, sv['ptarget'], it,
                               replay(*jax_tick_draws(key)), F.make_image_loss('logl1'),
                               raster_K=1024)
    (img + reg).backward()
    assert int(bufs['raster_overflow']) == 0
    np.testing.assert_allclose(img.item(), float(jimg), rtol=RTOL)
    np.testing.assert_allclose(reg.item(), float(jreg), rtol=RTOL)
    _close_grad(st.deform.grad.numpy(), jg['deform'])
    _close_grad(st.sdf.grad.numpy(), jg['sdf'])


@pytest.mark.parametrize('its', [(50,), (150,), (99, 100)])
def test_singleview_step_matches_jax(sv, its):
    """Steps of fit_singleview from a fresh Adam (its loop body,
    singleview.py:245-264, built here from the JAX package's pieces): at
    iteration 50 the deform gradient is zeroed, at 150 it is not; 99 then
    100 crosses the freeze, where a dropped (None) gradient would leave
    deform's Adam count behind and change its bias correction."""
    jfit, pfit, jst = sv['jfit'], sv['pfit'], sv['jstate']
    cfg = F.FitConfig(iter=ITERS, train_res=RES, dmtet_grid=8, mesh_scale=1.0,
                      surface_samples=1000, raster_K=1024, cam_radius=2.0)
    lossfn = JF.make_image_loss(cfg.loss)
    tx = optax.adam(JF.lr_schedule(cfg.learning_rate[0]))
    tgt = dict(sv['jtarget'])

    def loss_fn(leaves, state, iteration, k):
        img, reg, _ = jfit.tick(state.replace(**leaves), JF.default_material(),
                                sv['jren'].envlight, tgt, iteration, k, lossfn,
                                raster_K=cfg.raster_K)
        return img + reg, (img, reg)

    @jax.jit
    def jstep(state, opt, iteration, k):
        leaves = {'sdf': state.sdf, 'deform': state.deform}
        (_, (img, reg)), g = jax.value_and_grad(loss_fn, has_aux=True)(leaves, state,
                                                                       iteration, k)
        g['deform'] = jnp.where(iteration < 100, jnp.zeros_like(g['deform']), g['deform'])
        up, opt = tx.update(g, opt, leaves)
        leaves = optax.apply_updates(leaves, up)
        state = state.replace(**leaves)
        state = jfit.shrink_deform(state, iteration)
        state = jfit.carve_occluded(state, tgt, iteration)
        state = jfit.update_ema(jfit.clamp(state))
        return state, opt, img, reg, g

    jopt = tx.init({'sdf': jst.sdf, 'deform': jst.deform})
    pnew = fit_state_from_jax(jst)
    pnew = pnew.replace(sdf=pnew.sdf.requires_grad_(), deform=pnew.deform.requires_grad_())
    opt = torch.optim.Adam([pnew.sdf, pnew.deform], lr=0.0)
    step = SV.make_singleview_step(pfit, cfg, sv['pren'])
    jnew = jst
    for it in its:
        key = jax.random.key(20 + it)
        jnew, jopt, jimg, jreg, jg = jstep(jnew, jopt, jnp.float32(it), key)
        pnew, metrics = step(pnew, opt, sv['ptarget'], it, replay(*jax_tick_draws(key)))
        np.testing.assert_allclose(float(metrics['img_loss']), float(jimg), rtol=RTOL)
        np.testing.assert_allclose(float(metrics['reg_loss']), float(jreg), rtol=RTOL)
    for k in ('sdf', 'deform'):
        got, want = getattr(pnew, k).detach().numpy(), np.asarray(getattr(jnew, k))
        if k == 'deform' and its[-1] < 100:
            np.testing.assert_array_equal(got, want)        # frozen: zero gradient
            continue
        if k == 'sdf' and len(its) > 1:
            continue        # two real steps: a gradient that flips sign cancels in Adam's mean
        firm = np.abs(np.asarray(jg[k])) >= 1e-5
        assert firm.mean() > 0.25, firm.mean()
        np.testing.assert_allclose(got[firm], want[firm], rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * cfg.learning_rate[0], err_msg=k)
    np.testing.assert_array_equal(pnew.sdf_ema.numpy(), np.asarray(jnew.sdf_ema))
    moved = np.abs(np.asarray(jnew.deform) - np.asarray(jst.deform)).max()
    assert (moved == 0) == (its[-1] < 100), moved
    assert F._count(opt) == opt.state[pnew.deform]['step'] == len(its)
