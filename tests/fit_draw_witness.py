"""How far the fit-quality numbers depend on the initial draw, in both
packages, on the CPU.

The JAX package's fit gate (tests/test_fit_convergence.py
``test_pass1_fit_converges``) and its AA ablation (tools/aa_ablation.py
``run_arm``) each fit from one initial sdf, drawn from ``jax.random.key(1)``.
This script reruns them, unchanged, with ``DMTetFitter.init_state`` drawing
from other keys, and runs the port's ablation arm (``chip_smoke.ablation_arm``)
from JAX's own initial sdf, its chamfer measured both by the port's sampler
and by JAX's (the points of ``jax.random.key(3)`` on the fitted mesh, of
``key(2)`` on the GT, as ``run_arm`` samples them).

    python tests/fit_draw_witness.py jax-gate 1 2 3 4 5 6 7 8
    python tests/fit_draw_witness.py jax-ablation 1 2 3 4
    python tests/fit_draw_witness.py port-gate jax:1 torch:1
    python tests/fit_draw_witness.py port-ablation jax:1 torch:1
    python tests/fit_draw_witness.py cd0 64
    python tests/fit_draw_witness.py paired-gate 1 2

Each prints one JSON line per run: minutes a fit, on the CPU only. ``cd0 N``
(seconds) gives the gate's starting chamfer over N draws: JAX's keys 1..N
measured by JAX, the same initial sdfs measured by the port, and the port's
CPU seeds 1..N. ``paired-gate k`` runs JAX's gate and the port's in lockstep
on the same draws (JAX's initial sdf of key k, its GT surface samples and
prediction samples replayed into the port, the same cameras, capacities
grown as JAX's gate grows them), and reports how far the two fits drift
apart."""

import contextlib
import copy
import io
import json
import os
import re
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, '..'))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, '..', 'tools'))


def _jax_cpu():
    import jax
    jax.config.update('jax_platforms', 'cpu')
    return jax


@contextlib.contextmanager
def _init_key(k: int):
    """JAX's ``DMTetFitter.init_state`` drawing from ``jax.random.key(k)``,
    whatever key its caller passes."""
    jax = _jax_cpu()
    from meshdiffusion_tpu.fitting.geometry import DMTetFitter
    orig = DMTetFitter.init_state
    DMTetFitter.init_state = lambda self, key: orig(self, jax.random.key(k))
    try:
        yield
    finally:
        DMTetFitter.init_state = orig


@contextlib.contextmanager
def _gt_obj_in(work: str):
    """``run_arm`` writes and reads its GT at a fixed temp path: keep it in
    ``work``."""
    from meshdiffusion_tpu.fitting import fit as F
    from meshdiffusion_tpu.geometry import obj_io
    w, ld = obj_io.write_obj, F.obj_mod.load_mesh
    fix = lambda p: os.path.join(work, os.path.basename(p))
    obj_io.write_obj = lambda p, *a, **kw: w(fix(p), *a, **kw)
    F.obj_mod.load_mesh = lambda p, *a, **kw: ld(fix(p), *a, **kw)
    try:
        yield
    finally:
        obj_io.write_obj, F.obj_mod.load_mesh = w, ld


def jax_gate(k: int) -> dict:
    """JAX's ``test_pass1_fit_converges`` with its initial sdf from key
    ``k``: its MEASURED line and the thresholds it missed."""
    import pathlib
    _jax_cpu()
    import conftest
    import test_fit_convergence as T
    tg = conftest.tiny_tet_grid.__wrapped__()
    buf, missed = io.StringIO(), None
    with tempfile.TemporaryDirectory() as work, _init_key(k), contextlib.redirect_stdout(buf):
        try:
            T.test_pass1_fit_converges(tg, pathlib.Path(work))
        except AssertionError as e:
            missed = str(e)
    vals = dict(re.findall(r'(\w+)=([0-9.]+)', buf.getvalue().split('MEASURED')[1]))
    r = {k2: float(v) for k2, v in vals.items()}
    r.update(ratio=r['cd1'] / r['cd0'], img_ratio=r['img_last_q'] / r['img_first_q'],
             missed=missed)
    return r


def jax_ablation(k: int, aa: bool = True, iters: int = 150) -> dict:
    """JAX's ``run_arm`` with its initial sdf from key ``k``."""
    _jax_cpu()
    import aa_ablation
    with tempfile.TemporaryDirectory() as work, _init_key(k), _gt_obj_in(work):
        cd, psnr = aa_ablation.run_arm(aa, iters)
    return {'chamfer': cd, 'psnr_db': float(psnr)}


def _jax_sdf(k: int, dev):
    """JAX's initial sdf of ``jax.random.key(k)`` on the tests' grid, as a
    torch tensor on ``dev``."""
    import numpy as np
    import torch
    jax = _jax_cpu()
    import conftest
    from meshdiffusion_tpu.fitting.geometry import DMTetFitter
    fitter = DMTetFitter(grid=conftest.tiny_tet_grid.__wrapped__(), scale=1.0)
    return torch.from_numpy(np.array(fitter.init_state(jax.random.key(k)).sdf)).to(dev)


@contextlib.contextmanager
def _port_init(init: str):
    """The port's gate and ablation (``chip_smoke._gate_draws``) starting
    from ``init``: ``jax:k`` (JAX's initial sdf of key k, the rest of the
    draws from the CPU generator seeded 1) or ``torch:s`` (the CPU
    generator seeded s, as the gate draws). Yields the seed to pass."""
    import chip_smoke
    src, n = init.split(':')
    draws = chip_smoke._gate_draws

    def jax_draws(fitter, dev, seed):
        gen, uniform, state = draws(fitter, dev, seed)
        sdf = _jax_sdf(int(n), dev)
        return gen, uniform, state.replace(sdf=sdf, sdf_ema=sdf.clone())

    if src == 'jax':
        chip_smoke._gate_draws = jax_draws
    try:
        yield int(n) if src == 'torch' else 1
    finally:
        chip_smoke._gate_draws = draws


def port_gate(init: str) -> dict:
    """The port's gate (``chip_smoke.fit_gate``, compact AA) on the CPU
    from ``init`` (see :func:`_port_init`)."""
    import torch
    import chip_smoke
    torch.set_num_threads(4)
    with tempfile.TemporaryDirectory() as work, _port_init(init) as seed:
        r = chip_smoke.fit_gate(chip_smoke.tiny_tet_grid(), work, torch.device('cpu'), seed)
    keep = ('cd0', 'cd1', 'img_first_q', 'img_last_q', 'fit_s')
    out = {k: r[k] for k in keep}
    out.update(ratio=r['cd1'] / r['cd0'], img_ratio=r['img_last_q'] / r['img_first_q'])
    return out


def cd0_census(n: int) -> dict:
    """The gate's starting chamfer over ``n`` draws: JAX's (keys 1..n, its
    test's sampling keys), the port's on JAX's same initial sdfs, and the
    port's own (CPU seeds 1..n)."""
    import pathlib
    import numpy as np
    import torch
    import chip_smoke
    jax = _jax_cpu()
    import jax.numpy as jnp
    import conftest
    from meshdiffusion_tpu.fitting import fit as JF
    from meshdiffusion_tpu.fitting.geometry import DMTetFitter as JFitter
    from meshdiffusion_tpu.geometry.fit_losses import chamfer_distance, sample_points
    from meshdiffusion_tpu.geometry.marching_tets import compact_mesh, marching_tets
    from meshdiffusion_tpu.geometry.obj_io import write_obj
    from meshdiffusion_tpu.render import mesh as jmesh
    from meshdiffusion_tpu_torch.fitting.geometry import DMTetFitter
    from meshdiffusion_tpu_torch.geometry.fit_losses import sample_points as port_sample
    jtg = conftest.tiny_tet_grid.__wrapped__()
    dev = torch.device('cpu')
    out = {'jax': [], 'port_on_jax_sdf': [], 'port': []}
    with tempfile.TemporaryDirectory() as work:
        sdf_gt = np.linalg.norm(jtg.verts, axis=1).astype(np.float32) - 0.3
        v, f = compact_mesh(marching_tets(jtg, jnp.asarray(jtg.verts), jnp.asarray(sdf_gt)))
        path = str(pathlib.Path(work) / 'gt.obj')
        write_obj(path, np.asarray(v), np.asarray(f))
        ref = JF.obj_mod.load_mesh(path)
        lo, hi = jmesh.aabb(ref.v_pos)
        ref = jmesh.center_by_reference(ref, (np.asarray(lo), np.asarray(hi)), 1.0)
        gt_pts = sample_points(ref.v_pos, ref.t_pos_idx, 2000, jax.random.key(2))
        jfit = JFitter(grid=jtg, scale=1.0, deform_scale=2.0, sdf_regularizer=0.2,
                       total_iter=120, buffer_capacity=50)
        for k in range(1, n + 1):
            m = jfit.get_mesh(jfit.init_state(jax.random.key(k)))
            pts = sample_points(m.v_pos, m.t_pos_idx, 2000, jax.random.key(3),
                                face_mask=m.face_mask)
            out['jax'].append(float(chamfer_distance(pts, gt_pts)))
        ref_t, _ = chip_smoke._gate_reference(chip_smoke.tiny_tet_grid(), work, dev)
        fitter = DMTetFitter(grid=chip_smoke.tiny_tet_grid(), scale=1.0, deform_scale=2.0,
                             sdf_regularizer=0.2, total_iter=120, buffer_capacity=50)
        for k in range(1, n + 1):
            gen, uniform, state = chip_smoke._gate_draws(fitter, dev, k)
            gt_t = port_sample(ref_t.v_pos, ref_t.t_pos_idx, 2000, uniform)
            out['port'].append(chip_smoke._chamfer_to(fitter, state, gt_t, uniform))
            sdf = _jax_sdf(k, dev)
            out['port_on_jax_sdf'].append(chip_smoke._chamfer_to(
                fitter, state.replace(sdf=sdf, sdf_ema=sdf), gt_t, uniform))
    return {name: {'mean': float(np.mean(x)), 'median': float(np.median(x)),
                   'min': float(np.min(x)), 'max': float(np.max(x)),
                   'below_0.04': int(np.sum(np.array(x) < 0.04))}
            for name, x in out.items()}


def paired_gate(k: int, iters: int = 120) -> dict:
    """JAX's gate (``test_pass1_fit_converges``, its initial sdf from key
    ``k``) and the port's on the CPU, step by step on the same draws: the
    largest sdf difference at a few iterations, the image losses' quartiles
    and the final chamfers, both measured by JAX's sampler."""
    import dataclasses
    import numpy as np
    import torch
    import chip_smoke
    jax = _jax_cpu()
    import jax.numpy as jnp
    import conftest
    from test_torch_fit import jax_tick_draws, replay
    from meshdiffusion_tpu.fitting import fit as JF
    from meshdiffusion_tpu.fitting.dataset import TargetRenderer as JRenderer
    from meshdiffusion_tpu.fitting.geometry import DMTetFitter as JFitter
    from meshdiffusion_tpu.geometry.fit_losses import chamfer_distance, sample_points
    from meshdiffusion_tpu.render import light as jlight
    from meshdiffusion_tpu.render import mesh as jmesh
    from meshdiffusion_tpu_torch.fitting import fit as F
    from meshdiffusion_tpu_torch.fitting.dataset import TargetRenderer
    from meshdiffusion_tpu_torch.fitting.geometry import DMTetFitter
    from meshdiffusion_tpu_torch.utils.convert import fit_state_from_jax
    torch.set_num_threads(4)
    dev = torch.device('cpu')
    jtg, tg = conftest.tiny_tet_grid.__wrapped__(), chip_smoke.tiny_tet_grid()
    res = (48, 48)
    with tempfile.TemporaryDirectory() as work:
        pref, penv = chip_smoke._gate_reference(tg, work, dev)
        jref = JF.obj_mod.load_mesh(os.path.join(work, 'gt_sphere.obj'))
    lo, hi = jmesh.aabb(jref.v_pos)
    jref = jmesh.auto_normals(jmesh.center_by_reference(jref, (np.asarray(lo), np.asarray(hi)),
                                                        1.0))
    jref.material = JF.default_material()
    jenv = jlight.create_trainable_env_rnd(64, scale=0.0, bias=0.5)
    jenv.build_mips()
    kw = dict(iter=iters, batch=1, train_res=res, dmtet_grid=jtg.resolution, mesh_scale=1.0,
              surface_samples=2000, raster_K=256, normal_only=True, learn_light=True,
              cam_radius=2.0)
    jcfg, pcfg = JF.FitConfig(**kw), F.FitConfig(**kw)
    fkw = dict(scale=1.0, deform_scale=2.0, sdf_regularizer=0.2, total_iter=iters,
               buffer_capacity=50)
    jfit, pfit = JFitter(grid=jtg, **fkw), DMTetFitter(grid=tg, **fkw)
    jren = JRenderer(ref_mesh=jref, envlight=jenv, cam_radius=2.0, train_res=res,
                     num_surface_samples=2000, target_pool=8)
    pren = TargetRenderer(ref_mesh=pref, envlight=penv, cam_radius=2.0, train_res=res,
                          num_surface_samples=2000, target_pool=8,
                          generator=torch.Generator().manual_seed(0))
    jst = jfit.init_state(jax.random.key(k))
    pst = fit_state_from_jax(jst)
    pst = pst.replace(sdf=pst.sdf.requires_grad_(), deform=pst.deform.requires_grad_())
    jstep, tx_geo, _, tx_lgt = JF.make_fit_step(jfit, jcfg, jren, None, 0)
    jopt = tx_geo.init({'sdf': jst.sdf, 'deform': jst.deform})
    jlb = jenv.base
    jopt_l = tx_lgt.init(jlb)
    popt = torch.optim.Adam([pst.sdf, pst.deform], lr=0.0)
    plb = penv.base.detach().clone().requires_grad_()
    popt_l = torch.optim.Adam([plb], lr=0.0)
    pstep = F.make_fit_step(pfit, pcfg, pren, 0)
    key, jrng, prng = jax.random.key(0), np.random.default_rng(0), np.random.default_rng(0)
    jimg, pimg, drift, it, regrows = [], [], {}, 0, 0
    while it < iters:
        key, k_t, k_s = jax.random.split(key, 3)
        jt = jren.random_target(1, jrng, k_t)
        pt = pren.random_target(1, prng)
        np.testing.assert_allclose(pt['mvp'].numpy(), np.asarray(jt['mvp']), rtol=1e-5, atol=1e-6)
        pt['spts'] = torch.from_numpy(np.array(jt['spts']))
        new = jstep(jst, None, jlb, jopt, None, jopt_l, jt, jnp.asarray(it, jnp.float32), k_s)
        over, sh = int(new[6]['raster_overflow']), int(new[6]['shade_overflow'])
        saved = (pst, pst.sdf.detach().clone(), pst.deform.detach().clone(),
                 copy.deepcopy(popt.state_dict()), plb.detach().clone(),
                 copy.deepcopy(popt_l.state_dict()))
        pnew, pm = pstep(pst, plb, popt, popt_l, pt, it, replay(*jax_tick_draws(k_s)))
        if over > 0 or sh > 0:
            # JAX's gate's regrow, on both sides; the port's step undone
            st, sdf, deform, sd, lb, sdl = saved
            with torch.no_grad():
                st.sdf.copy_(sdf)
                st.deform.copy_(deform)
                plb.copy_(lb)
            popt.load_state_dict(sd)
            popt_l.load_state_dict(sdl)
            pst = st
            upd = {}
            if over > 0:
                need, newk = jcfg.raster_K + over, jcfg.raster_K
                while newk < need:
                    newk *= 2
                upd['raster_K'] = newk
            if sh > 0:
                cur = res[0] * res[1] // 4 if jcfg.shade_cap < 0 else jcfg.shade_cap
                newc = cur
                while newc < cur + sh:
                    newc *= 2
                upd['shade_cap'] = min(newc, res[0] * res[1])
            jcfg, pcfg = dataclasses.replace(jcfg, **upd), dataclasses.replace(pcfg, **upd)
            jstep = JF.make_fit_step(jfit, jcfg, jren, None, 0)[0]
            pstep = F.make_fit_step(pfit, pcfg, pren, 0)
            regrows += 1
            assert regrows < 10
            continue
        jst, _, jlb, jopt, _, jopt_l, jm = new
        pst = pnew
        jimg.append(float(jm['img_loss']))
        pimg.append(float(pm['img_loss']))
        it += 1
        if it in (1, 10, 30, 60, 120):
            drift[it] = float(np.abs(pst.sdf.detach().numpy() - np.asarray(jst.sdf)).max())
    gt_pts = sample_points(jref.v_pos, jref.t_pos_idx, 2000, jax.random.key(2))

    def cd(v, f, mask):
        pts = sample_points(jnp.asarray(v), jnp.asarray(f, jnp.int32), 2000, jax.random.key(3),
                            face_mask=jnp.asarray(mask))
        return float(chamfer_distance(pts, gt_pts))

    jm0, jm1, pm1 = jfit.get_mesh(jfit.init_state(jax.random.key(k))), jfit.get_mesh(jst), \
        pfit.get_mesh(pst)
    q = iters // 4
    return {'jax_cd0': cd(jm0.v_pos, jm0.t_pos_idx, jm0.face_mask),
            'jax_cd1': cd(jm1.v_pos, jm1.t_pos_idx, jm1.face_mask),
            'port_cd1': cd(pm1.v_pos.detach().numpy(), pm1.t_pos_idx.numpy(),
                           pm1.face_mask.numpy()),
            'jax_img_q': [float(np.mean(jimg[:q])), float(np.mean(jimg[-q:]))],
            'port_img_q': [float(np.mean(pimg[:q])), float(np.mean(pimg[-q:]))],
            'sdf_max_abs_diff_at': drift, 'regrows': regrows}


def port_ablation(init: str, aa: bool = True) -> dict:
    """The port's ablation arm on the CPU from ``init``: ``jax:k`` (JAX's
    initial sdf of key k) or ``torch:s`` (the port's CPU generator seeded
    s). Its chamfer by the port's sampler, and by JAX's on the same
    fitted mesh."""
    import numpy as np
    import torch
    import chip_smoke
    jax = _jax_cpu()
    import jax.numpy as jnp
    from meshdiffusion_tpu.fitting import fit as JF
    from meshdiffusion_tpu.geometry.fit_losses import chamfer_distance, sample_points
    from meshdiffusion_tpu.render import mesh as jmesh
    torch.set_num_threads(4)
    fitted = {}

    chamfer_to = chip_smoke._chamfer_to

    def keep(fitter, state, gt_pts, uniform):
        fitted['mesh'] = fitter.get_mesh(state)
        return chamfer_to(fitter, state, gt_pts, uniform)

    chip_smoke._chamfer_to = keep
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as work, _port_init(init) as seed:
            cd, psnr, _ = chip_smoke.ablation_arm(chip_smoke.tiny_tet_grid(), work,
                                                  torch.device('cpu'), aa, seed=seed)
            ref = JF.obj_mod.load_mesh(os.path.join(work, 'gt_sphere.obj'))
    finally:
        chip_smoke._chamfer_to = chamfer_to
    lo, hi = jmesh.aabb(ref.v_pos)
    ref = jmesh.center_by_reference(ref, (np.asarray(lo), np.asarray(hi)), 1.0)
    m = fitted['mesh']
    pts = sample_points(jnp.asarray(m.v_pos.detach().numpy()),
                        jnp.asarray(m.t_pos_idx.numpy().astype(np.int32)), 2000,
                        jax.random.key(3), face_mask=jnp.asarray(m.face_mask.numpy()))
    gt_pts = sample_points(ref.v_pos, ref.t_pos_idx, 2000, jax.random.key(2))
    return {'chamfer': cd, 'chamfer_jax_sampler': float(chamfer_distance(pts, gt_pts)),
            'psnr_db': psnr, 's': time.perf_counter() - t0}


def main(argv) -> int:
    what, runs = argv[0], argv[1:]
    for r in runs:
        t0 = time.perf_counter()
        if what == 'jax-gate':
            out = jax_gate(int(r))
        elif what == 'jax-ablation':
            out = jax_ablation(int(r))
        elif what == 'port-gate':
            out = port_gate(r)
        elif what == 'port-ablation':
            out = port_ablation(r)
        elif what == 'cd0':
            out = cd0_census(int(r))
        elif what == 'paired-gate':
            out = paired_gate(int(r))
        else:
            raise SystemExit(f'unknown run {what!r}')
        out.update(run=what, init=r, seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
