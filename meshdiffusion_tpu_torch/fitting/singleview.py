"""Single-view DMTet fitting with visibility extraction (feeds cond_gen).

Counterpart of ``meshdiffusion_tpu/fitting/singleview.py`` (reference
``nvdiffrec/fit_singleview.py`` + ``lib/geometry/dmtet_singleview.py``):
fit one fixed validation view (pose ``angle_ind``), bootstrap occupancy
from the GT surface every 10 iterations (nearest surface face centre with
a half-space sign test, dmtet_singleview.py:421-435), then extract
per-tet-vertex visibility labels ``{sdf, deform, vis, vis_rast}``
(fit_singleview.py:795-827), the conditioning input of ``evaler.cond_gen``.

Differences from the multiview fitter (dmtet_singleview.py vs dmtet.py):
deform frozen for the first 100 iterations (:440-445); carving outside
the view's mask clamps the sdf to |sdf| instead of resetting it
(:447-458); the sdf BCE weighs x2.5 (:501); only the first layer's image
and depth terms. As in the JAX package, the fit keeps its render
capacities (raster_K from the config, the renderer's defaults otherwise)
and grows none: the noise-soup start overflows them, and the step reports
the overflow counts.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict

import numpy as np
import torch

from ..geometry.fit_losses import Uniform, chamfer_distance, sample_points, sdf_reg_loss, \
    torch_uniform
from ..geometry.tet_grid import TetGrid
from ..render import light as light_mod
from ..render import mesh as mesh_mod
from ..render import obj as obj_mod
from ..render import ops as rops
from ..render.render import render_mesh
from ..utils.device import resolve_device
from .dataset import TargetRenderer
from .fit import FitConfig, _count, default_material, lr_schedule, make_image_loss
from .geometry import DMTetFitter, FitState

logger = logging.getLogger(__name__)

_OVERFLOWS = ('raster_overflow', 'raster_overflow_global', 'raster_overflow_live',
              'aa_overflow')


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise a.b of (..., 3) fp32, rounded as a fused multiply-add chain
    rounds it (a0 b0, then + a1 b1, then + a2 b2, one rounding each), which
    is how XLA's CPU code computes ``jnp.sum(a * b, -1)``: each product is
    exact in fp64, so one fp64 add and a cast give the fused result."""
    s = a[..., 0] * b[..., 0]
    for k in (1, 2):
        s = (a[..., k].double() * b[..., k].double() + s.double()).float()
    return s


@dataclasses.dataclass(frozen=True)
class SingleViewFitter(DMTetFitter):
    """The dmtet_singleview.py variant of the pass-1 fitter."""

    def carve_occluded(self, state: FitState, target: Dict, iteration: int) -> FitState:
        """Where a vertex projects outside the view's mask, clamp its sdf to
        [0, 1] as |sdf| (dmtet_singleview.py:447-458), at iterations
        200 < i < 2000 that are multiples of 20."""
        if not (200 < iteration < 2000 and iteration % 20 == 0):
            return state
        v = self.get_deformed(state)
        mvp = target['mvp']
        B = mvp.shape[0]
        res = target['img'].shape[1]
        homo = rops.xfm_points(v[None].expand(B, -1, -1), mvp)
        w = homo[..., 3:4]
        xy = homo[..., :2] / torch.where(w.abs() > 1e-9, w, torch.full_like(w, 1e-9))
        pix = torch.round(torch.clamp(xy * 0.5 + 0.5, 0, 1) * (res - 1)).long()
        empty = target['mask_cont'][..., 0] == 0
        outside = empty[torch.arange(B, device=v.device)[:, None], pix[..., 1], pix[..., 0]]
        return state.replace(sdf=torch.where(outside.any(dim=0),
                                             state.sdf.abs().clamp(0.0, 1.0), state.sdf))

    def init_with_gt_surface(self, state: FitState, gt_verts: torch.Tensor,
                             surface_faces: torch.Tensor, campos: torch.Tensor,
                             chunk: int = 4096) -> FitState:
        """Set sdf = +1 (outside) at the tet vertices on the far side of
        their nearest GT face centre, the face's normal turned toward the
        camera (dmtet_singleview.py:421-435). The nearest centre is an
        exact chunked argmin of |q|^2 - 2 q.p + |p|^2 clamped at 0, the
        first index winning within a chunk and a later chunk only when
        strictly nearer, as the JAX package computes it. Equidistant
        centres and vertices on a face's plane are common on a grid-aligned
        mesh, so the centres, norms and sign tests also round as there
        (:func:`_dot3`)."""
        face_verts = gt_verts[surface_faces]                   # (F, 3, 3)
        centers = face_verts.sum(dim=1) * (1.0 / 3.0)         # XLA's mean
        q = self.get_deformed(state)
        q2 = _dot3(q, q)[:, None]
        best_d = torch.full((q.shape[0],), float('inf'), device=q.device)
        best_i = torch.zeros((q.shape[0],), dtype=torch.int64, device=q.device)
        for off in range(0, centers.shape[0], chunk):
            pc = centers[off:off + chunk]
            d = torch.clamp(q2 - 2 * q @ pc.T + _dot3(pc, pc)[None, :], min=0.0)
            i = torch.argmin(d, dim=1)
            dm = torch.gather(d, 1, i[:, None])[:, 0]
            upd = dm < best_d
            best_d = torch.where(upd, dm, best_d)
            best_i = torch.where(upd, i + off, best_i)
        normals = torch.cross(face_verts[:, 0] - face_verts[:, 1],
                              face_verts[:, 0] - face_verts[:, 2], dim=-1)
        facing = _dot3(normals, campos - centers)[:, None] >= 0
        normals = torch.where(facing, normals, -normals)
        outside = _dot3(q - centers[best_i], normals[best_i]) > 0
        return state.replace(sdf=torch.where(outside, 1.0, state.sdf))

    def tick(self, state: FitState, material, lgt, target: Dict, iteration: int,
             uniform: Uniform, image_loss_fn, no_depth_thin: bool = True,
             raster_K: int = 256):
        """The single-view losses (dmtet_singleview.py:438-514): first-layer
        image and depth, sdf BCE x2.5, kd and occlusion regularizers,
        chamfer; ``uniform`` supplies the 50k surface samples' draws.
        Returns (img_loss, reg_loss, buffers)."""
        m = self.get_mesh(state, material)
        res = (target['img'].shape[1], target['img'].shape[2])
        buffers = render_mesh(m, target['mvp'], target['campos'], lgt, res, num_layers=2,
                              raster_K=raster_K)
        t_iter = iteration / self.total_iter
        color_ref = target['img']
        img_loss = torch.mean((buffers['shaded'][..., 3:] - color_ref[..., 3:]) ** 2)
        img_loss = img_loss + image_loss_fn(buffers['shaded'][..., :3] * color_ref[..., 3:],
                                            color_ref[..., :3] * color_ref[..., 3:])
        mask = (target['mask_cont'][..., 0] == 1.0).float()
        if no_depth_thin:
            valid_depth = (target['depth_second'] >= 0).float() * \
                ((target['depth_second'] - target['depth']).abs() >= 5e-3).float()
        else:
            valid_depth = 1.0
        dd = (buffers['depth'][..., :1] - target['depth'][..., :1]).abs() \
            * mask[..., None] * valid_depth
        small = (dd < 1.0).to(dd.dtype)
        img_loss = img_loss + torch.mean(small * dd + (1 - small) * dd ** 2) * 100.0

        sdf_weight = self.sdf_regularizer - (self.sdf_regularizer - 0.01) * min(1.0, 4.0 * t_iter)
        sdf_mask = m.valid_vert_idx.float()
        sdf_masked = state.sdf.detach() * sdf_mask + state.sdf * (1 - sdf_mask)
        reg_loss = sdf_reg_loss(sdf_masked, self.grid.tensor('unique_edges', sdf_mask.device)) \
            * sdf_weight * 2.5
        ramp = min(1.0, iteration / 500)
        reg_loss = reg_loss + torch.mean(buffers['kd_grad'][..., :-1]
                                         * buffers['kd_grad'][..., -1:]) * 0.03 * ramp
        reg_loss = reg_loss + torch.mean(buffers['occlusion'][..., :-1]
                                         * buffers['occlusion'][..., -1:]) * 1e0 * ramp
        pred_pts = sample_points(m.v_pos, m.t_pos_idx, 50000, uniform, face_mask=m.face_mask)
        reg_loss = reg_loss + chamfer_distance(pred_pts, target['spts'])
        return img_loss, reg_loss, buffers


def make_singleview_step(fitter: SingleViewFitter, cfg: FitConfig, renderer: TargetRenderer):
    """One single-view iteration:

        step(state, opt, target, iteration, uniform) -> (state, metrics)

    ``state.sdf`` and ``state.deform`` are the leaves of ``opt`` (one Adam
    with one update count, lr from it); the deform gradient is zeroed (not
    dropped, so Adam's moments and count advance as one) for the first 100
    iterations (dmtet_singleview.py:440-445); then shrink -> carve -> clamp
    -> EMA."""
    image_loss_fn = make_image_loss(cfg.loss)
    lr = lr_schedule(cfg.learning_rate[0])
    material = default_material(renderer.device)

    def step(state: FitState, opt: torch.optim.Optimizer, target: Dict, iteration: int,
             uniform: Uniform):
        opt.param_groups[0]['lr'] = lr(_count(opt))
        opt.zero_grad(set_to_none=True)
        img_loss, reg_loss, bufs = fitter.tick(state, material, renderer.envlight, target,
                                               iteration, uniform, image_loss_fn,
                                               raster_K=cfg.raster_K)
        (img_loss + reg_loss).backward()
        if iteration < 100:
            state.deform.grad.zero_()
        opt.step()
        with torch.no_grad():
            new = fitter.shrink_deform(state, iteration)
            new = fitter.carve_occluded(new, target, iteration)
            new = fitter.update_ema(fitter.clamp(new))
            state.sdf.copy_(new.sdf)
            state.deform.copy_(new.deform)
        metrics = {'img_loss': img_loss.detach(), 'reg_loss': reg_loss.detach(),
                   **{k: bufs[k] for k in _OVERFLOWS}}
        return new.replace(sdf=state.sdf, deform=state.deform), metrics

    return step


def extract_visibility(fitter: DMTetFitter, state: FitState, renderer: TargetRenderer,
                       angle_ind: int = 10, raster_K: int = 256) -> Dict[str, torch.Tensor]:
    """Per-tet-vertex visibility labels from the fitting view (reference
    fit_singleview.py:795-827), a one-layer render at ``display_res``:
    ``vis`` marks the vertices of the visible tets, ``vis_rast`` adds the
    vertices of the tets whose faces were rasterized (face slot k belongs
    to tet k // 2, the marching-tets layout). CPU tensors."""
    grid = fitter.grid
    _, mvp, campos = renderer.rotate_camera(angle_ind)
    m = fitter.get_mesh(state, default_material(renderer.device))
    out = render_mesh(m, mvp, campos, renderer.envlight, renderer.display_res, num_layers=1,
                      tet_centers=fitter.tet_centers(state), raster_K=raster_K)
    visible = out['visible_tet_mask'].cpu().numpy()
    rast_tets = np.zeros(grid.num_tets, bool)
    rast_tets[np.nonzero(out['rast_triangle_mask'].cpu().numpy())[0] // 2] = True
    vis = np.zeros(grid.num_verts, np.float32)
    vis[np.unique(grid.indices[visible])] = 1.0
    vis_rast = vis.copy()
    vis_rast[np.unique(grid.indices[visible | rast_tets])] = 1.0
    return {'sdf': state.sdf.detach().cpu(), 'deform': state.deform.detach().cpu(),
            'vis': torch.from_numpy(vis), 'vis_rast': torch.from_numpy(vis_rast.astype(bool))}


def fit_singleview(mesh_path: str, cfg: FitConfig, out_dir: str, angle_ind: int = 10,
                   seed: int = 0, gt_bootstrap_every: int = 10, device=None) -> str:
    """Fit one fixed view of one mesh and write ``out_dir/tets/dmtet.pt``
    (reference fit_singleview.py driver) on ``device``, the card unless the
    caller names another; returns its path."""
    device = resolve_device(device or 'cuda')
    os.makedirs(os.path.join(out_dir, 'tets'), exist_ok=True)
    ref = obj_mod.load_mesh(mesh_path, device=device)
    ref = mesh_mod.center_by_reference(ref, mesh_mod.aabb(ref.v_pos), 1.0)
    ref = mesh_mod.auto_normals(ref)
    ref.material = default_material(device)
    if cfg.learn_light or cfg.envmap is None:
        envlight = light_mod.create_trainable_env_rnd(512, scale=0.0, bias=0.5, device=device)
        envlight.build_mips()
    else:
        envlight = light_mod.load_env(cfg.envmap, scale=cfg.env_scale, device=device)

    gen = torch.Generator(device).manual_seed(seed)
    renderer = TargetRenderer(ref_mesh=ref, envlight=envlight, cam_radius=cfg.cam_radius,
                              train_res=tuple(cfg.train_res), display_res=tuple(cfg.train_res),
                              num_surface_samples=cfg.surface_samples, generator=gen)
    grid = TetGrid.load(cfg.dmtet_grid, cfg.tet_root)
    fitter = SingleViewFitter(grid=grid, scale=cfg.mesh_scale,
                              deform_scale=cfg.first_stage_deform,
                              sdf_regularizer=cfg.sdf_regularizer, total_iter=cfg.iter)
    state = fitter.init_state(gen, device)
    state = state.replace(sdf=state.sdf.requires_grad_(), deform=state.deform.requires_grad_())
    opt = torch.optim.Adam([state.sdf, state.deform], lr=0.0)

    # the fixed view: validation pose angle_ind (fit_singleview.py:480-491)
    _, mvp, campos = renderer.rotate_camera(angle_ind)
    target = renderer.render_target(mvp, campos)
    step = make_singleview_step(fitter, cfg, renderer)
    uniform = torch_uniform(gen, device)
    cam = torch.as_tensor(campos[0], device=device)

    over = {k: 0 for k in _OVERFLOWS}
    t0 = time.perf_counter()
    for it in range(cfg.iter):
        if it % gt_bootstrap_every == 0:
            with torch.no_grad():
                state.sdf.copy_(fitter.init_with_gt_surface(state, ref.v_pos, ref.t_pos_idx,
                                                            cam).sdf)
        state, metrics = step(state, opt, target, it, uniform)
        for k in _OVERFLOWS:
            over[k] = max(over[k], int(metrics[k]))
        if it % cfg.log_interval == 0:
            logger.info('sv iter=%5d img=%.6f reg=%.6f', it, float(metrics['img_loss']),
                        float(metrics['reg_loss']))
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    fit_s = time.perf_counter() - t0
    logger.info('singleview: %d iterations in %.3f s; largest overflow counts %s', cfg.iter,
                fit_s, over, extra={'singleview_fit': (cfg.iter, fit_s, over)})

    # freeze the topology as pass 2 does, then extract the visibility
    fitter2 = SingleViewFitter(grid=grid, scale=cfg.mesh_scale,
                               deform_scale=cfg.second_stage_deform, total_iter=cfg.iter)
    with torch.no_grad():
        s = torch.sign(state.sdf)
        state = state.replace(sdf=torch.where(s == 0, 1.0, s),
                              deform=state.deform * cfg.first_stage_deform
                              / cfg.second_stage_deform)
        d = extract_visibility(fitter2, state, renderer, angle_ind, raster_K=cfg.raster_K)
    path = os.path.join(out_dir, 'tets', 'dmtet.pt')
    torch.save({k: v.contiguous() for k, v in d.items()}, path)
    logger.info('saved %s', path)
    return path
