"""DMTet fitting geometry: trainable SDF + deformation over the tet grid.

Counterpart of ``meshdiffusion_tpu/fitting/geometry.py`` (reference
``nvdiffrec/lib/geometry/dmtet.py``: DMTetGeometry:203-462, the
sign-majority buffer:179-197; ``dmtet_fixedtopo.py``:176-349). The state
is a dataclass of tensors; ``sdf`` and ``deform`` are the leaves the
optimizer updates, and the maintenance steps (clamp, EMA push, occluded
carving, periodic deform shrink) return a new state. The iteration is a
Python int, so a maintenance step that does not fire this iteration costs
nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..geometry.fit_losses import (Uniform, chamfer_distance, laplacian_uniform,
                                   sample_points, sdf_reg_loss)
from ..geometry.marching_tets import marching_tets
from ..geometry.tet_grid import TetGrid
from ..render import mesh as mesh_mod
from ..render import ops as rops
from ..render.render import Normal, render_mesh


@dataclasses.dataclass
class FitState:
    sdf: torch.Tensor          # (V,)
    deform: torch.Tensor       # (V, 3)
    sdf_ema: torch.Tensor      # (V,) sign-majority snapshot
    sdf_buffer: torch.Tensor   # (cap, V) ring buffer of sdf snapshots
    buf_len: torch.Tensor      # () int64
    buf_ptr: torch.Tensor      # () int64

    def replace(self, **kw) -> "FitState":
        return dataclasses.replace(self, **kw)


def _huber(d, thres=1.0):
    small = (d < thres).to(d.dtype)
    return small * d + (1 - small) * (d ** 2 + thres - thres ** 2)


@dataclasses.dataclass(frozen=True)
class DMTetFitter:
    """First-pass fitter: trainable sdf + deform (reference dmtet.py:203)."""

    grid: TetGrid
    scale: float = 1.1                 # mesh_scale (nvdiffrec config)
    deform_scale: float = 2.0
    sdf_regularizer: float = 0.2
    total_iter: int = 5000
    buffer_capacity: int = 200

    def init_state(self, generator: Optional[torch.Generator] = None, device=None) -> FitState:
        V = self.grid.num_verts
        sdf = torch.rand((V,), generator=generator, device=device) - 0.1  # reference dmtet.py:224
        return FitState(sdf=sdf, deform=torch.zeros((V, 3), device=device), sdf_ema=sdf.clone(),
                        sdf_buffer=torch.zeros((self.buffer_capacity, V), device=device),
                        buf_len=torch.zeros((), dtype=torch.int64, device=device),
                        buf_ptr=torch.zeros((), dtype=torch.int64, device=device))

    # ---- geometry ----

    def get_deformed(self, state: FitState) -> torch.Tensor:
        return self.grid.deformed_verts(state.deform, self.scale, self.deform_scale)

    def get_mesh(self, state: FitState, material=None, ema: bool = False) -> mesh_mod.Mesh:
        mt = marching_tets(self.grid, self.get_deformed(state),
                           state.sdf_ema if ema else state.sdf)
        return mesh_mod.auto_normals(mesh_mod.Mesh(
            v_pos=mt.verts, t_pos_idx=mt.faces, face_mask=mt.face_mask, material=material,
            valid_vert_idx=mt.valid_vert_mask))

    def tet_centers(self, state: FitState) -> torch.Tensor:
        """(T, 3) centroids of the deformed tets."""
        v = self.get_deformed(state)
        return v[self.grid.tensor('indices', v.device)].mean(dim=1)

    # ---- in-loop state maintenance ----

    def clamp(self, state: FitState) -> FitState:
        """Reference dmtet.py:335-338."""
        return state.replace(deform=state.deform.clamp(-0.99, 0.99),
                             sdf=state.sdf.clamp(-1.0, 1.0))

    def update_ema(self, state: FitState) -> FitState:
        """Sign-majority ring buffer (reference dmtet.py:179-197,351-354)."""
        buf = state.sdf_buffer.index_copy(0, state.buf_ptr.view(1), state.sdf[None])
        length = torch.clamp(state.buf_len + 1, max=self.buffer_capacity)
        w = (torch.arange(self.buffer_capacity, device=buf.device) < length).float()[:, None]
        mean_sign = torch.sum(torch.sign(buf) * w, dim=0) / torch.clamp(torch.sum(w), min=1.0)
        return state.replace(sdf_buffer=buf, buf_len=length,
                             buf_ptr=(state.buf_ptr + 1) % self.buffer_capacity,
                             sdf_ema=torch.sign(mean_sign))

    def shrink_deform(self, state: FitState, iteration: int) -> FitState:
        """deform *= 0.4 every 300 iterations while iteration < 1790
        (reference dmtet.py:409-410)."""
        if iteration % 300 == 0 and iteration < 1790:
            return state.replace(deform=state.deform * 0.4)
        return state

    def carve_occluded(self, state: FitState, target: Dict, iteration: int) -> FitState:
        """Project the vertices to screen; force sdf = 1e-2 (outside) and
        zero deform where the 11x11-dilated target mask is empty in any view
        (reference dmtet.py:366-378)."""
        if not (200 < iteration < 2000 and iteration % 20 == 0):
            return state
        v = self.get_deformed(state)
        mvp = target['mvp']                                       # (B, 4, 4)
        B = mvp.shape[0]
        res = target['img'].shape[1]
        homo = rops.xfm_points(v[None].expand(B, -1, -1), mvp)
        w = homo[..., 3:4]
        xy = homo[..., :2] / torch.where(w.abs() > 1e-9, w, torch.full_like(w, 1e-9))
        pix = torch.round(torch.clamp(xy * 0.5 + 0.5, 0, 1) * (res - 1)).long()
        mask = (target['mask_cont'][..., 0] > 0).float()
        dil = F.max_pool2d(mask[:, None], 11, stride=1, padding=5)[:, 0]
        outside = dil[torch.arange(B, device=v.device)[:, None], pix[..., 1], pix[..., 0]] == 0
        carve = outside.any(dim=0)
        return state.replace(sdf=torch.where(carve, 1e-2, state.sdf),
                             deform=torch.where(carve[:, None], 0.0, state.deform))

    # ---- loss (reference dmtet.py:362-462) ----

    def _render(self, m, lgt, target, raster_K, raster_Kg, aa, aa_budget, raster_live,
                shade_cap, normal):
        res = (target['img'].shape[1], target['img'].shape[2])
        return render_mesh(m, target['mvp'], target['campos'], lgt, res, num_layers=2,
                           raster_K=raster_K, raster_Kg=raster_Kg, aa=aa, aa_budget=aa_budget,
                           raster_live=raster_live, remat=True, shade_cap=shade_cap,
                           xfm_lgt=target.get('envlight_transform'), normal=normal)

    def tick(self, state: FitState, material, lgt, target: Dict, iteration: int,
             uniform: Uniform, image_loss_fn, no_depth_thin: bool = True,
             raster_K: int = 256, raster_Kg: int = 64, aa: bool = True, aa_budget=None,
             raster_live: int = 65536, shade_cap=None, normal: Optional[Normal] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
        """Image, depth and regularizer losses of one iteration. ``uniform``
        supplies the 50k prediction surface samples' draws, ``normal`` a
        neural material's shading jitter (:func:`render_mesh`)."""
        m = self.get_mesh(state, material)
        buffers = self._render(m, lgt, target, raster_K, raster_Kg, aa,
                               aa_budget, raster_live, shade_cap, normal)
        t_iter = iteration / self.total_iter

        color_ref = target['img']
        img_loss = torch.mean((buffers['shaded'][..., 3:] - color_ref[..., 3:]) ** 2)
        img_loss = img_loss + image_loss_fn(buffers['shaded'][..., :3] * color_ref[..., 3:],
                                            color_ref[..., :3] * color_ref[..., 3:])
        ref2 = target['img_second']
        img_loss = img_loss + torch.mean((buffers['shaded_second'][..., 3:]
                                          - ref2[..., 3:]) ** 2) * 1e-1
        img_loss = img_loss + image_loss_fn(buffers['shaded_second'][..., :3] * ref2[..., 3:],
                                            ref2[..., :3] * ref2[..., 3:]) * 1e-1

        mask = (target['mask_cont'][..., 0] == 1.0).float()
        depth_scale = 100.0 if iteration < 10000 else 1.0
        if no_depth_thin:
            valid_depth = (target['depth_second'] >= 0).float()
            depth_prox = ((target['depth_second'] - target['depth']).abs() >= 5e-3).float()
        else:
            valid_depth = depth_prox = 1.0
        dd = (buffers['depth'][..., :1] - target['depth'][..., :1]).abs() \
            * mask[..., None] * valid_depth
        dd2 = (buffers['depth_second'][..., :1] - target['depth_second'][..., :1]).abs() \
            * mask[..., None] * valid_depth * depth_prox * 1e-1
        img_loss = img_loss + (torch.mean(_huber(dd)) + torch.mean(_huber(dd2))) * depth_scale

        # SDF sign regularizer masked to non-surface verts (dmtet.py:439-446)
        sdf_weight = self.sdf_regularizer - (self.sdf_regularizer - 0.01) * min(1.0, 4.0 * t_iter)
        sdf_mask = m.valid_vert_idx.float()
        sdf_masked = state.sdf.detach() * sdf_mask + state.sdf * (1 - sdf_mask)
        reg_loss = sdf_reg_loss(sdf_masked, self.grid.tensor('unique_edges', sdf_mask.device)) \
            * sdf_weight * 0.1
        ramp = min(1.0, iteration / 500)
        reg_loss = reg_loss + torch.mean(buffers['kd_grad'][..., :-1]
                                         * buffers['kd_grad'][..., -1:]) * 0.03 * ramp
        reg_loss = reg_loss + torch.mean(buffers['occlusion'][..., :-1]
                                         * buffers['occlusion'][..., -1:]) * 1e0 * ramp

        pred_pts = sample_points(m.v_pos, m.t_pos_idx, 50000, uniform, face_mask=m.face_mask)
        reg_loss = reg_loss + chamfer_distance(pred_pts, target['spts'])
        return img_loss, reg_loss, buffers


@dataclasses.dataclass(frozen=True)
class FixedTopoFitter(DMTetFitter):
    """Second pass: topology frozen (sdf = its sign), deform only, with a
    Laplacian relative to the pass-1 vertices
    (reference dmtet_fixedtopo.py:176-349)."""

    laplace_scale: float = 10000.0

    def freeze(self, state: FitState) -> FitState:
        s = torch.sign(state.sdf)
        return state.replace(sdf=torch.where(s == 0, 1.0, s))

    def tick_fixed(self, state: FitState, init_v_pos: torch.Tensor, material, lgt,
                   target: Dict, iteration: int, uniform: Uniform, image_loss_fn,
                   mesh_edges: torch.Tensor, raster_K: int = 256, raster_Kg: int = 64,
                   aa: bool = True, aa_budget=None, raster_live: int = 65536, shade_cap=None,
                   normal: Optional[Normal] = None):
        m = self.get_mesh(state, material)
        buffers = self._render(m, lgt, target, raster_K, raster_Kg, aa,
                               aa_budget, raster_live, shade_cap, normal)
        t_iter = iteration / self.total_iter
        color_ref = target['img']
        img_loss = torch.mean((buffers['shaded'][..., 3:] - color_ref[..., 3:]) ** 2)
        img_loss = img_loss + image_loss_fn(buffers['shaded'][..., :3] * color_ref[..., 3:],
                                            color_ref[..., :3] * color_ref[..., 3:])
        mask = (target['mask_cont'][..., 0] == 1.0).float()
        dd = (buffers['depth'][..., :1] - target['depth'][..., :1]).abs() * mask[..., None]
        img_loss = img_loss + torch.mean(_huber(dd)) * 100.0

        # Laplacian relative to the pass-1 verts (dmtet_fixedtopo.py:207-211,342)
        reg_loss = laplacian_uniform(m.v_pos - init_v_pos, mesh_edges) \
            * self.laplace_scale * (1 - t_iter) * 1e-2
        pred_pts = sample_points(m.v_pos, m.t_pos_idx, 50000, uniform, face_mask=m.face_mask)
        reg_loss = reg_loss + chamfer_distance(pred_pts, target['spts'])
        return img_loss, reg_loss, buffers
