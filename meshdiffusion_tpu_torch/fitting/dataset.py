"""Ground-truth renders for fitting.

Counterpart of ``meshdiffusion_tpu/fitting/dataset.py`` (reference
``nvdiffrec/lib/dataset/dataset_mesh.py``: random poses:78-94, circular
validation poses:67-76, the target dict:132-163): the GT mesh is rendered
by the same renderer at random cameras (radius fixed, fov 45 degrees,
random rigid jitter +-0.2), and the target carries images, depths, masks
and surface samples. With ``random_lgt`` every target batch also turns the
environment light by a random rotation (``envlight_transform``, drawn
after the batch's cameras). Cameras and light rotations come from a numpy
``Generator`` with the JAX package's calls in the same order, so they
match it bit for bit; the surface samples draw from the renderer's
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..geometry.fit_losses import sample_points, torch_uniform
from ..render import mesh as mesh_mod
from ..render import utils as U
from ..render.render import render_mesh


@dataclasses.dataclass
class TargetRenderer:
    ref_mesh: mesh_mod.Mesh
    envlight: object
    cam_radius: float = 2.0
    train_res: tuple = (512, 512)
    display_res: tuple = (512, 512)
    cam_near_far: tuple = (0.1, 1000.0)
    fovy: float = float(np.deg2rad(45))
    layers: int = 2
    random_lgt: bool = False
    num_surface_samples: int = 50000
    # >0: render this many random view batches once and sample from the
    # pool each iteration instead of rendering the GT every iteration.
    # Pooled targets keep only the keys the fit losses read, colour and
    # coverage in f16 and depth in f32 (f16 depth at camera distance 2-4 is
    # ~1e-3 apart, the order of the 5e-3 depth_prox threshold); the
    # surface samples are drawn fresh every call. 0 = the reference's
    # behaviour.
    target_pool: int = 0
    generator: Optional[torch.Generator] = None
    # filled by the first pooled call: the pool, its batch, and the seconds
    # its renders took (synchronized)
    pool: Optional[list] = None
    pool_batch: Optional[int] = None
    pool_s: float = 0.0

    @property
    def device(self):
        return self.ref_mesh.v_pos.device

    def random_cameras(self, batch: int, rng: np.random.Generator):
        """Random training poses (reference dataset_mesh.py:78-94)."""
        iter_res = self.train_res
        proj = U.perspective(self.fovy, iter_res[1] / iter_res[0], *self.cam_near_far)
        mvs, mvps, camposes = [], [], []
        for _ in range(batch):
            mv = U.translate(0, 0, -self.cam_radius) @ U.random_rotation_translation(0.2, rng)
            mvs.append(mv)
            mvps.append(proj @ mv)
            camposes.append(np.linalg.inv(mv)[:3, 3])
        return (np.stack(mvs).astype(np.float32), np.stack(mvps).astype(np.float32),
                np.stack(camposes).astype(np.float32))

    def rotate_camera(self, itr: int):
        """Validation pose ``itr`` on a circle of 50 (reference
        dataset_mesh.py:67-76): (mv, mvp, campos), each with a batch of 1."""
        proj = U.perspective(self.fovy, self.display_res[1] / self.display_res[0],
                             *self.cam_near_far)
        mv = U.translate(0, 0, -self.cam_radius) @ (U.rotate_x(-0.4)
                                                    @ U.rotate_y((itr / 50) * np.pi * 2))
        return (mv[None].astype(np.float32), (proj @ mv)[None].astype(np.float32),
                np.linalg.inv(mv)[:3, 3][None].astype(np.float32))

    def _spts(self) -> torch.Tensor:
        m = self.ref_mesh
        return sample_points(m.v_pos, m.t_pos_idx, self.num_surface_samples,
                             torch_uniform(self.generator, self.device), face_mask=m.face_mask)

    @torch.no_grad()
    def render_target(self, mvp, campos, envlight_transform=None) -> Dict:
        """Render the GT mesh into a target dict (reference
        dataset_mesh.py:119-163), the light turned by
        ``envlight_transform`` (1, 4, 4) when given."""
        dev = self.device
        mvp = torch.as_tensor(mvp, device=dev)
        campos = torch.as_tensor(campos, device=dev)
        xfm = (None if envlight_transform is None
               else torch.as_tensor(envlight_transform, dtype=torch.float32, device=dev))
        out = render_mesh(self.ref_mesh, mvp, campos, self.envlight, self.train_res,
                          num_layers=self.layers, xfm_lgt=xfm)
        return {
            'mvp': mvp, 'campos': campos, 'envlight_transform': xfm,
            'img': out['shaded'], 'img_second': out['shaded_second'],
            'spts': self._spts(),
            'depth': out['depth'], 'depth_second': out['depth_second'],
            'normal': out['normal'], 'normal_second': out['normal_second'],
            'geo_normal': out['geo_normal'], 'geo_viewdir': out['geo_viewdir'],
            'pos': out['pos'], 'mask': out['mask'], 'mask_cont': out['mask_cont'],
        }

    # the target keys the fit losses read (geometry.py tick/tick_fixed,
    # carve_occluded): colour and coverage pooled in f16, depth in f32
    _POOLED_F16_KEYS = ('img', 'img_second', 'mask_cont')
    _POOLED_IMAGE_KEYS = _POOLED_F16_KEYS + ('depth', 'depth_second')
    _POOLED_KEYS = _POOLED_IMAGE_KEYS + ('mvp', 'campos', 'envlight_transform')

    def _random_view_batch(self, batch: int, np_rng: np.random.Generator):
        """(mvp, campos, envlight_transform or None) in the JAX package's
        draw order: the cameras, then the light's rotation."""
        _, mvp, campos = self.random_cameras(batch, np_rng)
        xfm = U.random_rotation_translation(0.0, np_rng)[None] if self.random_lgt else None
        return mvp, campos, xfm

    def _build_pool(self, batch: int, np_rng: np.random.Generator):
        t0 = time.perf_counter()
        entries = []
        for _ in range(self.target_pool):
            t = self.render_target(*self._random_view_batch(batch, np_rng))
            entries.append({k: t[k].half() if k in self._POOLED_F16_KEYS else t[k]
                            for k in self._POOLED_KEYS})
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.pool_s = time.perf_counter() - t0
        return entries

    def random_target(self, batch: int, np_rng: np.random.Generator) -> Dict:
        if self.target_pool > 0:
            if self.pool is None or self.pool_batch != batch:
                self.pool = self._build_pool(batch, np_rng)
                self.pool_batch = batch
            t = dict(self.pool[int(np_rng.integers(len(self.pool)))])
            for k in self._POOLED_F16_KEYS:
                t[k] = t[k].float()
            with torch.no_grad():
                t['spts'] = self._spts()
            return t
        return self.render_target(*self._random_view_batch(batch, np_rng))
