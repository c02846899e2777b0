"""Validation renders: circular poses, PSNR / MSE against the GT.

Counterpart of ``meshdiffusion_tpu/fitting/validate.py`` (reference
``nvdiffrec/eval.py:217-261`` / ``fit_dmtets.py:287-331``): the fitted
geometry and the GT mesh rendered at the first ``num_views`` of the 50
circular validation poses, one layer each, the per-view and average MSE
and PSNR of their sRGB images written to ``metrics.txt`` with the PNGs.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..render import utils as U
from ..render.render import render_mesh
from .dataset import TargetRenderer
from .fit import default_material

logger = logging.getLogger(__name__)


@torch.no_grad()
def validate(fitter, state, renderer: TargetRenderer, out_dir: str, material=None,
             num_views: int = 50, save_images: bool = True, raster_K: int = 256) -> float:
    """Returns the average PSNR; writes ``metrics.txt`` (and
    ``val_{i:06d}_opt.png`` / ``_ref.png``). The fit is shaded with
    ``material`` (the default diffuse material if None), the GT with its
    own, both under the renderer's light."""
    os.makedirs(out_dir, exist_ok=True)
    mesh = fitter.get_mesh(state, material or default_material(renderer.device))
    mse_values, psnr_values = [], []
    with open(os.path.join(out_dir, 'metrics.txt'), 'w') as fout:
        fout.write('ID, MSE, PSNR\n')
        for it in range(num_views):
            _, mvp, campos = renderer.rotate_camera(it)
            ref = render_mesh(renderer.ref_mesh, mvp, campos, renderer.envlight,
                              renderer.display_res, num_layers=1, raster_K=raster_K)
            opt = render_mesh(mesh, mvp, campos, renderer.envlight, renderer.display_res,
                              num_layers=1, raster_K=raster_K)
            o = torch.clamp(U.rgb_to_srgb(opt['shaded'][0, ..., :3]), 0.0, 1.0)
            r = torch.clamp(U.rgb_to_srgb(ref['shaded'][0, ..., :3]), 0.0, 1.0)
            mse = float(torch.mean((o - r) ** 2))
            psnr = float(U.mse_to_psnr(max(mse, 1e-10)))
            mse_values.append(mse)
            psnr_values.append(psnr)
            fout.write('%d, %1.8f, %1.8f\n' % (it, mse, psnr))
            if save_images:
                U.save_image(os.path.join(out_dir, 'val_%06d_opt.png' % it), o.cpu().numpy())
                U.save_image(os.path.join(out_dir, 'val_%06d_ref.png' % it), r.cpu().numpy())
        avg_mse = float(np.mean(mse_values))
        avg_psnr = float(np.mean(psnr_values))
        fout.write('AVERAGES: %1.4f, %2.3f\n' % (avg_mse, avg_psnr))
    logger.info('validate: MSE %1.8f, PSNR %2.3f', avg_mse, avg_psnr,
                extra={'validate': (num_views, avg_mse, avg_psnr)})
    return avg_psnr
