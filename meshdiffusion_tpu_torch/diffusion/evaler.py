"""Generation drivers: uncond_gen, uncond_gen_interp and cond_gen.

Counterpart of ``meshdiffusion_tpu/diffusion/evaler.py`` (reference
``lib/diffusion/evaler.py``: uncond_gen:14-60, slerp + interp:63-131,
cond_gen:134-212). The model samples from the EMA weights of
``eval.ckpt_path`` (a reference-format ``.pth``), or from a seeded random
init when that is unset. Samples are saved in the reference's file format,
channel-first ``(B, 4, R, R, R)`` ``.npy``. As in the JAX package, the
reference's undefined-variable bug in ``uncond_gen_interp`` (reference
evaler.py:126-127) is not copied: the slerp chain is the intended one.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from ..geometry.tet_grid import TetGrid
from ..models import create_model
from ..utils.checkpoint import load_eval_weights
from ..utils.device import resolve_device
from . import sampling
from .vpsde import VPSDE

logger = logging.getLogger(__name__)


def load_grid_mask(config) -> np.ndarray:
    """(R, R, R) float32 occupancy mask: ``data.grid_mask_path`` (.npy, or a
    torch .pt such as the reference's grid_mask_{R}.pt) if set, else derived
    from the tet grid."""
    R = config.data.image_size
    path = config.data.get('grid_mask_path', '')
    if path:
        m = (np.load(path) if path.endswith('.npy')
             else torch.load(path, map_location='cpu', weights_only=True).numpy())
        return np.asarray(m, np.float32).reshape(R, R, R)
    return TetGrid.load(R, config.gpu.tet_root or None).grid_mask()


def _is_set(path) -> bool:
    return bool(path) and path != 'PLACEHOLDER'


def _setup(config, device):
    """The eval model on ``device`` with the checkpoint's EMA weights (or a
    seeded random init), its grid mask (1, R, R, R, 1) and the SDE
    (reference evaler.py:34-69): (model_fn(x, labels), sde, mask). A
    text-conditioned model gets its condition (:func:`_condition`) at every
    call of model_fn. Raises where ``device`` is CUDA and there is none."""
    device = resolve_device(device)
    mask = torch.as_tensor(load_grid_mask(config), device=device)[None, ..., None]
    model = create_model(config, device,
                         torch.Generator(device=device).manual_seed(config.seed)).eval()
    ckpt_path = config.eval.ckpt_path
    # a .pth/.pt that is missing raises (JAX: load_torch_checkpoint's torch.load);
    # another missing path warns, as the JAX package's orbax restore does
    if _is_set(ckpt_path) and (ckpt_path.endswith(('.pth', '.pt')) or os.path.exists(ckpt_path)):
        step = load_eval_weights(ckpt_path, model, config)
        logger.info('loaded model trained till iter %d', step // config.training.iter_size)
    elif _is_set(ckpt_path):
        logger.warning('No checkpoint found at %s; sampling from a random model', ckpt_path)
    else:
        logger.warning('eval.ckpt_path unset; sampling from a random model')
    sde = VPSDE(beta_min=config.model.beta_min, beta_max=config.model.beta_max,
                N=config.model.num_scales)
    cond = _condition(config, model, device)
    return (lambda x, labels: model(x, labels, mask, **cond)), sde, mask


def _condition(config, model, device) -> dict:
    """The keyword inputs a text-conditioned model (``models/flux3d.py``) takes
    at every step of a chain: ``eval.condition_path``'s ``txt``, ``y`` and
    ``guidance`` (a torch file, each with the eval batch), or, where that is
    empty, the model's standard normal features drawn from ``config.seed``
    at ``model.guidance``; nothing for a model without a condition."""
    if not hasattr(model, 'draw_condition'):
        return {}
    path = config.eval.condition_path
    if _is_set(path):
        d = torch.load(path, map_location=device, weights_only=True)
        return {k: d[k].float() for k in ('txt', 'y', 'guidance')}
    gen = torch.Generator(device=device).manual_seed(config.seed)
    return model.draw_condition(config.eval.batch_size, gen, config.model.guidance)


def _save(samples: torch.Tensor, eval_dir: str, fname: str) -> str:
    os.makedirs(eval_dir, exist_ok=True)
    path = os.path.join(eval_dir, f"{fname}.npy")
    # channels-last device layout -> the reference's channel-first file layout
    np.save(path, np.moveaxis(samples.float().cpu().numpy(), -1, 1))
    return path


def _shape(config):
    R = config.data.image_size
    return (config.eval.batch_size, R, R, R, config.data.num_channels)


def _noise(config, seed, device):
    return sampling.default_noise(device, config.seed if seed is None else seed)


def _run(sampler_call):
    """Run a sampler in inference mode; (samples on the CPU, nfe, seconds)."""
    t0 = time.perf_counter()
    with torch.inference_mode():
        samples, nfe = sampler_call()
        samples = samples.cpu()
    return samples, nfe, time.perf_counter() - t0


def uncond_gen(config, idx=0, seed: Optional[int] = None, device='cuda',
               return_traj: bool = False):
    """Unconditional generation (reference evaler.py:14-60) on ``device``;
    returns the path of the saved ``.npy``. With ``return_traj`` it saves
    the x0-prediction snapshots (steps >= 700 every 10) as
    ``{idx}_time{t:03d}.npy`` and returns their paths."""
    model_fn, sde, mask = _setup(config, device)
    sampler = sampling.get_sampling_fn(config, sde, _shape(config), eps=1e-3, grid_mask=mask,
                                       return_traj=return_traj)
    samples, nfe, sample_s = _run(lambda: sampler(model_fn, _noise(config, seed, device)))
    if return_traj:
        paths = [_save(samples[t], config.eval.eval_dir, f'{idx}_time{t:03d}')
                 for t in range(samples.shape[0])]
        logger.info('saved %d trajectory snapshots (nfe=%d)', len(paths), nfe)
        return paths
    path = _save(samples, config.eval.eval_dir, str(idx))
    logger.info("saved %s (nfe=%d; %d steps in %.3f s)", path, nfe, sde.N - 1, sample_s,
                extra={'sample_s': sample_s, 'steps': sde.N - 1})
    return path


def slerp(z1: torch.Tensor, z2: torch.Tensor, alpha: float) -> torch.Tensor:
    """Spherical linear interpolation (reference evaler.py:63-71)."""
    theta = torch.arccos(torch.sum(z1 * z2) / (torch.linalg.norm(z1) * torch.linalg.norm(z2)))
    return (torch.sin((1 - alpha) * theta) / torch.sin(theta) * z1
            + torch.sin(alpha * theta) / torch.sin(theta) * z2)


def uncond_gen_interp(config, idx=0, seed: Optional[int] = None, device='cuda') -> str:
    """DDIM generation from slerp-interpolated prior noise (reference
    evaler.py:73-131): sample 0 and B-1 start from two prior draws, sample
    i from their slerp at i / (B - 1)."""
    B = config.eval.batch_size
    if B < 2:
        raise ValueError(f'uncond_gen_interp needs eval.batch_size >= 2, got {B}')
    model_fn, sde, mask = _setup(config, device)
    shape = _shape(config)
    sampler = sampling.get_ddim_sampler(sde, shape, denoise=config.sampling.noise_removal,
                                        grid_mask=mask)
    ends = _noise(config, seed, device)('prior', (2,) + shape[1:]).float()
    x0 = torch.zeros(shape, device=ends.device)
    x0[0], x0[-1] = ends[0], ends[1]
    for i in range(1, B - 1):
        x0[i] = slerp(ends[0], ends[1], i / float(B - 1))
    samples, nfe, sample_s = _run(lambda: sampler(model_fn, None, x0=x0))
    path = _save(samples, config.eval.eval_dir, str(idx))
    logger.info('saved %s (nfe=%d; DDIM in %.3f s)', path, nfe, sample_s,
                extra={'sample_s': sample_s})
    return path


def load_partial_grids(config):
    """The single-view dict {sdf, vis} of ``eval.partial_dmtet_path`` (.pt
    or .npz) scattered onto the grid: (partial_sdf, partial_mask), each
    (1, R, R, R, 1) float32 on the CPU (reference evaler.py:181-201). The
    vertex -> grid map comes from ``eval.tet_path`` when set, else from the
    tet grid of the config's resolution."""
    R = config.data.image_size
    path = config.eval.partial_dmtet_path
    if path.endswith('.npz'):
        d = np.load(path)
        partial_sdf = np.asarray(d['sdf'], np.float32)
        partial_vis = np.asarray(d['vis'], np.float32)
    else:
        d = torch.load(path, map_location='cpu', weights_only=True)
        partial_sdf = d['sdf'].float().numpy()
        partial_vis = d['vis'].float().numpy()
    if _is_set(config.eval.tet_path):
        verts = np.asarray(np.load(config.eval.tet_path)['vertices'])
        u = np.unique(verts)
        coords = np.round((verts - verts.min()) / (u[1] - u[0])).astype(np.int64)
    else:
        coords = TetGrid.load(R, config.gpu.tet_root or None).vert_grid_coords
    sdf_grid = np.zeros((1, R, R, R, 1), np.float32)
    mask_grid = np.zeros((1, R, R, R, 1), np.float32)
    sdf_grid[0, coords[:, 0], coords[:, 1], coords[:, 2], 0] = partial_sdf
    mask_grid[0, coords[:, 0], coords[:, 1], coords[:, 2], 0] = partial_vis
    return torch.from_numpy(sdf_grid), torch.from_numpy(mask_grid)


def cond_gen(config, save_fname='0', seed: Optional[int] = None, device='cuda') -> str:
    """Single-view conditional generation (reference evaler.py:134-212):
    the SDF channel inpainted from ``eval.partial_dmtet_path`` until
    ``eval.freeze_iters``; returns the path of the saved ``.npy``."""
    model_fn, sde, mask = _setup(config, device)
    sampler = sampling.get_sampling_fn(config, sde, _shape(config), eps=1e-3, grid_mask=mask)
    partial, partial_mask = (g.to(device) for g in load_partial_grids(config))
    samples, nfe, sample_s = _run(
        lambda: sampler(model_fn, _noise(config, seed, device), partial=partial,
                        partial_mask=partial_mask, freeze_iters=config.eval.freeze_iters))
    path = _save(samples, config.eval.eval_dir, str(save_fname))
    logger.info('saved %s (nfe=%d; %d steps in %.3f s)', path, nfe, sde.N, sample_s,
                extra={'sample_s': sample_s, 'steps': sde.N})
    return path
