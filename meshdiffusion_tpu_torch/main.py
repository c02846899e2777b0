"""Command-line entry point (reference main_diffusion.py:13-25).

Usage:
  python -m meshdiffusion_tpu_torch.main --config res64 --mode train \
      --config.data.meta_path=grids.json --config.training.train_dir=run/ [--device cuda]
  python -m meshdiffusion_tpu_torch.main --config res64 --mode uncond_gen \
      --config.eval.eval_dir=out/ [--config.eval.ckpt_path=ckpt.pth] [--traj] [--device cuda]
  python -m meshdiffusion_tpu_torch.main --config res64 --mode uncond_gen_interp \
      --config.eval.batch_size=5 --config.eval.eval_dir=out/ [--config.eval.ckpt_path=ckpt.pth]
  python -m meshdiffusion_tpu_torch.main --config res64 --mode cond_gen \
      --config.eval.ckpt_path=ckpt.pth --config.eval.partial_dmtet_path=sv/tets/dmtet.pt \
      --config.eval.eval_dir=out/ [--config.eval.freeze_iters=950]
  python -m meshdiffusion_tpu_torch.main --mode extract --sample_path out/0.npy \
      --out_dir meshes/ [--resolution 128] [--save_viz [--angle_ind 25]] [--device cuda]
  python -m meshdiffusion_tpu_torch.main --mode extract_traj --sample_path out/ \
      --out_dir meshes/
  python -m meshdiffusion_tpu_torch.main --mode fit_dmtets --meta_path meshes.json \
      --out_dir fits/ [--fit_config cfg.json] [--device cuda]
  python -m meshdiffusion_tpu_torch.main --mode fit_singleview --meta_path mesh.obj \
      --out_dir sv/ [--angle_ind 25] [--fit_config cfg.json] [--device cuda]

``--config`` takes a preset (res64/res128/dit3d_xl4_res64/default) or a Python file that
defines ``get_config()``; ``--config.a.b=value`` overrides one key. The
device defaults to ``cuda``; there is no fallback when it is missing.

Training on several ranks: start one process a rank (a card each, or with
``--config.gpu.dist_backend=gloo`` several on one card or on the CPU), each
with MESHDIFFUSION_COORDINATOR=host:port, MESHDIFFUSION_NUM_PROCESSES=N and
MESHDIFFUSION_PROCESS_ID=rank, and the mesh in ``--config.gpu.mesh_data_axis``
and ``--config.gpu.mesh_spatial_axis`` (diffusion/trainer.py).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import logging
import os
import sys

import torch

from .config import PRESETS, apply_overrides, get_config
from .utils.device import resolve_device


def _load_config(spec: str):
    if spec in PRESETS:
        return get_config(spec)
    if not os.path.isfile(spec):
        raise SystemExit(f"--config {spec!r}: not a preset ({'/'.join(PRESETS)}) "
                         "and no such config file")
    modspec = importlib.util.spec_from_file_location('user_config', spec)
    mod = importlib.util.module_from_spec(modspec)
    modspec.loader.exec_module(mod)
    return mod.get_config()


def _device(name: str) -> torch.device:
    return resolve_device(name, '--device')


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    logging.basicConfig(level=logging.INFO, format='%(asctime)s %(levelname)s %(message)s')
    parser = argparse.ArgumentParser('meshdiffusion_tpu_torch')
    parser.add_argument('--config', default='res64', help='preset name or config .py file')
    parser.add_argument('--mode', required=True,
                        choices=['train', 'uncond_gen', 'uncond_gen_interp', 'cond_gen',
                                 'extract', 'extract_traj', 'fit_dmtets', 'fit_singleview'])
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--idx', default='0')
    parser.add_argument('--seed', type=int, default=None)
    # extract-mode flags (reference nvdiffrec/eval.py argparse)
    parser.add_argument('--sample_path', default=None)
    parser.add_argument('--out_dir', default='./viz_tet')
    parser.add_argument('--resolution', type=int, default=64)
    parser.add_argument('--mesh_scale', type=float, default=2.1)
    parser.add_argument('--deform_scale', type=float, default=1.0)
    parser.add_argument('--num_smooth_steps', type=int, default=3)
    parser.add_argument('--no_remesh', action='store_true',
                        help='extract: skip the isotropic remeshing post-process')
    parser.add_argument('--unnormalized_sdf', action='store_true')
    parser.add_argument('--save_viz', action='store_true',
                        help='extract: also render a sanity PNG per mesh')
    parser.add_argument('--traj', action='store_true',
                        help='uncond_gen: save the x0-prediction trajectory')
    parser.add_argument('--angle_ind', type=int, default=25,
                        help='extract --save_viz: the rendered pose; fit_singleview: the '
                        'validation pose fitted')
    # fitting flags (reference nvdiffrec argparse)
    parser.add_argument('--meta_path', default=None,
                        help='fit modes: a json list of mesh paths, or one .obj')
    parser.add_argument('--fit_config', default=None,
                        help='fit modes: an nvdiffrec-style json config')
    parser.add_argument('--iter', type=int, default=5000)
    parser.add_argument('--batch', type=int, default=4)
    parser.add_argument('--index', type=int, default=0)
    parser.add_argument('--split_size', type=int, default=1)

    overrides, rest = [], []
    for a in argv:
        if a.startswith('--config.'):
            k, _, v = a[len('--config.'):].partition('=')
            overrides.append((k, v))
        else:
            rest.append(a)
    args = parser.parse_args(rest)
    device = _device(args.device)

    if args.mode in ('extract', 'extract_traj'):
        from .extract import extract_batch, extract_dir
        if not args.sample_path:
            raise SystemExit(f'--sample_path is required for --mode {args.mode}')
        fn = extract_batch if args.mode == 'extract' else extract_dir
        return fn(args.sample_path, args.out_dir, resolution=args.resolution,
                  mesh_scale=args.mesh_scale, deform_scale=args.deform_scale,
                  num_smooth_steps=args.num_smooth_steps, unnormalized_sdf=args.unnormalized_sdf,
                  save_viz=args.save_viz, angle_ind=args.angle_ind,
                  remesh=not args.no_remesh, device=device)

    if args.mode == 'fit_dmtets':
        return _fit_dmtets(args, device)
    if args.mode == 'fit_singleview':
        from .fitting.singleview import fit_singleview
        fcfg, mesh_list = _fit_inputs(args)
        return fit_singleview(mesh_list[args.index], fcfg, args.out_dir,
                              angle_ind=args.angle_ind, seed=args.seed or 0, device=device)

    config = apply_overrides(_load_config(args.config), overrides)
    if args.mode == 'train':
        from .diffusion.trainer import train
        from .parallel.distributed import maybe_initialize
        maybe_initialize(config.gpu.dist_backend)      # before the first device use
        return train(config, device=device)
    from .diffusion import evaler
    if args.mode == 'uncond_gen':
        return evaler.uncond_gen(config, idx=args.idx, seed=args.seed, device=device,
                                 return_traj=args.traj)
    if args.mode == 'uncond_gen_interp':
        return evaler.uncond_gen_interp(config, idx=args.idx, seed=args.seed, device=device)
    return evaler.cond_gen(config, save_fname=args.idx, seed=args.seed, device=device)


def _fit_inputs(args):
    """(FitConfig from ``--iter``, ``--batch`` and ``--fit_config``, the
    mesh list of ``--meta_path``)."""
    from .fitting.fit import FitConfig
    if not args.meta_path:
        raise SystemExit(f'--meta_path is required for --mode {args.mode}')
    fcfg = FitConfig(iter=args.iter, batch=args.batch)
    if args.fit_config:
        with open(args.fit_config) as f:
            for k, v in json.load(f).items():
                if hasattr(fcfg, k):
                    setattr(fcfg, k, tuple(v) if isinstance(v, list) else v)
    if args.meta_path.endswith('.obj'):
        return fcfg, [args.meta_path]
    with open(args.meta_path) as f:
        return fcfg, json.load(f)


def _fit_dmtets(args, device):
    """Fit meshes ``index*split_size .. +split_size`` of the list; a mesh
    whose ``tets/`` dict exists (``.pt``, or the ``.npz`` the JAX package
    writes where torch is absent) is skipped, and one that fails is logged
    and skipped (reference fit_dmtets.py:657-810). Returns the written
    paths, one dict per fitted mesh."""
    from .fitting.fit import fit_one_mesh
    fcfg, mesh_list = _fit_inputs(args)
    written = []
    for k in range(args.split_size):
        gi = k + args.index * args.split_size
        if gi >= len(mesh_list):
            break
        done = os.path.join(args.out_dir, f'tets/dmt_dict_{gi:05d}')
        if os.path.exists(done + '.pt') or os.path.exists(done + '.npz'):
            continue
        try:
            written.append(fit_one_mesh(mesh_list[gi], fcfg, args.out_dir, gi,
                                        seed=args.seed or 0, device=device))
        except Exception:
            logging.exception('fit %d (%s) failed', gi, mesh_list[gi])
    return written


if __name__ == '__main__':
    main()
