"""Dataset conversion tools: fitted DMTet dicts -> training grids, the grid
mask, the meta list.

Counterpart of ``meshdiffusion_tpu/data/convert.py``, which stands in for
the reference's standalone scripts:

* ``tets_to_grid`` / CLI ``tets-to-3dgrid``: scatter fitted DMTet dicts
  {sdf, deform} onto (4, R, R, R) float32 grids (reference
  data/tets_to_3dgrid.py:7-49), the scatter on ``--device`` (the card by
  default), the file reads and writes on the host;
* ``save_grid_mask`` / CLI ``get-tet-mask``: reference data/get_tet_mask.py:9-37;
* ``save_meta`` / CLI ``save-meta``: reference metadata/save_meta.py:5-14.

Job sharding (``--index/--split-size``) is kept: a fitting farm's outputs
are converted in parallel over hosts. The files written are byte-identical
to the JAX package's.

    python -m meshdiffusion_tpu_torch.data.convert tets-to-3dgrid -res 64 \\
        -s fits/tets -t grids [--format npy|pt] [--device cuda]
    python -m meshdiffusion_tpu_torch.data.convert get-tet-mask --resolution 64 [--out mask.npy]
    python -m meshdiffusion_tpu_torch.data.convert save-meta --data-dir grids --out meta.json
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
from typing import List, Optional

import numpy as np
import torch

from ..geometry.tet_grid import TetGrid
from ..utils.device import resolve_device

logger = logging.getLogger(__name__)


def load_dmt_dict(path: str) -> dict:
    """{sdf: (V,), deform: (V, 3)} float32 numpy from a ``.npz`` or a
    reference ``.pt`` dict."""
    if path.endswith('.npz'):
        d = np.load(path)
        return {'sdf': np.asarray(d['sdf'], np.float32),
                'deform': np.asarray(d['deform'], np.float32)}
    d = torch.load(path, map_location='cpu', weights_only=True)
    return {'sdf': d['sdf'].detach().float().numpy().reshape(-1),
            'deform': d['deform'].detach().float().numpy()}


def tets_to_grid(tet_grid: TetGrid, sdf: np.ndarray, deform: np.ndarray,
                 device='cuda') -> np.ndarray:
    """One dict -> its (4, R, R, R) grid (the file layout), scattered on
    ``device``, returned as float32 numpy on the host."""
    device = resolve_device(device)
    g = tet_grid.tet_to_grid(torch.as_tensor(sdf, dtype=torch.float32, device=device),
                             torch.as_tensor(deform, dtype=torch.float32, device=device))
    g = g.cpu().numpy()
    # a view, as the JAX package returns it: np.save writes it in C order and
    # torch.save keeps its strides, so both files match the JAX package's
    return np.moveaxis(g, -1, 0)


def convert_folder(source: str, target: str, resolution: int = 64,
                   index: int = 0, split_size: int = 10 ** 8,
                   tet_root: Optional[str] = None,
                   out_format: str = 'npy', device='cuda') -> List[str]:
    """``dmt_dict_{i:05d}.(pt|npz)`` under ``source`` -> ``grid_{i:05d}.(npy|pt)``
    under ``target`` for i in ``index*split_size .. +split_size``; a missing
    dict is skipped, and the unbounded default scan stops at the first gap."""
    device = resolve_device(device)
    tg = TetGrid.load(resolution, tet_root)
    os.makedirs(target, exist_ok=True)
    written = []
    for k in range(split_size):
        gi = k + index * split_size
        src = next((c for c in (os.path.join(source, f'dmt_dict_{gi:05d}.{ext}')
                                for ext in ('pt', 'npz')) if os.path.exists(c)), None)
        if src is None:
            if k > 0 and split_size >= 10 ** 8:
                break
            continue
        d = load_dmt_dict(src)
        grid = tets_to_grid(tg, d['sdf'], d['deform'], device=device)
        if out_format == 'npy':
            out = os.path.join(target, f'grid_{gi:05d}.npy')
            np.save(out, grid)
        else:
            out = os.path.join(target, f'grid_{gi:05d}.pt')
            torch.save(torch.from_numpy(grid), out)
        written.append(out)
    logger.info('converted %d grids -> %s', len(written), target)
    return written


def save_grid_mask(resolution: int, out_path: Optional[str] = None,
                   tet_root: Optional[str] = None) -> str:
    """The tet grid's (R, R, R) float32 occupancy mask as ``.npy``."""
    out_path = out_path or f'grid_mask_{resolution}.npy'
    np.save(out_path, TetGrid.load(resolution, tet_root).grid_mask())
    return out_path


def save_meta(data_dir: str, out_path: str, extensions=('pt', 'npy')) -> str:
    """The sorted list of ``data_dir``'s grid files as json (reference
    metadata/save_meta.py:12-13)."""
    files = sorted(f for ext in extensions for f in glob.glob(os.path.join(data_dir, f'*.{ext}')))
    with open(out_path, 'w') as f:
        json.dump(files, f)
    logger.info('wrote %d entries to %s', len(files), out_path)
    return out_path


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser('meshdiffusion_tpu_torch.data.convert')
    sub = p.add_subparsers(dest='cmd', required=True)

    g = sub.add_parser('tets-to-3dgrid')
    g.add_argument('-res', '--resolution', type=int, required=True)
    g.add_argument('-ss', '--split-size', type=int, default=int(1e8))
    g.add_argument('-ind', '--index', type=int, default=0)
    g.add_argument('-s', '--source', required=True)
    g.add_argument('-t', '--target', required=True)
    g.add_argument('--tet-root', default=None)
    g.add_argument('--format', choices=['npy', 'pt'], default='npy')
    g.add_argument('--device', default='cuda', help='where the scatter runs')

    m = sub.add_parser('get-tet-mask')
    m.add_argument('--resolution', type=int, required=True)
    m.add_argument('--out', default=None)
    m.add_argument('--tet-root', default=None)

    s = sub.add_parser('save-meta')
    s.add_argument('--data-dir', required=True)
    s.add_argument('--out', required=True)

    args = p.parse_args(argv)
    if args.cmd == 'tets-to-3dgrid':
        return convert_folder(args.source, args.target, args.resolution, args.index,
                              args.split_size, args.tet_root, args.format,
                              device=resolve_device(args.device, '--device'))
    if args.cmd == 'get-tet-mask':
        out = save_grid_mask(args.resolution, args.out, args.tet_root)
        print(out)
        return out
    return save_meta(args.data_dir, args.out)


if __name__ == '__main__':
    main()
