"""The rasterizer's per-tile z-min candidate test.

Replaces the TPU kernel ``meshdiffusion_tpu/ops/tile_raster.py``
(``tile_zmin_pallas``, pallas_call at :153), the inner loop of the
differentiable rasterizer (``render/rasterize.py::_rasterize_tiles``).
Every TILE x TILE screen tile tests its K binned candidate triangles at
each pixel centre (x + 0.5, y + 0.5):

* three edge functions; inside on either winding; |area| > 1e-12; id >= 0;
* screen-linear z = l0*az + l1*bz + (1 - l0 - l1)*cz, l_i = w_i * (1/area);
* only z > floor + 1e-7 and -1 <= z <= 1 count (the depth-peel floor is
  -1e30 for the first layer and the previous layer's z, +1e30 where it is
  empty, after that);
* the nearest (z, id) is kept: candidates go in groups of 8 in list order,
  within a group the smallest z wins and on an exact z tie the smallest
  id, and across groups a strict ``<`` keeps the earlier group (the Pallas
  kernel's tie-break, which the plain version below reproduces).

Outputs: best_tri (N, TILE, TILE) int32, -1 where nothing was hit, and
best_z (N, TILE, TILE) f32, 1e30 there. Ids travel as int32 (the Pallas
kernel carried them as f32 lanes). Tile n sits at pixel origin
((n % tpv) % ntx * TILE, (n % tpv) // ntx * TILE), where tpv is the
number of tiles of one view, so one call may hold the tiles of several
views back to back.

On a CPU tensor :func:`tile_zmin` runs :func:`tile_zmin_reference`; on a
CUDA tensor it launches ``csrc/tile_zmin.cu`` or raises, and counts the
launch in ``tile_zmin.launches``. Selection is not differentiable (the
rasterizer re-derives barycentrics with autograd), so there is no backward.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

TILE = 32
BIG = 1e30
_CHUNK = 64        # candidates per step of the plain version
_GROUP = 8         # the tie-break group


def _tile_pixels(N: int, ntx: int, tpv: int, device):
    """Pixel centres (N, TILE*TILE) of every tile, row-major in the tile."""
    t = torch.arange(N, device=device) % tpv
    lin = torch.arange(TILE * TILE, device=device)
    px = ((t % ntx) * TILE)[:, None] + (lin % TILE)[None]
    py = ((t // ntx) * TILE)[:, None] + (lin // TILE)[None]
    return px.float() + 0.5, py.float() + 0.5


def tile_zmin_reference(cand: torch.Tensor, tile_tris: torch.Tensor,
                        z_floor_tiles: torch.Tensor, ntx: int, tpv: int = 0):
    """Plain version: vectorised over tiles and 64-candidate chunks, with
    the kernel's group tie-break and its exact arithmetic order (every
    product and sum rounded on its own, as the kernel's ``__f*_rn`` do).
    cand (N, K, 9) f32; tile_tris (N, K) int32; z_floor_tiles (N, TILE,
    TILE) f32; tpv: tiles per view (0 = N)."""
    N, K, _ = cand.shape
    dev = cand.device
    px, py = _tile_pixels(N, ntx, tpv or N, dev)
    px, py = px[:, None], py[:, None]                       # (N, 1, P)
    zf = z_floor_tiles.reshape(N, 1, TILE * TILE) + 1e-7
    pad = (-K) % _CHUNK
    cand = torch.cat([cand, cand.new_zeros((N, pad, 9))], 1)
    tids = torch.cat([tile_tris, tile_tris.new_full((N, pad), -1)], 1)
    imax = torch.iinfo(torch.int32).max
    best_z = torch.full((N, TILE * TILE), BIG, device=dev)
    best_t = torch.full((N, TILE * TILE), -1, dtype=torch.int32, device=dev)
    for k0 in range(0, K + pad, _CHUNK):
        c = cand[:, k0:k0 + _CHUNK, :, None]                # (N, C, 9, 1)
        ax, ay, az, bx, by, bz, cx, cy, cz = c.unbind(2)    # each (N, C, 1)
        tc = tids[:, k0:k0 + _CHUNK, None]
        area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        ok = area.abs() > 1e-12
        inv_area = torch.reciprocal(torch.where(ok, area, torch.ones_like(area)))
        live = ok & (tc >= 0)
        w0 = (cx - bx) * (py - by) - (cy - by) * (px - bx)  # (N, C, P)
        w1 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
        w2 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
        inside = (((w0 >= 0) & (w1 >= 0) & (w2 >= 0))
                  | ((w0 <= 0) & (w1 <= 0) & (w2 <= 0))) & live
        l0 = w0 * inv_area
        l1 = w1 * inv_area
        z = l0 * az + l1 * bz + (1.0 - l0 - l1) * cz
        hit = inside & (z > zf) & (z >= -1.0) & (z <= 1.0)
        zc = torch.where(hit, z, torch.full_like(z, BIG))
        # within each group of 8: nearest z, smallest id on an exact tie
        zc = zc.view(N, -1, _GROUP, TILE * TILE)
        gz = zc.min(dim=2).values                           # (N, G, P)
        tg = tc.view(N, -1, _GROUP, 1).expand_as(zc)
        gt = torch.where(zc <= gz[:, :, None], tg, torch.full_like(tg, imax)).min(dim=2).values
        # across groups (and chunks): strict <, so the earliest group wins
        cz_, gi = gz.min(dim=1)                             # first minimal group
        ct = gt.gather(1, gi[:, None]).squeeze(1)
        upd = cz_ < best_z
        best_z = torch.where(upd, cz_, best_z)
        best_t = torch.where(upd, ct, best_t)
    best_t = torch.where(best_z < BIG, best_t, torch.full_like(best_t, -1))
    return best_t.view(N, TILE, TILE), best_z.view(N, TILE, TILE)


def tile_zmin_cost(cand: torch.Tensor, tile_tris: torch.Tensor) -> Tuple[float, float]:
    """(FLOP, bytes) of one call on these inputs: the three edge functions
    (21 fp32 operations) at every pixel for every live candidate (id >= 0,
    counted from the data); cand, ids and the depth floor read once, ids and
    z written once."""
    N, K, _ = cand.shape
    live = int((tile_tris >= 0).sum())
    return 21.0 * live * TILE * TILE, float(N * K * (9 + 1) * 4 + N * TILE * TILE * 3 * 4)


def tile_zmin(cand: torch.Tensor, tile_tris: torch.Tensor, z_floor_tiles: torch.Tensor,
              ntx: int, tpv: int = 0):
    """Nearest candidate triangle at every pixel of every tile; see the
    module docstring. Returns (best_tri int32, best_z f32), each (N, TILE,
    TILE)."""
    if not _build.use_kernel('tile_zmin', cand, tile_tris, z_floor_tiles):
        return tile_zmin_reference(cand, tile_tris, z_floor_tiles, ntx, tpv)
    N, K, nine = cand.shape
    tpv = tpv or N
    if nine != 9 or cand.dtype != torch.float32 or tile_tris.dtype != torch.int32 \
            or z_floor_tiles.dtype != torch.float32:
        raise ValueError('need cand (N, K, 9) float32, tile_tris int32, z_floor float32')
    if tile_tris.shape != (N, K) or z_floor_tiles.shape != (N, TILE, TILE):
        raise ValueError(f'shapes {tuple(tile_tris.shape)}, {tuple(z_floor_tiles.shape)} '
                         f'do not match cand {tuple(cand.shape)}')
    if N % tpv or K < 1:
        raise ValueError(f'N={N} is not a multiple of tpv={tpv}, or K={K} < 1')
    cand, tile_tris, z_floor_tiles = (t.contiguous() for t in (cand, tile_tris, z_floor_tiles))
    best_t = torch.empty((N, TILE, TILE), dtype=torch.int32, device=cand.device)
    best_z = torch.empty((N, TILE, TILE), dtype=torch.float32, device=cand.device)
    lib = _build.lib()
    with torch.cuda.device(cand.device):
        err = lib.tile_zmin(cand.data_ptr(), tile_tris.data_ptr(), z_floor_tiles.data_ptr(),
                            best_t.data_ptr(), best_z.data_ptr(), N, K, ntx, tpv,
                            torch.cuda.current_stream().cuda_stream)
    _build.check(err, 'tile_zmin')
    tile_zmin.launches += 1
    return best_t, best_z


tile_zmin.launches = 0
