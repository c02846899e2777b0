"""The rasterizer's per-tile z-min candidate test, all depth layers at once.

Replaces the TPU kernel ``meshdiffusion_tpu/ops/tile_raster.py``
(``tile_zmin_pallas``, pallas_call at :153), the inner loop of the
differentiable rasterizer (``render/rasterize.py::rasterize_select``).
Every TILE x TILE screen tile tests its binned candidate triangles at each
pixel centre (x + 0.5, y + 0.5):

* three edge functions; inside on either winding; |area| > 1e-12; id >= 0;
* screen-linear z = l0*az + l1*bz + (1 - l0 - l1)*cz, l_i = w_i * (1/area);
* only z > floor + 1e-7 and -1 <= z <= 1 count;
* the nearest (z, id) is kept: candidates go in groups of 8 slots in list
  order, within a group the smallest z wins and on an exact z tie the
  smallest id, and across groups a strict ``<`` keeps the earlier group (the
  Pallas kernel's tie-break, which the plain version below reproduces).

Inputs, for B views of T tiles each (N = B*T tiles, tile n of view n // T):

* ``coords`` (B, F, 9) f32: each view's screen coords [ax ay az bx by bz cx
  cy cz] of every (compacted) face; a list entry is a row of its view;
* ``tile_tris`` (N, K) int32 and ``tile_counts`` (N,) int32: each tile's
  binned ids, of which only slots [0, min(count, K)) are read;
* ``global_tris`` (B, Kg) int32 and ``global_count`` (B,) int32: each view's
  big-triangle list, tested by every tile of the view, of which slots
  [0, min(count, Kg)) are read.

Every id read lies in [0, F) or is negative (no candidate), as
``render/rasterize.py::bin_triangles`` gives them; the kernel does not check.

Tile slot s < K is ``tile_tris[n, s]`` and slot K + j is ``global_tris[b, j]``:
the tie-break group of a candidate is its slot // 8 in that layout, the one
the JAX package pads and tests. Layer 0's floor is ``z_floor`` (N, TILE,
TILE), or -1e30 everywhere when it is None; layer l + 1's is layer l's z
where it hit, 1e30 where it did not and at the pixels past the image (the
padding of the last tile row and column), as the depth peel of
``rasterize_select`` sets it.

Outputs: best_tri (L, N, TILE, TILE) int32, -1 where nothing was hit, and
best_z (L, N, TILE, TILE) f32, 1e30 there. Tile n sits at pixel origin
((n % T) % ntx * TILE, (n % T) // ntx * TILE), ntx = ceil(W / TILE).

:func:`tile_zmin` takes its route by the rule of ``ops/_build.py``; its
plain version is :func:`tile_zmin_reference`. The kernel,
``csrc/tile_zmin.cu``, runs once for all layers, and the wrapper counts the
launch in ``tile_zmin.launches``. Selection is not differentiable (the
rasterizer re-derives barycentrics with autograd, and selects under
``torch.no_grad``), so the wrapper declares no backward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._build import kernel_wrapper
from .roofline import PEAK_ALU_OPS, PEAK_FP32_UNFUSED_OPS, pipes_bound_ms

TILE = 32
BIG = 1e30
_CHUNK = 64        # candidates per step of the plain version
_GROUP = 8         # the tie-break group


def tile_grid(res: Tuple[int, int]):
    """(tiles a row, tiles a column, tiles a view) of an (H, W) image."""
    H, W = res
    ntx, nty = -(-W // TILE), -(-H // TILE)
    return ntx, nty, ntx * nty


def _tile_pixels(N: int, ntx: int, tpv: int, device):
    """Pixel centres (N, TILE*TILE) of every tile, row-major in the tile."""
    t = torch.arange(N, device=device) % tpv
    lin = torch.arange(TILE * TILE, device=device)
    px = ((t % ntx) * TILE)[:, None] + (lin % TILE)[None]
    py = ((t // ntx) * TILE)[:, None] + (lin // TILE)[None]
    return px.float() + 0.5, py.float() + 0.5


def padded_candidates(coords: torch.Tensor, tile_tris: torch.Tensor, tile_counts: torch.Tensor,
                      global_tris: torch.Tensor, global_count: torch.Tensor):
    """The padded layout the kernel reads in place: (cand (N, K + Kg, 9),
    ids (N, K + Kg) int32), ids -1 past each list's count and cand the
    coords of row 0 there."""
    B = coords.shape[0]
    N, K = tile_tris.shape
    Kg = global_tris.shape[1]
    dev = coords.device
    tt = torch.where(torch.arange(K, device=dev) < tile_counts[:, None], tile_tris, -1)
    gl = torch.where(torch.arange(Kg, device=dev) < global_count[:, None], global_tris, -1)
    ids = torch.cat([tt.view(B, N // B, K), gl[:, None].expand(B, N // B, Kg)], 2).view(N, K + Kg)
    view = torch.arange(N, device=dev) // (N // B)
    cand = coords[view[:, None], ids.clamp(min=0).long()]
    return cand, ids.to(torch.int32)


def _zmin_padded(cand: torch.Tensor, tids: torch.Tensor, z_floor: torch.Tensor, ntx: int,
                 tpv: int):
    """One layer on the padded layout: vectorised over the (tile,
    64-candidate chunk) pairs that hold a live candidate (a chunk without
    one hits nothing), with the kernel's group tie-break and its exact
    arithmetic order (every product and sum rounded on its own, as the
    kernel's ``__f*_rn`` do). cand (N, K, 9); tids (N, K); z_floor (N,
    TILE*TILE). Returns (best_t, best_z), each (N, TILE*TILE)."""
    N, K, _ = cand.shape
    P = TILE * TILE
    dev = cand.device
    pad = (-K) % _CHUNK
    nc = (K + pad) // _CHUNK
    cand = torch.cat([cand, cand.new_zeros((N, pad, 9))], 1).view(N, nc, _CHUNK, 9)
    tids = torch.cat([tids, tids.new_full((N, pad), -1)], 1).view(N, nc, _CHUNK)
    tile, chunk = (tids >= 0).any(2).nonzero(as_tuple=True)    # in list order
    px, py = _tile_pixels(N, ntx, tpv, dev)
    zf = z_floor + 1e-7
    imax = torch.iinfo(torch.int32).max
    chunk_z = torch.full((N, nc, P), BIG, device=dev)
    chunk_t = torch.full((N, nc, P), -1, dtype=torch.int32, device=dev)
    for r0 in range(0, len(tile), N):          # N pairs at a time
        n, j = tile[r0:r0 + N], chunk[r0:r0 + N]
        M = len(n)
        c = cand[n, j][..., None]                           # (M, C, 9, 1)
        ax, ay, az, bx, by, bz, cx, cy, cz = c.unbind(2)    # each (M, C, 1)
        tc = tids[n, j][..., None]
        pxn, pyn = px[n][:, None], py[n][:, None]           # (M, 1, P)
        area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        ok = area.abs() > 1e-12
        inv_area = torch.reciprocal(torch.where(ok, area, torch.ones_like(area)))
        live = ok & (tc >= 0)
        w0 = (cx - bx) * (pyn - by) - (cy - by) * (pxn - bx)  # (M, C, P)
        w1 = (ax - cx) * (pyn - cy) - (ay - cy) * (pxn - cx)
        w2 = (bx - ax) * (pyn - ay) - (by - ay) * (pxn - ax)
        inside = (((w0 >= 0) & (w1 >= 0) & (w2 >= 0))
                  | ((w0 <= 0) & (w1 <= 0) & (w2 <= 0))) & live
        l0 = w0 * inv_area
        l1 = w1 * inv_area
        z = l0 * az + l1 * bz + (1.0 - l0 - l1) * cz
        hit = inside & (z > zf[n][:, None]) & (z >= -1.0) & (z <= 1.0)
        zc = torch.where(hit, z, torch.full_like(z, BIG))
        # within each group of 8: nearest z, smallest id on an exact tie
        zc = zc.view(M, -1, _GROUP, P)
        gz = zc.min(dim=2).values                           # (M, G, P)
        tg = tc.view(M, -1, _GROUP, 1).expand_as(zc)
        gt = torch.where(zc <= gz[:, :, None], tg, torch.full_like(tg, imax)).min(dim=2).values
        # across groups: the first minimal group, as a strict < in list order keeps
        cz_, gi = gz.min(dim=1)
        chunk_z[n, j] = cz_
        chunk_t[n, j] = gt.gather(1, gi[:, None]).squeeze(1)
    # across chunks the same: the first chunk of the least z
    best_z, ci = chunk_z.min(dim=1)
    best_t = chunk_t.gather(1, ci[:, None]).squeeze(1)
    best_t = torch.where(best_z < BIG, best_t, torch.full_like(best_t, -1))
    return best_t, best_z


def tile_zmin_reference(coords: torch.Tensor, tile_tris: torch.Tensor, tile_counts: torch.Tensor,
                        global_tris: torch.Tensor, global_count: torch.Tensor,
                        res: Tuple[int, int], num_layers: int = 1,
                        z_floor: Optional[torch.Tensor] = None):
    """Plain version: rebuilds the padded candidate tensor from the coords
    table and peels the layers one at a time; see the module docstring."""
    H, W = res
    ntx, _, T = tile_grid(res)
    N = tile_tris.shape[0]
    dev = coords.device
    cand, ids = padded_candidates(coords, tile_tris, tile_counts, global_tris, global_count)
    px, py = _tile_pixels(N, ntx, T, dev)
    in_image = (px < W) & (py < H)
    floor = (torch.full((N, TILE * TILE), -BIG, device=dev) if z_floor is None
             else z_floor.reshape(N, TILE * TILE))
    tris, zs = [], []
    for _ in range(num_layers):
        t, z = _zmin_padded(cand, ids, floor, ntx, T)
        tris.append(t.view(N, TILE, TILE))
        zs.append(z.view(N, TILE, TILE))
        floor = torch.where(in_image & (t >= 0), z, BIG)
    return torch.stack(tris), torch.stack(zs)


def tile_zmin_cost(coords: torch.Tensor, tile_counts: torch.Tensor, global_count: torch.Tensor,
                   res: Tuple[int, int], num_layers: int = 1,
                   z_floor: Optional[torch.Tensor] = None, best_z: Optional[torch.Tensor] = None
                   ) -> Tuple[float, float, float]:
    """(fp32 operations, ALU operations, bytes) of one call on these inputs:
    what the function cannot do without, whatever the kernel does. Per
    layer, for every live (candidate, tile) pair (the global list counted
    for every tile of its view) and every pixel of the tile that the layer's
    floor leaves open (below 1e30): the last difference of each of the three
    edge functions (3 fp32) and the inside test, six compares and their
    combination (7 ALU); for every row and every column of a tile with an
    open pixel, each edge's offset and product (6 fp32 a row, 6 a column);
    once a pair, its edge deltas, area and 1/area (12 fp32, 1 ALU). The
    z of the pairs that cover a pixel (as many as the geometry gives) is
    left out, so the count is a floor. Open pixels: in the first layer every
    pixel, or those of ``z_floor``; in a later one, given the call's output
    ``best_z``, the pixels of the image that the layer before hit, else
    every pixel (the most a layer could need). Bytes: the live ids, each
    view's coords table and the floor read once, ids and z of every layer
    written once. None depends on the lists' capacities K and Kg."""
    N, B = tile_counts.shape[0], global_count.shape[0]
    pairs = (tile_counts.view(B, N // B) + global_count[:, None]).reshape(N).double()
    every = torch.full_like(pairs, TILE * TILE)
    open_px = [every if z_floor is None else (z_floor.reshape(N, -1) < BIG).sum(1).double()]
    if num_layers > 1 and best_z is not None:
        ntx, _, T = tile_grid(res)
        px, py = _tile_pixels(N, ntx, T, best_z.device)
        in_image = (px < res[1]) & (py < res[0])
        open_px += [((best_z[li].reshape(N, -1) < BIG) & in_image).sum(1).double()
                    for li in range(num_layers - 1)]
    open_px += [every] * (num_layers - len(open_px))
    fp32 = 12.0 * float(pairs.sum()) + sum(
        float((pairs * (3 * o + 12 * TILE * (o > 0))).sum()) for o in open_px)
    alu = float(pairs.sum()) + sum(7.0 * float((pairs * o).sum()) for o in open_px)
    nbytes = 4 * int(tile_counts.sum() + global_count.sum()) + 4 * coords.numel() \
        + num_layers * N * TILE * TILE * 8
    if z_floor is not None:
        nbytes += 4 * z_floor.numel()
    return fp32, alu, float(nbytes)


def tile_zmin_bound_ms(*args, **kwargs) -> Tuple[float, str]:
    """The least time an H100 could take for a call (arguments as
    :func:`tile_zmin_cost`): the kernel rounds every operation on its own
    (no FMA), so each fp32 operation is one instruction at the unfused
    rate; the ALU pipe runs at half that, beside it; and the schedulers
    issue both kinds at the fp32 rate in all."""
    fp32, alu, nbytes = tile_zmin_cost(*args, **kwargs)
    return pipes_bound_ms(nbytes, (fp32, PEAK_FP32_UNFUSED_OPS), (alu, PEAK_ALU_OPS),
                          (fp32 + alu, PEAK_FP32_UNFUSED_OPS))


@kernel_wrapper(tile_zmin_reference)
def tile_zmin(coords: torch.Tensor, tile_tris: torch.Tensor, tile_counts: torch.Tensor,
              global_tris: torch.Tensor, global_count: torch.Tensor, res: Tuple[int, int],
              num_layers: int = 1, z_floor: Optional[torch.Tensor] = None):
    """Nearest candidate triangle at every pixel of every tile, for
    ``num_layers`` depth layers; see the module docstring. Returns
    (best_tri int32, best_z f32), each (num_layers, N, TILE, TILE)."""
    H, W = res
    ntx, _, T = tile_grid(res)
    B, F, nine = coords.shape
    N, K = tile_tris.shape
    Kg = global_tris.shape[1]
    if nine != 9 or coords.dtype != torch.float32 or any(
            t.dtype != torch.int32 for t in (tile_tris, tile_counts, global_tris, global_count)):
        raise ValueError('need coords (B, F, 9) float32 and int32 lists and counts')
    if N != B * T or tile_counts.shape != (N,) or global_tris.shape[0] != B \
            or global_count.shape != (B,) or num_layers < 1 or K < 1:
        raise ValueError(f'{B} views of {T} tiles at {res}: tile_tris {tuple(tile_tris.shape)}, '
                         f'tile_counts {tuple(tile_counts.shape)}, global_tris '
                         f'{tuple(global_tris.shape)}, global_count {tuple(global_count.shape)}, '
                         f'num_layers {num_layers}')
    if z_floor is not None and (z_floor.shape != (N, TILE, TILE) or z_floor.dtype != torch.float32):
        raise ValueError(f'z_floor {tuple(z_floor.shape)} {z_floor.dtype}: need ({N}, {TILE}, '
                         f'{TILE}) float32')
    # the kernel reads slots [0, count): a raw bin count above the capacity
    # would run past the list
    tile_counts, global_count = tile_counts.clamp(0, K), global_count.clamp(0, Kg)
    coords, tile_tris, tile_counts, global_tris, global_count = (
        t.contiguous() for t in (coords, tile_tris, tile_counts, global_tris, global_count))
    if z_floor is not None:
        z_floor = z_floor.contiguous()
    # the heaviest tiles first, so that the longest blocks start at once
    live = (tile_counts.view(B, T) + global_count[:, None]).view(N)
    order = torch.argsort(live, descending=True, stable=True).to(torch.int32)
    best_t = torch.empty((num_layers, N, TILE, TILE), dtype=torch.int32, device=coords.device)
    best_z = torch.empty((num_layers, N, TILE, TILE), dtype=torch.float32, device=coords.device)
    lib = _build.lib()
    with torch.cuda.device(coords.device):
        err = lib.tile_zmin(coords.data_ptr(), tile_tris.data_ptr(), tile_counts.data_ptr(),
                            global_tris.data_ptr(), global_count.data_ptr(),
                            None if z_floor is None else z_floor.data_ptr(), order.data_ptr(),
                            best_t.data_ptr(), best_z.data_ptr(), N, F, K, Kg, ntx, T, H, W,
                            num_layers, torch.cuda.current_stream().cuda_stream)
    _build.check(err, 'tile_zmin')
    tile_zmin.launches += 1
    return best_t, best_z
