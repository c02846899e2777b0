"""Differentiable triangle rasterizer.

Counterpart of ``meshdiffusion_tpu/render/rasterize.py``, which replaces
nvdiffrast's rasterize/interpolate/antialias (reference
``nvdiffrec/lib/render/render.py:262,290-297``):

* **Tile binning by sort.** Each triangle's screen bbox maps to the <= 2x2
  coarse 32-pixel tiles it touches; the (tile, triangle) pairs are sorted
  once (stable) and per-tile segments found with searchsorted, into
  fixed-capacity lists of K (overflow counted, the fit driver grows K).
  Triangles spanning more tiles go to a global list of Kg every tile tests.
* **Dense per-tile z-test** through the hand-written kernel
  :func:`~meshdiffusion_tpu_torch.ops.tile_zmin` (CUDA on the card, its
  plain version on the CPU): every view and depth layer in one launch,
  reading each listed face's coords from the view's table.
* **Hard visibility, soft attributes.** Selection is detached; barycentrics
  are recomputed with autograd from the winning triangle's vertices, and
  silhouette gradients come from the analytic edge-AA pass
  (:func:`antialias_views`, the ``dr.antialias`` equivalent: on the
  compacted silhouette pairs by default, or with a slot for every pair,
  all views at once or one view at a time with :func:`antialias`).

Conventions: clip-space input after an OpenGL projection
(``utils.perspective``), y-down pixel grid, screen-linear z/w depth. A view
batch is one leading dimension where the JAX package vmaps. Scatters with
JAX's ``mode='drop'`` write into a buffer one row longer and slice the
sentinel row off.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops import tile_zmin
from ..ops.tile_zmin import tile_grid
from ..utils.gather import gather

TILE = 32          # tile side in pixels
SPAN = 2           # tiles a triangle bbox may span per axis
BIG = 1e30


@dataclasses.dataclass
class RasterOut:
    """Per-pixel rasterization result (one depth layer)."""
    tri_id: torch.Tensor     # (H, W) int64, -1 where empty
    bary: torch.Tensor       # (H, W, 3) perspective-correct barycentrics
    zbuf: torch.Tensor       # (H, W) screen z in [-1, 1], BIG where empty
    valid: torch.Tensor      # (H, W) bool
    # triangles dropped from the fullest tile (0 = exact), and from the
    # global big-triangle list; grow K / Kg when nonzero
    bin_overflow: Optional[torch.Tensor] = None
    global_overflow: Optional[torch.Tensor] = None


def _screen_coords(v_clip: torch.Tensor, res: Tuple[int, int]):
    """Clip -> pixel coords. Returns (x, y, z, inv_w) with guarded w."""
    H, W = res
    w = v_clip[..., 3]
    inv_w = torch.reciprocal(torch.where(w.abs() > 1e-9, w, torch.full_like(w, 1e-9)))
    x = (v_clip[..., 0] * inv_w * 0.5 + 0.5) * W
    y = (v_clip[..., 1] * inv_w * 0.5 + 0.5) * H
    z = v_clip[..., 2] * inv_w
    return x, y, z, inv_w


def _edge(ax, ay, bx, by, px, py):
    """Signed doubled area of (a, b, p)."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def bin_triangles(xs, ys, face_mask, res: Tuple[int, int], K: int, Kg: int = 64):
    """Sort-based binning with a global big-triangle list. xs, ys (F, 3)
    screen coords. Returns (tile_tris (T, K) int32 with -1 padding,
    tile_counts (T,), global_tris (min(Kg, F),) int32 with -1 padding,
    global_count ())."""
    H, W = res
    ntx, nty, T = tile_grid(res)
    dev = xs.device
    xmin, xmax = xs.min(1).values, xs.max(1).values
    ymin, ymax = ys.min(1).values, ys.max(1).values
    tx0 = torch.floor(xmin / TILE).clamp(0, ntx - 1).long()
    ty0 = torch.floor(ymin / TILE).clamp(0, nty - 1).long()
    tx1 = torch.floor(xmax / TILE).clamp(0, ntx - 1).long()
    ty1 = torch.floor(ymax / TILE).clamp(0, nty - 1).long()

    offscreen = (xmax < 0) | (xmin >= W) | (ymax < 0) | (ymin >= H)
    dead = offscreen | ~face_mask
    big = ((tx1 - tx0 >= SPAN) | (ty1 - ty0 >= SPAN)) & ~dead

    # the <= SPAN x SPAN tiles a small triangle's bbox touches; a duplicate
    # (the same tile twice), a dead or a big triangle goes to sentinel T
    entries = []
    for dy in range(SPAN):
        for dx in range(SPAN):
            tile = torch.minimum(ty0 + dy, ty1) * ntx + torch.minimum(tx0 + dx, tx1)
            drop = dead | big
            if dx:
                drop = drop | (tx0 + dx > tx1)
            if dy:
                drop = drop | (ty0 + dy > ty1)
            entries.append(torch.where(drop, T, tile))
    tiles = torch.cat(entries)
    tris = torch.arange(xs.shape[0], device=dev, dtype=torch.int32).repeat(SPAN * SPAN)

    tiles_sorted, order = torch.sort(tiles, stable=True)
    tris_sorted = tris[order]
    starts = torch.searchsorted(tiles_sorted, torch.arange(T, device=dev))
    counts = torch.searchsorted(tiles_sorted, torch.arange(1, T + 1, device=dev)) - starts

    ks = torch.arange(K, device=dev)
    idx = (starts[:, None] + ks[None]).clamp(0, tris_sorted.shape[0] - 1)
    tile_tris = torch.where(ks[None] < counts[:, None], tris_sorted[idx],
                            torch.full_like(tris_sorted[idx], -1))

    # global list: stable-sort the big flags descending, take the first Kg ids
    gorder = torch.sort((~big).to(torch.uint8), stable=True).indices[:Kg]
    global_tris = torch.where(big[gorder], gorder.to(torch.int32),
                              torch.full_like(gorder, -1, dtype=torch.int32))
    return tile_tris, counts, global_tris, big.sum()


class ViewBins(NamedTuple):
    """One view's binning: the z-test's inputs and the overflow counters."""
    coords: torch.Tensor        # (F', 9) f32 screen coords [ax ay az bx by bz cx cy cz]
    tile_tris: torch.Tensor     # (T, K) int32, -1 past each tile's count
    tile_counts: torch.Tensor   # (T,) int32, min(count, K)
    global_tris: torch.Tensor   # (Kg',) int32, -1 past global_count
    global_count: torch.Tensor  # () int32, min(big triangles, Kg')
    sel: Optional[torch.Tensor]  # (live_cap,) compacted id -> face, or None
    tile_over: torch.Tensor     # triangles dropped from the fullest tile
    global_over: torch.Tensor   # big triangles dropped from the global list
    live_over: torch.Tensor     # live faces dropped by the compaction


def tile_candidates(v_clip: torch.Tensor, faces: torch.Tensor, res: Tuple[int, int],
                    face_mask: Optional[torch.Tensor] = None, K: int = 256, Kg: int = 64,
                    live_cap: int = 65536) -> ViewBins:
    """Binning for one view (v_clip (V, 4)): the z-test's inputs. The
    z-test gathers each listed face's coords itself, so no per-tile
    candidate tensor is built. When the face list is longer than
    ``live_cap`` (the marching-tets list is ~318k slots of which ~20k are
    live), live faces are compacted into ``live_cap`` slots first and
    ``sel`` maps a compacted id back to its face; dropped live faces count
    in live_over. Kg' = min(Kg, F')."""
    F = faces.shape[0]
    dev = v_clip.device
    v_clip = v_clip.detach()
    if face_mask is None:
        face_mask = torch.ones((F,), dtype=torch.bool, device=dev)
    x, y, z, _ = _screen_coords(v_clip, res)

    # behind-camera triangles are dropped (no near-plane clipping; DMTet
    # objects are fully in front of the reference cameras)
    face_ok = face_mask & (v_clip[faces, 3] > 1e-6).all(dim=1)
    if F > live_cap:
        pos = torch.cumsum(face_ok.int(), 0) - 1
        slot = torch.where(face_ok & (pos < live_cap), pos, live_cap)
        sel = torch.full((live_cap + 1,), -1, dtype=torch.int64, device=dev)
        sel = sel.scatter(0, slot, torch.arange(F, device=dev))[:live_cap]
        live_over = (pos[-1] + 1 - live_cap).clamp(min=0)
        fb = faces[sel.clamp(min=0)]
        face_ok_b = sel >= 0
    else:
        sel = None
        live_over = torch.zeros((), dtype=torch.int64, device=dev)
        fb, face_ok_b = faces, face_ok
    xs, ys, zs = x[fb], y[fb], z[fb]                          # (F', 3)

    tile_tris, tile_counts, global_tris, global_count = bin_triangles(
        xs, ys, face_ok_b, res, K, Kg)
    Kg = global_tris.shape[0]            # bin_triangles clamps Kg to F'
    coords = torch.stack([xs, ys, zs], dim=2).reshape(-1, 9)  # ax ay az bx by bz cx cy cz
    return ViewBins(coords, tile_tris, tile_counts.clamp(max=K).to(torch.int32), global_tris,
                    global_count.clamp(max=Kg).to(torch.int32), sel,
                    (tile_counts.max() - K).clamp(min=0), (global_count - Kg).clamp(min=0),
                    live_over)


def _tile_image(t: torch.Tensor, B: int, res: Tuple[int, int]) -> torch.Tensor:
    """(..., B*T, TILE, TILE) tiles -> (..., B, H, W) images."""
    H, W = res
    ntx, nty, _ = tile_grid(res)
    lead = t.shape[:-3]
    t = t.reshape(lead + (B, nty, ntx, TILE, TILE)).transpose(-3, -2)
    return t.reshape(lead + (B, nty * TILE, ntx * TILE))[..., :H, :W]


@torch.no_grad()
def rasterize_select(v_clip: torch.Tensor, faces: torch.Tensor, res: Tuple[int, int],
                     face_mask: Optional[torch.Tensor] = None, num_layers: int = 1,
                     K: int = 256, Kg: int = 64, live_cap: int = 65536):
    """The non-differentiable half of rasterization: binning + the tile
    z-test of every view and depth layer in one kernel launch.

    v_clip (B, V, 4). Returns (tri_imgs (B, L, H, W) int64, tile_over (B,),
    global_over (B,), live_over (B,)). Kept apart from
    :func:`rasterize_apply` so that callers run selection once, outside a
    checkpointed region."""
    B = v_clip.shape[0]
    bins = ViewBins(*zip(*(tile_candidates(v_clip[b], faces, res, face_mask, K, Kg, live_cap)
                           for b in range(B))))     # each field a tuple over the views
    tri_t, _ = tile_zmin(torch.stack(bins.coords), torch.cat(bins.tile_tris),
                         torch.cat(bins.tile_counts), torch.stack(bins.global_tris),
                         torch.stack(bins.global_count), res, num_layers)
    tri_img = _tile_image(tri_t, B, res).transpose(0, 1).long()     # (B, L, H, W)
    if bins.sel[0] is not None:
        # map compacted ids back to the original face list
        sel = torch.stack(bins.sel)
        orig = sel.gather(1, tri_img.clamp(min=0).reshape(B, -1)).view_as(tri_img)
        tri_img = torch.where(tri_img >= 0, orig, -1)
    return tri_img, torch.stack(bins.tile_over), torch.stack(bins.global_over), \
        torch.stack(bins.live_over)


def _barycentrics_at(v_clip, faces, tri_id, px, py, res):
    """Differentiable perspective-correct barycentrics and screen z of the
    (fixed) triangle ``tri_id`` at pixel centres ``px, py`` (any shape
    matching ``tri_id``)."""
    x, y, z, inv_w = _screen_coords(v_clip, res)
    f = faces[tri_id.clamp(min=0)]                  # (..., 3)
    f0, f1, f2 = f[..., 0], f[..., 1], f[..., 2]
    ax, bx, cx = gather(x, f0), gather(x, f1), gather(x, f2)
    ay, by, cy = gather(y, f0), gather(y, f1), gather(y, f2)
    w0 = _edge(bx, by, cx, cy, px, py)
    w1 = _edge(cx, cy, ax, ay, px, py)
    area = _edge(ax, ay, bx, by, cx, cy)
    tiny = torch.where(area >= 0, 1e-12, -1e-12)
    inv_area = torch.reciprocal(torch.where(area.abs() > 1e-12, area, tiny))
    l0 = w0 * inv_area
    l1 = w1 * inv_area
    l2 = 1.0 - l0 - l1
    # perspective correction: weight by 1/w, then renormalize
    p0 = l0 * gather(inv_w, f0)
    p1 = l1 * gather(inv_w, f1)
    p2 = l2 * gather(inv_w, f2)
    s = p0 + p1 + p2
    s = torch.where(s.abs() > 1e-12, s, torch.full_like(s, 1e-12))
    bary = torch.stack([p0 / s, p1 / s, p2 / s], dim=-1)
    zpix = l0 * gather(z, f0) + l1 * gather(z, f1) + l2 * gather(z, f2)
    return bary, zpix


def _pixel_centres(res, device):
    H, W = res
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device) + 0.5,
                            torch.arange(W, dtype=torch.float32, device=device) + 0.5,
                            indexing='ij')
    return px, py


def rasterize_apply(v_clip: torch.Tensor, faces: torch.Tensor, tri_imgs: torch.Tensor,
                    res: Tuple[int, int], tile_over=None, global_over=None):
    """The differentiable half for one view: barycentrics of the selected
    triangles, tri_imgs (L, H, W). Returns a list of RasterOut."""
    px, py = _pixel_centres(res, v_clip.device)
    layers = []
    for tri_img in tri_imgs:
        bary, zpix = _barycentrics_at(v_clip, faces, tri_img, px, py, res)
        valid = tri_img >= 0
        layers.append(RasterOut(tri_id=tri_img, bary=torch.where(valid[..., None], bary, 0.0),
                                zbuf=torch.where(valid, zpix, BIG), valid=valid,
                                bin_overflow=tile_over, global_overflow=global_over))
    return layers


@torch.no_grad()
def compact_pixels(tri_img: torch.Tensor, cap: int):
    """Indices of covered pixels in a fixed ``cap`` of slots: tri_img
    (..., H, W) -> (idx (..., cap) into the flattened image, sel_valid
    (..., cap) bool, overflow (...) = covered pixels dropped)."""
    flat = tri_img.flatten(-2)
    covered = flat >= 0
    pos = torch.cumsum(covered.int(), -1) - 1
    tgt = torch.where(covered & (pos < cap), pos, cap).long()
    src = torch.arange(flat.shape[-1], device=flat.device).expand_as(flat)
    idx = torch.zeros(flat.shape[:-1] + (cap + 1,), dtype=torch.int64, device=flat.device)
    idx = idx.scatter(-1, tgt, src)[..., :cap]
    count = pos[..., -1] + 1
    sel_valid = torch.arange(cap, device=flat.device) < count.clamp(max=cap)[..., None]
    return idx, sel_valid, (count - cap).clamp(min=0)


def rasterize_apply_compact(v_clip, faces, tri_img, idx, sel_valid, res) -> RasterOut:
    """Differentiable barycentrics on the compacted covered-pixel list: a
    RasterOut whose fields are 1-D over the cap slots, equal to the dense
    path at every covered pixel; scatter back with :func:`scatter_pixels`."""
    H, W = res
    tri_c = torch.where(sel_valid, tri_img.reshape(-1)[idx], -1)
    px = (idx % W).float() + 0.5
    py = torch.div(idx, W, rounding_mode='floor').float() + 0.5
    bary, zpix = _barycentrics_at(v_clip, faces, tri_c, px, py, res)
    valid = tri_c >= 0
    return RasterOut(tri_id=tri_c, bary=torch.where(valid[..., None], bary, 0.0),
                     zbuf=torch.where(valid, zpix, BIG), valid=valid)


def scatter_pixels(vals: torch.Tensor, idx: torch.Tensor, sel_valid: torch.Tensor,
                   res: Tuple[int, int], fill: float = 0.0) -> torch.Tensor:
    """(cap, C) or (cap,) compact values -> dense (H, W, C) or (H, W),
    ``fill`` elsewhere. Differentiable (the backward is a gather)."""
    H, W = res
    squeeze = vals.ndim == 1
    if squeeze:
        vals = vals[:, None]
    tgt = torch.where(sel_valid, idx, H * W)
    out = vals.new_full((H * W + 1, vals.shape[-1]), fill).index_put((tgt,), vals)
    out = out[:H * W].reshape(H, W, vals.shape[-1])
    return out[..., 0] if squeeze else out


def rasterize(v_clip: torch.Tensor, faces: torch.Tensor, res: Tuple[int, int],
              face_mask: Optional[torch.Tensor] = None, num_layers: int = 1,
              K: int = 256, Kg: int = 64, live_cap: int = 65536):
    """Rasterize one view (v_clip (V, 4)): a list of ``num_layers``
    RasterOut, far layers testing strictly greater z (reference
    render.py:290-297). The live-face overflow folds into bin_overflow."""
    tri_imgs, tile_over, global_over, live_over = rasterize_select(
        v_clip[None], faces, res, face_mask, num_layers, K, Kg, live_cap)
    return rasterize_apply(v_clip, faces, tri_imgs[0], res, tile_over[0] + live_over[0],
                           global_over[0])


def grow_capacity(cur: int, over: int, cap: Optional[int] = None, first: int = 1) -> int:
    """Double ``cur`` (times ``first`` at once) until it holds cur + over,
    at most ``cap``: the capacity a render that overflowed by ``over`` is
    redone with."""
    new = max(cur, 1) * first
    while new < cur + over:
        new *= 2
    return new if cap is None else min(new, cap)


def interpolate(attr: torch.Tensor, rast: RasterOut, faces: torch.Tensor) -> torch.Tensor:
    """Perspective-correct attribute interpolation (``dr.interpolate``):
    attr (V, C) -> (..., C); zeros where empty."""
    vals = gather(attr, faces[rast.tri_id.clamp(min=0)])  # (..., 3, C)
    out = torch.sum(vals * rast.bary[..., None], dim=-2)
    return torch.where(rast.valid[..., None], out, 0.0)


def uv_derivatives(texc: torch.Tensor) -> torch.Tensor:
    """Screen-space uv derivatives (du/dx, du/dy, dv/dx, dv/dy) of a
    (H, W, 2) uv image by one-pixel forward differences (the last row and
    column difference to themselves): the cheap estimate;
    :func:`uv_derivatives_analytic` is the exact ``rast_db`` equivalent."""
    du_dx = torch.diff(texc, dim=1, append=texc[:, -1:])
    du_dy = torch.diff(texc, dim=0, append=texc[-1:])
    return torch.cat([du_dx[..., :1], du_dy[..., :1], du_dx[..., 1:2], du_dy[..., 1:2]], dim=-1)


def uv_derivatives_analytic(uv_attr: torch.Tensor, rast: RasterOut, v_clip: torch.Tensor,
                            faces: torch.Tensor, res: Tuple[int, int]) -> torch.Tensor:
    """Exact screen-space derivatives (du/dx, du/dy, dv/dx, dv/dy) of the
    perspective-correct interpolated uv: nvdiffrast's ``rast_db`` feeding
    ``dr.texture``'s mip selection (reference texture.py:67-75).

    The winning triangle's screen-linear barycentrics l_i are affine in the
    pixel coordinates; with q_i = 1/w_i and s = sum_j l_j q_j the
    perspective-correct p_i = l_i q_i / s has dp_i = (dl_i q_i s - l_i q_i
    ds) / s^2, in closed form a pixel. uv_attr (V, 2); returns (H, W, 4),
    zeros where nothing covers."""
    x, y, _, inv_w = _screen_coords(v_clip, res)
    f = faces[rast.tri_id.clamp(min=0)]                # (H, W, 3)
    f0, f1, f2 = f[..., 0], f[..., 1], f[..., 2]
    ax, bx, cx = gather(x, f0), gather(x, f1), gather(x, f2)
    ay, by, cy = gather(y, f0), gather(y, f1), gather(y, f2)
    qa, qb, qc = gather(inv_w, f0), gather(inv_w, f1), gather(inv_w, f2)
    px, py = _pixel_centres(res, v_clip.device)
    w0 = _edge(bx, by, cx, cy, px, py)
    w1 = _edge(cx, cy, ax, ay, px, py)
    area = _edge(ax, ay, bx, by, cx, cy)
    tiny = torch.where(area >= 0, 1e-12, -1e-12)
    inv_area = 1.0 / torch.where(area.abs() > 1e-12, area, tiny)
    l0 = w0 * inv_area
    l1 = w1 * inv_area
    l2 = 1.0 - l0 - l1
    # the affine gradients of the screen-linear barycentrics:
    # w0 = (cx-bx)(py-by) - (cy-by)(px-bx)  =>  dw0 = (-(cy-by), cx-bx)
    dl0x = (by - cy) * inv_area
    dl0y = (cx - bx) * inv_area
    dl1x = (cy - ay) * inv_area
    dl1y = (ax - cx) * inv_area
    dl2x = -(dl0x + dl1x)
    dl2y = -(dl0y + dl1y)

    n0, n1, n2 = l0 * qa, l1 * qb, l2 * qc
    s = n0 + n1 + n2
    s = torch.where(s.abs() > 1e-12, s, torch.full_like(s, 1e-12))
    dsx = dl0x * qa + dl1x * qb + dl2x * qc
    dsy = dl0y * qa + dl1y * qb + dl2y * qc
    inv_s = 1.0 / s

    def dp(dlx, dly, q, n):
        return ((dlx * q - n * inv_s * dsx) * inv_s, (dly * q - n * inv_s * dsy) * inv_s)

    dps = (dp(dl0x, dl0y, qa, n0), dp(dl1x, dl1y, qb, n1), dp(dl2x, dl2y, qc, n2))
    uv = [gather(uv_attr, fi) for fi in (f0, f1, f2)]   # each (H, W, 2)
    duv_dx = uv[0] * dps[0][0][..., None] + uv[1] * dps[1][0][..., None] \
        + uv[2] * dps[2][0][..., None]
    duv_dy = uv[0] * dps[0][1][..., None] + uv[1] * dps[1][1][..., None] \
        + uv[2] * dps[2][1][..., None]
    out = torch.stack([duv_dx[..., 0], duv_dy[..., 0], duv_dx[..., 1], duv_dy[..., 1]], dim=-1)
    return torch.where(rast.valid[..., None], out, 0.0)


def _aa_dir(color, tri, valid, z, x, y, faces, horizontal: bool):
    """Edge AA for one view and one neighbour direction (right or down
    pairs), over every pair: :func:`_aa_dir_flat` on a batch of one view.
    color (H, W, C); tri/valid/z (H, W); x, y (V,) screen coords. Returns
    the delta (H, W, C)."""
    return _aa_dir_flat(color[None], tri[None], valid[None], z[None], torch.stack([x, y], -1),
                        faces, torch.zeros(1, dtype=torch.int64, device=color.device),
                        horizontal)[0]


def _aa_dir_flat(color, tri, valid, z, xy, faces, voffs, horizontal: bool):
    """Edge AA for one neighbour direction over every adjacent pixel pair
    of every view (the JAX package's ``impl='flat'``):
    :func:`_aa_dir_compact` with a slot for every pair, so nothing is
    dropped. color (B, H, W, C); tri/valid/z (B, H, W); xy (B*V, 2) every
    view's screen coords in one table; voffs (B,) a view's offset into it.
    Returns the delta (B, H, W, C)."""
    B, H, W, _ = color.shape
    pairs = B * H * (W - 1) if horizontal else B * (H - 1) * W
    return _aa_dir_compact(color, tri, valid, z, xy, faces, voffs, horizontal, pairs)[0]


def _aa_dir_compact(color, tri, valid, z, xy, faces, voffs, horizontal: bool, budget: int):
    """Edge AA for one neighbour direction, on the silhouette pairs only.

    For every adjacent pixel pair whose triangle ids differ, the covering
    (nearer, or only valid) triangle's exit edge crosses the segment
    between the two centres at t; sub-pixel coverage is blended across the
    pair. t is differentiable in the projected vertices: the geometry
    gradient through coverage (nvdiffrast ``dr.antialias``). Active pairs
    are compacted into ``budget`` slots; a budget of every pair keeps each
    pair in its own slot instead. Returns (delta (B, H, W, C), overflow =
    active pairs dropped)."""
    B, H, W, C = color.shape
    if horizontal:
        h, w, stride = H, W - 1, 1
        sl_u = (slice(None), slice(None), slice(None, -1))
        sl_v = (slice(None), slice(None), slice(1, None))
    else:
        h, w, stride = H - 1, W, W
        sl_u = (slice(None), slice(None, -1), slice(None))
        sl_v = (slice(None), slice(1, None), slice(None))
    dev = color.device

    with torch.no_grad():
        tu, tv = tri[sl_u], tri[sl_v]
        vu, vv = valid[sl_u], valid[sl_v]
        cov_is_u = torch.where(vu & vv, z[sl_u] <= z[sl_v], vu)
        active = ((tu != tv) & (vu | vv)).reshape(-1)
        every_pair = budget >= active.numel()
        if every_pair:
            # each pair in its own slot: an idle slot adds its zero to its
            # own pixel, not to the sentinel row, where the idle slots'
            # atomic adds would all land on one address
            budget = active.numel()
            sel, ok = torch.arange(budget, device=dev), active
            overflow = torch.zeros((), dtype=torch.int64, device=dev)
        else:
            pos = torch.cumsum(active.int(), 0) - 1
            slot = torch.where(active & (pos < budget), pos, budget).long()
            sel = torch.full((budget + 1,), -1, dtype=torch.int64, device=dev)
            sel = sel.scatter(0, slot, torch.arange(B * h * w, device=dev))[:budget]
            overflow = (pos[-1] + 1 - budget).clamp(min=0)
            ok = sel >= 0
        selc = sel.clamp(min=0)
        b = torch.div(selc, h * w, rounding_mode='floor')
        r = selc % (h * w)
        yy = torch.div(r, w, rounding_mode='floor')
        xx = r % w
        u_id = b * (H * W) + yy * W + xx
        v_id = u_id + stride
        cov_u = cov_is_u.reshape(-1)[selc]
        tcov = torch.where(cov_u, tu.reshape(-1)[selc], tv.reshape(-1)[selc])
        f = faces[tcov.clamp(min=0)] + voffs[b][:, None]          # (A, 3)

    pc = gather(xy, f)                                            # (A, 3, 2)
    ax, ay = pc[:, 0, 0], pc[:, 0, 1]
    bx, by = pc[:, 1, 0], pc[:, 1, 1]
    cx, cy = pc[:, 2, 0], pc[:, 2, 1]
    area = _edge(ax, ay, bx, by, cx, cy)
    s = torch.where(area >= 0, 1.0, -1.0)

    pux = xx.float() + 0.5
    puy = yy.float() + 0.5
    pvx, pvy = (pux + 1.0, puy) if horizontal else (pux, puy + 1.0)
    pcx, pcy = torch.where(cov_u, pux, pvx), torch.where(cov_u, puy, pvy)
    pox, poy = torch.where(cov_u, pvx, pux), torch.where(cov_u, pvy, puy)

    def edges_at(qx, qy):
        return (_edge(bx, by, cx, cy, qx, qy) * s,
                _edge(cx, cy, ax, ay, qx, qy) * s,
                _edge(ax, ay, bx, by, qx, qy) * s)

    # Each edge belongs to ONE pair direction by its slope (nvdiffrast's
    # dy > dx rule): horizontal pairs resolve y-major edges, vertical pairs
    # x-major; otherwise a near-axis-parallel edge would also cross the
    # pairs parallel to it with dt/dvertex ~ 1/slope.
    exs = (cx - bx, ax - cx, bx - ax)
    eys = (cy - by, ay - cy, by - ay)
    t = torch.full((budget,), 2.0, device=dev)
    for ec, eo, ex, ey in zip(edges_at(pcx, pcy), edges_at(pox, poy), exs, eys):
        owned = ey.abs() >= ex.abs() if horizontal else ex.abs() > ey.abs()
        crossing = (eo < 0) & (ec >= 0) & owned
        denom = ec - eo
        tk = ec / torch.where(denom.abs() > 1e-12, denom, torch.full_like(denom, 1e-12))
        t = torch.minimum(t, torch.where(crossing, tk, 2.0))
    act = (ok & (t <= 1.0)).to(color.dtype)[:, None]
    t = t.clamp(0.0, 1.0)[:, None]

    col_flat = color.reshape(B * H * W, C)
    cu_, cv_ = gather(col_flat, u_id), gather(col_flat, v_id)
    ccov = torch.where(cov_u[:, None], cu_, cv_)
    coth = torch.where(cov_u[:, None], cv_, cu_)
    # the boundary at t from the covering centre: t > 1/2 covers (t - 1/2)
    # of the other pixel's cell, t < 1/2 uncovers (1/2 - t) of its own
    d_oth = torch.relu(t - 0.5) * (ccov - coth) * act
    d_cov = torch.relu(0.5 - t) * (coth - ccov) * act
    du = torch.where(cov_u[:, None], d_cov, d_oth)
    dv = torch.where(cov_u[:, None], d_oth, d_cov)
    n = B * H * W
    if not every_pair:
        u_id = torch.where(ok, u_id, n)     # unfilled slots go to the sentinel row
        v_id = torch.where(ok, v_id, n)
    delta = color.new_zeros((n + 1, C)).index_add(0, u_id, du).index_add(0, v_id, dv)
    return delta[:n].reshape(B, H, W, C), overflow


def antialias_views(color: torch.Tensor, tri_id: torch.Tensor, valid: torch.Tensor,
                    zbuf: torch.Tensor, v_clip: torch.Tensor, faces: torch.Tensor,
                    impl: str = 'compact', budget: Optional[int] = None):
    """All-views edge AA in one call (the semantics of :func:`antialias` on
    each view). color (B, H, W, C); tri_id/valid/zbuf (B, H, W); v_clip
    (B, V, 4); faces (F, 3). Every view's screen coords go into one (B*V,
    2) table. ``impl`` 'compact' runs the pair math on the silhouette pairs
    compacted into ``budget`` slots; any other value, as in the JAX
    package, gives every pair a slot ('flat'). Returns (img, overflow): the
    active pairs 'compact' dropped, 0 for 'flat'."""
    B, H, W, _ = color.shape
    V = v_clip.shape[1]
    x, y, _, _ = _screen_coords(v_clip.reshape(B * V, 4), (H, W))
    xy = torch.stack([x, y], dim=-1)
    voffs = torch.arange(B, device=color.device) * V
    args = (tri_id, valid, zbuf, xy, faces, voffs)
    if impl == 'compact':
        if budget is None:
            budget = B * (H + W) * 8          # ~16x a typical blob silhouette
        dh, oh = _aa_dir_compact(color, *args, True, budget)
        dv, ov = _aa_dir_compact(color, *args, False, budget)
        return color + dh + dv, torch.maximum(oh, ov)
    return (color + _aa_dir_flat(color, *args, True) + _aa_dir_flat(color, *args, False),
            torch.zeros((), dtype=torch.int64, device=color.device))


def antialias(color: torch.Tensor, rast: RasterOut, v_clip: torch.Tensor,
              faces: torch.Tensor) -> torch.Tensor:
    """Edge AA of one view (``dr.antialias``, reference render.py:262):
    color (H, W, C), the view's rasterization and v_clip (V, 4); returns
    (H, W, C). Adjacent pixel pairs (right and down) with differing
    triangle ids are blended by the covering triangle's analytic sub-pixel
    coverage, over every pair, which gives gradients with respect to
    the vertices through coverage. A shared interior edge gives a near-zero
    delta, both sides shading alike."""
    H, W = rast.tri_id.shape
    x, y, _, _ = _screen_coords(v_clip, (H, W))
    args = (rast.tri_id, rast.valid, rast.zbuf, x, y, faces)
    return color + _aa_dir(color, *args, True) + _aa_dir(color, *args, False)
