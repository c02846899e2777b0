"""Deferred mesh renderer: rasterize -> interpolate -> shade -> composite.

Counterpart of ``meshdiffusion_tpu/render/render.py`` (reference
``nvdiffrec/lib/render/render.py``: shade:26-138, render_layer:146-227,
render_mesh:235-409, render_uv:414-432) on the port's rasterizer:

* triangle selection (binning + the tile z-test kernel) runs once for all
  views and layers, outside any checkpointed region, since it carries no
  gradient;
* ``shade_cap`` runs the per-pixel chain (barycentrics, interpolation,
  shading) over at most ``shade_cap`` covered pixels per view and layer,
  then scatters back; exact where the coverage fits, the dropped pixels
  counted in ``shade_overflow``;
* ``remat`` wraps each view's per-pixel chain in
  ``torch.utils.checkpoint``, so its intermediates are recomputed in the
  backward pass instead of kept;
* composite antialiasing is the analytic edge AA, the coverage-gradient
  path to vertices: ``MESHDIFFUSION_AA_IMPL`` picks ``compact`` (the
  default: ``rasterize.antialias_views`` on the compacted silhouette
  pairs), ``flat`` (the same call, a slot for every pair) or ``vmap``
  (``rasterize.antialias``, one view at a time), as in the JAX package.

Materials are constant textures (a texture's first texel: no render path
interpolates texture coordinates, as in the JAX package) or the neural
``kd_ks_normal`` texture sampled at the interpolated positions, its kd
smoothness term from a second sample at positions jittered by
0.01 * N(0, 1). The jitter's normal draws come from a ``normal(shape)``
source, one draw a view, shared by its layers (the JAX package's one key
a view). BSDFs: 'diffuse' under an environment light, optionally rotated
by ``xfm_lgt``, and the 'normal', 'tangent', 'kd' and 'ks' debug BSDFs;
'pbr' raises, as in the JAX package and the reference. One sample a
pixel, a black background, smooth shading; ``render_uv`` bakes a neural
texture into UV space.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..utils.gather import gather
from . import ops, utils
from .light import EnvironmentLight
from .mesh import Mesh
from .rasterize import (BIG, RasterOut, antialias, antialias_views, compact_pixels,
                        grow_capacity, interpolate, rasterize, rasterize_apply,
                        rasterize_apply_compact, rasterize_select, scatter_pixels)
from .texture import Texture2D

# a source of N(0, 1) draws of a given shape (the neural material's jitter)
Normal = Callable[[Tuple[int, ...]], torch.Tensor]


def torch_normal(generator: Optional[torch.Generator] = None, device=None) -> Normal:
    """A :data:`Normal` source drawing from ``generator``."""
    return lambda shape: torch.randn(shape, generator=generator, device=device)


def _constant(tex: Texture2D, like):
    """A texture's first texel broadcast over ``like``'s pixels (no render
    path interpolates texture coordinates, reference render.py:66-68)."""
    const = tex.get_mips()[0][0, 0, 0]
    return const.expand(like.shape[:-1] + const.shape[-1:])


def shade(gb_pos, gb_geometric_normal, gb_normal, view_pos, lgt, material, bsdf,
          gb_tangent=None, xfm_lgt=None, jitter=None) -> Dict[str, torch.Tensor]:
    """Pixel shader (reference render.py:26-138). view_pos broadcasts
    against gb_pos (..., 3). ``jitter``: N(0, 1) draws shaped like gb_pos
    for a neural material's kd smoothness term (None: no jitter, the term
    is 0)."""
    perturbed_nrm = None
    if 'kd_ks_normal' in material:
        tex = material['kd_ks_normal']
        all_tex = tex.sample(gb_pos)
        kd, ks, perturbed_nrm = all_tex[..., :-6], all_tex[..., -6:-3], all_tex[..., -3:]
        if jitter is None:
            kd_grad = torch.zeros_like(kd[..., 0:1])
        else:
            all_tex_jitter = tex.sample(gb_pos + 0.01 * jitter)
            kd_grad = torch.sum((all_tex_jitter[..., :-6] - kd).abs(), dim=-1, keepdim=True) / 3
    else:
        kd = _constant(material['kd'], gb_pos)
        ks = _constant(material['ks'], gb_pos)[..., 0:3]
        # no texture coordinates, so no jitter: the kd smoothness term is zero
        kd_grad = torch.zeros_like(kd[..., 0:1])
    alpha = kd[..., 3:4] if kd.shape[-1] == 4 else torch.ones_like(kd[..., 0:1])
    kd = kd[..., 0:3]
    if material.get('no_perturbed_nrm'):
        perturbed_nrm = None

    gb_normal_s = ops.prepare_shading_normal(gb_pos, view_pos, perturbed_nrm, gb_normal,
                                             gb_tangent, gb_geometric_normal)
    gb_geo_corrected = ops.prepare_shading_normal(gb_pos, view_pos, None, gb_geometric_normal,
                                                  gb_tangent, gb_geometric_normal)
    bsdf = material.get('bsdf') if bsdf is None else bsdf
    if bsdf == 'pbr':
        raise NotImplementedError('pbr split-sum shading (the reference raises too, '
                                  'render.py:93-95)')
    if bsdf == 'diffuse':
        assert isinstance(lgt, EnvironmentLight), 'Invalid light type'
        shaded_col = lgt.shade(gb_pos, gb_geo_corrected, kd, ks, view_pos, specular=False,
                               xfm_lgt=xfm_lgt)
    elif bsdf == 'normal':
        shaded_col = (gb_normal_s + 1.0) * 0.5
    elif bsdf == 'tangent':
        shaded_col = (gb_tangent + 1.0) * 0.5
    elif bsdf == 'kd':
        shaded_col = kd
    elif bsdf == 'ks':
        shaded_col = ks
    else:
        raise ValueError(f"Invalid BSDF '{bsdf}'")

    depth = torch.sqrt(torch.sum((gb_pos - view_pos) ** 2, dim=-1, keepdim=True) + 1e-20)

    def cat(a):
        return torch.cat([a, alpha], dim=-1)
    return {
        'shaded': cat(shaded_col),
        'kd_grad': cat(kd_grad),
        'occlusion': cat(ks[..., :1]),
        'normal': cat(gb_normal_s),
        'depth': cat(depth),
        'pos': cat(gb_pos),
        'geo_normal': cat(gb_geo_corrected),
        'geo_viewdir': cat(view_pos - gb_pos),
        'alpha': alpha,
    }


def render_layer(rast: RasterOut, mesh: Mesh, view_pos, lgt, bsdf, xfm_lgt=None,
                 jitter=None) -> Dict[str, torch.Tensor]:
    """Interpolate the G-buffer and shade one depth layer
    (reference render.py:146-227). ``rast`` may be dense (H, W) or the
    compacted 1-D slots. The mesh has smooth normals (and tangents, if
    any) on its position index (``mesh.auto_normals``), as every mesh a
    render path builds does."""
    faces = mesh.t_pos_idx
    assert mesh.v_nrm is not None and mesh.t_nrm_idx is faces, 'needs auto_normals'
    assert mesh.v_tng is None or mesh.t_tng_idx is faces, 'tangents off the position index'
    v0, v1, v2 = (gather(mesh.v_pos, faces[:, k]) for k in range(3))
    face_normals = utils.safe_normalize(torch.cross(v1 - v0, v2 - v0, dim=-1))
    valid = rast.valid[..., None]
    gb_geometric_normal = torch.where(valid, gather(face_normals, rast.tri_id.clamp(min=0)), 0.0)
    # positions, normals (and tangents) share one index: one gather of the
    # concatenated attribute table (and one scatter in backward)
    parts = [mesh.v_pos, mesh.v_nrm] + ([mesh.v_tng] if mesh.v_tng is not None else [])
    gb = interpolate(torch.cat(parts, dim=1), rast, faces)
    gb_tangent = gb[..., 6:9] if mesh.v_tng is not None else None
    buffers = shade(gb[..., 0:3], gb_geometric_normal, gb[..., 3:6], view_pos, lgt,
                    mesh.material, bsdf, gb_tangent, xfm_lgt, jitter)
    # interpolate(ones) is the coverage mask: the barycentrics sum to 1
    buffers['mask'] = buffers['mask_cont'] = valid.float()
    return buffers


def render_mesh(mesh: Mesh, mtx_in: torch.Tensor, view_pos: torch.Tensor, lgt,
                resolution: Tuple[int, int], num_layers: int = 2, bsdf=None,
                raster_K: int = 256, raster_Kg: int = 64, aa: bool = True,
                aa_budget: Optional[int] = None, raster_live: int = 65536,
                remat: bool = False, shade_cap: Optional[int] = None,
                tet_centers: Optional[torch.Tensor] = None, xfm_lgt=None,
                normal: Optional[Normal] = None) -> Dict[str, torch.Tensor]:
    """Depth-peeled render of a camera batch (reference render.py:235-409).

    mtx_in (B, 4, 4) mvp; view_pos (B, 3). Returns (B, H, W, C) buffers and
    the overflow counters raster_overflow (grow raster_K),
    raster_overflow_global (raster_Kg), raster_overflow_live
    (raster_live), aa_overflow (aa_budget) and shade_overflow (shade_cap);
    with ``tet_centers`` (T, 3) also ``visible_tet_mask`` (T,)
    (:func:`visible_tets`). ``xfm_lgt`` (1 or B, 4, 4) rotates the
    environment light's lookup (``random_lgt``); ``normal`` supplies a
    neural material's jitter draws, one call a view in view order (shape
    (H, W, 3) dense, (shade_cap, 3) compacted); without it the jitter term
    is 0.
    """
    dev = mesh.v_pos.device
    mtx_in = torch.as_tensor(mtx_in, dtype=torch.float32, device=dev)
    view_pos = torch.as_tensor(view_pos, dtype=torch.float32, device=dev)
    if mtx_in.ndim == 2:
        mtx_in = mtx_in[None]
    if view_pos.ndim == 1:
        view_pos = view_pos[None]
    B = mtx_in.shape[0]
    full_res = tuple(resolution)
    faces = mesh.t_pos_idx

    v_clip = ops.xfm_points(mesh.v_pos[None].expand(B, -1, -1), mtx_in)
    tri_sel, tile_over, global_over, live_over = rasterize_select(
        v_clip, faces, full_res, face_mask=mesh.face_mask, num_layers=num_layers,
        K=raster_K, Kg=raster_Kg, live_cap=raster_live)
    if shade_cap is not None:
        pix_idx, pix_valid, shade_over = compact_pixels(tri_sel, shade_cap)  # (B, L, cap)

    if xfm_lgt is not None:
        xfm_lgt = torch.as_tensor(xfm_lgt, dtype=torch.float32, device=dev)
    neural = mesh.material is not None and 'kd_ks_normal' in mesh.material

    def one_view(v_clip_b, tri_sel_b, view_pos_b, xfm_b, jitter_b, idx_b=None, selv_b=None):
        if idx_b is None:
            layers = rasterize_apply(v_clip_b, faces, tri_sel_b, full_res)
            return tuple(render_layer(r, mesh, view_pos_b, lgt, bsdf, xfm_b, jitter_b)
                         for r in layers), tuple(layers)
        # compact path: the per-pixel chain over (cap,) slots, scattered dense
        bufs, rasts = [], []
        for li in range(tri_sel_b.shape[0]):
            rast_c = rasterize_apply_compact(v_clip_b, faces, tri_sel_b[li], idx_b[li],
                                             selv_b[li], full_res)
            buf_c = render_layer(rast_c, mesh, view_pos_b, lgt, bsdf, xfm_b, jitter_b)
            dense_valid = tri_sel_b[li] >= 0
            buf = {k: scatter_pixels(v, idx_b[li], selv_b[li], full_res)
                   for k, v in buf_c.items() if k not in ('mask', 'mask_cont')}
            buf['mask'] = buf['mask_cont'] = dense_valid[..., None].float()
            bufs.append(buf)
            rasts.append(RasterOut(
                tri_id=tri_sel_b[li], bary=None, valid=dense_valid,
                zbuf=scatter_pixels(rast_c.zbuf, idx_b[li], selv_b[li], full_res, fill=BIG)))
        return tuple(bufs), tuple(rasts)

    def body(*args):
        if remat:
            return checkpoint(one_view, *args, use_reentrant=False)
        return one_view(*args)

    per_view = []
    for b in range(B):
        xfm_b = None if xfm_lgt is None else xfm_lgt[b if xfm_lgt.shape[0] > 1 else 0][None]
        # drawn outside the checkpointed region, so the recompute sees the same draws
        jitter_b = None
        if neural and normal is not None:
            jitter_b = normal((shade_cap, 3) if shade_cap is not None else full_res + (3,))
        args = (v_clip[b], tri_sel[b], view_pos[b], xfm_b, jitter_b)
        if shade_cap is not None:
            args += (pix_idx[b], pix_valid[b])
        per_view.append(body(*args))
    L = num_layers
    view_bufs = [{k: torch.stack([pv[0][li][k] for pv in per_view]) for k in per_view[0][0][li]}
                 for li in range(L)]
    view_rasts = [RasterOut(tri_id=tri_sel[:, li], bary=None,
                            zbuf=torch.stack([pv[1][li].zbuf for pv in per_view]),
                            valid=tri_sel[:, li] >= 0) for li in range(L)]

    background = torch.zeros((1, full_res[0], full_res[1], 4), device=dev)

    # the edge AA's implementation, as the JAX package reads it: 'compact'
    # (the default), 'flat' (every pair, every view in one call; so is any
    # other value) or 'vmap' (every pair, one view at a time); only 'compact' can drop
    # pairs, so only it reports an aa_overflow
    aa_impl = os.environ.get('MESHDIFFUSION_AA_IMPL', 'compact')
    aa_overflows = []

    def composite(key, li, bg, want_aa=False):
        buf = view_bufs[li][key]
        rast = view_rasts[li]
        alpha = rast.valid[..., None].float() * buf[..., -1:]
        fg = torch.cat([buf[..., :-1], torch.ones_like(buf[..., -1:])], dim=-1)
        img = bg + alpha * (fg - bg)
        if want_aa and aa:
            img = img.expand((B,) + img.shape[1:])
            if aa_impl == 'vmap':
                img = torch.stack([antialias(img[b], RasterOut(
                    tri_id=rast.tri_id[b], bary=None, zbuf=rast.zbuf[b], valid=rast.valid[b]),
                    v_clip[b], faces) for b in range(B)])
            else:
                img, aa_over = antialias_views(img, rast.tri_id, rast.valid, rast.zbuf, v_clip,
                                               faces, impl=aa_impl, budget=aa_budget)
                aa_overflows.append(aa_over)
        return img

    out: Dict[str, torch.Tensor] = {}
    for key in view_bufs[0]:
        if key == 'shaded':
            out[key] = composite(key, 0, background, want_aa=True)
        elif key in ('depth', 'pos'):
            out[key] = composite(key, 0, torch.full_like(view_bufs[0][key], 20.0))
        else:
            out[key] = composite(key, 0, torch.zeros_like(view_bufs[0][key]),
                                 want_aa='normal' in key)
    if num_layers > 1:
        out['shaded_second'] = composite('shaded', 1, background, want_aa=True)
        out['depth_second'] = composite('depth', 1, torch.full_like(view_bufs[1]['depth'], -1.0))
        out['normal_second'] = composite('normal', 1, torch.zeros_like(view_bufs[1]['normal']))

    zero = torch.zeros((), dtype=torch.int64, device=dev)
    out['rast_depth'] = view_rasts[0].zbuf
    out['raster_overflow'] = tile_over.max()
    out['raster_overflow_global'] = global_over.max()
    out['raster_overflow_live'] = live_over.max()
    out['aa_overflow'] = torch.stack(aa_overflows).max() if aa_overflows else zero
    out['shade_overflow'] = shade_over.max() if shade_cap is not None else zero
    # a fixed-size mask over faces in place of the reference's dynamic id list
    tri0 = view_rasts[0].tri_id.reshape(-1)
    out['rast_triangle_mask'] = torch.zeros(faces.shape[0], dtype=torch.int32, device=dev) \
        .scatter_reduce(0, tri0.clamp(min=0), (tri0 >= 0).int(), 'amax') > 0
    if tet_centers is not None:
        out['visible_tet_mask'] = visible_tets(tet_centers, mtx_in, view_pos, out['depth'],
                                               view_rasts[0].valid, full_res)
    return out


def visible_tets(tet_centers: torch.Tensor, mtx_in: torch.Tensor, view_pos: torch.Tensor,
                 depth_img: torch.Tensor, rast_valid: torch.Tensor, full_res,
                 depth_search_range: int = 7) -> torch.Tensor:
    """Tets not occluded in any view (reference render.py:346-407): a tet
    centre projected into the image is visible where the minimum depth in
    a SAME (2r+1)^2 window (empty pixels at 100) is at least its distance
    from the camera, or where every pixel of the window is empty. Like the JAX
    package, it compares camera distance on both sides (the reference
    compares a clip-space z with the distance image). Returns (T,) bool,
    the union over the views."""
    B = mtx_in.shape[0]
    H, W = full_res
    k, r = 2 * depth_search_range + 1, depth_search_range
    homo = ops.xfm_points(tet_centers[None].expand(B, -1, -1), mtx_in)
    w = homo[..., 3:4]
    ndc = homo[..., :3] / torch.where(w.abs() > 1e-9, w, torch.full_like(w, 1e-9))
    px = torch.round((ndc[..., 0] * 0.5 + 0.5) * (W - 1)).long()
    py = torch.round((ndc[..., 1] * 0.5 + 0.5) * (H - 1)).long()
    in_view = (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
    pxc, pyc = px.clamp(0, W - 1), py.clamp(0, H - 1)
    # max_pool2d pads with -inf: a SAME window over the image only
    d = torch.where(rast_valid, depth_img[..., 0], 100.0)
    dmin = -F.max_pool2d(-d[:, None], k, stride=1, padding=r)[:, 0]
    empty_all = -F.max_pool2d(-(~rast_valid).float()[:, None], k, stride=1, padding=r)[:, 0] > 0.5
    tet_depth = torch.sqrt(torch.sum((tet_centers[None] - view_pos[:, None, :]) ** 2, dim=-1))
    b = torch.arange(B, device=tet_centers.device)[:, None]
    vis = in_view & ((dmin[b, pyc, pxc] >= tet_depth) | empty_all[b, pyc, pxc])
    return vis.any(dim=0)


def render_uv(mesh: Mesh, resolution: Tuple[int, int], mlp_texture):
    """Bake a neural texture into UV space (reference render.py:414-432):
    the UV charts rasterized at z = 0 (every candidate ties, so the
    z-test's tie rule picks the winner), the 3D position interpolated at
    each texel and the texture sampled there. Returns (mask (H, W, 1),
    kd, ks, normalized normal). The bake drops nothing: no live-face
    compaction, and a binning that overflows K or Kg is redone with them
    grown (the JAX package keeps its first binning)."""
    uv_clip = mesh.v_tex * 2.0 - 1.0
    uv_clip4 = torch.cat([uv_clip, torch.zeros_like(uv_clip[..., :1]),
                          torch.ones_like(uv_clip[..., :1])], dim=-1)
    F_ = int(mesh.t_tex_idx.shape[0])
    K, Kg = 256, 64
    while True:
        rast = rasterize(uv_clip4, mesh.t_tex_idx, tuple(resolution), K=K, Kg=Kg,
                         live_cap=F_)[0]
        tile_over, global_over = int(rast.bin_overflow), int(rast.global_overflow)
        if not tile_over and not global_over:
            break
        K, Kg = grow_capacity(K, tile_over), grow_capacity(Kg, global_over)
    gb_pos = interpolate(mesh.v_pos, rast, mesh.t_pos_idx)
    all_tex = mlp_texture.sample(gb_pos)
    mask = rast.valid[..., None].float()
    return (mask, all_tex[..., :-6], all_tex[..., -6:-3],
            utils.safe_normalize(all_tex[..., -3:]))

