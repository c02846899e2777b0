"""UV parameterization of extracted meshes (xatlas.parametrize equivalent).

A copy of ``meshdiffusion_tpu/geometry/uv_unwrap.py`` (host numpy, so the
same code gives the same atlas bit for bit). The reference bakes its
learned MLP material into texture images through an xatlas UV atlas
(``nvdiffrec/eval.py:96-128``: ``xatlas.parametrize`` ->
``render.render_uv`` -> Texture2D material). xatlas is a C++ library this
package does not depend on; this module provides the same contract with a
chart-projection atlas:

1. faces are binned by dominant normal axis (6 bins, +-x/+-y/+-z) and split
   into edge-connected components -> charts (a chart never folds past 90
   degrees, so its axis projection is injective for typical DMTet surfaces;
   staircase-shaped charts within one bin CAN still self-overlap, so every
   chart is verified by rasterizing its triangles into a coverage grid and
   recursively bisected until its projection is provably injective — the
   guarantee xatlas provides by construction);
2. each chart is orthographically projected along its axis (sign-corrected
   so winding is preserved in UV space), keeping world scale -> uniform
   texel density across charts;
3. charts are shelf-packed into a square atlas with padding;
4. chart-boundary vertices are duplicated per chart, exactly like xatlas:
   returns (vmapping, new_faces, uvs) with ``new_v_pos = v_pos[vmapping]``.

Host-side numpy: it runs once per extracted mesh, and connectivity
surgery is the wrong shape for the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _face_components(faces: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Union-find over faces: connect faces sharing an edge AND a label.
    Returns per-face component id."""
    F = len(faces)
    parent = np.arange(F)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    e = np.sort(faces[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), axis=1)
    fid = np.repeat(np.arange(F), 3)
    order = np.lexsort((e[:, 1], e[:, 0]))
    es, fs = e[order], fid[order]
    same = (es[1:] == es[:-1]).all(axis=1)
    for k in np.nonzero(same)[0]:
        a, b = fs[k], fs[k + 1]
        if labels[a] == labels[b]:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra
    return np.asarray([find(i) for i in range(F)])


def chart_overlaps(uv: np.ndarray, lf: np.ndarray, res: int = 256) -> bool:
    """True if the chart's projected triangles double-cover any point.

    Rasterizes triangle INTERIORS (strict barycentric margin, so shared
    edges between neighbors don't count) at pixel centers of a res-bounded
    grid over the chart bbox and checks for coverage > 1.
    """
    if len(lf) < 2:
        return False
    size = uv.max(axis=0) - uv.min(axis=0)
    if size.max() <= 0:
        return False
    sc = (res - 1) / size.max()
    p = (uv - uv.min(axis=0)) * sc                     # pixel space
    nx = int(np.ceil(size[0] * sc)) + 1
    ny = int(np.ceil(size[1] * sc)) + 1
    cover = np.zeros((ny, nx), np.int32)
    tri = p[lf]                                        # (F, 3, 2)
    for a, b, c in tri:
        x0 = max(int(np.floor(min(a[0], b[0], c[0]))), 0)
        x1 = min(int(np.ceil(max(a[0], b[0], c[0]))), nx - 1)
        y0 = max(int(np.floor(min(a[1], b[1], c[1]))), 0)
        y1 = min(int(np.ceil(max(a[1], b[1], c[1]))), ny - 1)
        if x1 < x0 or y1 < y0:
            continue
        gx, gy = np.meshgrid(np.arange(x0, x1 + 1) + 0.5,
                             np.arange(y0, y1 + 1) + 0.5)
        d = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        if abs(d) < 1e-12:
            continue
        w0 = ((b[0] - a[0]) * (gy - a[1]) - (b[1] - a[1]) * (gx - a[0])) / d
        w1 = ((a[0] - c[0]) * (gy - c[1]) - (a[1] - c[1]) * (gx - c[0])) / d
        w2 = 1.0 - w0 - w1
        eps = 1e-4                                     # strict interior
        inside = (w0 > eps) & (w1 > eps) & (w2 > eps)
        cover[y0:y1 + 1, x0:x1 + 1] += inside.astype(np.int32)
    return bool((cover > 1).any())


# per dominant-axis bin: (u axis, v axis, u sign) chosen so the projected
# triangle keeps its winding (bake rasterization is orientation-agnostic,
# but consistent winding keeps derivative-based mip selection sane)
_PROJ = {
    0: (1, 2, +1.0),   # +x: (y, z)
    1: (2, 1, +1.0),   # -x: (z, y)
    2: (2, 0, +1.0),   # +y: (z, x)
    3: (0, 2, +1.0),   # -y: (x, z)
    4: (0, 1, +1.0),   # +z: (x, y)
    5: (1, 0, +1.0),   # -z: (y, x)
}


def parametrize(v_pos: np.ndarray, faces: np.ndarray,
                padding_frac: float = 0.01
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """xatlas.parametrize-compatible: (vmapping, new_faces, uvs).

    vmapping: (V', ) int32 into the original vertex array;
    new_faces: (F, 3) int32 into the V'-sized arrays; uvs: (V', 2) in [0,1].
    """
    v_pos = np.asarray(v_pos, np.float64)
    faces = np.asarray(faces, np.int64)
    if len(faces) == 0:
        return (np.zeros((0,), np.uint32), np.zeros((0, 3), np.uint32),
                np.zeros((0, 2), np.float32))

    n = np.cross(v_pos[faces[:, 1]] - v_pos[faces[:, 0]],
                 v_pos[faces[:, 2]] - v_pos[faces[:, 0]])
    ax = np.argmax(np.abs(n), axis=1)                  # 0..2
    sign_neg = np.take_along_axis(n, ax[:, None], 1)[:, 0] < 0
    bins = ax * 2 + sign_neg.astype(np.int64)          # 0..5

    comp = _face_components(faces, bins)
    chart_ids = np.unique(comp)

    def make_chart(fsel):
        b = bins[fsel[0]]
        ua, va, _ = _PROJ[int(b)]
        vids = np.unique(faces[fsel].reshape(-1))
        local = {int(g): i for i, g in enumerate(vids)}
        uv = np.stack([v_pos[vids, ua], v_pos[vids, va]], axis=1)
        uv = uv - uv.min(axis=0)
        lf = np.vectorize(lambda g: local[int(g)])(faces[fsel])
        return (uv, vids, lf, fsel)

    charts = []      # (local uvs (k,2), orig vert ids (k,), face rows, ids)
    # injectivity guarantee: a chart whose projection double-covers (checked
    # by strict-interior rasterization) is bisected along the longer bbox
    # axis of its face centroids until every piece passes; single-triangle
    # charts are trivially injective, so termination is guaranteed
    work = [np.nonzero(comp == cid)[0] for cid in chart_ids]
    while work:
        fsel = work.pop()
        chart = make_chart(fsel)
        uv, _, lf, _ = chart
        if len(fsel) > 1 and chart_overlaps(uv, lf):
            cent = uv[lf].mean(axis=1)                 # (F, 2)
            axis = int(np.argmax(uv.max(axis=0)))
            med = np.median(cent[:, axis])
            left = cent[:, axis] <= med
            if left.all() or not left.any():           # degenerate split
                left = np.zeros(len(fsel), bool)
                left[: len(fsel) // 2] = True
            work.append(fsel[left])
            work.append(fsel[~left])
            continue
        charts.append(chart)

    # shelf packing at uniform world scale
    sizes = np.asarray([c[0].max(axis=0) if len(c[0]) else np.zeros(2)
                        for c in charts])                   # (w, h) per chart
    total_area = float(np.prod(sizes + 1e-9, axis=1).sum())
    pad = padding_frac * max(np.sqrt(total_area), 1e-9)
    atlas_w = max(np.sqrt(total_area) * 1.15, sizes[:, 0].max() + 2 * pad)

    order = np.argsort(-sizes[:, 1])                   # tallest first
    offsets = np.zeros((len(charts), 2))
    x = pad
    y = pad
    row_h = 0.0
    for ci in order:
        w, h = sizes[ci]
        if x + w + pad > atlas_w and x > pad:
            x = pad
            y += row_h + pad
            row_h = 0.0
        offsets[ci] = (x, y)
        x += w + pad
        row_h = max(row_h, h)
    atlas_h = y + row_h + pad
    scale = 1.0 / max(atlas_w, atlas_h)

    vmapping, uvs = [], []
    # new_faces stays aligned with the ORIGINAL face order (the reference
    # keeps the base mesh's t_pos_idx and pairs it slot-for-slot with the
    # returned t_tex_idx, eval.py:111-121 / render_uv)
    new_faces = np.zeros_like(faces)
    base = 0
    for (uv, vids, lf, fsel), off in zip(charts, offsets):
        vmapping.append(vids)
        uvs.append((uv + off[None]) * scale)
        new_faces[fsel] = lf + base
        base += len(vids)
    return (np.concatenate(vmapping).astype(np.uint32),
            new_faces.astype(np.uint32),
            np.concatenate(uvs).astype(np.float32))
