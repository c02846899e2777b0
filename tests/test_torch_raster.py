"""The port's rasterizer against the JAX package, on the CPU.

The tile z-test's plain version (what ``ops.tile_zmin`` runs on a CPU
tensor; the CUDA kernel matches it exactly on the card, see
tests/test_torch_kernels.py) against the Pallas kernel in interpret mode and
the jnp scan path, ties included; binning, selection, rasterization,
interpolation, the compacted AA and the pixel compaction against their JAX
counterparts. Integer outputs must be equal; float tolerances are stated
where they are used.

XLA on the CPU contracts ``a*b - c*d`` into a fused multiply-add; the port
rounds every product and sum on its own (as its CUDA kernel does, so that
kernel and plain version agree to the bit). Screen-space z therefore
differs from JAX's by a few ulps: measured 1.4e-6 at most on these scenes,
hence z atol 2e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshdiffusion_tpu.ops.tile_raster import tile_zmin_pallas
from meshdiffusion_tpu.render import rasterize as JR
from meshdiffusion_tpu_torch.ops import tile_zmin
from meshdiffusion_tpu_torch.render import rasterize as R

pytest_plugins = ('torch_rules',)

Z_ATOL = 2e-6     # FMA (XLA) against op-by-op rounding (port), see above


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a)) if dtype is None else torch.from_numpy(np.array(a)).to(dtype)


def random_scene(seed, n_tris=300, big=1.2):
    """tests/test_tile_raster.py's scene: random triangles, z in [-0.9, 0.9]."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-big, big, (n_tris * 3, 4)).astype(np.float32)
    v[:, 2] = rng.uniform(-0.9, 0.9, n_tris * 3)
    v[:, 3] = 1.0
    return v, np.arange(n_tris * 3, dtype=np.int32).reshape(-1, 3)


def small_scene(seed, n_tris=400, res=64):
    """Many small triangles (a few pixels) plus a few screen-filling ones:
    both the per-tile lists and the global big-triangle list are used."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.9, 0.9, (n_tris, 1, 2))
    xy = c + rng.normal(0.0, 4.0 / res, (n_tris, 3, 2))
    xy[:12] = rng.uniform(-1.0, 1.0, (12, 3, 2))
    v = np.concatenate([xy.reshape(-1, 2), rng.uniform(-0.9, 0.9, (n_tris * 3, 1)),
                        rng.uniform(0.8, 1.2, (n_tris * 3, 1))], 1).astype(np.float32)
    v[:, :3] *= v[:, 3:]                  # clip space: the same NDC at varying w
    return v, np.arange(n_tris * 3, dtype=np.int32).reshape(-1, 3)


def _binned(v, f, res, K, Kg=64):
    """The JAX rasterizer's binning of one view as the port's z-test takes
    it, as numpy: (coords (1, F, 9), tile_tris (T, K), tile_counts (T,) =
    min(count, K), global_tris (1, Kg'), global_count (1,))."""
    x, y, z, _ = JR._screen_coords(jnp.asarray(v), res)
    f = jnp.asarray(f)
    xs, ys, zs = (jnp.stack([a[f[:, 0]], a[f[:, 1]], a[f[:, 2]]], 1) for a in (x, y, z))
    tt, counts, gt, gcount = JR.bin_triangles(xs, ys, jnp.ones((f.shape[0],), bool), res, K=K,
                                              Kg=Kg)
    coords = jnp.stack([xs, ys, zs], 2).reshape(-1, 9)
    i32 = lambda a: np.asarray(a).astype(np.int32)
    return (np.asarray(coords)[None], i32(tt), np.minimum(i32(counts), K), i32(gt)[None],
            np.minimum(i32(gcount), gt.shape[0]).reshape(1))


def _padded(coords, tt, counts, gt, gcount):
    """The padded layout the JAX z-test reads: (cand (N, K + Kg, 9), ids),
    ids -1 past each list's count, tile n of view n // (N / B)."""
    B, N, K = coords.shape[0], tt.shape[0], tt.shape[1]
    ids = np.concatenate([np.where(np.arange(K) < counts[:, None], tt, -1),
                          np.repeat(np.where(np.arange(gt.shape[1]) < gcount[:, None], gt, -1),
                                    N // B, axis=0)], 1).astype(np.int32)
    view = np.arange(N) // (N // B)
    return coords[view[:, None], np.maximum(ids, 0)], ids


def _to_tiles(img, res, fill=1e30):
    """(H, W) image -> (T, 32, 32) tiles, padded with ``fill``."""
    H, W = res
    ntx, nty = -(-W // 32), -(-H // 32)
    img = np.pad(img, ((0, nty * 32 - H), (0, ntx * 32 - W)), constant_values=img.dtype.type(fill))
    return img.reshape(nty, 32, ntx, 32).transpose(0, 2, 1, 3).reshape(-1, 32, 32)


def _to_image(tiles, res):
    H, W = res
    ntx, nty = -(-W // 32), -(-H // 32)
    return tiles.reshape(nty, ntx, 32, 32).transpose(0, 2, 1, 3).reshape(nty * 32, ntx * 32)[:H, :W]


def _peeled(fn, cand, ids, res, layers):
    """Peel ``layers`` layers with a one-layer z-test ``fn(cand, ids, floor
    tiles, floor image or None) -> (tri, z)`` tiles: the first floor -1e30
    everywhere, each next one the image's z where it hit, 1e30 elsewhere
    and past the image (as rasterize_select peels). Returns (tri, z)
    images."""
    out, img = [], None
    zf = np.full((ids.shape[0], 32, 32), -1e30, np.float32)
    for _ in range(layers):
        tri, z = (_to_image(np.asarray(a), res) for a in fn(cand, ids, zf, img))
        out.append((tri, z))
        img = np.where(tri >= 0, z, np.float32(1e30)).astype(np.float32)
        zf = _to_tiles(img, res)
    return out


@functools.lru_cache(maxsize=None)
def _jax_layers(seed, res, K, Kg, cut, layers=2):
    """A random scene binned by JAX (tile counts cut to ``cut`` of K, and
    the global list to ``Kg``), and its peeled layers from the Pallas kernel
    (interpret mode) and the jnp scan path."""
    v, f = random_scene(seed)
    coords, tt, counts, gt, gcount = _binned(v, f, res, K, Kg)
    counts = np.minimum(counts, int(K * cut)).astype(np.int32)
    cand, ids = _padded(coords, tt, counts, gt, gcount)
    ntx = -(-res[1] // 32)
    pallas = _peeled(lambda c, t, zf, _: tile_zmin_pallas(
        jnp.asarray(c), jnp.asarray(t), jnp.asarray(zf), ntx, 32, interpret=True),
        cand, ids, res, layers)

    def scan(c, t, _, img):           # the jnp path, on the image, back to tiles
        tri, z = JR._rasterize_tiles(jnp.asarray(c), jnp.asarray(t), res,
                                     None if img is None else jnp.asarray(img), use_pallas=False)
        return _to_tiles(np.asarray(tri), res, -1), _to_tiles(np.asarray(z), res)
    return (coords, tt, counts, gt, gcount), pallas, _peeled(scan, cand, ids, res, layers)


@pytest.mark.parametrize('seed,res,K,Kg,cut,num_layers', [
    (0, (96, 96), 128, 64, 1.0, 2),
    (0, (96, 96), 128, 64, 1.0, 1),
    (1, (96, 96), 128, 64, 1.0, 2),
    (2, (80, 112), 128, 64, 1.0, 2),     # past the image: the second layer's floor is 1e30
    (6, (96, 96), 12, 64, 1.0, 2),       # K % 8 != 0: a group spans both lists
    (4, (96, 96), 128, 64, 0.25, 2),     # counts cut below what the lists hold
    (5, (96, 96), 128, 0, 1.0, 2),       # no global list
])
def test_tile_zmin_reference_matches_pallas_and_scan(seed, res, K, Kg, cut, num_layers):
    """Peeled layers on tests/test_tile_raster.py's scenes, binned by JAX:
    the port's z-test (every layer in one call, reading only each list's
    live slots) against the Pallas kernel (interpret mode) and the jnp scan
    path on the padded layout: ids exactly equal, z within Z_ATOL."""
    inputs, pallas, scanned = _jax_layers(seed, res, K, Kg, cut)
    tri, z = tile_zmin(*(_t(a) for a in inputs), res, num_layers=num_layers)
    assert tri.shape == z.shape == (num_layers, inputs[1].shape[0], 32, 32)
    for li in range(num_layers):
        lt, lz = _to_image(tri[li].numpy(), res), _to_image(z[li].numpy(), res)
        assert (lt >= 0).sum() > 5000
        for name, (rt, rz) in (('pallas', pallas[li]), ('scan', scanned[li])):
            np.testing.assert_array_equal(lt, rt, err_msg=f'{name} layer {li}')
            hit = rt >= 0
            np.testing.assert_allclose(lz[hit], rz[hit], atol=Z_ATOL, rtol=0)
            assert (lz[~hit] == 1e30).all()


@pytest.mark.parametrize('layout', ['tile_list', 'straddle'])
def test_tile_zmin_ties_match_pallas(layout):
    """Coincident triangles (equal z at every pixel) in two views of one
    32x32 tile each: inside one group of 8 slots the smallest id wins,
    across groups the earlier group wins; a dead list entry (id -1, whose
    clamped row 0 would be nearer) and a degenerate triangle never win.
    ``tile_list``: 24 slots, no global list. ``straddle``: K = 12 with 10
    live, so slots 8..15 (one group) hold tile slots 8, 9, two padding slots
    and global slots 0..3."""
    rng = np.random.default_rng(5)
    tri = np.array([2.0, 3.0, 0.25, 30.0, 5.0, 0.25, 12.0, 29.0, 0.25], np.float32)
    F = 140
    coords = np.tile(tri, (2, F, 1))
    coords[:, :, 2::3] += rng.uniform(0.1, 0.5, (2, F, 1)).astype(np.float32)   # behind
    coords[:, 0] = tri - np.float32([0, 0, 0.1, 0, 0, 0.1, 0, 0, 0.1])    # nearer, never listed
    coords[:, 102] = np.float32([4, 4, -0.5, 8, 8, -0.5, 12, 12, -0.5])   # degenerate (area 0)
    for view, ids in ((0, (7, 3)), (1, (9, 1))):
        coords[view, list(ids)] = tri
    if layout == 'tile_list':
        K, count, Kg, gcount = 24, 24, 4, 0
        # view 0: slots 1 and 5 (one group), ids 7 and 3 -> 3 wins
        # view 1: slots 6 (group 0, id 9) and 9 (group 1, id 1) -> 9 wins
        slots = {0: ((1, 7), (5, 3)), 1: ((6, 9), (9, 1))}
    else:
        K, count, Kg, gcount = 12, 10, 8, 6
        # view 0: tile slot 9 (group 1, id 7), global slot 1 = slot 13 (group 1, id 3) -> 3
        # view 1: tile slot 6 (group 0, id 9), global slot 5 = slot 17 (group 2, id 1) -> 9
        slots = {0: ((9, 7), (13, 3)), 1: ((6, 9), (17, 1))}
    tt = np.tile(np.arange(100, 100 + K, dtype=np.int32), (2, 1))
    gt = np.tile(np.arange(120, 120 + Kg, dtype=np.int32), (2, 1))
    for view, pairs in slots.items():
        for s, i in pairs:
            if s < K:
                tt[view, s] = i
            else:
                gt[view, s - K] = i
    tt[:, 0] = -1                       # dead: coords row 0 is nearer
    counts = np.full(2, count, np.int32)
    gcounts = np.full(2, gcount, np.int32)
    cand, ids = _padded(coords, tt, counts, gt, gcounts)
    cand[1, :, 0::3] += 32.0            # the Pallas kernel sees one 64-wide view
    want_t, want_z = tile_zmin_pallas(jnp.asarray(cand), jnp.asarray(ids),
                                      jnp.full((2, 32, 32), -1e30, jnp.float32), 2, 32,
                                      interpret=True)
    got_t, got_z = tile_zmin(_t(coords), _t(tt), _t(counts), _t(gt), _t(gcounts), (32, 32))
    want_t = np.asarray(want_t)
    assert (want_t[0] == 3).sum() > 100 and (want_t[1] == 9).sum() > 100
    np.testing.assert_array_equal(got_t[0].numpy(), want_t)
    hit = want_t >= 0
    np.testing.assert_allclose(got_z[0].numpy()[hit], np.asarray(want_z)[hit], atol=Z_ATOL, rtol=0)


@pytest.mark.parametrize('case', ['small_big', 'k_overflow', 'live_cap'])
def test_bin_and_select_match_jax(case):
    """Tile lists, counts, the global list, and rasterize_select's images
    and three overflow counters, equal to JAX's."""
    v, f = small_scene(3)
    res = (96, 128)
    K, Kg, live = {'small_big': (256, 16, 65536), 'k_overflow': (8, 2, 65536),
                   'live_cap': (64, 16, 300)}[case]
    face_mask = np.random.default_rng(4).random(f.shape[0]) > 0.1

    x, y, _, _ = JR._screen_coords(jnp.asarray(v), res)
    xs, ys = (np.asarray(jnp.stack([a[f[:, k]] for k in range(3)], 1)) for a in (x, y))
    want = JR.bin_triangles(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(face_mask), res, K, Kg)
    got = R.bin_triangles(_t(xs), _t(ys), _t(face_mask), res, K, Kg)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    want = JR.rasterize_select(jnp.asarray(v), jnp.asarray(f), res, jnp.asarray(face_mask),
                               num_layers=2, K=K, Kg=Kg, live_cap=live)
    got = R.rasterize_select(_t(v)[None], _t(f, torch.int64), res, _t(face_mask),
                             num_layers=2, K=K, Kg=Kg, live_cap=live)
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    for w, g in zip(want[1:], got[1:]):
        assert int(g[0]) == int(w)
    overflow = [int(w) for w in want[1:]]
    assert {'small_big': overflow == [0, 0, 0], 'k_overflow': overflow[0] > 0 and overflow[1] > 0,
            'live_cap': overflow[2] > 0}[case], overflow
    assert (np.asarray(want[0]) >= 0).sum() > 500


def test_rasterize_and_interpolate_match_jax():
    v, f = small_scene(6)
    res = (64, 64)
    attr = np.random.default_rng(7).normal(size=(v.shape[0], 5)).astype(np.float32)
    want = JR.rasterize(jnp.asarray(v), jnp.asarray(f), res, num_layers=2, K=64, Kg=16)
    got = R.rasterize(_t(v), _t(f, torch.int64), res, num_layers=2, K=64, Kg=16)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.tri_id.numpy(), np.asarray(w.tri_id))
        np.testing.assert_allclose(g.bary.numpy(), np.asarray(w.bary), atol=1e-6, rtol=0)
        hit = np.asarray(w.valid)
        np.testing.assert_allclose(g.zbuf.numpy()[hit], np.asarray(w.zbuf)[hit], atol=Z_ATOL)
        assert int(g.bin_overflow) == int(w.bin_overflow)
        ia = np.asarray(JR.interpolate(jnp.asarray(attr), w, jnp.asarray(f)))
        np.testing.assert_allclose(R.interpolate(_t(attr), g, _t(f, torch.int64)).numpy(), ia,
                                   rtol=2e-5, atol=2e-5)
    assert (np.asarray(want[1].tri_id) >= 0).sum() > 200


def test_antialias_views_matches_jax():
    """The compacted edge AA of two views: the image, and the gradient of
    a fixed scalar of it with respect to v_clip, against jax.grad."""
    res = (48, 48)
    views = [small_scene(s, n_tris=200, res=48) for s in (8, 9)]
    f = views[0][1]
    vc = np.stack([v for v, _ in views])
    rng = np.random.default_rng(10)
    color = rng.uniform(size=(2, 48, 48, 3)).astype(np.float32)
    wgt = rng.normal(size=(2, 48, 48, 3)).astype(np.float32)
    sel = [JR.rasterize(jnp.asarray(v), jnp.asarray(f), res, K=64, Kg=16)[0] for v in vc]
    tri = np.stack([np.asarray(r.tri_id) for r in sel])
    valid = tri >= 0
    zbuf = np.stack([np.asarray(r.zbuf) for r in sel])

    def jloss(vclip):
        img, over = JR.antialias_views(jnp.asarray(color), jnp.asarray(tri), jnp.asarray(valid),
                                       jnp.asarray(zbuf), vclip, jnp.asarray(f), impl='compact')
        return jnp.sum(img * wgt), (img, over)
    (_, (want_img, over)), want_g = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(vc))

    vt = _t(vc).requires_grad_()
    img, got_over = R.antialias_views(_t(color), _t(tri, torch.int64), _t(valid), _t(zbuf), vt,
                                      _t(f, torch.int64))
    (img * _t(wgt)).sum().backward()
    assert int(got_over) == int(over)
    assert np.abs(np.asarray(want_img) - color).max() > 0.05      # AA moved pixels
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(want_img), rtol=2e-4, atol=2e-5)
    g = np.asarray(want_g)
    assert np.abs(g).max() > 0
    np.testing.assert_allclose(vt.grad.numpy(), g, rtol=2e-4, atol=2e-4 * np.abs(g).max())


def test_compact_and_scatter_round_trip():
    """compact_pixels -> rasterize_apply_compact -> scatter_pixels equals
    the dense rasterize_apply at every pixel; the overflow counts the
    covered pixels a short cap drops, as JAX's compact_pixels does."""
    v, f = small_scene(11)
    res = (48, 64)
    vt, ft = _t(v), _t(f, torch.int64)
    tri = R.rasterize_select(vt[None], ft, res, K=64, Kg=16)[0][0, 0]
    dense = R.rasterize_apply(vt, ft, tri[None], res)[0]
    n = int((tri >= 0).sum())
    idx, ok, over = R.compact_pixels(tri, n + 7)
    assert int(over) == 0 and int(ok.sum()) == n
    c = R.rasterize_apply_compact(vt, ft, tri, idx, ok, res)
    np.testing.assert_array_equal(R.scatter_pixels(c.bary, idx, ok, res).numpy(), dense.bary.numpy())
    zb = R.scatter_pixels(c.zbuf, idx, ok, res, fill=R.BIG)
    np.testing.assert_array_equal(zb.numpy(), dense.zbuf.numpy())
    for cap in (n + 7, n // 2):
        wi, wv, wo = JR.compact_pixels(jnp.asarray(tri.numpy().astype(np.int32)), cap)
        gi, gv, go = R.compact_pixels(tri, cap)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy()[gv.numpy()], np.asarray(wi)[np.asarray(wv)])
        assert int(go) == int(wo)
