"""The port's hand-written kernels against their plain PyTorch versions, on
a CUDA card. Every test carries the ``cuda`` marker and skips itself where
there is no card. The file imports neither jax nor the JAX package, so it
also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(chip_smoke.py compares the same kernels at the main path's shapes.)"""

import numpy as np
import pytest
import torch

import chip_smoke
from meshdiffusion_tpu_torch import ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the Triton and CUDA kernels have no CPU mode')
    return torch.device('cuda')


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ancestral_inputs(rng, shape):
    x, e, n = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    mask = (rng.random((1,) + shape[1:4] + (1,)) > 0.3).astype(np.float32)
    return x, e, mask, n, 0.0123, 0.87


def _gsc_inputs(rng, B, D, H, W, C, O):
    x = rng.standard_normal((B, D, H, W, C)).astype(np.float32)
    sc = (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    bi = (0.1 * rng.standard_normal(C)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, C, O)) * 0.05).astype(np.float32)
    cb = (0.1 * rng.standard_normal(O)).astype(np.float32)
    return x, sc, bi, k, cb


@pytest.mark.cuda
def test_ancestral_kernel_matches_plain(cuda, rng):
    x, e, mask, n, beta, std = _ancestral_inputs(rng, (2, 16, 16, 16, 4))
    args = [_t(a).to(cuda) for a in (x, e, mask, n)] + [beta, std]
    kx, km = ops.ancestral_update(*args)
    px, pm = ops.ancestral_update_reference(*args)
    torch.testing.assert_close(kx, px, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(km, pm, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_groupnorm_kernels_match_plain(cuda, rng, dtype):
    x = (_t(rng.normal(size=(2, 9, 10, 11, 96)).astype(np.float32)) * 2 + 0.5).to(cuda, dtype)
    sc = _t(rng.normal(size=(96,)).astype(np.float32)).to(cuda)
    bi = _t(rng.normal(size=(96,)).astype(np.float32)).to(cuda)
    with torch.inference_mode():
        a, b = ops.gn_affine(x, sc, bi)
        ra, rb = ops.gn_affine_reference(x, sc, bi)
        torch.testing.assert_close(a, ra, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(b, rb, rtol=1e-5, atol=1e-5)
        y, r = ops.groupnorm_silu(x, sc, bi), ops.groupnorm_silu_reference(x, sc, bi)
    tol = 1e-5 if dtype == torch.float32 else 1.6e-2    # bf16: one rounding of the output
    torch.testing.assert_close(y.float(), r.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize('shape,dtype,in_block', [
    ((1, 32, 32, 32, 256), torch.bfloat16, False),     # many blocks: the last-block merge
    ((2, 16, 16, 16, 768), torch.float32, False),      # the up path's fp32 sums, 192-channel blocks
    ((1, 4, 4, 4, 128), torch.bfloat16, True),         # one block a channel chunk: in-block merge
    ((2, 4, 4, 4, 1024), torch.float32, False),
])
def test_gn_affine_one_launch_deterministic(cuda, rng, shape, dtype, in_block):
    """gn_stats against its plain version within 1e-5, in one launch a call,
    and bit-equal from one run to the next (the merge order is fixed)."""
    from meshdiffusion_tpu_torch.ops.groupnorm import _gn_plan
    B, C = shape[0], shape[-1]
    S = int(np.prod(shape[1:-1]))
    x = (_t(rng.normal(size=shape).astype(np.float32)) * 2 + 0.5).to(cuda, dtype)
    sc = _t(1.0 + 0.1 * rng.normal(size=(C,)).astype(np.float32)).to(cuda)
    bi = _t(0.1 * rng.normal(size=(C,)).astype(np.float32)).to(cuda)
    assert (_gn_plan(S, C, 32, x.element_size())[1] >= S) == in_block
    with torch.inference_mode():
        n0 = ops.gn_affine.launches
        a, b = ops.gn_affine(x, sc, bi)
        a2, b2 = ops.gn_affine(x, sc, bi)
        ra, rb = ops.gn_affine_reference(x, sc, bi)
    assert ops.gn_affine.launches == n0 + 2
    torch.testing.assert_close(a, ra, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(b, rb, rtol=1e-5, atol=1e-5)
    assert torch.equal(a, a2) and torch.equal(b, b2)


@pytest.mark.cuda
@pytest.mark.parametrize('shape,dtype,halo,route', [
    ((2, 5, 6, 7, 64, 32), torch.float32, None, 0),
    ((2, 5, 6, 7, 64, 32), torch.bfloat16, None, 0),
    ((1, 9, 10, 12, 128, 128), torch.bfloat16, None, 1),   # ragged edges of the 4x8x8 tile
    ((1, 9, 10, 12, 128, 128), torch.float32, None, 1),
    ((1, 8, 8, 8, 384, 128), torch.float32, None, 1),      # the up path's odd width
    ((1, 6, 7, 5, 96, 64), torch.bfloat16, None, 0),       # a zero-padded 32-channel tail chunk
    ((1, 16, 16, 16, 256, 256), torch.bfloat16, None, 0),  # 128 x 256 tiling, split
    ((1, 8, 8, 8, 1024, 512), torch.float32, None, 0),
    ((1, 4, 4, 4, 1024, 512), torch.bfloat16, None, 0),    # 64 x 256 tiling, N split, many splits
    ((1, 4, 4, 4, 1024, 512), torch.float32, None, 0),
    ((2, 4, 4, 4, 512, 512), torch.bfloat16, None, 0),
    ((1, 16, 16, 16, 128, 128), torch.bfloat16, None, 1),  # descriptor route, split
    ((2, 12, 16, 16, 256, 128), torch.float32, None, 1),   # the up path's fp32 concat width
    ((1, 8, 8, 8, 384, 128), torch.bfloat16, None, 1),
    ((2, 8, 16, 8, 128, 128), torch.bfloat16, (1, 0), 1),  # depth halo, descriptor route
    ((1, 8, 8, 6, 128, 128), torch.bfloat16, None, 0),     # W < 8: the register route
])
def test_gn_silu_conv3d_kernel_matches_plain(cuda, rng, shape, dtype, halo, route):
    """Relative L2 error against the plain bf16 composition at most 1e-2,
    finite, and bit-equal from one run to the next (split-K sums in split
    order); the launches took the A operand's route the plan gives the
    shape (``descriptor_launches``). ``halo``: the depth-halo mode, x with
    lo + hi more planes around the output's D."""
    if halo is None:
        x, sc, bi, k, cb = (_t(a).to(cuda) for a in _gsc_inputs(rng, *shape))
        op, args = ops.gn_silu_conv3d, (x.to(dtype), sc, bi, k, cb)
        ref = ops.gn_silu_conv3d_reference
    else:
        B, D, H, W, C, O = shape
        x, sc, bi, k, cb = (_t(a).to(cuda) for a in _gsc_inputs(rng, B, D + sum(halo), H, W, C, O))
        a, b = ops.gn_affine_reference(x, sc, bi)
        op, args = ops.gn_silu_conv3d_halo, (x.to(dtype), a, b, k, cb, halo)
        ref = ops.gn_silu_conv3d_halo_reference
    n0, d0 = op.launches, op.descriptor_launches
    with torch.inference_mode():
        y = op(*args)
        y2 = op(*args, packed=ops.pack_conv_weights(k))
        r = ref(*args)
    assert (op.launches - n0, op.descriptor_launches - d0) == (2, 2 * route)
    assert torch.isfinite(y).all()
    assert (y.float() - r.float()).norm() / r.float().norm() < 1e-2
    assert torch.equal(y, y2)


@pytest.mark.cuda
@pytest.mark.parametrize('shape,dtype', [
    ((2, 8, 8, 8, 128, 128), torch.bfloat16),
    ((1, 8, 8, 8, 384, 128), torch.float32),          # the up path's fp32 concat input
])
def test_gn_silu_conv3d_autograd_matches_plain(cuda, rng, shape, dtype):
    """The conv under autograd (kernel forward, plain backward) against
    autograd through the plain composition: the forward at relative L2
    1e-2 (the kernel's bound), each gradient at relative L2 2e-2 (bf16
    operands; the backward recomputes through the same plain ops)."""
    args = [_t(a).to(cuda) for a in _gsc_inputs(rng, *shape)]
    g = torch.randn(shape[:4] + (shape[5],), device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0))
    before = ops.gn_silu_conv3d.launches
    outs = []
    for op in (ops.gn_silu_conv3d, ops.gn_silu_conv3d_reference):
        leaves = [args[0].to(dtype)] + args[1:]
        leaves = [t.clone().requires_grad_(True) for t in leaves]
        y = op(*leaves, 32, 1e-6, torch.bfloat16)
        y.float().backward(g)
        outs.append((y.detach().float(), [t.grad.float() for t in leaves]))
    assert ops.gn_silu_conv3d.launches == before + 1
    (y1, g1), (y2, g2) = outs
    assert (y1 - y2).norm() / y2.norm() < 1e-2
    for a, b in zip(g1, g2):
        assert torch.isfinite(a).all() and (a - b).norm() / b.norm() < 2e-2


def _blobs(rng, res, n=20000):
    """Screen coords (n, 9) of many small triangles (a few pixels) and 20
    that span the view, z in [-0.9, 0.9]."""
    H, W = res
    c = rng.uniform(0.05, 0.95, (n, 1, 2)) * (W, H)
    xy = c + rng.normal(0.0, 2.56, (n, 3, 2))
    xy[:20] = rng.uniform(0.0, 1.0, (20, 3, 2)) * (W, H)
    z = rng.uniform(-0.9, 0.9, (n, 3, 1))
    return np.concatenate([xy, z], 2).reshape(n, 9).astype(np.float32)


def _slivers(rng, res):
    """Near-degenerate triangles over a few thousand ordinary ones: slivers
    whose base joins two pixel centres (half of them along a row or column)
    and whose apex sits 0 to 3 ulps off its midpoint (0: area 0, dead; the
    pixel centres on the base lie on an edge), some spanning many tiles
    (the global list), and slivers by x = 0 whose |area| lies just above or
    below 1e-12."""
    H, W = res
    parts = [_blobs(rng, res, 4000)]
    for n, span in ((3000, 40), (30, 300)):
        a = np.floor(rng.uniform(0, 1, (n, 2)) * (W - span, H - span)) + 0.5 + span / 2
        d = rng.integers(-span // 2, span // 2 + 1, (n, 2)).astype(np.float64)
        d[rng.random(n) < 0.5, rng.integers(0, 2)] = 0.0      # half along a row or column
        a32, b32 = a.astype(np.float32), (a + d).astype(np.float32)
        c32 = ((a32 + b32) * np.float32(0.5)).astype(np.float32)
        across = (np.abs(d[:, 0]) >= np.abs(d[:, 1])).astype(int)   # the axis off the base
        for i, k in enumerate(rng.integers(0, 4, n)):
            for _ in range(k):
                c32[i, across[i]] = np.nextafter(c32[i, across[i]], np.float32(np.inf))
        xy = np.stack([a32, b32, c32], 1).astype(np.float64)
        parts.append(np.concatenate([xy, rng.uniform(-0.9, 0.9, (n, 3, 1))], 2).reshape(n, 9))
    n = 1000
    y0 = rng.uniform(0.5, H - 40, n)
    L = rng.uniform(5.0, 30.0, n)
    h = rng.uniform(0.5, 3.0, n) * 1e-12 / L                  # |area| = L * h around 1e-12
    x0 = np.float32(1e-7)
    tri = np.stack([np.full(n, x0), y0, np.full(n, x0), y0 + L, x0 + h, y0 + L / 2], 1)
    parts.append(np.concatenate([tri.reshape(n, 3, 2), rng.uniform(-0.9, 0.9, (n, 3, 1))],
                                2).reshape(n, 9))
    return np.concatenate(parts).astype(np.float32)


def _crowd(rng, res):
    """6000 triangles of a few pixels in one tile, over 2000 spread ones:
    that tile's list fills K = 4096, longer than the four blocks of its
    cluster hold in shared memory, so they stream it once a layer."""
    H, W = res
    c = rng.uniform(0.0, 1.0, (6000, 1, 2)) * 32 + (5 * 32, 5 * 32)
    xy = c + rng.normal(0.0, 1.5, (6000, 3, 2))
    z = rng.uniform(-0.9, 0.9, (6000, 3, 1))
    crowd = np.concatenate([xy, z], 2).reshape(6000, 9).astype(np.float32)
    return np.concatenate([_blobs(rng, res, 2000), crowd])


def _zmin_inputs(coords, res, K, Kg, clamp=True):
    """Binning by the port's rasterizer: the z-test's arguments for views
    coords (B, F, 9) on the card, with the live counts cut to the
    capacities, or with the raw bin counts (which may exceed them)."""
    from meshdiffusion_tpu_torch.render import rasterize as R
    B, F, _ = coords.shape
    ok = torch.ones(F, dtype=torch.bool, device=coords.device)
    per = [R.bin_triangles(c[:, 0::3], c[:, 1::3], ok, res, K, Kg) for c in coords]
    cap = (lambda t, n: t.clamp(max=n)) if clamp else (lambda t, n: t)
    return (coords, torch.cat([p[0] for p in per]),
            torch.cat([cap(p[1], K) for p in per]).int(), torch.stack([p[2] for p in per]),
            torch.stack([cap(p[3], p[2].shape[0]) for p in per]).int())


@pytest.mark.cuda
@pytest.mark.parametrize('scene,res,K,layers', [
    ('blobs', (512, 512), 256, 2),        # the fit path's capacity, K + Kg = 320
    ('blobs', (512, 512), 4096, 2),       # the capacity a noise-soup fit grows to, 4160
    ('blobs', (512, 512), 256, 1),        # one layer, above a given floor
    ('blobs', (500, 470), 256, 2),        # ragged: the last tile row and column part outside
    ('slivers', (512, 512), 256, 2),
    ('crowd', (512, 512), 4096, 2),       # a tile of 4096 + 20: streamed, not resident
    ('overflow', (512, 512), 256, 2),     # the crowd at K 256, raw counts above K
])
def test_tile_zmin_kernel_matches_plain(cuda, rng, scene, res, K, layers):
    """Every depth layer of 4 views in one launch, binned by the port's
    rasterizer (Kg 64), short lists, split ones (> 64 live) and streamed
    ones (> 4 x 768): triangle ids equal and z to the bit against the
    plain version (the kernel rounds every operation as it does), and equal
    from one launch to the next. The one-layer case starts from a given
    floor, uniform in [-0.5, 0.5); the overflow case passes the raw bin
    counts, above K, which the wrapper cuts to K."""
    make = {'blobs': _blobs, 'slivers': _slivers, 'crowd': _crowd, 'overflow': _crowd}[scene]
    views = np.stack([make(rng, res) for _ in range(4)])
    args = _zmin_inputs(torch.from_numpy(views).to(cuda), res, K, 64, clamp=scene != 'overflow')
    floor = None
    if layers == 1:
        floor = _t(rng.uniform(-0.5, 0.5, (args[1].shape[0], 32, 32)).astype(np.float32)).to(cuda)
    n0 = ops.tile_zmin.launches
    kt, kz = ops.tile_zmin(*args, res, num_layers=layers, z_floor=floor)
    kt2, kz2 = ops.tile_zmin(*args, res, num_layers=layers, z_floor=floor)
    pt, pz = ops.tile_zmin_reference(*args, res, num_layers=layers, z_floor=floor)
    assert ops.tile_zmin.launches == n0 + 2
    assert kt.shape == (layers, args[1].shape[0], 32, 32)
    assert (pt[0] >= 0).sum() > 50000 and (layers == 1 or (pt[1] >= 0).sum() > 10000)
    if scene == 'slivers':      # ids 4000..7029: pixel-aligned slivers, won somewhere
        assert ((pt >= 4000) & (pt < 7030)).sum() > 100
    if scene == 'crowd':
        assert int((args[2].view(4, -1) + args[4][:, None]).max()) > 4 * 3 * 256
    if scene == 'overflow':
        assert int(args[2].max()) > K
    assert torch.equal(kt, pt) and torch.equal(kz, pz)
    assert torch.equal(kt, kt2) and torch.equal(kz, kz2)


def _uv_scene(rng, res):
    """The UV bake's case: one view of 1024^2 tiles, every triangle at
    z = 0 (so every candidate ties and the tie-break picks each pixel):
    a lattice of 6.5-pixel quads, each split on its diagonal, whose
    corners and diagonals pass through pixel centres (as an atlas of a
    grid-aligned mesh does), under 20,000 small triangles scattered over
    it."""
    H, W = res
    s = 6.5
    gy, gx = np.mgrid[0:int(H / s) - 1, 0:int(W / s) - 1]
    x0, y0 = (gx * s + 0.5).ravel(), (gy * s + 0.5).ravel()
    quads = []
    for (ax, ay), (bx, by), (cx, cy) in ((((0, 0), (s, 0), (s, s))), (((0, 0), (s, s), (0, s)))):
        quads.append(np.stack([x0 + ax, y0 + ay, x0 + bx, y0 + by, x0 + cx, y0 + cy], 1))
    quads = np.concatenate(quads)
    n = 20000
    c = rng.uniform(0.0, 1.0, (n, 1, 2)) * (W, H)
    small = (c + rng.normal(0.0, 3.0, (n, 3, 2))).reshape(n, 6)
    xy = np.concatenate([quads, small]).reshape(-1, 3, 2)
    return np.concatenate([xy, np.zeros(xy.shape[:2] + (1,))], 2).reshape(-1, 9).astype(np.float32)


@pytest.mark.cuda
def test_tile_zmin_kernel_matches_plain_on_the_uv_bake(cuda, rng):
    """The bake's z-test: one view at 1024^2 (1,024 tiles), one layer,
    every candidate at z = 0, binned at K 256 (counts cut to it) + Kg 64:
    ids equal and z bit-equal to the plain version, and equal from one
    launch to the next."""
    res = (1024, 1024)
    views = _uv_scene(rng, res)[None]
    args = _zmin_inputs(torch.from_numpy(views).to(cuda), res, 256, 64)
    n0 = ops.tile_zmin.launches
    kt, kz = ops.tile_zmin(*args, res, num_layers=1)
    kt2, kz2 = ops.tile_zmin(*args, res, num_layers=1)
    pt, pz = ops.tile_zmin_reference(*args, res, num_layers=1)
    assert ops.tile_zmin.launches == n0 + 2
    assert kt.shape == (1, 1024, 32, 32) and (pt >= 0).float().mean() > 0.9
    assert (pz[pt >= 0] == 0).all()
    assert torch.equal(kt, pt) and torch.equal(kz, pz)
    assert torch.equal(kt, kt2) and torch.equal(kz, kz2)


# every distinct (K, N, x dtype) of the 22 shortcuts of a res64 forward, at the
# grid size r where it occurs
_NIN_RES64 = [(16, 128, 256, torch.bfloat16), (8, 256, 512, torch.bfloat16),
              (8, 1024, 512, torch.float32), (8, 768, 512, torch.float32),
              (16, 768, 256, torch.float32), (16, 512, 256, torch.float32),
              (16, 384, 256, torch.float32), (32, 384, 128, torch.bfloat16),
              (64, 256, 128, torch.bfloat16), (64, 256, 128, torch.float32)]


def _nin_inputs(cuda, lead, K, N, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(lead + (K,), device=cuda, generator=g).to(dtype)
    w = (torch.randn(K, N, device=cuda, generator=g) * K ** -0.5).to(torch.bfloat16)
    b = 0.1 * torch.randn(N, device=cuda, generator=g)
    h = torch.randn(lead + (N,), device=cuda, generator=g).to(torch.bfloat16)
    return x, w, b, h


@pytest.mark.cuda
@pytest.mark.parametrize('r,K,N,dtype', _NIN_RES64 + [(None, 384, 256, torch.float32)])
@pytest.mark.parametrize('B', [1, 4])
def test_nin_residual_kernel_matches_plain(cuda, B, r, K, N, dtype):
    """The shortcut + residual kernel against the plain composition at the
    res64 forward's shapes (M = B r^3 voxels; r None: a ragged M, 1000 B + 37,
    no multiple of a tile): relative L2 at most 1e-5 (the same bf16 products,
    summed over k in another order), one launch a call, bit-equal reruns."""
    lead = (B, r, r, r) if r else (B * 1000 + 37,)
    x, w, b, h = _nin_inputs(cuda, lead, K, N, dtype)
    with torch.inference_mode():
        n0 = ops.nin_residual.launches
        y = ops.nin_residual(x, w, b, h)
        assert ops.nin_residual.launches == n0 + 1
        y2 = ops.nin_residual(x, w, b, h)
        ref = ops.nin_residual_reference(x, w, b, h)
    assert y.dtype == torch.float32 and y.shape == lead + (N,)
    assert torch.equal(y, y2)
    err = (y.double() - ref.double()).norm() / ref.double().norm()
    assert err <= 1e-5, err.item()


@pytest.mark.cuda
def test_nin_residual_raises_on_what_it_does_not_take(cuda):
    """The kernel refuses what it does not take; under autograd the wrapper
    launches nothing and gives its plain version's values."""
    x, w, b, h = _nin_inputs(cuda, (2, 4, 4, 4), 256, 128, torch.float32)
    xg = x.clone().requires_grad_(True)
    n0 = ops.nin_residual.launches
    y = ops.nin_residual(xg, w, b, h)
    assert ops.nin_residual.launches == n0 and y.requires_grad
    assert torch.equal(y, ops.nin_residual_reference(xg, w, b, h))
    with torch.inference_mode():
        with pytest.raises(ValueError):        # non-contiguous x
            ops.nin_residual(x.transpose(1, 2), w, b, h)
        with pytest.raises(ValueError):        # non-float x
            ops.nin_residual(x.to(torch.int32), w, b, h)
        with pytest.raises(ValueError):        # mismatched shapes
            ops.nin_residual(x, w[:128], b, h)
        with pytest.raises(ValueError):
            ops.nin_residual(x, w, b, h[..., :64])


@pytest.mark.cuda
def test_res64_forward_runs_every_shortcut_in_the_kernel(cuda):
    """A warm res64 forward at batch 1 launches the shortcut kernel 22 times
    (every block whose width changes) and rebuilds nothing: each NIN's bf16
    weight is kept from the first forward."""
    from torch.profiler import ProfilerActivity, profile

    from meshdiffusion_tpu_torch.config import get_config
    from meshdiffusion_tpu_torch.models import create_model
    from meshdiffusion_tpu_torch.utils import trace
    cfg = get_config('res64')
    R = cfg.data.image_size
    model = create_model(cfg, device=cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((1, R, R, R, 4), device=cuda, generator=g)
    lab, mask = torch.tensor([500.0], device=cuda), torch.ones((1, R, R, R, 1), device=cuda)
    with torch.inference_mode():
        model(x, lab, mask)
        torch.cuda.synchronize()
        trace.clear()
        n0 = ops.nin_residual.launches
        with profile(activities=[ProfilerActivity.CUDA]):
            y = model(x, lab, mask)
            torch.cuda.synchronize()
    assert ops.nin_residual.launches == n0 + 22
    assert not [i.name for i in trace.instants() if i.name.startswith('rebuild.')]
    assert sum(s.name == 'ops.nin_residual' for s in trace.spans()) == 22
    assert torch.isfinite(y).all()
    trace.clear()


def _qkv(cuda, B, T, H, dh=72, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn((B, T, 3 * H * dh), device=cuda, generator=g).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize('B,T,H', [(4, 4096, 16), (1, 4096, 16), (2, 1000 + 37, 3),
                                   (2, 50, 3), (1, 4097, 2), (1, 700, 1)])
def test_dit_attention_kernel_matches_plain(cuda, B, T, H):
    """The attention kernel against its plain version (fp32 from the same
    bf16 q, k, v) at the DiT-XL/4 cell's shapes (batch 4 and 1, 4096 tokens,
    16 heads of 72), at a ragged T, no multiple of a tile, at T shorter than
    one query tile, at a last key tile of one key, and with fewer work items
    than SMs (the persistent schedule's short grid): relative L2 at most
    1e-2 per head (the kernel rounds the probabilities and its output to
    bf16, ~2^-9 each), one launch a call, bit-equal reruns."""
    qkv = _qkv(cuda, B, T, H)
    with torch.inference_mode():
        n0 = ops.dit_attention.launches
        y = ops.dit_attention(qkv, H)
        assert ops.dit_attention.launches == n0 + 1
        y2 = ops.dit_attention(qkv, H)
        torch.cuda.synchronize()
        ref = torch.cat([ops.dit_attention_reference(qkv[b:b + 1].float(), H)
                         for b in range(B)])
    assert y.dtype == torch.bfloat16 and y.shape == (B, T, H * 72)
    assert torch.equal(y, y2)
    yh = y.float().reshape(B, T, H, 72)
    rh = ref.reshape(B, T, H, 72)
    err = ((yh - rh).norm(dim=(1, 3)) / rh.norm(dim=(1, 3))).max()
    assert err <= 1e-2, err.item()


@pytest.mark.cuda
def test_dit_attention_is_one_profiled_kernel_a_call(cuda):
    """torch.profiler records exactly one kernel a call, and its name holds
    ``dit_attention_kernel``, the name that ``portbench``'s attention
    roofline and its DiT window check (``drivers/gen_dit.py``) count."""
    from torch.profiler import ProfilerActivity, profile
    qkv = _qkv(cuda, 1, 1000, 4)
    with torch.inference_mode():
        ops.dit_attention(qkv, 4)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                ops.dit_attention(qkv, 4)
            torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 3, kernels
    assert all('dit_attention_kernel' in n for n in kernels), kernels


@pytest.mark.cuda
def test_dit_attention_raises_on_what_it_does_not_take(cuda):
    """The kernel refuses what it does not take; under autograd the wrapper
    launches nothing and gives its plain version's values."""
    qkv = _qkv(cuda, 2, 256, 2)
    qg = qkv.float().requires_grad_(True).to(torch.bfloat16)
    n0 = ops.dit_attention.launches
    y = ops.dit_attention(qg, 2)
    assert ops.dit_attention.launches == n0 and y.requires_grad
    assert torch.equal(y, ops.dit_attention_reference(qg, 2))
    with torch.inference_mode():
        with pytest.raises(ValueError):        # head dimension 64
            ops.dit_attention(_qkv(cuda, 1, 256, 2, dh=64), 2)
        with pytest.raises(ValueError):        # fp32
            ops.dit_attention(qkv.float(), 2)
        with pytest.raises(ValueError):        # non-contiguous
            ops.dit_attention(qkv.transpose(0, 1), 2)
        with pytest.raises(ValueError):        # no (B, T, 3 D) of these heads
            ops.dit_attention(qkv[..., :-8], 2)


@pytest.mark.cuda
def test_dit_forward_runs_every_attention_in_the_kernel(cuda):
    """A warm full-width DiT-XL/4 forward at batch 1 launches the attention
    kernel 28 times (once a block), rebuilds nothing (every Linear's bf16
    weight is kept from the first forward), and agrees with the forward
    under autograd, which takes the plain attention, to a relative L2 of
    2e-2."""
    from torch.profiler import ProfilerActivity, profile

    from meshdiffusion_tpu_torch.config import get_config
    from meshdiffusion_tpu_torch.models import create_model
    from meshdiffusion_tpu_torch.utils import trace
    cfg = get_config('dit3d_xl4_res64')
    R = cfg.data.image_size
    model = create_model(cfg, device=cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.uniform_(-0.03, 0.03, generator=g)
    x = torch.randn((1, R, R, R, 4), device=cuda, generator=g)
    lab, mask = torch.tensor([500.0], device=cuda), torch.ones((1, R, R, R, 1), device=cuda)
    with torch.inference_mode():
        model(x, lab, mask)
        torch.cuda.synchronize()
        trace.clear()
        n0 = ops.dit_attention.launches
        with profile(activities=[ProfilerActivity.CUDA]):
            y = model(x, lab, mask)
            torch.cuda.synchronize()
        assert ops.dit_attention.launches == n0 + 28
        assert not [i.name for i in trace.instants() if i.name.startswith('rebuild.')]
        names = [s.name for s in trace.spans()]
        assert names.count('ops.dit_attention') == 28 and names.count('dit.attn') == 28
    with torch.enable_grad():                  # under autograd: the plain attention
        y_plain = model(x, lab, mask).detach()
    assert torch.isfinite(y).all()
    err = (y - y_plain).norm() / y_plain.norm()
    assert err <= 2e-2, err.item()
    trace.clear()


def _np_qkv(cuda, B, T, H, dh, seed):
    """A bf16 (B, T, 3 H dh) buffer from numpy's generator: the same bits on
    any machine."""
    a = np.random.default_rng(seed).standard_normal((B, T, 3 * H * dh), dtype=np.float32)
    return torch.from_numpy(a).to(torch.bfloat16).to(cuda)


# sha256 of the dh-72 kernel's bf16 output bytes for _np_qkv(B, T, H, 72, seed 7), as
# the kernel built for dh 72 alone (commit 5b5f089) gave them on an H100
DH72_DIGESTS = {
    (2, 1037, 3): 'f15479077205141d59bfc3946dde19f7e2916d6434f0826f07486d78a0188bf0',
    (4, 4096, 16): '047e7d01459b488fc6cc73826aaede62b50b93fe5a8cfadbddf7612d042bfe43',
}


@pytest.mark.cuda
@pytest.mark.parametrize('B,T,H', list(DH72_DIGESTS))
def test_dit_attention_dh72_output_is_bit_equal_to_the_dh72_only_kernel(cuda, B, T, H):
    """Templating the kernel on the head dimension left dh 72's arithmetic
    as it was: its output is bit-equal to the kernel built for dh 72 alone,
    at a ragged T and at the DiT cell's b4 call."""
    import hashlib
    with torch.inference_mode():
        y = ops.dit_attention(_np_qkv(cuda, B, T, H, 72, 7), H)
        torch.cuda.synchronize()
    digest = hashlib.sha256(y.cpu().view(torch.int16).numpy().tobytes()).hexdigest()
    assert digest == DH72_DIGESTS[(B, T, H)]


@pytest.mark.cuda
@pytest.mark.parametrize('B,T,H', [(4, 4608, 24), (1, 4608, 24), (2, 1000 + 37, 3), (1, 50, 2),
                                   (1, 4609, 2), (1, 700, 1)])
def test_dit_attention_dh128_kernel_matches_plain(cuda, B, T, H):
    """The dh-128 instantiation against the plain version (fp32 from the
    same bf16 q, k, v) at the FLUX cell's joint sequence (batch 4 and 1,
    512 + 4096 tokens, 24 heads of 128), at a ragged T, at T shorter than
    one query tile, at a last key tile of one key, and with fewer work items
    than SMs: relative L2 at most 1e-2 per head (P and the output rounded to
    bf16, ~2^-9 each), one launch a call, bit-equal reruns."""
    qkv = _qkv(cuda, B, T, H, dh=128, seed=3)
    with torch.inference_mode():
        n0 = ops.dit_attention.launches
        y = ops.dit_attention(qkv, H)
        assert ops.dit_attention.launches == n0 + 1
        y2 = ops.dit_attention(qkv, H)
        torch.cuda.synchronize()
        ref = torch.cat([ops.dit_attention_reference(qkv[b:b + 1].float(), H)
                         for b in range(B)])
    assert y.dtype == torch.bfloat16 and y.shape == (B, T, H * 128)
    assert torch.equal(y, y2)
    yh = y.float().reshape(B, T, H, 128)
    rh = ref.reshape(B, T, H, 128)
    err = ((yh - rh).norm(dim=(1, 3)) / rh.norm(dim=(1, 3))).max()
    assert err <= 1e-2, err.item()


def _qk_inputs(cuda, B, T1, T2, H, single, seed=0):
    """Sources as the FLUX blocks give them (``chip_smoke.flux_qk_inputs``)."""
    return chip_smoke.flux_qk_inputs(cuda, torch.Generator(device=cuda).manual_seed(seed),
                                     single, (B, T1, T2, H))


@pytest.mark.cuda
@pytest.mark.parametrize('single', [False, True], ids=['double', 'single'])
@pytest.mark.parametrize('B,T1,T2,H', [(4, 512, 4096, 24), (2, 37, 101, 3), (1, 1, 1, 1)])
def test_qk_norm_rope_kernel_matches_plain(cuda, single, B, T1, T2, H):
    """The QK norm and RoPE kernel in both modes (two 3 D wide sources with
    their own scales; one 7 D wide source) against its plain version in fp32
    from the same bf16 values, at the FLUX cell's shapes and at small odd
    ones: v copied bit for bit, q and k within one bf16 rounding (2^-8 of
    the value, 1e-5 beside it for the order of fp32 sums), one launch a
    call, bit-equal reruns."""
    args = _qk_inputs(cuda, B, T1, T2, H, single)
    D = H * 128
    with torch.inference_mode():
        n0 = ops.qk_norm_rope.launches
        y = ops.qk_norm_rope(*args)
        assert ops.qk_norm_rope.launches == n0 + 1
        assert torch.equal(y, ops.qk_norm_rope(*args))
        fargs = [a.float() if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16 else a
                 for a in args]
        ref = ops.qk_norm_rope_reference(*fargs)
        torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and y.shape == (B, T1 + T2, 3 * D)
    v_src = args[0][..., 2 * D:3 * D] if single else torch.cat([args[0][..., 2 * D:],
                                                                args[5][..., 2 * D:]], dim=1)
    assert torch.equal(y[..., 2 * D:], v_src)
    torch.testing.assert_close(y[..., :2 * D].float(), ref[..., :2 * D], rtol=2 ** -8, atol=1e-5)


@pytest.mark.cuda
def test_qk_norm_rope_raises_on_what_it_does_not_take(cuda):
    """The kernel refuses what it does not take; under autograd the wrapper
    launches nothing and gives its plain version's values."""
    args = _qk_inputs(cuda, 1, 8, 8, 2, False)
    x, qs, ks, pe, H, x2, qs2, ks2 = args
    n0 = ops.qk_norm_rope.launches
    y = ops.qk_norm_rope(x, qs.clone().requires_grad_(True), ks, pe, H, x2, qs2, ks2)
    assert ops.qk_norm_rope.launches == n0 and y.requires_grad
    with torch.inference_mode():
        with pytest.raises(ValueError):        # head dimension 64
            ops.qk_norm_rope(x, qs[:64], ks[:64], pe[:, :32], 4, x2, qs2[:64], ks2[:64])
        with pytest.raises(ValueError):        # fp32 source
            ops.qk_norm_rope(x.float(), qs, ks, pe, H, x2, qs2, ks2)
        with pytest.raises(ValueError):        # a second source without its scales
            ops.qk_norm_rope(x, qs, ks, pe, H, x2)
        with pytest.raises(ValueError):        # pe of another length
            ops.qk_norm_rope(x, qs, ks, pe[:-1], H, x2, qs2, ks2)
        with pytest.raises(ValueError):        # rows not one after another
            ops.qk_norm_rope(x.transpose(0, 1), qs, ks, pe[:8], H)


@pytest.mark.cuda
def test_flux_forward_runs_every_block_in_the_kernels(cuda):
    """A warm FLUX forward at the cell's widths (10 double and 20 single
    blocks, 512 txt tokens) at batch 1 launches the dh-128 attention kernel
    and the QK norm and RoPE kernel 30 times each (once a block), each call
    one profiled kernel of its own name, rebuilds nothing, and agrees with
    the same forward within ``ops.plain()`` to a relative L2 of 2e-2."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from meshdiffusion_tpu_torch.config import get_config
    from meshdiffusion_tpu_torch.models import create_model
    from meshdiffusion_tpu_torch.utils import trace
    cfg = get_config('flux3d_dev_res64')
    R, m = cfg.data.image_size, cfg.model
    model = create_model(cfg, device=cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('.scale'):
                p.uniform_(0.5, 1.5, generator=g)
            else:
                p.uniform_(-0.02, 0.02, generator=g)
    x = torch.randn((1, R, R, R, 4), device=cuda, generator=g)
    cond = dict(txt=torch.randn((1, m.context_len, m.context_in_dim), device=cuda, generator=g),
                y=torch.randn((1, m.vec_in_dim), device=cuda, generator=g),
                guidance=torch.full((1,), 3.5, device=cuda))
    lab, mask = torch.tensor([500.0], device=cuda), torch.ones((1, R, R, R, 1), device=cuda)
    with torch.inference_mode():
        model(x, lab, mask, **cond)
        torch.cuda.synchronize()
        trace.clear()
        n0 = ops.launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            y = model(x, lab, mask, **cond)
            torch.cuda.synchronize()
        n = {k: v - n0[k] for k, v in ops.launch_counts().items() if v != n0[k]}
        assert n == {'dit_attention': 30, 'qk_norm_rope': 30}, n
        kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert sum('dit_attention_dh128_kernel' in k for k in kernels) == 30
        assert sum('qk_norm_rope_kernel' in k for k in kernels) == 30
        assert not any('dit_attention_kernel' in k for k in kernels)
        assert not [i.name for i in trace.instants() if i.name.startswith('rebuild.')]
        names = [s.name for s in trace.spans()]
        assert names.count('flux.double') == 10 and names.count('flux.single') == 20
        with ops.plain():
            y_plain = model(x, lab, mask, **cond)
    assert torch.isfinite(y).all()
    err = (y - y_plain).norm() / y_plain.norm()
    assert err <= 2e-2, err.item()
    trace.clear()


@pytest.mark.cuda
@pytest.mark.parametrize('N,routing', [(16384, 'cell'), (16384, 'skewed'), (16384, 'empty'),
                                       (300, 'cell')])
def test_moe_experts_kernel_matches_plain(cuda, N, routing):
    """The grouped expert kernels against their plain version (fp32 sums of
    the same bf16 values) at the DiT-MoE-XL cell's shapes (16,384 tokens of
    batch 4, top 2: 32,768 rows over 8 experts, D 1152, F 4608), under a
    skewed routing (one expert takes every token) and one that leaves six
    experts without a row, and at a ragged 600 rows: relative L2 at most
    1e-3 (the sums' order, and H's bf16 rounding where it then falls the
    other way, ~2^-9 on one element in thousands), two launches a call,
    bit-equal reruns. Times the call beside the per-expert cuBLAS loop it
    replaces (CUDA events, 20 calls each; printed)."""
    import json
    E, k, D, F = 8, 2, 1152, 4608
    x, w_gu, w_down, order, offsets, wts, top = chip_smoke.moe_case(
        cuda, torch.Generator(device=cuda).manual_seed(0), routing, (N, E, k, D, F))
    counts = torch.diff(offsets).tolist()
    if routing == 'skewed':
        assert counts[3] == N and max(counts[2:3] + counts[4:]) == 0
    if routing == 'empty':
        assert counts[0] == counts[-1] == N and sum(counts) == 2 * N
    with torch.inference_mode():
        n0 = ops.moe_experts.launches
        y = ops.moe_experts(x, w_gu, w_down, order, offsets, wts, k)
        assert ops.moe_experts.launches == n0 + 2
        y2 = ops.moe_experts(x, w_gu, w_down, order, offsets, wts, k)
        torch.cuda.synchronize()
        ref = ops.moe_experts_reference(x, w_gu, w_down, order, offsets, wts, k)
    assert y.dtype == torch.float32 and y.shape == (N * k, D)
    assert torch.equal(y, y2)
    err = ((y - ref).norm() / ref.norm()).item()
    assert err <= 1e-3, err
    if N < 16384:
        return
    bounds = offsets.tolist()

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(20):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / 20
    with torch.inference_mode():
        ms = timed(lambda: ops.moe_experts(x, w_gu, w_down, order, offsets, wts, k))
        lib = timed(lambda: chip_smoke.moe_cublas_loop(x, w_gu, w_down, order, bounds, wts, k))
        loop = chip_smoke.moe_cublas_loop(x, w_gu, w_down, order, bounds, wts, k)
    fl = sum(c[0] for c in ops.moe_experts_cost(N * k, D, F, E).values())
    print(json.dumps({'moe_experts': routing, 'rows': N * k, 'ms': ms, 'cublas_loop_ms': lib,
                      'bound_ms': fl / 989e12 * 1e3, 'counts': counts,
                      'loop_rel_l2': ((loop - ref).norm() / ref.norm()).item(),
                      'rel_l2': err, 'card': torch.cuda.get_device_name(0)}))


@pytest.mark.cuda
def test_moe_experts_raises_on_what_it_does_not_take(cuda):
    """The kernel refuses what it does not take; under autograd the wrapper
    launches nothing and gives its plain version's values."""
    x, w_gu, w_down, order, offsets, wts, _ = chip_smoke.moe_case(
        cuda, torch.Generator(device=cuda).manual_seed(0), 'cell', (256, 4, 2, 384, 256))
    xg = x.float().requires_grad_(True).to(torch.bfloat16)
    n0 = ops.moe_experts.launches
    y = ops.moe_experts(xg, w_gu, w_down, order, offsets, wts, 2)
    assert ops.moe_experts.launches == n0 and y.requires_grad
    assert torch.equal(y, ops.moe_experts_reference(xg, w_gu, w_down, order, offsets, wts, 2))
    with torch.inference_mode():
        with pytest.raises(ValueError):        # fp32 tokens
            ops.moe_experts(x.float(), w_gu, w_down, order, offsets, wts, 2)
        with pytest.raises(ValueError):        # int64 order
            ops.moe_experts(x, w_gu, w_down, order.long(), offsets, wts, 2)
        with pytest.raises(ValueError):        # D 320, no multiple of 192
            ops.moe_experts(x[:, :320].contiguous(), w_gu[..., :320].contiguous(),
                            w_down[:, :320].contiguous(), order, offsets, wts, 2)
        with pytest.raises(ValueError):        # rows that are not N k
            ops.moe_experts(x, w_gu, w_down, order, offsets, wts, 1)


@pytest.mark.cuda
def test_moe_dit_forward_runs_the_experts_in_the_kernel(cuda):
    """A warm full-width DiT-MoE-XL/4 forward at batch 1 (4,167,325,696
    parameters) launches both expert kernels and the attention kernel 28
    times each, rebuilds nothing, makes no host synchronisation and no copy
    to or from the host inside its ``dit.moe`` spans, and agrees with its plain version (every
    wrapper plain, ``ops.plain()``) to a relative L2 of 2e-2, with the same
    routes but at near-ties."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from meshdiffusion_tpu_torch.config import get_config
    from meshdiffusion_tpu_torch.models import create_model
    from meshdiffusion_tpu_torch.utils import trace
    cfg = get_config('dit3d_moe_xl4_res64')
    R = cfg.data.image_size
    model = create_model(cfg, device=cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.uniform_(-0.03, 0.03, generator=g)
    x = torch.randn((1, R, R, R, 4), device=cuda, generator=g)
    lab, mask = torch.tensor([500.0], device=cuda), torch.ones((1, R, R, R, 1), device=cuda)
    routes, plain_routes = [], []
    with torch.inference_mode():
        model(x, lab, mask)
        torch.cuda.synchronize()
        trace.clear()
        n0, a0 = ops.moe_experts.launches, ops.dit_attention.launches
        model.capture_routes(routes)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            y = model(x, lab, mask)
            torch.cuda.synchronize()
        assert ops.moe_experts.launches == n0 + 56 and ops.dit_attention.launches == a0 + 28
        assert not [i.name for i in trace.instants() if i.name.startswith('rebuild.')]
        spans = trace.spans()
        moe = [(s.t0, s.t1) for s in spans if s.name == 'dit.moe']
        assert len(moe) == 28 and [s.name for s in spans].count('ops.moe_experts') == 28
        events = prof.profiler.kineto_results.events()
        calls = {e.correlation_id(): e.name() for e in events
                 if e.device_type() != DeviceType.CUDA and e.name().startswith('cu')
                 and any(a <= e.start_ns() <= b for a, b in moe)}
        copies = {e.name() for e in events
                  if e.device_type() == DeviceType.CUDA and e.correlation_id() in calls
                  and 'Memcpy' in e.name()}
        assert calls and not [c for c in calls.values() if 'Synchronize' in c], \
            sorted(set(calls.values()))
        assert not [c for c in copies if 'DtoD' not in c], copies      # the sort's own copy
        model.capture_routes(plain_routes)
        with ops.plain():
            y_plain = model(x, lab, mask)
        model.capture_routes(None)
    trace.clear()
    assert torch.isfinite(y).all()
    err = ((y - y_plain).norm() / y_plain.norm()).item()
    assert err <= 2e-2, err
    flips = sum(int((a.sort(1).values != b.sort(1).values).any(1).sum())
                for a, b in zip(routes, plain_routes))
    assert flips <= 0.01 * 28 * 4096, flips


@pytest.mark.cuda
def test_routes_under_autograd_and_within_plain(cuda, rng):
    """Under autograd the conv's two modes and gn_moments launch their
    kernels (the forward; the backward is the plain version's or
    gn_moments' own) and every wrapper without a backward launches nothing;
    within ``ops.plain()`` no wrapper launches."""
    x, sc, bi, k, cb = (_t(a).to(cuda) for a in _gsc_inputs(rng, 1, 4, 8, 8, 64, 64))
    a, b = ops.gn_affine_reference(x, sc, bi)
    xn, wn, bn, hn = _nin_inputs(cuda, (1, 4, 8, 8), 64, 128, torch.float32)
    qkv = _qkv(cuda, 1, 64, 2).float()
    qk = _qk_inputs(cuda, 1, 8, 8, 2, True)
    moe = chip_smoke.moe_case(cuda, torch.Generator(device=cuda).manual_seed(0), 'cell',
                              (64, 4, 2, 192, 128))
    xa, ea, ma, na, beta, std = _ancestral_inputs(rng, (1, 8, 8, 8, 4))
    xa, ea, ma, na = (_t(v).to(cuda) for v in (xa, ea, ma, na))
    coords = torch.tensor([[[2., 2., .1, 30., 4., .2, 5., 28., .3]]], device=cuda)
    lists = [torch.tensor(v, dtype=torch.int32, device=cuda)
             for v in ([[0, -1, -1, -1]], [1], [[-1]], [0])]
    g = lambda t: t.clone().requires_grad_(True)
    calls = {
        'gn_silu_conv3d': lambda: ops.gn_silu_conv3d(g(x), sc, bi, k, cb),
        'gn_silu_conv3d_halo': lambda: ops.gn_silu_conv3d_halo(g(x), a, b, k, cb, (1, 1)),
        'gn_moments': lambda: ops.gn_moments(g(x)),
        'gn_affine': lambda: ops.gn_affine(g(x), sc, bi),
        'groupnorm_silu': lambda: ops.groupnorm_silu(g(x), sc, bi),
        'nin_residual': lambda: ops.nin_residual(g(xn), wn, bn, hn),
        'dit_attention': lambda: ops.dit_attention(g(qkv).to(torch.bfloat16), 2),
        'qk_norm_rope': lambda: ops.qk_norm_rope(g(qk[0].float()).to(torch.bfloat16), *qk[1:]),
        'moe_experts': lambda: ops.moe_experts(g(moe[0].float()).to(torch.bfloat16), *moe[1:6], 2),
        'ancestral_update': lambda: ops.ancestral_update(g(xa), ea, ma, na, beta, std),
        'tile_zmin': lambda: ops.tile_zmin(g(coords), *lists, (32, 32)),
    }
    assert set(calls) == set(ops.launch_counts())
    launching = {'gn_silu_conv3d': {'gn_silu_conv3d': 1, 'gn_affine': 1},
                 'gn_silu_conv3d_halo': {'gn_silu_conv3d_halo': 1},
                 'gn_moments': {'gn_moments': 1}}
    for name, call in calls.items():
        n0 = ops.launch_counts()
        call()
        torch.cuda.synchronize()
        n = {w: c - n0[w] for w, c in ops.launch_counts().items() if c != n0[w]}
        assert n == launching.get(name, {}), name
    n0 = ops.launch_counts()
    with torch.inference_mode(), ops.plain():
        for call in calls.values():
            call()
    assert ops.launch_counts() == n0
