"""The port's hand-written kernels against their plain PyTorch versions, on
a CUDA card. Every test carries the ``cuda`` marker and skips itself where
there is no card. The file imports neither jax nor the JAX package, so it
also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(chip_smoke.py compares the same kernels at the main path's shapes.)"""

import numpy as np
import pytest
import torch

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
@pytest.mark.parametrize('shape,dtype', [
    ((2, 5, 6, 7, 64, 32), torch.float32),
    ((2, 5, 6, 7, 64, 32), torch.bfloat16),
    ((1, 9, 10, 12, 128, 128), torch.bfloat16),      # ragged edges of the 4x8x8 tile
    ((1, 9, 10, 12, 128, 128), torch.float32),
    ((1, 8, 8, 8, 384, 128), torch.float32),         # the up path's odd width
    ((1, 6, 7, 5, 96, 64), torch.bfloat16),          # a zero-padded 32-channel tail chunk
    ((1, 16, 16, 16, 256, 256), torch.bfloat16),     # 128 x 256 tiling, split
    ((1, 8, 8, 8, 1024, 512), torch.float32),
    ((1, 4, 4, 4, 1024, 512), torch.bfloat16),       # 64 x 256 tiling, N split, many splits
    ((1, 4, 4, 4, 1024, 512), torch.float32),
    ((2, 4, 4, 4, 512, 512), torch.bfloat16),
])
def test_gn_silu_conv3d_kernel_matches_plain(cuda, rng, shape, dtype):
    """Relative L2 error against the plain bf16 composition at most 1e-2,
    finite, and bit-equal from one run to the next (split-K sums in split
    order)."""
    x, sc, bi, k, cb = (_t(a).to(cuda) for a in _gsc_inputs(rng, *shape))
    with torch.inference_mode():
        y = ops.gn_silu_conv3d(x.to(dtype), sc, bi, k, cb)
        y2 = ops.gn_silu_conv3d(x.to(dtype), sc, bi, k, cb, packed=ops.pack_conv_weights(k))
        r = ops.gn_silu_conv3d_reference(x.to(dtype), sc, bi, k, cb)
    assert torch.isfinite(y).all()
    assert (y.float() - r.float()).norm() / r.float().norm() < 1e-2
    assert torch.equal(y, y2)


@pytest.mark.cuda
def test_tile_zmin_kernel_matches_plain(cuda, rng):
    """Both depth layers of 4 views at 512^2 (1024 tiles, K = 256 + 64):
    many small triangles and a few big ones, binned by the port's
    rasterizer; triangle ids equal, z to the bit (the kernel rounds every
    operation as the plain version does)."""
    from meshdiffusion_tpu_torch.render import rasterize as R
    n, res, B = 20000, (512, 512), 4
    views = []
    for _ in range(B):
        c = rng.uniform(-0.9, 0.9, (n, 1, 2))
        xy = c + rng.normal(0.0, 0.01, (n, 3, 2))
        xy[:20] = rng.uniform(-1.0, 1.0, (20, 3, 2))
        v = np.concatenate([xy.reshape(-1, 2), rng.uniform(-0.9, 0.9, (3 * n, 1)),
                            np.ones((3 * n, 1))], 1).astype(np.float32)
        views.append(_t(v).to(cuda))
    faces = torch.arange(3 * n, device=cuda).view(n, 3)
    per = [R.tile_candidates(v, faces, res, K=256, Kg=64) for v in views]
    cand = torch.stack([p[0] for p in per]).flatten(0, 1)
    tt = torch.stack([p[1] for p in per]).flatten(0, 1)
    zf = R.floor_tiles(None, B, res, cuda)
    for _ in range(2):
        kt, kz = ops.tile_zmin(cand, tt, zf, 16, 256)
        pt, pz = ops.tile_zmin_reference(cand, tt, zf, 16, 256)
        assert (pt >= 0).sum() > 100000
        assert torch.equal(kt, pt) and torch.equal(kz, pz)
        zf = torch.where(kt >= 0, kz, R.BIG)
