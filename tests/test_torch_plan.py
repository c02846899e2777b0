"""The port's kernel launch plans, weight layout, roofline counts and entry
point devices, in pure Python on the CPU (no card, no JAX).

* ``gn_silu_conv3d``'s plan at every conv shape of the res64 and res128
  U-Nets (taken from a forward on the meta device), batch 1 and 4: every
  output voxel in exactly one tile, every work item one (tile, N block,
  split), the splits a partition of the k-steps with none empty, shared
  memory within the H100's 232,448 bytes; the A operand's route at every K3
  input of the benchmark's res64 and res128 forwards (the descriptor route
  at O = 128, the register route at O >= 256) and by shape.
* the statistics kernel's plan at every GroupNorm input of a res64 forward.
* ``pack_conv_weights`` against the swizzle formula the wgmma descriptor reads.
* each kernel's ``*_cost`` helper against counts made by hand.
* the kernel library's C entry points against their ctypes signatures, and
  its build key over the sources and the headers they share.
* ``create_model``, ``extract_grid`` and ``extract_batch`` run on the card
  unless told otherwise, and every CPU test says ``device='cpu'``.
"""

import ast
import collections
import functools
import glob
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from meshdiffusion_tpu_torch import ops
from meshdiffusion_tpu_torch.config import get_config
from meshdiffusion_tpu_torch.models import get_model
from meshdiffusion_tpu_torch.models.layers import ResnetBlockDDPM
from meshdiffusion_tpu_torch.ops.gn_silu_conv import (_TILINGS, SMEM_LIMIT, _plan,
                                                      gn_silu_conv3d_bound_ms, pack_conv_weights)
from meshdiffusion_tpu_torch.ops.groupnorm import _gn_plan
from meshdiffusion_tpu_torch.ops.roofline import (PEAK_ALU_OPS, PEAK_BF16_FLOPS,
                                                  PEAK_FP32_UNFUSED_OPS, bound_ms)

pytest_plugins = ('torch_rules',)

HERE = os.path.dirname(os.path.abspath(__file__))


@functools.lru_cache(maxsize=None)
def _conv_calls(name: str):
    """{(x shape, x dtype, O): calls} of gn_silu_conv3d in one batch-1
    forward of the full-width U-Net ``name``, on the meta device."""
    cfg = get_config(name)
    R = cfg.data.image_size
    with torch.device('meta'):
        model = get_model(cfg.model.name).from_config(cfg)
    calls = collections.Counter()

    def hook(mod, args):
        x = args[0]
        calls[(tuple(x.shape), x.dtype, mod.out_ch)] += 1
        calls[(tuple(x.shape[:-1]) + (mod.out_ch,), mod.dtype, mod.out_ch)] += 1

    for m in model.modules():
        if isinstance(m, ResnetBlockDDPM):
            m.register_forward_pre_hook(hook)
    with torch.inference_mode(), ops.plain():
        model(torch.empty((1, R, R, R, 4), device='meta'), torch.empty((1,), device='meta'),
              torch.empty((1, R, R, R, 1), device='meta'))
    return dict(calls)


def _covers_once(n: int, t: int) -> bool:
    count = np.zeros(n, int)
    for o in range(0, n, t):
        count[o:o + t] += 1
    return bool((count == 1).all())


@pytest.mark.parametrize('name,batch', [('res64', 1), ('res64', 4), ('res128', 1), ('res128', 4)])
def test_conv_plan_covers_every_voxel_once(name, batch):
    calls = _conv_calls(name)
    assert sum(calls.values()) == {'res64': 74, 'res128': 64}[name]
    for (xs, _, O) in calls:
        _, D, H, W, C = xs
        p = _plan(batch, D, H, W, C, O)
        bm = _TILINGS[p.tiling][0]
        assert p.TD * p.TH * p.TW <= bm and p.smem <= SMEM_LIMIT, (xs, p)
        assert all(_covers_once(n, t) for n, t in ((D, p.TD), (H, p.TH), (W, p.TW))), (xs, p)
        assert p.tiles == batch * -(-D // p.TD) * -(-H // p.TH) * -(-W // p.TW)
        # the kernel's decode: item -> (tile, N block, split), each exactly once
        seen = {(i % p.tiles, (i // p.tiles) % p.NB, i // p.tiles // p.NB) for i in range(p.items)}
        assert len(seen) == p.items == p.tiles * p.NB * p.splits
        assert max(s for _, _, s in seen) == p.splits - 1
        # the splits partition the k-steps, none empty
        ks = [k for s in range(p.splits) for k in range(s * p.per, min(p.KS, (s + 1) * p.per))]
        assert ks == list(range(p.KS)) and (p.splits - 1) * p.per < p.KS, (xs, p)
        assert 1 <= p.grid <= 132 and p.grid <= p.items


@pytest.mark.parametrize('cell,batch,routed', [('gen64-b4', 4, 28), ('gen128-b7', 7, 20)])
def test_conv_plan_route_at_every_k3_input_of_a_forward(cell, batch, routed):
    """Every O = 128 call of a res64 or res128 forward (``counts/unet.py``'s
    walk at the cell's batch) plans the descriptor route (a 4 x 8 x 8 tile of
    tiling 0, within the shared memory a block may use), every O >= 256 call
    the register route: 28 of 74 launches at res64, 20 of 64 at res128."""
    from portbench.counts import unet as unet_counts
    from portbench.harness import Cell
    from portbench.reference import unet as ref_unet
    k3 = unet_counts.walk(ref_unet.arch(Cell.load(cell).config), batch)['k3']
    routes = []
    for (B, D, H, W, C), _, O in k3:
        p = _plan(B, D, H, W, C, O)
        assert p.route == (O == 128), ((B, D, H, W, C), O, p)
        if p.route:
            assert p.tiling == 0 and (p.TD, p.TH, p.TW) == (4, 8, 8) and p.smem <= SMEM_LIMIT, p
        routes.append(p.route)
    assert (sum(routes), len(routes)) == (routed, {'gen64-b4': 74, 'gen128-b7': 64}[cell])


@pytest.mark.parametrize('shape,route', [((1, 9, 10, 12, 128, 128), 1), ((1, 8, 8, 8, 384, 128), 1),
                                         ((1, 8, 8, 4, 128, 128), 0), ((1, 2, 8, 8, 128, 128), 0),
                                         ((1, 8, 8, 8, 128, 256), 0), ((1, 4, 4, 4, 512, 512), 0)])
def test_conv_plan_route_by_shape(shape, route):
    """The descriptor route only where the tile is 8 x 8 in (H, W) and 4
    planes deep at O = 128; a narrower or shallower tile, or O = 256 and
    512 (tilings 1 and 2), keep the register route."""
    p = _plan(*shape)
    assert p.route == route, p
    assert p.smem <= SMEM_LIMIT


@pytest.mark.parametrize('shape', [(1, 8, 8, 8, 48, 64), (1, 8, 8, 8, 100, 64),
                                   (1, 8, 8, 8, 64, 12), (1, 8, 8, 8, 0, 64)])
def test_conv_plan_raises_on_shapes_it_does_not_take(shape):
    with pytest.raises(ValueError):
        _plan(*shape)


def test_gn_stats_plan_at_every_groupnorm_input():
    """CC divides C into whole groups in 16-byte loads, at most 256
    channels; R a whole number of the block's parallel rows; at most 256
    row blocks a sample (the last block merges them); the smallest inputs
    merge in one block."""
    shapes = {(xs, dt) for xs, dt, _ in _conv_calls('res64')} | {((1, 64, 64, 64, 128), torch.float32)}
    for xs, dt in shapes:
        S, C = int(np.prod(xs[1:-1])), xs[-1]
        esize = torch.empty((), dtype=dt).element_size()
        CC, R = _gn_plan(S, C, 32, esize)
        rp = 256 // (CC // 8)
        assert CC % 8 == 0 and C % CC == 0 and CC % (C // 32) == 0 and CC <= 256
        assert R % rp == 0 and -(-S // R) <= 256
    assert _gn_plan(64, 128, 32, 2)[1] >= 64            # 4^3 x 128 bf16: one block
    assert _gn_plan(64 ** 3, 128, 32, 2)[1] < 64 ** 3


def test_pack_conv_weights_is_the_swizzled_tile_image():
    """Tile (N block, chunk, tap) holds W[tap, chunk*64 + k, block*128 + n]
    at n*64 + ((k//8) ^ (n%8))*8 + k%8, zero past C and O."""
    rng = np.random.default_rng(0)
    C, O = 96, 136                     # a zero-padded tail chunk and N block
    k = torch.from_numpy(rng.standard_normal((3, 3, 3, C, O)).astype(np.float32))
    packed = pack_conv_weights(k).float().view(2, 2, 27, 128 * 64)
    kb = F.pad(k.reshape(27, C, O).to(torch.bfloat16).float(), (0, 256 - O, 0, 128 - C))
    n, kk = torch.arange(128)[:, None], torch.arange(64)[None, :]
    pos = (n * 64 + ((kk // 8) ^ (n % 8)) * 8 + kk % 8).reshape(-1)
    for nb in range(2):
        for ck in range(2):
            tile = kb[:, ck * 64:(ck + 1) * 64, nb * 128:(nb + 1) * 128].permute(0, 2, 1)
            want = torch.zeros(27, 128 * 64)
            want[:, pos] = tile.reshape(27, -1)
            assert torch.equal(packed[nb, ck], want)


def _head_and_ancestral_shapes():
    return (1, 64, 64, 64, 128), (1, 64, 64, 64, 4), (1, 64, 64, 64, 1)


@pytest.mark.parametrize('kernel', ['gn_silu_conv3d', 'gn_affine', 'groupnorm_silu',
                                    'ancestral_update', 'tile_zmin', 'nin_residual'])
def test_cost_helpers_match_hand_counts(kernel):
    """FLOP and bytes behind each kernel's bound_ms, against counts made by
    hand for a res64 forward (989 TFLOP/s bf16, 67 fp32, 3.35 TB/s), and for
    the z-test on a small input (33.5 T unfused fp32 operations/s)."""
    calls = _conv_calls('res64')
    head, xs4, ms4 = _head_and_ancestral_shapes()
    if kernel == 'gn_silu_conv3d':
        # 2 R^3 27 C O a call: 5.13 TFLOP and a 5.26 ms bound over the 74 calls
        flop = sum(n * ops.gn_silu_conv3d_cost(xs, dt, O)[0] for (xs, dt, O), n in calls.items())
        ms = sum(n * gn_silu_conv3d_bound_ms(xs, dt, O)[0] for (xs, dt, O), n in calls.items())
        assert abs(flop / 5.13e12 - 1) < 2e-3 and abs(ms / 5.26 - 1) < 2e-3, (flop, ms)
        assert gn_silu_conv3d_bound_ms((1, 64, 64, 64, 128), torch.bfloat16, 128) \
            == pytest.approx((2 * 64 ** 3 * 27 * 128 * 128 / 989e12 * 1e3, 'operations'))
        assert gn_silu_conv3d_bound_ms((1, 4, 4, 4, 512), torch.bfloat16, 512)[1] == 'bytes'
    elif kernel == 'gn_affine':
        # x read once: 0.566 ms over the 74 conv inputs, 0.04 ms at the head (fp32)
        convs = sum(n * bound_ms(*ops.gn_affine_cost(xs, dt))[0] for (xs, dt, O), n in calls.items())
        at_head = bound_ms(*ops.gn_affine_cost(head, torch.float32))[0]
        assert abs(convs / 0.566 - 1) < 5e-3 and abs(at_head / 0.04 - 1) < 0.01, (convs, at_head)
    elif kernel == 'groupnorm_silu':
        flop, nbytes = ops.groupnorm_silu_cost(head, torch.float32)
        assert nbytes == 2 * 64 ** 3 * 128 * 4 + 2 * 128 * 4 and flop == 8 * 64 ** 3 * 128
    elif kernel == 'nin_residual':
        # the 22 shortcuts (first chains whose width changes) at batch 4: x at
        # its dtype, bf16 W and h, fp32 b and output, 2.46 ms (bytes)
        short = {(xs, dt, O): n for (xs, dt, O), n in calls.items() if xs[-1] != O}
        assert sum(short.values()) == 22
        ms = sum(n * bound_ms(*ops.nin_residual_cost((4,) + xs[1:], dt, O), PEAK_BF16_FLOPS)[0]
                 for (xs, dt, O), n in short.items())
        assert abs(ms / 2.46 - 1) < 2e-3, ms
        M = 64 ** 3
        assert ops.nin_residual_cost((1, 64, 64, 64, 256), torch.float32, 128) == (
            2 * M * 256 * 128, M * 256 * 4 + 256 * 128 * 2 + 128 * 4 + M * 128 * (2 + 4))
    elif kernel == 'ancestral_update':
        # x, eps, noise and the mask read, x and x_mean written: about 6.6 us
        ms, by = bound_ms(*ops.ancestral_update_cost(xs4, ms4))
        assert by == 'bytes' and abs(ms / 6.57e-3 - 1) < 1e-3, ms
    else:
        # 2 views of 2 tiles (a 32 x 40 image: the second tile has 8 columns
        # inside): 6 tile entries and 3 global ones, each global one tested by
        # both tiles of its view: pairs 4, 1, 3, 4 a tile, whatever K and Kg
        res = (32, 40)
        coords = torch.zeros((2, 5, 9))
        counts = torch.tensor([3, 0, 1, 2], dtype=torch.int32)
        gcount = torch.tensor([1, 2], dtype=torch.int32)
        # per layer and (pair, open pixel) 3 fp32 and 7 ALU operations, per
        # (pair, tile with an open pixel) 12 fp32 a row and a column, per
        # pair once 12 fp32 and 1 ALU
        line = 12 * 32
        fp32, alu, nbytes = ops.tile_zmin_cost(coords, counts, gcount, res, num_layers=2)
        assert fp32 == 2 * 12 * (3 * 1024 + line) + 12 * 12 and alu == 2 * 7 * 12 * 1024 + 12
        assert nbytes == 4 * 9 + 4 * 90 + 2 * 4 * 1024 * 8
        floor = torch.zeros((4, 32, 32))
        floor[1] = 1e30                 # the second tile of view 0 is closed
        assert ops.tile_zmin_cost(coords, counts, gcount, res, 2, floor) \
            == ((11 + 12) * (3 * 1024 + line) + 12 * 12, 7 * (11 + 12) * 1024 + 12,
                nbytes + 4 * 4096)
        # the second layer tests only the pixels of the image the first hit:
        # 10 in each first tile, 16 in row 0 of each second tile of which 8
        # lie inside the image
        best_z = torch.full((2, 4, 32, 32), 1e30)
        best_z[0, 0::2, :2, :5] = 0.5
        best_z[0, 1::2, 0, :16] = 0.5
        best_z[1] = 0.5                 # the last layer opens nothing
        second = 4 * 10 + 1 * 8 + 3 * 10 + 4 * 8
        assert ops.tile_zmin_cost(coords, counts, gcount, res, 2, best_z=best_z)[:2] \
            == (3 * (12 * 1024 + second) + 2 * 12 * line + 12 * 12, 7 * (12 * 1024 + second) + 12)
        # no FMA: one fp32 instruction an operation, 132 x 128 lanes at 1.98
        # GHz; compares and predicate logic at half that on the ALU pipe
        assert PEAK_FP32_UNFUSED_OPS == pytest.approx(33.454e12, rel=1e-4)
        assert PEAK_ALU_OPS == pytest.approx(PEAK_FP32_UNFUSED_OPS / 2)
        busy = torch.full((4,), 4000, dtype=torch.int32)        # the ALU pipe bounds it
        assert ops.tile_zmin_bound_ms(coords, busy, gcount, res) == pytest.approx(
            ((7 * 1024 + 1) * (16000 + 2 * 3) / 16.72704e12 * 1e3, 'operations'))


_ENTRY_POINTS = ('create_model', 'extract_grid', 'extract_batch', 'extract_dir', 'uncond_gen',
                 'uncond_gen_interp', 'cond_gen', 'fit_singleview', 'train')


@pytest.mark.parametrize('entry', ['create_model', 'extract_grid', 'extract_batch',
                                   'uncond_gen', 'uncond_gen_interp', 'cond_gen', 'fit_singleview',
                                   'train']
                         + [f'main --mode {m}' for m in ('uncond_gen', 'uncond_gen_interp',
                                                         'cond_gen', 'extract', 'extract_traj',
                                                         'fit_dmtets', 'fit_singleview', 'train')])
def test_entry_points_default_to_cuda(entry, monkeypatch, tmp_path):
    """Called with no device, ``create_model``, the extraction functions,
    the generation drivers, the single-view fit, the trainer and every mode
    of the command line ask for the card, and raise where CUDA is missing
    instead of falling back."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    from meshdiffusion_tpu_torch import extract
    from meshdiffusion_tpu_torch.diffusion import evaler
    from meshdiffusion_tpu_torch.fitting.fit import FitConfig
    from meshdiffusion_tpu_torch.fitting.singleview import fit_singleview
    from meshdiffusion_tpu_torch.main import main
    from meshdiffusion_tpu_torch.models import create_model
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        if entry == 'create_model':
            create_model(get_config('res64'))
        elif entry == 'extract_grid':
            extract.extract_grid(np.zeros((4, 8, 8, 8), np.float32), None, str(tmp_path / 'a.obj'))
        elif entry == 'extract_batch':
            np.save(tmp_path / 's.npy', np.zeros((1, 4, 8, 8, 8), np.float32))
            extract.extract_batch(str(tmp_path / 's.npy'), str(tmp_path), resolution=8,
                                  tet_root=str(tmp_path))
        elif entry == 'fit_singleview':
            fit_singleview(str(tmp_path / 'none.obj'), FitConfig(), str(tmp_path))
        elif entry == 'train':
            from meshdiffusion_tpu_torch.diffusion.trainer import train
            train(get_config('res64'))
        elif entry.startswith('main'):
            main(entry.split()[1:])
        else:
            getattr(evaler, entry)(get_config('res64'))


def test_cpu_tests_name_their_device():
    """Every call of one of the port's entry points (create_model, the
    extraction functions, the generation drivers, fit_singleview) in the
    port's test files passes ``device=`` (the default is the card), whether
    called by its imported name or through an imported port module."""
    missing = []
    for path in sorted(glob.glob(os.path.join(HERE, 'test_torch_*.py'))):
        tree = ast.parse(open(path).read())
        port = [node for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
                and (node.module or '').startswith('meshdiffusion_tpu_torch')]
        names = {a.asname or a.name for node in port for a in node.names
                 if a.name in _ENTRY_POINTS}
        modules = {a.asname or a.name for node in port for a in node.names
                   if a.name not in _ENTRY_POINTS}
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef) or fn.name == 'test_entry_points_default_to_cuda':
                continue          # that test leaves the device out on purpose
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or any(k.arg == 'device' for k in node.keywords):
                    continue
                f = node.func
                if (isinstance(f, ast.Name) and f.id in names) or (
                        isinstance(f, ast.Attribute) and f.attr in _ENTRY_POINTS
                        and isinstance(f.value, ast.Name) and f.value.id in modules):
                    missing.append(f'{os.path.basename(path)}:{node.lineno}')
    assert not missing, missing


def test_library_entry_points_and_build_key(monkeypatch, tmp_path):
    """Every entry point ``ops/_build.py`` binds is an ``extern "C"`` function
    of a ``csrc/*.cu`` source with as many parameters as its ctypes
    signature; the library's name changes when a shared header does."""
    import re

    from meshdiffusion_tpu_torch.ops import _build
    text = ''.join(open(p).read() for p in _build._sources())
    for name, argtypes in _build._SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r'\(([^)]*)\)', text)
        assert m, name
        assert len(m.group(1).split(',')) == len(argtypes), name
    (tmp_path / 'a.cu').write_text('// a')
    (tmp_path / 'b.cuh').write_text('// b')
    monkeypatch.setattr(_build, 'SRC_DIR', str(tmp_path))
    before = _build.library_path()
    (tmp_path / 'b.cuh').write_text('// b, changed')
    assert _build.library_path() != before
