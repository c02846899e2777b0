"""The port's textured render stack against the JAX package, on the CPU:
the hash-grid encoding and the neural material (forward and gradients,
JAX's weights carried across), image files (the PNG decoder against PIL,
Radiance .hdr), the environment light (HDR loading, GGX prefiltering,
rotated shading), 2D textures, materials and textured OBJ files, the
BSDFs, the neural-material shader with JAX's jitter draws, ``random_lgt``
targets and the validation metrics.

Tolerances: fp32 rtol 2e-4 / atol 2e-5 (as ``test_torch_parity.py``);
gradients rtol 2e-4 with an atol of 2e-4 of the gradient's largest
magnitude (scatter sums taken in another order); hash indices, decoded
pixels and face sets exactly.

The JAX package's ``render_mesh`` raises on ``xfm_lgt`` (its light's
``shade`` unpacks a (B, H, W, 3) batch, but runs inside the per-view
vmap on one view's (H, W, 3) or compacted (cap, 3) G-buffer), so its
``random_lgt`` fit fails. Where a test needs JAX's rotated shading, it
renders with :class:`AnyRankLight`, which hands JAX's own ``shade`` the
view's G-buffer as a batch of one."""

import functools
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meshdiffusion_tpu.fitting import fit as JF
from meshdiffusion_tpu.render import light as JL
from meshdiffusion_tpu.render import material as JMat
from meshdiffusion_tpu.render import mesh as JM
from meshdiffusion_tpu.render import mlptexture as JMLP
from meshdiffusion_tpu.render import obj as JObj
from meshdiffusion_tpu.render import ops as JO
from meshdiffusion_tpu.render import texture as JT
from meshdiffusion_tpu.render import utils as JU
from meshdiffusion_tpu_torch.fitting import fit as F
from meshdiffusion_tpu_torch.render import light as L
from meshdiffusion_tpu_torch.render import material as Mat
from meshdiffusion_tpu_torch.render import mesh as M
from meshdiffusion_tpu_torch.render import mlptexture as MLP
from meshdiffusion_tpu_torch.render import obj as Obj
from meshdiffusion_tpu_torch.render import ops as O
from meshdiffusion_tpu_torch.render import texture as T
from meshdiffusion_tpu_torch.render import utils as U
from meshdiffusion_tpu_torch.utils.convert import mlp_texture_state_from_jax

pytest_plugins = ('torch_rules',)

RTOL, ATOL = 2e-4, 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **kw):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL, **kw)


def _close_grad(got, want):
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=2e-4 * np.abs(want).max())


class AnyRankLight(JL.EnvironmentLight):
    """JAX's light, its ``shade`` given one view's G-buffer of any rank as
    a (1, N, 1, 3) batch: JAX's own shading, xfm_lgt included, at a shape
    it accepts inside ``render_mesh``'s per-view vmap."""

    def shade(self, gb_pos, gb_normal, kd, ks, view_pos, specular=False, xfm_lgt=None):
        def b4(a):
            return a.reshape(1, -1, 1, a.shape[-1])
        out = super().shade(b4(gb_pos), b4(gb_normal), b4(kd), b4(ks), view_pos, specular,
                            xfm_lgt)
        return out.reshape(gb_normal.shape[:-1] + (out.shape[-1],))


def any_rank(light):
    out = AnyRankLight(light.base)
    out.diffuse, out.specular = light.diffuse, light.specular
    return out


# ------------------------------------------------------- the neural material

def _points(rng, n, lo=0.0, hi=1.0):
    """n points in [lo, hi]^3 with the box's corners and faces among them
    (x = hi is the lattice's last vertex at every level)."""
    x = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    corners = np.array([[(i >> k) & 1 for k in range(3)] for i in range(8)], np.float32)
    x[:8] = lo + corners * (hi - lo)
    x[8:40, rng.integers(0, 3, 32)] = hi
    return x


def test_hash_indices_and_encoding_match_jax(rng):
    """The uint32 spatial hash: the rows ``hash_encode`` reads (its int64
    form, every level at once) against the uint32 formula of JAX's
    ``hash_encode`` at every level and corner, exactly, on 3000 points
    including x = 0 and x = 1.0, and its trilinear weights; then the
    encoding of a random table at fp32 tolerance."""
    enc = JMLP.HashEncoder()
    res = enc.resolutions()
    x = _points(rng, 3000)
    T = 2 ** enc.log2_hashmap_size
    idx, wts = MLP.hash_corners(_t(x), res, T)
    assert idx.shape == wts.shape == (len(res), 8, len(x))
    for lvl, r in enumerate(res):
        xs = jnp.asarray(x) * int(r)
        x0 = jnp.floor(xs).astype(jnp.int32)
        frac = xs - x0
        for corner in range(8):
            offs = np.array([(corner >> k) & 1 for k in range(3)], np.int32)
            c = jnp.clip(x0 + offs, 0, int(r)).astype(jnp.uint32)
            h = ((c[:, 0] * jnp.uint32(1)) ^ (c[:, 1] * jnp.uint32(2654435761))
                 ^ (c[:, 2] * jnp.uint32(805459861)))
            want = np.asarray(jnp.remainder(h, jnp.uint32(T)).astype(jnp.int32))
            np.testing.assert_array_equal(idx[lvl, corner].numpy(), want + lvl * T)
            w = jnp.prod(jnp.where(offs[None, :] == 1, frac, 1.0 - frac), axis=-1)
            _close(wts[lvl, corner], w)
    table = rng.uniform(-1, 1, (len(res), T, 2)).astype(np.float32)
    want = JMLP.hash_encode(jnp.asarray(x), jnp.asarray(table), res)
    got = MLP.hash_encode(_t(x), _t(table), res)
    _close(got, want)


def material_pair(aabb, key, coarse=6):
    """JAX's neural material (``make_mlp_material``) over ``aabb``, its
    ``coarse`` coarsest hash levels N(0, 0.3^2), the rest at their +-1e-4
    start, and the port's with the same weights."""
    module, params = JF.make_mlp_material(aabb)
    table = params['params']['encoder']['table']
    lvl = (jnp.arange(table.shape[0]) < coarse)[:, None, None]
    table = table + 0.3 * lvl * jax.random.normal(jax.random.key(key), table.shape)
    params = {'params': {**params['params'], 'encoder': {'table': table}}}
    mat = F.make_mlp_material(aabb, device='cpu')
    mat.load_state_dict({**mat.state_dict(), **mlp_texture_state_from_jax(params)})
    return module, params, mat


SMALL_HASH = dict(num_levels=4, log2_hashmap_size=14, desired_resolution=64)


@pytest.fixture
def small_hash(monkeypatch):
    """Both packages' hash grid cut to 4 levels of 2^14 entries, 16 -> 64
    cells a side, for the tests of what the material feeds (the render, the
    bake, fit steps): the JAX package traces its encoder level by level and
    corner by corner, so at 16 x 2^19 such a test spends most of its time
    tracing it. The full-size encoder is held in
    ``test_mlp_texture_forward_and_grads_match_jax``."""
    monkeypatch.setattr(JMLP, 'HashEncoder', functools.partial(JMLP.HashEncoder, **SMALL_HASH))
    monkeypatch.setattr(MLP, 'HashEncoder', functools.partial(MLP.HashEncoder, **SMALL_HASH))


@pytest.fixture(scope='module')
def jax_material():
    """JAX's neural material at full size (16 x 2^19 x 2 table, 2 x 32
    hidden, 9 outputs) over a box. The six coarsest levels (16 to 102 cells
    a side) get N(0, 0.3^2) entries, the rest keep their +-1e-4 start: a
    material that varies over the sphere like a fitted one. (Noise of that
    size at the 4096 level would make the texture vary by ~1e-3 over
    1e-7 of position, so renders would differ by the rounding of their
    interpolated positions.)"""
    aabb = (np.array([-0.4, -0.3, -0.5], np.float32), np.array([0.5, 0.35, 0.45], np.float32))
    return (aabb,) + material_pair(aabb, 1)


def test_mlp_texture_forward_and_grads_match_jax(rng, jax_material):
    """MLPTexture3D forward (aabb normalization, clip, encoder, ReLU MLP,
    sigmoid into min_max) on 2500 points including the box's corners and
    points outside it, and the gradients of a weighted sum to the table
    (the encoder's scatter) and every dense kernel."""
    aabb, module, params, mat = jax_material
    assert dict(mat.named_parameters()).keys() == {'encoder.table', 'dense_0.weight',
                                                   'dense_1.weight', 'dense_2.weight'}
    assert mat.encoder.table.shape == (16, 2 ** 19, 2)
    np.testing.assert_array_equal(mat.encoder.resolutions(), JMLP.HashEncoder().resolutions())
    x = _points(rng, 2500, -0.55, 0.55).reshape(50, 50, 3)
    w = rng.normal(size=(50, 50, 9)).astype(np.float32)
    (want, grads) = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (jnp.sum(o * w), o))(module.apply(p, jnp.asarray(x))),
        has_aux=True))(params)
    got = mat(_t(x))
    _close(got, want[1])
    (got * _t(w)).sum().backward()
    g = grads['params']
    _close_grad(mat.encoder.table.grad.numpy(), g['encoder']['table'])
    for i in range(3):
        _close_grad(getattr(mat, f'dense_{i}').weight.grad.numpy().T, g[f'dense_{i}']['kernel'])
    # the fit's rescale: the encoder's gradient / 8, the MLP's untouched
    before = {k: p.grad.clone() for k, p in mat.named_parameters()}
    F.rescale_encoder_grads(mat)
    for k, p in mat.named_parameters():
        torch.testing.assert_close(p.grad, before[k] / 8 if k.startswith('encoder') else before[k],
                                   rtol=0, atol=0)


# ------------------------------------------------------------- image files

def _png_bytes(img: np.ndarray, filters) -> bytes:
    """An 8-bit PNG of ``img`` (H, W[, C]) with row y filtered by
    filters[y % len(filters)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth),
    written here from the PNG specification."""
    a = img if img.ndim == 3 else img[..., None]
    h, w, c = a.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = a.reshape(h, w * c).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        ft = filters[y % len(filters)]
        if ft == 0:
            pred = np.zeros_like(cur)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        raw += bytes([ft]) + ((cur - pred) % 256).astype(np.uint8).tobytes()

    def chunk(tag, data):
        return (struct.pack('>I', len(data)) + tag + data
                + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff))
    return (b'\x89PNG\r\n\x1a\n' + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, ctype, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(bytes(raw), 9))
            + chunk(b'IEND', b''))


@pytest.mark.parametrize('channels', [1, 2, 3, 4])
def test_png_decoder_matches_pil(rng, tmp_path, channels):
    """Every colour type: files PIL writes (its own filter choice) and
    files written here with all five row filters in turn, the pixels
    exactly equal to PIL's decoding; load_image scales them to [0, 1]."""
    from PIL import Image
    img = rng.integers(0, 256, (37, 29, channels)).astype(np.uint8)
    img[5:20, 3:17] = 200                        # flat runs, where Paeth and Up differ
    img = img[..., 0] if channels == 1 else img
    mode = {1: 'L', 2: 'LA', 3: 'RGB', 4: 'RGBA'}[channels]
    paths = [str(tmp_path / 'pil.png'), str(tmp_path / 'ours.png')]
    Image.fromarray(img, mode).save(paths[0], optimize=True)
    with open(paths[1], 'wb') as f:
        f.write(_png_bytes(img, [0, 1, 2, 3, 4, 4, 3, 2, 1]))
    for p in paths:
        want = np.asarray(Image.open(p))
        with open(p, 'rb') as f:
            got = U.decode_png(f.read())
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(U.load_image(p), want.astype(np.float32) / 255.0)


def test_png_decoder_refuses_what_it_does_not_read(rng, tmp_path):
    from PIL import Image
    img = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
    cases = {'palette': Image.fromarray(img).convert('P'),
             '16-bit': Image.fromarray(rng.integers(0, 65535, (8, 8)).astype(np.uint16))}
    for name, im in cases.items():
        p = str(tmp_path / f'{name}.png')
        im.save(p)
        with open(p, 'rb') as f:
            with pytest.raises(ValueError):
                U.decode_png(f.read())
    p = str(tmp_path / 'interlaced.png')
    Image.fromarray(img).save(p, interlace=1)
    with open(p, 'rb') as f:
        data = f.read()
    if data[28] == 1:                           # the writer honoured the option
        with pytest.raises(ValueError):
            U.decode_png(data)


def write_hdr(path, rgbe: np.ndarray, rle: bool) -> None:
    """A Radiance .hdr of (H, W, 4) RGBE bytes, scanlines flat or in the
    new RLE form (runs of 3 or more as runs, the rest as literals)."""
    h, w, _ = rgbe.shape
    out = bytearray(b'#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n' + f'-Y {h} +X {w}\n'.encode())
    for y in range(h):
        if not rle:
            out += rgbe[y].tobytes()
            continue
        out += bytes([2, 2, w >> 8, w & 255])
        for ch in range(4):
            row, x = rgbe[y, :, ch], 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and row[x + run] == row[x]:
                    run += 1
                if run >= 3:
                    out += bytes([128 + run, row[x]])
                    x += run
                    continue
                n = 1
                while x + n < w and n < 128 and not (
                        x + n + 2 < w and row[x + n] == row[x + n + 1] == row[x + n + 2]):
                    n += 1
                out += bytes([n]) + row[x:x + n].tobytes()
                x += n
    with open(path, 'wb') as f:
        f.write(bytes(out))


def sky_rgbe(rng, h, w) -> np.ndarray:
    """A latlong sky of RGBE bytes: a gradient, flat runs and a bright sun."""
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = rng.integers(60, 250, (h, w, 3))
    rgbe[..., 3] = 128
    rgbe[: h // 3, :, 3] = 129                  # a brighter band, in runs
    rgbe[h // 4: h // 4 + 2, w // 3: w // 3 + 3] = (250, 240, 200, 136)    # the sun
    rgbe[-2:, :, 3] = 0                         # black (e = 0)
    return rgbe


@pytest.mark.parametrize('rle', [False, True])
def test_load_hdr_matches_jax(rng, tmp_path, rle):
    p = str(tmp_path / 'sky.hdr')
    write_hdr(p, sky_rgbe(rng, 12, 40), rle)
    want = JU.load_image(p)
    got = U.load_image(p)
    assert got.shape == (12, 40, 3) and got.max() > 100
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------- light

def test_load_env_and_specular_match_jax(rng, tmp_path, monkeypatch):
    """load_env (HDR latlong -> 512^2 cubemap -> mips and the diffuse map),
    specular_cubemap at a tiny resolution, the GGX chain of
    build_mips(with_specular=True), get_mip, regularizer, clamp, clone,
    and the latlong round trip. (JAX's latlong resampling runs under
    jax.jit, where op by op each op compiles on its own.)"""
    latlong_to_cubemap = jax.jit(JU.latlong_to_cubemap, static_argnums=1)
    monkeypatch.setattr(JU, 'latlong_to_cubemap', latlong_to_cubemap)
    p = str(tmp_path / 'sky.hdr')
    write_hdr(p, sky_rgbe(rng, 16, 32), True)
    jl = JL.load_env(p, scale=0.7)
    pl = L.load_env(p, scale=0.7)
    _close(pl.base, jl.base)
    _close(pl.diffuse, jl.diffuse)
    small = rng.uniform(0.0, 2.0, (6, 8, 8, 3)).astype(np.float32)
    for r in (0.08, 0.3, 1.0):
        _close(L.specular_cubemap(_t(small), r, chunk=100), JL.specular_cubemap(jnp.asarray(small), r))
    # the GGX chain (the smallest base with one: 64^2, mips 32 and 16) at
    # roughness 0.08, 0.5, 1. Level 0 is not held to JAX's: there the GGX
    # lobe is narrower than a texel, so each output is the nearest texel's
    # D at 1 - c^2 (1 - a^2) with c within 1e-4 of 1, which rounding sets
    # (XLA contracts it into FMAs; 2 % apart); the filter itself is held
    # above. Levels 1 and 2 against JAX's filter on JAX's mips.
    base = rng.uniform(0.0, 2.0, (6, 64, 64, 3)).astype(np.float32)
    jl, pl = JL.EnvironmentLight(jnp.asarray(base)), L.EnvironmentLight(_t(base))
    jl.build_mips()
    pl.build_mips(with_specular=True)
    assert [tuple(m.shape) for m in pl.specular] == [tuple(m.shape) for m in jl.specular] \
        == [(6, 64, 64, 3), (6, 32, 32, 3), (6, 16, 16, 3)]
    spec = jax.jit(JL.specular_cubemap, static_argnums=1)
    for a, b, r in zip(pl.specular[1:], jl.specular[1:], (0.5, 1.0)):
        _close(a, spec(b, r))
    assert torch.isfinite(pl.specular[0]).all()
    rough = rng.uniform(0, 1, (50, 1)).astype(np.float32)
    _close(pl.get_mip(_t(rough)), jl.get_mip(jnp.asarray(rough)))
    _close(pl.regularizer(), jl.regularizer())
    pl2 = pl.clone()
    pl2.clamp(0.5, 1.5)
    jl2 = jl.clone()
    jl2.clamp(0.5, 1.5)
    _close(pl2.base, jl2.base)
    want = jax.jit(JU.cubemap_to_latlong, static_argnums=1)(jnp.asarray(base), (16, 32))
    _close(U.cubemap_to_latlong(_t(base), (16, 32)), want)
    lat = rng.uniform(0, 1, (10, 20, 3)).astype(np.float32)
    _close(U.latlong_to_cubemap(_t(lat), (6, 6)), latlong_to_cubemap(jnp.asarray(lat), (6, 6)))


def test_shade_with_light_transform_matches_jax(rng):
    """EnvironmentLight.shade on a (B, H, W, 3) batch with a per-view light
    rotation, and the port's per-view call with a (1, 4, 4) one."""
    base = rng.uniform(0.1, 2.0, (6, 16, 16, 3)).astype(np.float32)
    jl, pl = JL.EnvironmentLight(jnp.asarray(base)), L.EnvironmentLight(_t(base))
    jl.build_mips()
    pl.build_mips()
    pos, nrm = (rng.normal(size=(2, 5, 7, 3)).astype(np.float32) for _ in range(2))
    kd = rng.uniform(0, 1, (2, 5, 7, 3)).astype(np.float32)
    ks = rng.uniform(0, 0.5, (2, 5, 7, 3)).astype(np.float32)
    view = np.zeros((2, 1, 1, 3), np.float32)
    xfm = np.stack([JU.random_rotation_translation(0.0, np.random.default_rng(i))
                    for i in range(2)])
    want = jl.shade(*(jnp.asarray(a) for a in (pos, nrm, kd, ks, view)), xfm_lgt=xfm)
    got = pl.shade(*(_t(a) for a in (pos, nrm, kd, ks, view)), xfm_lgt=_t(xfm))
    _close(got, want)
    one = pl.shade(*(_t(a[1]) for a in (pos, nrm, kd, ks, view)), xfm_lgt=_t(xfm[1:]))
    _close(one, want[1])
    with pytest.raises(NotImplementedError):
        pl.shade(*(_t(a) for a in (pos, nrm, kd, ks, view)), specular=True)


# ------------------------------------------------------ textures and files

def test_texture_sampling_matches_jax(rng):
    """Texture2D: bilinear wrap sampling (uv outside [0, 1] and negative),
    trilinear mips from uv derivatives, clamp to min_max, explicit mip
    lists, create_trainable (resized, and without auto mips), the sRGB
    converters; scale_img_nhwc's area and resize paths."""
    img = rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    uv = rng.uniform(-1.5, 2.5, (300, 2)).astype(np.float32)
    deriv = (rng.uniform(0, 0.2, (300, 4)) * rng.choice([-1, 1], (300, 4))).astype(np.float32)
    jt, pt = JT.Texture2D(img, min_max=(np.full(3, 0.2), np.full(3, 0.7))), \
        T.Texture2D(img, min_max=(np.full(3, 0.2), np.full(3, 0.7)))
    _close(pt.sample(_t(uv)), jt.sample(jnp.asarray(uv)))
    _close(pt.sample(_t(uv), _t(deriv)), jt.sample(jnp.asarray(uv), jnp.asarray(deriv)))
    _close(pt.sample(_t(uv), _t(deriv[:, :2])), jt.sample(jnp.asarray(uv), jnp.asarray(deriv[:, :2])))
    _close(pt.clamp().data, jt.clamp().data)
    assert pt.res == (16, 16) and pt.channels == 3
    for kw in (dict(res=(8, 8)), dict(res=(32, 64)), dict(res=(7, 9), auto_mipmaps=False)):
        j, p = JT.create_trainable(img, **kw), T.create_trainable(img, **kw)
        assert len(p.get_mips()) == len(j.get_mips())
        for a, b in zip(p.get_mips(), j.get_mips()):
            _close(a, b)
        _close(p.sample(_t(uv), _t(deriv)), j.sample(jnp.asarray(uv), jnp.asarray(deriv)))
    for a, b in zip(T.srgb_to_rgb(pt).get_mips(), JT.srgb_to_rgb(jt).get_mips()):
        _close(a, b)
    for a, b in zip(T.rgb_to_srgb(pt).get_mips(), JT.rgb_to_srgb(jt).get_mips()):
        _close(a, b)
    x = rng.uniform(0, 1, (2, 12, 18, 4)).astype(np.float32)
    for size in ((6, 9), (5, 7), (20, 31), (12, 40)):
        _close(U.scale_img_nhwc(_t(x), size), JU.scale_img_nhwc(jnp.asarray(x), size),
               err_msg=str(size))
    _close(U.reflect(_t(x[..., :3]), _t(x[..., 1:])), JU.reflect(jnp.asarray(x[..., :3]),
                                                                 jnp.asarray(x[..., 1:])))
    _close(U.to_hvec(_t(x[..., :3]), 1.0), JU.to_hvec(jnp.asarray(x[..., :3]), 1.0))
    _close(U.reinhard(_t(x)), JU.reinhard(jnp.asarray(x)))
    np.testing.assert_allclose(U.psnr_to_mse(U.mse_to_psnr(0.01)), JU.psnr_to_mse(JU.mse_to_psnr(0.01)))
    np.testing.assert_array_equal(U.checkerboard((20, 30), 4), JU.checkerboard((20, 30), 4))
    eye, at, up = np.array([1.0, 2.0, 3.0]), np.zeros(3), np.array([0.0, 1.0, 0.0])
    np.testing.assert_array_equal(U.lookAt(eye, at, up), JU.lookAt(eye, at, up))
    np.testing.assert_array_equal(U.scale(1.5), JU.scale(1.5))


def write_textured_obj(folder, rng):
    """A two-material quad mesh: vt and vn on every face, ``usemtl`` per
    half, kd maps of two sizes (so merging resizes one), a constant ks,
    one material without a bsdf line."""
    os.makedirs(folder, exist_ok=True)
    from PIL import Image
    Image.fromarray(rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)).save(
        os.path.join(folder, 'a.png'))
    Image.fromarray(rng.integers(0, 256, (4, 4, 4)).astype(np.uint8), 'RGBA').save(
        os.path.join(folder, 'b.png'))
    with open(os.path.join(folder, 'm.mtl'), 'w') as f:
        f.write('newmtl matA\nbsdf diffuse\nmap_Kd a.png\nKs 0.1 0.2 0.3\n'
                'newmtl matB\nmap_Kd b.png\nKd 0.5 0.5 0.5\n')
    lines = ['mtllib m.mtl']
    for i in range(4):
        for j in range(4):
            lines.append(f'v {i * 0.3 - 0.4} {j * 0.25 - 0.3} {0.1 * np.sin(i + j):.5f}')
            lines.append(f'vt {i / 3} {j / 3}')
            lines.append(f'vn 0 {0.1 * i} 1')
    for rows, name in (((0,), 'matA'), ((1, 2), 'matB')):
        lines.append(f'usemtl {name}')
        for i in rows:
            for j in range(3):
                a, b, c, d = (i * 4 + j + 1, (i + 1) * 4 + j + 1, (i + 1) * 4 + j + 2,
                              i * 4 + j + 2)
                lines.append(f'f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c} {d}/{d}/{d}')
    with open(os.path.join(folder, 'm.obj'), 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return os.path.join(folder, 'm.obj')


def _same_mesh(pm, jm):
    for k in ('v_pos', 'v_tex', 'v_nrm'):
        _close(getattr(pm, k), getattr(jm, k), err_msg=k)
    for k in ('t_pos_idx', 't_tex_idx', 't_nrm_idx'):
        np.testing.assert_array_equal(getattr(pm, k).numpy(), np.asarray(getattr(jm, k)), err_msg=k)


def test_obj_and_mtl_io_match_jax(rng, tmp_path):
    """load_obj with vt / vn / usemtl over two materials (merged into one
    atlas), load_mesh with an mtl_override, load_mtl's defaults and
    clear_ks, default_material; the
    textured write_obj (with its .mtl and maps) written by the port and
    read back by JAX's load_obj; tangents of the loaded mesh."""
    path = write_textured_obj(str(tmp_path / 'in'), rng)
    jm, pm = JObj.load_mesh(path), Obj.load_mesh(path, device='cpu')
    _same_mesh(pm, jm)
    assert pm.material['bsdf'] == jm.material['bsdf'] == 'diffuse'
    for k in ('kd', 'ks'):
        _close(pm.material[k].data, jm.material[k].data, err_msg=k)
    mats, jmats = Mat.load_mtl(str(tmp_path / 'in' / 'm.mtl'), clear_ks=False), \
        JMat.load_mtl(str(tmp_path / 'in' / 'm.mtl'), clear_ks=False)
    assert [m['bsdf'] for m in mats] == [m['bsdf'] for m in jmats] == ['diffuse', 'pbr']
    for a, b in zip(mats, jmats):
        for k in ('kd', 'ks'):
            _close(a[k].data, b[k].data)
    other = str(tmp_path / 'in' / 'o.mtl')
    with open(other, 'w') as f:
        f.write('newmtl matA\nbsdf diffuse\nKd 0.2 0.4 0.6\n')
    jo, po = JObj.load_mesh(path, mtl_override=other), Obj.load_mesh(path, other, device='cpu')
    _same_mesh(po, jo)
    _close(po.material['kd'].data, jo.material['kd'].data)
    d, jd = Mat.default_material(), JMat.default_material()
    _close(d['kd'].data, jd['kd'].data)
    assert d['bsdf'] == jd['bsdf']

    pm = M.compute_tangents(pm)
    jm = JM.compute_tangents(jm)
    _close(pm.v_tng, jm.v_tng)
    np.testing.assert_array_equal(M.unique_edges(pm.t_pos_idx.numpy()),
                                  JM.unique_edges(np.asarray(jm.t_pos_idx)))
    out = Obj.write_obj(str(tmp_path / 'out'), pm, save_material=True)
    jout = JObj.write_obj(str(tmp_path / 'jout'), jm, save_material=False)
    with open(out) as a, open(jout) as b:
        assert a.read() == b.read()                 # the same text, byte for byte
    back = JObj.load_mesh(out)
    _same_mesh(pm, back)
    np.testing.assert_allclose(back.material['kd'].data, jm.material['kd'].data, rtol=0,
                               atol=2.5 / 255)               # through an 8-bit sRGB PNG
    c = M.Mesh(v_pos=pm.v_pos)
    c.copy_none(pm)
    assert c.t_tex_idx is pm.t_tex_idx and c.v_pos is pm.v_pos


def test_bsdfs_match_jax(rng):
    n = 400
    nrm, wi, wo, pos, view, light = (rng.normal(size=(n, 3)).astype(np.float32)
                                     for _ in range(6))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    kd, arm = (rng.uniform(0, 1, (n, 3)).astype(np.float32) for _ in range(2))
    rough = rng.uniform(0.01, 1, (n, 1)).astype(np.float32)
    cos = rng.uniform(-0.2, 1.2, (n, 1)).astype(np.float32)
    j, p = (lambda *a: [jnp.asarray(x) for x in a]), (lambda *a: [_t(x) for x in a])
    _close(O.lambert(*p(nrm, wi)), JO.lambert(*j(nrm, wi)))
    _close(O.fresnel_shlick(*p(kd, rough, cos)), JO.fresnel_shlick(*j(kd, rough, cos)))
    _close(O.frostbite_diffuse(*p(nrm, wi, wo, rough)), JO.frostbite_diffuse(*j(nrm, wi, wo, rough)))
    _close(O.ndf_ggx(*p(rough, cos)), JO.ndf_ggx(*j(rough, cos)))
    _close(O.lambda_ggx(*p(rough, cos)), JO.lambda_ggx(*j(rough, cos)))
    _close(O.masking_smith(*p(rough, cos, cos[::-1])), JO.masking_smith(*j(rough, cos, cos[::-1])))
    _close(O.pbr_specular(*p(kd, nrm, wo, wi, rough)), JO.pbr_specular(*j(kd, nrm, wo, wi, rough)))
    for bsdf in ('lambert', 'frostbite'):
        _close(O.pbr_bsdf(*p(kd, arm, pos, nrm, view, light), bsdf=bsdf),
               JO.pbr_bsdf(*j(kd, arm, pos, nrm, view, light), bsdf=bsdf))


# ------------------------------------------- renders with the neural material

@pytest.fixture(scope='module')
def sphere(tiny_tet_grid):
    """A marching-tets sphere on the tiny grid, centred (both packages'
    meshes), with the port's and JAX's grids."""
    from meshdiffusion_tpu.geometry.marching_tets import compact_mesh, marching_tets
    from meshdiffusion_tpu_torch.geometry.tet_grid import TetGrid
    jtg = tiny_tet_grid
    sdf = 0.3 - np.linalg.norm(jtg.verts, axis=1).astype(np.float32)
    v, f = compact_mesh(marching_tets(jtg, jnp.asarray(jtg.verts), jnp.asarray(sdf)))
    v, f = np.asarray(v, np.float32), np.asarray(f, np.int32)
    jm = JM.Mesh(v_pos=jnp.asarray(v), t_pos_idx=jnp.asarray(f))
    lo, hi = JM.aabb(jm.v_pos)
    jm = JM.auto_normals(JM.center_by_reference(jm, (np.asarray(lo), np.asarray(hi)), 1.0))
    pm = M.Mesh(v_pos=_t(v), t_pos_idx=_t(f).long())
    pm = M.auto_normals(M.center_by_reference(pm, M.aabb(pm.v_pos), 1.0))
    return jm, pm, jtg, TetGrid.from_arrays(jtg.resolution, jtg.verts, jtg.indices)


def _light(rng, res=32):
    base = rng.uniform(0.1, 1.5, (6, res, res, 3)).astype(np.float32)
    jl, pl = JL.EnvironmentLight(jnp.asarray(base)), L.EnvironmentLight(_t(base))
    jl.build_mips()
    pl.build_mips()
    return jl, pl


def _cameras(n, seed=0, res=(48, 48)):
    from meshdiffusion_tpu_torch.fitting.dataset import TargetRenderer
    ren = TargetRenderer(ref_mesh=None, envlight=None, cam_radius=2.0, train_res=res)
    _, mvp, campos = ren.random_cameras(n, np.random.default_rng(seed))
    return mvp, campos


def test_neural_material_render_matches_jax(sphere, small_hash):
    """render_mesh of a 2-view batch with the kd_ks_normal material (the
    hash grid of ``small_hash``, every level N(0, 0.3^2)), the jitter's
    normal draws JAX's (jax.random.normal of each view's key, one draw a
    view for both layers), and the light rotated by a random ``xfm_lgt``:
    every buffer, kd_grad and occlusion included, with the fit's compacted
    shading (shade_cap H*W/4)."""
    shade_cap = 48 * 48 // 4
    import meshdiffusion_tpu.render.render as JR
    from meshdiffusion_tpu_torch.render.render import render_mesh
    jm, pm, _, _ = sphere
    jl, pl = _light(np.random.default_rng(3))
    aabb = (np.array([-0.4, -0.3, -0.5], np.float32), np.array([0.5, 0.35, 0.45], np.float32))
    module, params, port_mat = material_pair(aabb, 1, coarse=SMALL_HASH['num_levels'])
    jmat = JF.default_material()
    jmat['kd_ks_normal'] = JMLP.BoundTexture3D(module, params)
    jm = JM.Mesh.combine(jm)
    jm.material = jmat
    pmat = F.default_material()
    pmat['kd_ks_normal'] = port_mat
    pm = M.Mesh.combine(pm)
    pm.material = pmat
    mvp, campos = _cameras(2)
    xfm = JU.random_rotation_translation(0.0, np.random.default_rng(5))[None]
    key = jax.random.key(11)
    kw = dict(num_layers=2, raster_K=1024, shade_cap=shade_cap)
    want = jax.jit(lambda: JR.render_mesh(jm, mvp, campos, any_rank(jl), (48, 48), rng=key,
                                          xfm_lgt=xfm, **kw))()
    shape = (shade_cap, 3) if shade_cap else (48, 48, 3)
    draws = iter([np.asarray(jax.random.normal(k, shape)) for k in jax.random.split(key, 2)])
    got = render_mesh(pm, _t(mvp), _t(campos), pl, (48, 48), xfm_lgt=_t(xfm),
                      normal=lambda s: _t(next(draws)), **kw)
    assert float(np.asarray(want['kd_grad'])[..., 0].max()) > 1e-3
    for k in ('shaded', 'shaded_second', 'kd_grad', 'occlusion', 'normal', 'depth', 'mask'):
        _close(got[k], want[k], err_msg=k)
    with pytest.raises(NotImplementedError):
        pm.material['bsdf'] = 'pbr'
        render_mesh(pm, _t(mvp), _t(campos), pl, (48, 48), **kw)


@pytest.mark.parametrize('pool', [0, 2])
def test_random_lgt_targets_match_jax(sphere, pool):
    """``random_lgt`` targets: each batch's cameras and then its light
    rotation drawn from the numpy Generator in JAX's order (equal), and the
    GT rendered under the rotated light (JAX's shading through
    AnyRankLight), fresh and from a pool of two."""
    from meshdiffusion_tpu.fitting.dataset import TargetRenderer as JTR
    from meshdiffusion_tpu_torch.fitting.dataset import TargetRenderer
    jm, pm, _, _ = sphere
    jm.material, pm.material = JF.default_material(), F.default_material()
    jl, pl = _light(np.random.default_rng(4))
    kw = dict(cam_radius=2.0, train_res=(48, 48), random_lgt=True, num_surface_samples=100,
              target_pool=pool)
    jren, pren = JTR(ref_mesh=jm, envlight=any_rank(jl), **kw), TargetRenderer(
        ref_mesh=pm, envlight=pl, **kw)
    jrng, prng = np.random.default_rng(7), np.random.default_rng(7)
    for i in range(2):
        jt = jren.random_target(2, jrng, jax.random.key(i))
        pt = pren.random_target(2, prng)
        np.testing.assert_array_equal(pt['envlight_transform'].numpy(),
                                      np.asarray(jt['envlight_transform']))
        np.testing.assert_array_equal(pt['mvp'].numpy(), np.asarray(jt['mvp']))
        for k in ('img', 'img_second', 'depth', 'mask_cont'):
            # a pool keeps colour and coverage in f16: there, one f16 step
            f16 = pool and k != 'depth'
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(jt[k], np.float32),
                                       rtol=2.0 ** -10 if f16 else RTOL, atol=ATOL, err_msg=k)
    assert np.abs(np.asarray(pt['envlight_transform'])[0, :3, :3] - np.eye(3)).max() > 0.1
    assert jrng.integers(1 << 30) == prng.integers(1 << 30)      # the same draws taken


def test_validate_matches_jax(sphere, tmp_path, monkeypatch):
    """validate's metrics.txt (per-view MSE and PSNR of the sRGB renders,
    and the averages) and its PNGs, 3 views at 48^2, the fit's candidate a
    noisy sphere against the GT sphere."""
    from meshdiffusion_tpu.fitting.dataset import TargetRenderer as JTR
    from meshdiffusion_tpu.fitting.geometry import DMTetFitter as JFitter
    from meshdiffusion_tpu.fitting.validate import validate as jvalidate
    from meshdiffusion_tpu_torch.fitting.dataset import TargetRenderer
    from meshdiffusion_tpu_torch.fitting.geometry import DMTetFitter
    from meshdiffusion_tpu_torch.fitting.validate import validate
    from meshdiffusion_tpu_torch.utils.convert import fit_state_from_jax
    jm, pm, jtg, tg = sphere
    jm.material, pm.material = JF.default_material(), F.default_material()
    jl, pl = _light(np.random.default_rng(5))
    kw = dict(cam_radius=2.0, train_res=(48, 48), display_res=(48, 48))
    jren, pren = JTR(ref_mesh=jm, envlight=jl, **kw), TargetRenderer(ref_mesh=pm, envlight=pl, **kw)
    jfit, pfit = JFitter(grid=jtg, scale=1.0), DMTetFitter(grid=tg, scale=1.0)
    jst = jfit.init_state(jax.random.key(0))
    sdf = 0.28 - np.linalg.norm(jtg.verts, axis=1) + 0.02 * np.random.default_rng(1).normal(
        size=len(jtg.verts))
    jst = jst.replace(sdf=jnp.asarray(sdf, jnp.float32))
    # JAX's validate with its renders jitted (one compile a mesh, where op
    # by op each of ~700 ops compiles on its own)
    import meshdiffusion_tpu.fitting.validate as JV
    orig, jitted = JV.render_mesh, {}

    def render(mesh, mvp, campos, lgt, res, **kw):
        if id(mesh) not in jitted:
            jitted[id(mesh)] = jax.jit(lambda a, b: orig(mesh, a, b, lgt, res, **kw))
        return jitted[id(mesh)](mvp, campos)
    monkeypatch.setattr(JV, 'render_mesh', render)
    want = jvalidate(jfit, jst, jren, str(tmp_path / 'j'), num_views=3, raster_K=1024)
    got = validate(pfit, fit_state_from_jax(jst), pren, str(tmp_path / 'p'), num_views=3,
                   raster_K=1024)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    rows = [open(tmp_path / d / 'metrics.txt').read().splitlines() for d in ('p', 'j')]
    assert len(rows[0]) == len(rows[1]) == 5 and rows[0][0] == rows[1][0]
    for a, b in zip(rows[0][1:4], rows[1][1:4]):
        np.testing.assert_allclose([float(x) for x in a.split(',')],
                                   [float(x) for x in b.split(',')], rtol=RTOL)
    assert rows[0][4].startswith('AVERAGES')
    for i in range(3):
        for kind in ('opt', 'ref'):
            a, b = (U.load_image(str(tmp_path / d / f'val_{i:06d}_{kind}.png')) for d in 'pj')
            assert np.abs(a - b).max() <= 1 / 255 + 1e-6
