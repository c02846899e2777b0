"""Rendering math utilities: vectors, colour transforms, cameras, cubemaps,
image scaling and image files.

Counterpart of ``meshdiffusion_tpu/render/utils.py`` (reference
``nvdiffrec/lib/render/util.py``: vector ops:20-38, sRGB:44-63,
PSNR:72-78, cubemap helpers:99-136, image scaling:142-161, cameras:193-266,
random poses:268-298). Camera-matrix constructors, the PSNR conversions
and the image files are host-side numpy, copied as they are, so that a
numpy ``Generator`` gives the same poses bit for bit and an image the same
bytes; everything touching pixels or vertices is torch.

Images are read without imageio or PIL: :func:`load_image` decodes PNG
itself (:func:`decode_png`: 8-bit, non-interlaced, grey, grey + alpha, RGB
or RGBA, every row filter) and Radiance ``.hdr`` (flat and RLE scanlines).
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np
import torch

# ---------------------------------------------------------------- vector ops


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * y, -1, keepdim=True)


def reflect(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return 2 * dot(x, n) * n - x


def length(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dot(x, x), min=eps))


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return x / length(x, eps)


def to_hvec(x: torch.Tensor, w: float) -> torch.Tensor:
    """Append a last component ``w``."""
    return torch.nn.functional.pad(x, (0, 1), value=w)


# --------------------------------------------------------------- sRGB / tone

def _rgb_to_srgb(f: torch.Tensor) -> torch.Tensor:
    return torch.where(f <= 0.0031308, f * 12.92,
                       torch.pow(torch.clamp(f, min=0.0031308), 1.0 / 2.4) * 1.055 - 0.055)


def rgb_to_srgb(f: torch.Tensor) -> torch.Tensor:
    """Linear RGB(A) -> sRGB, alpha kept (reference util.py:44-53)."""
    assert f.shape[-1] in (3, 4)
    if f.shape[-1] == 4:
        return torch.cat([_rgb_to_srgb(f[..., 0:3]), f[..., 3:4]], dim=-1)
    return _rgb_to_srgb(f)


def _srgb_to_rgb(f: torch.Tensor) -> torch.Tensor:
    return torch.where(f <= 0.04045, f / 12.92,
                       torch.pow((torch.clamp(f, min=0.04045) + 0.055) / 1.055, 2.4))


def srgb_to_rgb(f: torch.Tensor) -> torch.Tensor:
    """sRGB -> linear RGB(A), alpha kept (reference util.py:55-63)."""
    assert f.shape[-1] in (3, 4)
    if f.shape[-1] == 4:
        return torch.cat([_srgb_to_rgb(f[..., 0:3]), f[..., 3:4]], dim=-1)
    return _srgb_to_rgb(f)


def reinhard(f: torch.Tensor) -> torch.Tensor:
    return f / (1 + f)


def mse_to_psnr(mse):
    return -10.0 / np.log(10.0) * np.log(mse)


def psnr_to_mse(psnr):
    return np.exp(-0.1 * np.log(10.0) * psnr)


# ----------------------------------------------------------------- cameras

def perspective(fovy: float = 0.7854, aspect: float = 1.0,
                n: float = 0.1, f: float = 1000.0) -> np.ndarray:
    """gluPerspective-compatible (reference util.py:193-198; note flipped y)."""
    y = np.tan(fovy / 2)
    return np.array([[1 / (y * aspect), 0, 0, 0],
                     [0, 1 / -y, 0, 0],
                     [0, 0, -(f + n) / (f - n), -(2 * f * n) / (f - n)],
                     [0, 0, -1, 0]], dtype=np.float32)


def translate(x, y, z) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = [x, y, z]
    return m


def rotate_x(a) -> np.ndarray:
    s, c = np.sin(a), np.cos(a)
    return np.array([[1, 0, 0, 0], [0, c, s, 0], [0, -s, c, 0], [0, 0, 0, 1]],
                    dtype=np.float32)


def rotate_y(a) -> np.ndarray:
    s, c = np.sin(a), np.cos(a)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
                    dtype=np.float32)


def scale(s) -> np.ndarray:
    return np.diag([s, s, s, 1.0]).astype(np.float32)


def lookAt(eye: np.ndarray, at: np.ndarray, up: np.ndarray) -> np.ndarray:
    a = eye - at
    w = a / np.linalg.norm(a)
    u = np.cross(up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    tr = np.eye(4, dtype=np.float32)
    tr[:3, 3] = -eye
    rot = np.eye(4, dtype=np.float32)
    rot[0, :3], rot[1, :3], rot[2, :3] = u, v, w
    return rot @ tr


def random_rotation_translation(t: float, rng: np.random.Generator) -> np.ndarray:
    """Random rigid pose (reference util.py:268-276)."""
    m = rng.normal(size=(3, 3))
    m[1] = np.cross(m[0], m[2])
    m[2] = np.cross(m[0], m[1])
    m = m / np.linalg.norm(m, axis=1, keepdims=True)
    out = np.zeros((4, 4), np.float32)
    out[:3, :3] = m
    out[3, 3] = 1.0
    out[:3, 3] = rng.uniform(-t, t, size=3)
    return out


# ----------------------------------------------------------------- cubemaps

def cube_to_dir(s: int, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Face-local (x, y) in [-1, 1] -> direction (reference util.py:99-106)."""
    one = torch.ones_like(x)
    table = [
        (one, -y, -x), (-one, -y, x),
        (x, one, y), (x, -one, -y),
        (x, -y, one), (-x, -y, -one),
    ]
    rx, ry, rz = table[s]
    return torch.stack((rx, ry, rz), dim=-1)


def _face_grid(res: Tuple[int, int], device=None):
    gy, gx = torch.meshgrid(
        torch.linspace(-1.0 + 1.0 / res[0], 1.0 - 1.0 / res[0], res[0], device=device),
        torch.linspace(-1.0 + 1.0 / res[1], 1.0 - 1.0 / res[1], res[1], device=device),
        indexing='ij')
    return gx, gy


def _bilinear_sample_2d(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                        wrap_u: bool = True) -> torch.Tensor:
    """Bilinear texel fetch of (H, W, C) at uv in [0, 1], texel centres as
    in GL; u wraps (floor-mod) or clamps, v clamps."""
    H, W = img.shape[0], img.shape[1]
    x = u * W - 0.5
    y = v * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.long()
    y0 = y0.long()
    x1 = x0 + 1
    y1 = y0 + 1
    if wrap_u:
        x0, x1 = torch.remainder(x0, W), torch.remainder(x1, W)
    else:
        x0, x1 = x0.clamp(0, W - 1), x1.clamp(0, W - 1)
    y0, y1 = y0.clamp(0, H - 1), y1.clamp(0, H - 1)
    a = img[y0, x0]
    b = img[y0, x1]
    c = img[y1, x0]
    d = img[y1, x1]
    return (a * (1 - fx) * (1 - fy) + b * fx * (1 - fy)
            + c * (1 - fx) * fy + d * fx * fy)


def latlong_to_cubemap(latlong_map: torch.Tensor, res: Tuple[int, int]) -> torch.Tensor:
    """HDR latlong panorama (H, W, C) -> (6, res, C) cubemap
    (reference util.py:108-121)."""
    gx, gy = _face_grid(res, latlong_map.device)
    faces = []
    for s in range(6):
        v = safe_normalize(cube_to_dir(s, gx, gy))
        tu = torch.atan2(v[..., 0], -v[..., 2]) / (2 * np.pi) + 0.5
        tv = torch.acos(torch.clamp(v[..., 1], -1, 1)) / np.pi
        faces.append(_bilinear_sample_2d(latlong_map, tu, tv, wrap_u=True))
    return torch.stack(faces)


def sample_cubemap(cubemap: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear cubemap fetch for unit directions (nvdiffrast
    texture(boundary='cube') without seam filtering).

    cubemap: (6, H, W, C); dirs: (..., 3). Face layout per cube_to_dir.
    """
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()

    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    face = torch.where(is_x, torch.where(x > 0, 0, 1),
                       torch.where(is_y, torch.where(y > 0, 2, 3),
                                   torch.where(z > 0, 4, 5)))
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    ma = torch.clamp(ma, min=1e-20)

    # face-local coords inverting cube_to_dir (see the JAX package)
    u = torch.where(is_x, torch.where(x > 0, -z, z),
                    torch.where(is_y, x, torch.where(z > 0, x, -x))) / ma
    v = torch.where(is_x, -y, torch.where(is_y, torch.where(y > 0, z, -z), -y)) / ma

    H, W = cubemap.shape[1], cubemap.shape[2]
    uu = u * 0.5 + 0.5
    vv = v * 0.5 + 0.5
    xx = torch.clamp(uu * W - 0.5, 0, W - 1)
    yy = torch.clamp(vv * H - 0.5, 0, H - 1)
    x0 = torch.floor(xx).long()
    y0 = torch.floor(yy).long()
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    fx = (xx - x0)[..., None]
    fy = (yy - y0)[..., None]
    a = cubemap[face, y0, x0]
    b = cubemap[face, y0, x1]
    c = cubemap[face, y1, x0]
    d = cubemap[face, y1, x1]
    return (a * (1 - fx) * (1 - fy) + b * fx * (1 - fy)
            + c * (1 - fx) * fy + d * fx * fy)


def cubemap_to_latlong(cubemap: torch.Tensor, res: Tuple[int, int]) -> torch.Tensor:
    """(6, H, W, C) cubemap -> (res, C) latlong panorama."""
    dev = cubemap.device
    gy, gx = torch.meshgrid(
        torch.linspace(0.0 + 1.0 / res[0], 1.0 - 1.0 / res[0], res[0], device=dev),
        torch.linspace(-1.0 + 1.0 / res[1], 1.0 - 1.0 / res[1], res[1], device=dev),
        indexing='ij')
    sintheta, costheta = torch.sin(gy * np.pi), torch.cos(gy * np.pi)
    sinphi, cosphi = torch.sin(gx * np.pi), torch.cos(gx * np.pi)
    reflvec = torch.stack((sintheta * sinphi, costheta, -sintheta * cosphi), dim=-1)
    return sample_cubemap(cubemap, reflvec)


# ------------------------------------------------------------ image scaling

def avg_pool_nhwc(x: torch.Tensor, size: int) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.reshape(B, H // size, size, W // size, size, C).mean(dim=(2, 4))


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) fp32 weights of ``jax.image.resize(method='linear')``
    along one axis: the triangle kernel, widened by n_in / n_out when
    shrinking (antialiasing), weights normalized over the input, zero where
    the sample lies outside it."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]
         ).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _resize_nhwc(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (B, size, C), 'linear')`` of an NHWC tensor."""
    H, W = x.shape[1], x.shape[2]
    x = x.float()
    if size[0] != H:
        x = torch.einsum('bhwc,hy->bywc', x, _resize_weights(H, size[0], x.device))
    if size[1] != W:
        x = torch.einsum('bhwc,wx->bhxc', x, _resize_weights(W, size[1], x.device))
    return x


def scale_img_nhwc(x: torch.Tensor, size: Tuple[int, int], mag: str = 'bilinear',
                   min: str = 'area') -> torch.Tensor:
    """Resize an NHWC image: a whole-factor shrink by the same factor on
    both axes with ``min='area'`` is average pooling, anything else
    ``jax.image.resize``'s 'linear' (``mag`` 'bilinear', the only one any
    caller uses)."""
    H, W = x.shape[1], x.shape[2]
    if H > size[0] and W > size[1] and min == 'area' \
            and H % size[0] == 0 and W % size[1] == 0 and H // size[0] == W // size[1]:
        return avg_pool_nhwc(x, H // size[0])
    if mag not in ('bilinear', 'linear'):
        raise ValueError(f'resize {mag!r}: only bilinear is ported')
    return _resize_nhwc(x, tuple(size))


def scale_img_hwc(x: torch.Tensor, size, mag='bilinear', min='area') -> torch.Tensor:
    return scale_img_nhwc(x[None], size, mag, min)[0]


# ------------------------------------------------------------------- images

def checkerboard(res: Tuple[int, int], checker_size: int = 8) -> np.ndarray:
    tiles_y = (res[0] + (checker_size * 2) - 1) // (checker_size * 2)
    tiles_x = (res[1] + (checker_size * 2) - 1) // (checker_size * 2)
    check = np.kron([[1, 0] * tiles_x, [0, 1] * tiles_x] * tiles_y,
                    np.ones((checker_size, checker_size))) * 0.33 + 0.33
    check = check[:res[0], :res[1]]
    return np.stack([check] * 3, axis=-1).astype(np.float32)


def save_image(path: str, img: np.ndarray) -> None:
    """A minimal PNG writer (8-bit RGB or RGBA, no imageio): float images
    are clipped to [0, 1] and rounded to uint8."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, -1)
    h, w, c = arr.shape
    if c == 1:
        arr = arr.repeat(3, -1)
        c = 3
    color_type = 6 if c == 4 else 2
    raw = b''.join(b'\x00' + arr[i].tobytes() for i in range(h))

    def chunk(tag, data):
        out = struct.pack('>I', len(data)) + tag + data
        return out + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff)

    png = (b'\x89PNG\r\n\x1a\n'
           + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, color_type, 0, 0, 0))
           + chunk(b'IDAT', zlib.compress(raw, 6))
           + chunk(b'IEND', b''))
    with open(path, 'wb') as f:
        f.write(png)


_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # colour type -> channels


def _unfilter_row(ftype: int, row: bytearray, prior: bytes, bpp: int) -> None:
    """Undo one scanline's filter in place (PNG spec, section 9)."""
    n = len(row)
    if ftype == 0:
        return
    if ftype == 1:                                   # Sub
        for i in range(bpp, n):
            row[i] = (row[i] + row[i - bpp]) & 0xFF
    elif ftype == 2:                                 # Up
        for i in range(n):
            row[i] = (row[i] + prior[i]) & 0xFF
    elif ftype == 3:                                 # Average
        for i in range(n):
            left = row[i - bpp] if i >= bpp else 0
            row[i] = (row[i] + ((left + prior[i]) >> 1)) & 0xFF
    elif ftype == 4:                                 # Paeth
        for i in range(n):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            row[i] = (row[i] + pred) & 0xFF
    else:
        raise ValueError(f'bad PNG row filter {ftype}')


def decode_png(data: bytes) -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG of colour type 0, 2, 4 or 6 into
    uint8 (H, W) for grey, else (H, W, C), as PIL and imageio return it.
    Raises ValueError on any other PNG (palette, 16-bit, interlaced)."""
    if data[:8] != b'\x89PNG\r\n\x1a\n':
        raise ValueError('not a PNG file')
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(data):
        n, tag = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b'IHDR':
            ihdr = struct.unpack('>IIBBBBB', body)
        elif tag == b'IDAT':
            idat.append(body)
        elif tag == b'IEND':
            break
    if ihdr is None:
        raise ValueError('PNG without IHDR')
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if depth != 8 or ctype not in _PNG_CHANNELS or comp or filt or interlace:
        raise ValueError(f'unsupported PNG: bit depth {depth}, colour type {ctype}, '
                         f'interlace {interlace}')
    c = _PNG_CHANNELS[ctype]
    raw = zlib.decompress(b''.join(idat))
    stride = w * c
    if len(raw) < h * (stride + 1):
        raise ValueError('truncated PNG data')
    out = bytearray(h * stride)
    prior = bytes(stride)
    for y in range(h):
        start = y * (stride + 1)
        row = bytearray(raw[start + 1:start + 1 + stride])
        _unfilter_row(raw[start], row, prior, c)
        out[y * stride:(y + 1) * stride] = row
        prior = bytes(row)
    img = np.frombuffer(bytes(out), np.uint8).reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def load_image(path: str) -> np.ndarray:
    """Load a PNG (float32 in [0, 1]) or a Radiance .hdr (float32 radiance)
    as HWC (HW for a grey PNG)."""
    if path.lower().endswith('.hdr'):
        return _load_hdr(path)
    with open(path, 'rb') as f:
        img = decode_png(f.read())
    return img.astype(np.float32) / 255.0


def _load_hdr(path: str) -> np.ndarray:
    """Minimal Radiance .hdr (RGBE) reader: -Y H +X W scanlines, flat or
    new-style RLE."""
    with open(path, 'rb') as f:
        data = f.read()
    pos = data.find(b'\n\n')
    if pos < 0:
        raise ValueError('bad hdr header')
    rest = data[pos + 2:]
    nl = rest.find(b'\n')
    dims = rest[:nl].decode('latin1').split()
    rest = rest[nl + 1:]
    if dims[0] != '-Y' or dims[2] != '+X':
        raise ValueError(f'unsupported hdr orientation {dims}')
    h, w = int(dims[1]), int(dims[3])
    img = np.zeros((h, w, 4), np.uint8)
    ptr = 0
    for y in range(h):
        if rest[ptr] == 2 and rest[ptr + 1] == 2:  # new RLE
            ptr += 4
            row = np.zeros((4, w), np.uint8)
            for ch in range(4):
                x = 0
                while x < w:
                    n = rest[ptr]
                    ptr += 1
                    if n > 128:
                        row[ch, x:x + n - 128] = rest[ptr]
                        ptr += 1
                        x += n - 128
                    else:
                        row[ch, x:x + n] = np.frombuffer(rest[ptr:ptr + n], np.uint8)
                        ptr += n
                        x += n
            img[y] = row.T
        else:  # flat
            img[y] = np.frombuffer(rest[ptr:ptr + 4 * w], np.uint8).reshape(w, 4)
            ptr += 4 * w
    rgbe = img.astype(np.float32)
    e = rgbe[..., 3]
    s = np.where(e > 0, np.ldexp(1.0, e.astype(np.int32) - 136), 0.0)
    return rgbe[..., :3] * s[..., None]
