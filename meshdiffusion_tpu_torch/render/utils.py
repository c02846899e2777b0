"""Rendering math utilities: vectors, cameras, cubemaps, pooling.

Counterpart of ``meshdiffusion_tpu/render/utils.py`` (reference
``nvdiffrec/lib/render/util.py``), limited to what the fitting path calls.
Camera-matrix constructors and the PNG writer are host-side numpy,
copied as they are, so that a numpy ``Generator`` gives the same poses bit
for bit and an image the same bytes; everything touching pixels or
vertices is torch.
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


def length(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return torch.sqrt(torch.clamp(dot(x, x), min=eps))


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return x / length(x, eps)


# --------------------------------------------------------------- sRGB

def _rgb_to_srgb(f: torch.Tensor) -> torch.Tensor:
    return torch.where(f <= 0.0031308, f * 12.92,
                       torch.pow(torch.clamp(f, min=0.0031308), 1.0 / 2.4) * 1.055 - 0.055)


def rgb_to_srgb(f: torch.Tensor) -> torch.Tensor:
    """Linear RGB(A) -> sRGB, alpha kept (reference util.py:44-53)."""
    assert f.shape[-1] in (3, 4)
    if f.shape[-1] == 4:
        return torch.cat([_rgb_to_srgb(f[..., 0:3]), f[..., 3:4]], dim=-1)
    return _rgb_to_srgb(f)


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


# ------------------------------------------------------------ image scaling

def avg_pool_nhwc(x: torch.Tensor, size: int) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.reshape(B, H // size, size, W // size, size, C).mean(dim=(2, 4))


# ------------------------------------------------------------------- images

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
