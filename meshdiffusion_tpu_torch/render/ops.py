"""Shading math, BSDFs, image loss and transforms (renderutils equivalents).

Counterpart of ``meshdiffusion_tpu/render/ops.py`` (reference
``nvdiffrec/lib/render/renderutils/{bsdf,loss,ops}.py``): shading-normal
preparation, the Lambert, Frostbite and GGX BSDFs, the fused tonemap +
image loss, and homogeneous transforms. Autograd supplies every backward.

The shading-normal, BSDF and loss math is derived from the reference
Python oracle (nvdiffrec's ``renderutils/bsdf.py`` and ``loss.py``, by
NVIDIA CORPORATION, under the NVIDIA Source Code License), as the JAX
package's is.
"""

from __future__ import annotations

import math

import torch

from .utils import dot, safe_normalize

NORMAL_THRESHOLD = 0.1
SPECULAR_EPSILON = 1e-4


# --------------------------------------------------------- shading normals

def _bend_normal(view_vec, smooth_nrm, geom_nrm, two_sided_shading):
    """Backface flip + clamped blend (reference bsdf.py:28-35)."""
    if two_sided_shading:
        front = dot(geom_nrm, view_vec) > 0
        smooth_nrm = torch.where(front, smooth_nrm, -smooth_nrm)
        geom_nrm = torch.where(front, geom_nrm, -geom_nrm)
    t = torch.clamp(dot(view_vec, smooth_nrm) / NORMAL_THRESHOLD, 0.0, 1.0)
    return geom_nrm + t * (smooth_nrm - geom_nrm)


def _perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng, opengl):
    smooth_bitang = safe_normalize(torch.cross(smooth_tng, smooth_nrm, dim=-1))
    sign = -1.0 if opengl else 1.0
    shading_nrm = (smooth_tng * perturbed_nrm[..., 0:1]
                   + sign * smooth_bitang * perturbed_nrm[..., 1:2]
                   + smooth_nrm * torch.clamp(perturbed_nrm[..., 2:3], min=0.0))
    return safe_normalize(shading_nrm)


def prepare_shading_normal(pos, view_pos, perturbed_nrm, smooth_nrm,
                           smooth_tng, geom_nrm, two_sided_shading=True,
                           opengl=True):
    """Tangent-frame normal perturbation + two-sided bend
    (reference bsdf.py:46-54)."""
    smooth_nrm = safe_normalize(smooth_nrm)
    view_vec = safe_normalize(view_pos - pos)
    if smooth_tng is None or perturbed_nrm is None:
        shading_nrm = smooth_nrm
    else:
        smooth_tng = safe_normalize(smooth_tng)
        shading_nrm = _perturb_normal(perturbed_nrm, smooth_nrm, smooth_tng, opengl)
    return _bend_normal(view_vec, shading_nrm, geom_nrm, two_sided_shading)


# ------------------------------------------------------------------- BSDFs

def lambert(nrm, wi):
    return torch.clamp(dot(nrm, wi), min=0.0) / math.pi


def fresnel_shlick(f0, f90, cos_theta):
    c = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    return f0 + (f90 - f0) * (1.0 - c) ** 5.0


def frostbite_diffuse(nrm, wi, wo, linear_roughness):
    wiDotN = dot(wi, nrm)
    woDotN = dot(wo, nrm)
    h = safe_normalize(wo + wi)
    wiDotH = dot(wi, h)
    energy_bias = 0.5 * linear_roughness
    energy_factor = 1.0 - (0.51 / 1.51) * linear_roughness
    f90 = energy_bias + 2.0 * wiDotH * wiDotH * linear_roughness
    wi_scatter = fresnel_shlick(1.0, f90, wiDotN)
    wo_scatter = fresnel_shlick(1.0, f90, woDotN)
    res = wi_scatter * wo_scatter * energy_factor
    return torch.where((wiDotN > 0.0) & (woDotN > 0.0), res, torch.zeros_like(res))


def ndf_ggx(alpha_sqr, cos_theta):
    c = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    d = (c * alpha_sqr - c) * c + 1
    return alpha_sqr / (d * d * math.pi)


def lambda_ggx(alpha_sqr, cos_theta):
    c = torch.clamp(cos_theta, SPECULAR_EPSILON, 1.0 - SPECULAR_EPSILON)
    c2 = c * c
    tan2 = (1.0 - c2) / c2
    return 0.5 * (torch.sqrt(1 + alpha_sqr * tan2) - 1.0)


def masking_smith(alpha_sqr, cos_theta_i, cos_theta_o):
    return 1 / (1 + lambda_ggx(alpha_sqr, cos_theta_i) + lambda_ggx(alpha_sqr, cos_theta_o))


def pbr_specular(col, nrm, wo, wi, alpha, min_roughness=0.08):
    _alpha = torch.clamp(alpha, min_roughness * min_roughness, 1.0)
    alpha_sqr = _alpha * _alpha
    h = safe_normalize(wo + wi)
    woDotN = dot(wo, nrm)
    wiDotN = dot(wi, nrm)
    woDotH = dot(wo, h)
    nDotH = dot(nrm, h)
    D = ndf_ggx(alpha_sqr, nDotH)
    G = masking_smith(alpha_sqr, woDotN, wiDotN)
    F = fresnel_shlick(col, 1, woDotH)
    w = F * D * G * 0.25 / torch.clamp(woDotN, min=SPECULAR_EPSILON)
    frontfacing = (woDotN > SPECULAR_EPSILON) & (wiDotN > SPECULAR_EPSILON)
    return torch.where(frontfacing, w, torch.zeros_like(w))


def pbr_bsdf(kd, arm, pos, nrm, view_pos, light_pos, min_roughness=0.08, bsdf='lambert'):
    """Punctual-light PBR BSDF (reference bsdf.py:139-154): arm is
    (specular strength, roughness, metallic)."""
    wo = safe_normalize(view_pos - pos)
    wi = safe_normalize(light_pos - pos)
    spec_str = arm[..., 0:1]
    roughness = arm[..., 1:2]
    metallic = arm[..., 2:3]
    ks = (0.04 * (1.0 - metallic) + kd * metallic) * (1 - spec_str)
    kd = kd * (1.0 - metallic)
    if bsdf == 'lambert':
        diffuse = kd * lambert(nrm, wi)
    else:
        diffuse = kd * frostbite_diffuse(nrm, wi, wo, roughness)
    specular = pbr_specular(ks, nrm, wo, wi, roughness * roughness, min_roughness=min_roughness)
    return diffuse + specular


# -------------------------------------------------------------- image loss

def _tonemap_srgb(f):
    return torch.where(f > 0.0031308,
                       torch.pow(torch.clamp(f, min=0.0031308), 1.0 / 2.4) * 1.055 - 0.055,
                       12.92 * f)


def image_loss(img, target, loss='l1', tonemapper='none'):
    """Fused tonemap + loss (reference renderutils/loss.py:29-41)."""
    if tonemapper == 'log_srgb':
        img = _tonemap_srgb(torch.log(torch.clamp(img, 0, 65535) + 1))
        target = _tonemap_srgb(torch.log(torch.clamp(target, 0, 65535) + 1))
    if loss == 'mse':
        return torch.mean((img - target) ** 2)
    if loss == 'smape':
        nom = (img - target).abs()
        denom = img.abs() + target.abs() + 0.01
        return torch.mean(nom / denom)
    if loss == 'relmse':
        nom = (img - target) ** 2
        denom = img * img + target * target + 0.1
        return torch.mean(nom / denom)
    return torch.mean((img - target).abs())


# --------------------------------------------------------------- transforms

def xfm_points(points: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Batched homogeneous point transform: points (B, N, 3), matrix
    (B, 4, 4) -> (B, N, 4)."""
    p = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    return torch.matmul(p, matrix.transpose(-1, -2))


def xfm_vectors(vectors: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """Direction transform (w=0): vectors (B, N, 3), matrix (B, 4, 4) -> (B, N, 3)."""
    return torch.matmul(vectors, matrix[..., :3, :3].transpose(-1, -2))
