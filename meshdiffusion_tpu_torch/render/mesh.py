"""Triangle-mesh container and geometry ops.

Counterpart of ``meshdiffusion_tpu/render/mesh.py`` (reference
``nvdiffrec/lib/render/mesh.py``: the container:20-93, aabb:108-116,
unique edges:121-173, center_by_reference:190-195, auto_normals:200-225,
compute_tangents:231-277). Per-vertex ops are fixed-shape index_add/gather
and take padded meshes through an optional face validity mask, so they
compose with the padded marching-tets output.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..utils.gather import gather
from .utils import dot, safe_normalize


@dataclasses.dataclass
class Mesh:
    """Attribute bundle with base-inheritance (reference mesh.py:20-93)."""
    v_pos: Optional[torch.Tensor] = None          # (V, 3)
    t_pos_idx: Optional[torch.Tensor] = None      # (F, 3) int64
    v_nrm: Optional[torch.Tensor] = None
    t_nrm_idx: Optional[torch.Tensor] = None
    v_tex: Optional[torch.Tensor] = None
    t_tex_idx: Optional[torch.Tensor] = None
    v_tng: Optional[torch.Tensor] = None
    t_tng_idx: Optional[torch.Tensor] = None
    f_nrm: Optional[torch.Tensor] = None
    material: Any = None
    face_mask: Optional[torch.Tensor] = None      # (F,) bool for padded meshes
    valid_vert_idx: Any = None

    @staticmethod
    def combine(base: "Mesh", **updates) -> "Mesh":
        fields = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}
        fields.update({k: v for k, v in updates.items() if v is not None})
        return Mesh(**fields)

    def copy_none(self, other: "Mesh") -> None:
        """Take ``other``'s value for every field that is None here."""
        for f in dataclasses.fields(self):
            if getattr(self, f.name) is None:
                setattr(self, f.name, getattr(other, f.name))


def aabb(v_pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return v_pos.min(dim=0).values, v_pos.max(dim=0).values


def center_by_reference(mesh: Mesh, ref_aabb, scale: float) -> Mesh:
    center = (ref_aabb[0] + ref_aabb[1]) * 0.5
    s = scale / float(torch.max(ref_aabb[1] - ref_aabb[0]))
    return Mesh.combine(mesh, v_pos=(mesh.v_pos - center[None]) * s)


def auto_normals(mesh: Mesh) -> Mesh:
    """Area-weighted smooth vertex normals (reference mesh.py:200-225)."""
    i0, i1, i2 = (mesh.t_pos_idx[:, k] for k in range(3))
    v0, v1, v2 = (gather(mesh.v_pos, i) for i in (i0, i1, i2))
    f_nrm = torch.cross(v1 - v0, v2 - v0, dim=-1)
    fw = f_nrm if mesh.face_mask is None else f_nrm * mesh.face_mask.to(f_nrm.dtype)[:, None]
    v_nrm = torch.zeros_like(mesh.v_pos).index_add(0, i0, fw).index_add(0, i1, fw) \
        .index_add(0, i2, fw)
    v_nrm = torch.where(dot(v_nrm, v_nrm) > 1e-20, v_nrm,
                        torch.tensor([0.0, 0.0, 1.0], dtype=v_nrm.dtype, device=v_nrm.device))
    v_nrm = safe_normalize(v_nrm)
    return Mesh.combine(mesh, v_nrm=v_nrm, t_nrm_idx=mesh.t_pos_idx, f_nrm=f_nrm)


def _face_weights(mesh: Mesh, like: torch.Tensor) -> torch.Tensor:
    if mesh.face_mask is None:
        return torch.ones_like(like[:, :1])
    return mesh.face_mask.to(like.dtype)[:, None]


def compute_tangents(mesh: Mesh) -> Mesh:
    """Per-vertex tangents from the UVs, mikktspace conventions
    (reference mesh.py:231-277), on the normal index."""
    pos = [gather(mesh.v_pos, mesh.t_pos_idx[:, i]) for i in range(3)]
    tex = [gather(mesh.v_tex, mesh.t_tex_idx[:, i]) for i in range(3)]
    vn_idx = [mesh.t_nrm_idx[:, i] for i in range(3)]

    uve1 = tex[1] - tex[0]
    uve2 = tex[2] - tex[0]
    pe1 = pos[1] - pos[0]
    pe2 = pos[2] - pos[0]

    nom = pe1 * uve2[..., 1:2] - pe2 * uve1[..., 1:2]
    denom = uve1[..., 0:1] * uve2[..., 1:2] - uve1[..., 1:2] * uve2[..., 0:1]
    denom_safe = torch.where(denom > 0.0, torch.clamp(denom, min=1e-6),
                             torch.clamp(denom, max=-1e-6))
    tang = nom / denom_safe

    w = _face_weights(mesh, tang)
    tangents = torch.zeros_like(mesh.v_nrm)
    tansum = torch.zeros_like(mesh.v_nrm)
    for i in range(3):
        tangents = tangents.index_add(0, vn_idx[i], tang * w)
        tansum = tansum.index_add(0, vn_idx[i], torch.ones_like(tang) * w)
    tangents = tangents / torch.clamp(tansum, min=1e-20)
    tangents = safe_normalize(tangents)
    tangents = safe_normalize(tangents - dot(tangents, mesh.v_nrm) * mesh.v_nrm)
    return Mesh.combine(mesh, v_tng=tangents, t_tng_idx=mesh.t_nrm_idx)


def unique_edges(t_pos_idx: np.ndarray) -> np.ndarray:
    """Sorted unique mesh edges (host-side; reference mesh.py:121-141)."""
    t = np.asarray(t_pos_idx)
    e = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]], axis=0)
    return np.unique(np.sort(e, axis=1), axis=0)
