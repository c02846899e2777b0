"""Minimal Wavefront OBJ I/O (replaces pytorch3d.io.save_obj, reference
nvdiffrec/eval.py:443-447)."""

from __future__ import annotations

import numpy as np


# rows formatted by one ``%`` at a time: a res128 noise-soup mesh of ~10M
# faces then takes seconds, not minutes
_CHUNK = 1 << 16


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Write a triangle mesh. faces are 0-based and written 1-based."""
    verts = np.asarray(verts, np.float32).astype(np.float64)
    faces = np.asarray(faces, np.int64) + 1
    with open(path, 'w') as fh:
        if not len(verts) and not len(faces):
            fh.write("\n")
        for arr, fmt in ((verts, "v %.6f %.6f %.6f\n"), (faces, "f %d %d %d\n")):
            for s in range(0, len(arr), _CHUNK):
                block = arr[s:s + _CHUNK]
                fh.write((fmt * len(block)) % tuple(block.ravel().tolist()))


def read_obj(path: str):
    """Read vertex positions and triangle faces (positions only)."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == 'v':
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == 'f':
                idx = [int(p.split('/')[0]) - 1 for p in parts[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int64)
