"""The ('data', 'spatial') rank mesh and the batch layout on it.

Counterpart of ``meshdiffusion_tpu/parallel/mesh.py``: batches split over
``data``, the grid's depth axis D (the first spatial axis of a channels-last
(B, D, H, W, C) grid) split over ``spatial``, parameters and the grid mask
replicated. Where JAX places one array on a mesh of devices, here every
rank is a process that holds its own slice, and the collectives that XLA's
partitioner would insert are written out (``parallel/spatial.py`` for the
model, ``diffusion/losses.py`` for the gradients).

The layout is JAX's: rank = data_index * spatial + spatial_index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch.distributed as dist

from .distributed import world


@dataclass(frozen=True)
class Mesh:
    data: int                       # ranks along the batch
    spatial: int                    # ranks along the grid's depth
    rank: int
    data_index: int
    spatial_index: int
    spatial_group: Any = None       # the ranks of this data row (None in one process)
    data_group: Any = None          # the ranks of this spatial column
    group: Any = None               # every rank of the mesh

    @property
    def size(self) -> int:
        return self.data * self.spatial

    def depth_range(self, D: int) -> Tuple[int, int]:
        """The planes [start, stop) of a depth-D grid this rank holds."""
        if D % self.spatial:
            raise ValueError(f'depth {D} is not divisible by the spatial axis {self.spatial}')
        n = D // self.spatial
        return self.spatial_index * n, (self.spatial_index + 1) * n


def make_mesh(data: int = -1, spatial: int = 1, world_size: Optional[int] = None,
              rank: Optional[int] = None) -> Optional[Mesh]:
    """A (data, spatial) mesh over the first ``world_size`` ranks (default:
    the process group's, or 1 without one); ``data=-1`` takes every rank
    left. In a process group every process must call it, with the same
    arguments and in the same order, since it creates the mesh's process
    groups; a rank outside the mesh gets None."""
    if world_size is None:
        world_size, rank = world()
    rank = 0 if rank is None else rank
    n = world_size
    if data == -1:
        if n % spatial != 0:
            raise AssertionError((n, spatial))
        data = n // spatial
    if data * spatial != n:
        raise AssertionError(f'mesh {data}x{spatial} != {n} ranks')
    groups = {}
    if dist.is_initialized() and dist.get_world_size() > 1:
        # every process creates every group, members or not, in one order
        for d in range(data):
            groups['s', d] = dist.new_group([d * spatial + s for s in range(spatial)])
        for s in range(spatial):
            groups['d', s] = dist.new_group([d * spatial + s for d in range(data)])
        groups['all'] = dist.new_group(list(range(n)))
    if rank >= n:
        return None
    di, si = divmod(rank, spatial)
    return Mesh(data, spatial, rank, di, si, groups.get(('s', di)), groups.get(('d', si)),
                groups.get('all'))


def shard_batch(batch, mesh: Mesh, spatial: bool = False, batch_dim: int = 0):
    """This rank's slice of a host (…, B, D, H, W, C) batch whose B is at
    ``batch_dim``: B over ``data`` and, with ``spatial``, D over
    ``spatial``, as JAX's ``data_spec`` lays the global array out. Works on
    numpy arrays and tensors (a view)."""
    B = batch.shape[batch_dim]
    if B % mesh.data:
        raise ValueError(f'batch {B} is not divisible by the data axis {mesh.data}')
    nb = B // mesh.data
    idx = [slice(None)] * batch.ndim
    idx[batch_dim] = slice(mesh.data_index * nb, (mesh.data_index + 1) * nb)
    if spatial:
        idx[batch_dim + 1] = slice(*mesh.depth_range(batch.shape[batch_dim + 1]))
    return batch[tuple(idx)]
