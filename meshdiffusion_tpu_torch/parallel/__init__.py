"""Data- and spatial-parallel training over a ('data', 'spatial') rank mesh."""

from .mesh import Mesh, make_mesh, shard_batch  # noqa: F401
