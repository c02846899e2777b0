from .dataset import GridLoader, ShapeNetDMTetDataset  # noqa: F401
