"""Model registry (reference models/utils.py:24-96)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..utils.device import resolve_device

_MODELS: Dict[str, Callable] = {}


def register_model(cls=None, *, name: str = None):
    def _register(cls):
        local_name = cls.__name__ if name is None else name
        if local_name in _MODELS:
            raise ValueError(f'Already registered model with name: {local_name}')
        _MODELS[local_name] = cls
        return cls

    return _register if cls is None else _register(cls)


def register_alias(name: str, target: str) -> None:
    """Register an extra name for an existing model."""
    _MODELS[name] = _MODELS[target]


def get_model(name: str):
    try:
        return _MODELS[name]
    except KeyError as e:
        raise KeyError(f"unknown model {name!r}; registered: {sorted(_MODELS)}") from e


def create_model(config, device='cuda', generator: Optional[torch.Generator] = None):
    """The U-Net for ``config.model.name`` on ``device`` (the card unless the
    caller names another; raises where CUDA is missing), with the DDPM
    initialisation drawn from ``generator`` (a generator on ``device``)."""
    with torch.device(resolve_device(device)):
        model = get_model(config.model.name).from_config(config)
    model.reset_parameters_ddpm(generator)
    return model
