"""Checkpoints in the reference's torch format.

Counterpart of ``meshdiffusion_tpu/utils/checkpoint.py`` (save, restore with
a warning on a missing path) and of
``meshdiffusion_tpu/utils/torch_convert.py::load_torch_checkpoint`` (the
released ``.pth`` files), for this package's U-Net, whose state_dict keys
are the reference's. The file is the reference's pickle
(reference ``lib/diffusion/utils.py:6-30``)::

    {'model': state_dict with the DataParallel 'module.' prefix,
     'ema': {'shadow_params': [...], 'num_updates': n, 'decay': d},
     'optimizer': an optimizer state_dict or None, 'step': int}

The EMA shadow list follows the reference model's ``parameters()`` order:
``pos_layer``, ``mask_layer``, then ``all_modules`` by index, each module's
tensors in registration order (reference ``models/ema.py:28-29``;
``torch_convert.py:184-226``). The reference's res128 model holds a
``pos_layer`` its forward never uses; this package's res128 has none, so
loading drops its keys and its two EMA entries, and saving writes them as
zeros of the res128 stem's shape so that the list keeps the reference's
length and order.

A model whose class sets ``own_param_order`` (the 3D DiT, which has no
reference checkpoint) lists its parameters in its own ``parameters()``
order instead: the same pickle, the EMA list in the order of the model's
state_dict.

Files are read with ``torch.load(..., weights_only=True)``: they hold only
tensors, numbers and lists. The JAX package's orbax checkpoint directories
cannot be read here.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import torch

from ..models import get_model
from .convert import _KIND_PARAMS, _nin, module_walk

logger = logging.getLogger(__name__)

_PREFIX = 'module.'
_POS = ('pos_layer.weight', 'pos_layer.bias')


class EMA:
    """Exponential moving average of a model's parameters (reference
    ``models/ema.py``), held by state_dict key."""

    def __init__(self, model: torch.nn.Module, decay: float = 0.9999):
        self.decay = decay
        self.num_updates = 0
        self.shadow = {k: p.detach().clone() for k, p in model.named_parameters()
                       if p.requires_grad}

    @torch.no_grad()
    def update(self, model: torch.nn.Module) -> None:
        """shadow -= (1 - d) * (shadow - param) with the warm-up decay
        d = min(decay, (1 + n) / (10 + n)), n the count after this update
        (reference ``models/ema.py:43-51``; JAX ``losses.ema_update``); in
        place, one fused pass over all tensors."""
        self.num_updates += 1
        n = self.num_updates
        d = min(self.decay, (1.0 + n) / (10.0 + n))
        params = dict(model.named_parameters())
        keys = list(self.shadow)
        torch._foreach_lerp_([self.shadow[k] for k in keys], [params[k].detach() for k in keys],
                             1.0 - d)


def reference_param_order(config, model_keys) -> List[str]:
    """The reference model's parameter keys in its ``parameters()`` order,
    the dormant res128 ``pos_layer`` included; ``model_keys`` (the
    checkpoint's or this package's keys, unprefixed) say which ResnetBlocks
    have a NIN shortcut. For a model of its own order, ``model_keys`` as
    they come."""
    if getattr(get_model(config.model.name), 'own_param_order', False):
        return list(model_keys)
    keys = list(_POS) + ['mask_layer.weight', 'mask_layer.bias']
    for prefix, _, kind in module_walk(config):
        if prefix in ('pos_layer', 'mask_layer'):
            continue
        entries = list(_KIND_PARAMS[kind])
        if kind == 'resblock' and f'{prefix}.NIN_0.W' in model_keys:
            entries += _nin('NIN_0')
        keys += [f'{prefix}.{suffix}' for suffix, _, _ in entries]
    return keys


def _is_res128(config) -> bool:
    return 'res128' in config.model.name


def _dormant_pos_layer(model: torch.nn.Module, config) -> Dict[str, torch.Tensor]:
    """Zeros in the place of the reference res128's unused ``pos_layer``
    (3 -> nf channels, the stem's kernel)."""
    stem = model.all_modules[2 if config.model.conditional else 0]
    w = stem.weight
    return {_POS[0]: torch.zeros((w.shape[0], 3) + tuple(w.shape[2:]), dtype=w.dtype),
            _POS[1]: torch.zeros((w.shape[0],), dtype=w.dtype)}


def save_checkpoint(path: str, state: dict, config) -> str:
    """Write ``state`` = {'model': module, 'ema': EMA or None, 'optimizer':
    optimizer or None, 'step': int} as the reference's pickle."""
    model = state['model']
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    if _is_res128(config):
        sd = {**_dormant_pos_layer(model, config), **sd}
    order = reference_param_order(config, sd)
    ema = state.get('ema')
    if ema is not None:
        shadow = {**sd, **{k: v.detach().cpu() for k, v in ema.shadow.items()}}
        ema_dict = {'decay': ema.decay, 'num_updates': ema.num_updates,
                    'shadow_params': [shadow[k] for k in order]}
    else:
        ema_dict = None
    opt = state.get('optimizer')
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + '.tmp'     # written whole, then renamed: a cut write leaves the old file
    torch.save({'model': {_PREFIX + k: sd[k] for k in order},
                'ema': ema_dict,
                'optimizer': None if opt is None else opt.state_dict(),
                'step': int(state.get('step', 0))}, tmp)
    os.replace(tmp, path)
    return path


def _read(path: str) -> dict:
    if os.path.isdir(path):
        raise ValueError(f'{path} is a directory: the JAX package\'s orbax checkpoints cannot '
                         'be read by this package; give the reference-format .pth file')
    return torch.load(path, map_location='cpu', weights_only=True)


def _unpacked(ckpt: dict, model: torch.nn.Module, config):
    """(model weights, EMA shadow weights or None), keyed as ``model``'s
    parameters: the prefix stripped, the dormant ``pos_layer`` and any
    non-parameter key (the reference's mask buffer) dropped, every
    parameter present, every EMA entry's shape checked against the
    checkpoint's own model tensor and against ``model``."""
    sd = {(k[len(_PREFIX):] if k.startswith(_PREFIX) else k): v
          for k, v in ckpt['model'].items()}
    params = dict(model.named_parameters())
    missing = [k for k in params if k not in sd]
    if missing:
        raise KeyError(f'checkpoint lacks parameters {missing[:5]} ({len(missing)} in all)')
    for k in params:
        if tuple(sd[k].shape) != tuple(params[k].shape):
            raise ValueError(f'{k}: checkpoint {tuple(sd[k].shape)} vs model '
                             f'{tuple(params[k].shape)}')
    weights = {k: sd[k] for k in params}
    ema = ckpt.get('ema')
    if not ema or ema.get('shadow_params') is None:
        return weights, None
    order = reference_param_order(config, sd)
    shadow = ema['shadow_params']
    if len(shadow) != len(order):
        raise ValueError(f'EMA list of {len(shadow)} entries; the reference model of this '
                         f'config has {len(order)} parameters')
    ema_weights = {}
    for k, v in zip(order, shadow):
        want = sd[k].shape if k in sd else None
        if want is not None and tuple(v.shape) != tuple(want):
            raise ValueError(f'EMA order mismatch at {k}: {tuple(v.shape)} vs {tuple(want)}')
        if k in params:
            ema_weights[k] = v
        elif not (_is_res128(config) and k in _POS):
            raise KeyError(f'EMA entry {k} has no parameter in this model')
    return weights, ema_weights


def load_eval_weights(path: str, model: torch.nn.Module, config) -> int:
    """Load a reference-format ``.pth`` into ``model`` for sampling: the EMA
    weights when the file has them, else the model's (reference
    evaler.py:52). Returns the checkpoint's step."""
    ckpt = _read(path)
    weights, ema_weights = _unpacked(ckpt, model, config)
    src = weights if ema_weights is None else ema_weights
    params = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in src.items():
            params[k].copy_(v)
    return int(ckpt.get('step', 0))


def restore_checkpoint(path: str, state: dict, config) -> dict:
    """Restore ``state`` (as :func:`save_checkpoint` takes it) from a
    reference-format file; a missing path warns and returns ``state``
    unchanged (reference utils.py:8-13)."""
    if not os.path.exists(path):
        logger.warning('No checkpoint found at %s. Returned the same state as input', path)
        return state
    ckpt = _read(path)
    model = state['model']
    weights, ema_weights = _unpacked(ckpt, model, config)
    params = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in weights.items():
            params[k].copy_(v)
    ema: Optional[EMA] = state.get('ema')
    if ema is not None and ema_weights is not None:
        dev = {k: v.device for k, v in ema.shadow.items()}
        ema.shadow = {k: v.to(dev[k]).clone() for k, v in ema_weights.items()}
        ema.num_updates = int(ckpt['ema'].get('num_updates') or 0)
        ema.decay = float(ckpt['ema'].get('decay', ema.decay))
    opt = state.get('optimizer')
    if opt is not None and ckpt.get('optimizer') is not None:
        opt.load_state_dict(ckpt['optimizer'])
    return dict(state, step=int(ckpt.get('step', 0)))
