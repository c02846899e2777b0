"""Weights carried across from the JAX package.

:func:`from_jax_params`: JAX/flax parameter tree -> this package's U-Net;
:func:`fit_state_from_jax`: a JAX fitting state -> this package's;
:func:`mlp_texture_state_from_jax`: a JAX neural material -> this package's;
:func:`ncsn_block_state_from_jax` and :func:`normalization_state_from_jax`:
the JAX package's NCSN blocks and norms -> ``models/ncsn_blocks.py``'s and
``models/normalization.py``'s.

:func:`from_jax_params` is the inverse of ``meshdiffusion_tpu/utils/torch_convert.py``
(``convert_model_state``, which maps the reference torch layout onto the
flax tree). This package's U-Net keeps that torch layout: a flat
``all_modules`` list in construction order plus ``pos_layer`` and
``mask_layer``. :func:`module_walk` replays the construction order from the
config (as ``torch_convert.module_walk`` does) without jax, and the per-kind
tables below say where each tensor goes and how it is transposed:

* Linear   weight (out, in)          <- Dense kernel (in, out)
* Conv3d   weight (O, I, kd, kh, kw) <- Conv kernel (kd, kh, kw, I, O)
* GroupNorm weight/bias              <- scale/bias
* NIN      W (in, out), b            <- unchanged
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def _level_blocks(config, lev: int) -> int:
    m = config.model
    if lev == 0 and 'res128' in m.name:
        return m.get('num_res_blocks_first', 2)
    return m.num_res_blocks


def module_walk(config) -> Iterator[Tuple[str, str, str]]:
    """Yield (torch prefix, flax module name, kind) in construction order."""
    m = config.model
    L = len(m.ch_mult)
    R = config.data.image_size
    res = [R // (2 ** i) for i in range(L)]
    attn = tuple(m.attn_resolutions)
    counter = iter(range(10 ** 6))

    def nxt():
        return f'all_modules.{next(counter)}'

    yield nxt(), 'temb_0', 'linear'
    yield nxt(), 'temb_1', 'linear'
    if 'res128' not in m.name:
        yield 'pos_layer', 'pos_layer', 'conv'
    yield 'mask_layer', 'mask_layer', 'conv'
    yield nxt(), 'stem', 'conv'
    for lev in range(L):
        for blk in range(_level_blocks(config, lev)):
            yield nxt(), f'down_{lev}_{blk}', 'resblock'
            if res[lev] in attn:
                yield nxt(), f'down_{lev}_{blk}_attn', 'attn'
        if lev != L - 1:
            yield nxt(), f'down_{lev}_downsample', 'down'
    yield nxt(), 'mid_0', 'resblock'
    yield nxt(), 'mid_attn', 'attn'
    yield nxt(), 'mid_1', 'resblock'
    for lev in reversed(range(L)):
        for blk in range(_level_blocks(config, lev) + 1):
            yield nxt(), f'up_{lev}_{blk}', 'resblock'
        if res[lev] in attn:
            yield nxt(), f'up_{lev}_attn', 'attn'
        if lev != 0:
            yield nxt(), f'up_{lev}_upsample', 'up'
    yield nxt(), 'out_norm', 'groupnorm'
    yield nxt(), 'out_conv', 'conv'


_T = lambda w: np.ascontiguousarray(np.asarray(w).T)
_CONV = lambda w: np.ascontiguousarray(np.transpose(np.asarray(w), (4, 3, 0, 1, 2)))
_ID = np.asarray


def _conv(name):
    return [(f'{name}.weight', (name, 'conv', 'kernel'), _CONV),
            (f'{name}.bias', (name, 'conv', 'bias'), _ID)]


def _norm(name):
    return [(f'{name}.weight', (name, 'norm', 'scale'), _ID),
            (f'{name}.bias', (name, 'norm', 'bias'), _ID)]


def _nin(name):
    return [(f'{name}.W', (name, 'W'), _ID), (f'{name}.b', (name, 'b'), _ID)]


# kind -> [(torch suffix, flax subpath, flax -> torch transform)]
_KIND_PARAMS = {
    'linear': [('weight', ('kernel',), _T), ('bias', ('bias',), _ID)],
    'conv': [('weight', ('conv', 'kernel'), _CONV), ('bias', ('conv', 'bias'), _ID)],
    'groupnorm': [('weight', ('norm', 'scale'), _ID), ('bias', ('norm', 'bias'), _ID)],
    'down': _conv('Conv_0'),
    'up': _conv('Conv_0'),
    'attn': _norm('GroupNorm_0') + _nin('NIN_0') + _nin('NIN_1') + _nin('NIN_2') + _nin('NIN_3'),
    'resblock': (_norm('GroupNorm_0') + _conv('Conv_0')
                 + [('Dense_0.weight', ('Dense_0', 'kernel'), _T),
                    ('Dense_0.bias', ('Dense_0', 'bias'), _ID)]
                 + _norm('GroupNorm_1') + _conv('Conv_1')),
}


def _get(tree: dict, path):
    for p in path:
        tree = tree[p]
    return tree


def from_jax_params(params: dict, config) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (``{'params': ...}`` or its inside; numpy or jax
    arrays) -> a state_dict for this package's U-Net, float32 on the CPU."""
    tree = params.get('params', params)
    sd: Dict[str, torch.Tensor] = {}
    for tprefix, fname, kind in module_walk(config):
        entries = list(_KIND_PARAMS[kind])
        if kind == 'resblock' and 'NIN_0' in tree[fname]:
            entries += _nin('NIN_0')
        for suffix, fpath, tf in entries:
            value = tf(np.asarray(_get(tree[fname], fpath), np.float32))
            sd[f'{tprefix}.{suffix}'] = torch.from_numpy(np.array(value, np.float32))
    return sd


def fit_state_from_jax(state, device=None):
    """A JAX ``FitState`` (any object with its six fields, as numpy or jax
    arrays) -> this package's :class:`~..fitting.geometry.FitState`, so
    that both fitters can start from the same state."""
    from ..fitting.geometry import FitState

    def t(name, dtype):
        return torch.as_tensor(np.array(getattr(state, name)), dtype=dtype, device=device)
    return FitState(sdf=t('sdf', torch.float32), deform=t('deform', torch.float32),
                    sdf_ema=t('sdf_ema', torch.float32),
                    sdf_buffer=t('sdf_buffer', torch.float32),
                    buf_len=t('buf_len', torch.int64), buf_ptr=t('buf_ptr', torch.int64))


def mlp_texture_state_from_jax(params) -> Dict[str, torch.Tensor]:
    """A JAX ``MLPTexture3D`` parameter tree ({'params': {'encoder':
    {'table'}, 'dense_{i}': {'kernel'}}}) -> the port's
    :class:`~meshdiffusion_tpu_torch.render.mlptexture.MLPTexture3D`
    parameters: ``encoder.table`` (L, T, F) as it is, ``dense_{i}.weight``
    the kernel transposed (out, in). Load with
    ``mat.load_state_dict({**mat.state_dict(), **state})``."""
    tree = params['params'] if 'params' in params else params
    out = {'encoder.table': torch.from_numpy(np.array(tree['encoder']['table'], np.float32))}
    for name, leaf in tree.items():
        if name.startswith('dense_'):
            out[f'{name}.weight'] = torch.from_numpy(np.array(leaf['kernel'], np.float32).T.copy())
    return out


def _flat_leaves(tree: dict, prefix: str = ''):
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            yield from _flat_leaves(leaf, f'{prefix}{name}.')
        else:
            yield prefix, name, np.array(leaf, np.float32)


def ncsn_block_state_from_jax(params) -> Dict[str, torch.Tensor]:
    """A flax tree of an NCSN block (``CRPBlock``, ``RCUBlock``,
    ``MSFBlock``, ``RefineBlock``, ``ConvMeanPool``, ``MeanPoolConv``) ->
    the state_dict of the port's module of the same name: the submodule
    names carry over, each conv's kernel (kd, kh, kw, I, O) becomes its
    weight (O, I, kd, kh, kw), its bias stays."""
    tree = params['params'] if 'params' in params else params
    out = {}
    for prefix, name, leaf in _flat_leaves(tree):
        if name == 'kernel':
            out[prefix + 'weight'] = torch.from_numpy(_CONV(leaf))
        else:
            out[prefix + name] = torch.from_numpy(leaf)
    return out


def normalization_state_from_jax(params) -> Dict[str, torch.Tensor]:
    """A flax tree of a norm of ``get_normalization`` -> the state_dict of
    the port's: the instance norms' ``gamma``, ``alpha``, ``beta`` and
    ``embed`` as they are, GroupNorm's ``scale`` as ``weight``."""
    tree = params['params'] if 'params' in params else params
    return {prefix + ('weight' if name == 'scale' else name): torch.from_numpy(leaf)
            for prefix, name, leaf in _flat_leaves(tree)}
