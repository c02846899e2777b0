"""The training loop (``main --mode train``).

Counterpart of ``meshdiffusion_tpu/diffusion/trainer.py`` (reference
``lib/diffusion/trainer.py:18-130``) on one device:

* the loader yields (iter_size * batch_size) samples a step, which the
  train step (``losses.make_train_step``) runs as ``iter_size``
  micro-batches of ``training.batch_size``, gradients summed;
* the host waits for the card only at a logged step (``log_freq``, where it
  reads the loss) and at a snapshot: elsewhere it loads the next batch and
  copies it from pinned memory while the card runs the step before, as the
  JAX package's asynchronous dispatch has it;
* steps ``initial_step .. n_iters`` inclusive, as the JAX package runs them;
  ``initial_step`` is the step of the preemption snapshot when there is one;
* snapshots are the reference's ``.pth`` files ({model, ema, optimizer: the
  Adam state_dict, step}, written by ``utils.checkpoint.save_checkpoint``):
  ``checkpoints-meta/checkpoint.pth`` every
  ``snapshot_freq_for_preemption`` steps (one kept, as the JAX package's
  ``max_to_keep=1``) and ``checkpoints/checkpoint_{step}.pth`` every
  ``snapshot_freq`` steps and at the last, ``step`` the optimizer steps
  taken;
* the timestep labels and noise come from a ``torch.Generator`` seeded
  from (``config.seed``, the first step), the dropout masks from torch's
  global generator seeded the same way; a resumed run does not replay the
  JAX package's key stream, which the reference's files do not hold.

Several processes, one a rank (the MESHDIFFUSION_* launch of
``parallel/distributed.py``, backend ``gpu.dist_backend``), train on a
(``gpu.mesh_data_axis``, ``gpu.mesh_spatial_axis``) mesh, as the JAX
trainer does on its device mesh: ``training.batch_size`` is the global
micro-batch, split over the data axis; each data row loads a disjoint
share of the dataset (seed ``config.seed + 1031 * data_index``), its
spatial peers the same samples, each keeping its depth slab; parameters
are replicated, the gradients summed (``losses.make_train_step``). A batch
the data axis does not divide is refused unless ``gpu.allow_device_idle``,
which shrinks the data axis and leaves the ranks past the mesh idle. Only
rank 0 writes the metrics, TensorBoard and snapshots; every rank restores
the preemption snapshot. A rank runs on ``cuda:{rank % device count}``.

There is no fallback device: on ``cuda`` without a card it raises.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
import types
from typing import Optional

import torch

from ..data.dataset import GridLoader, ShapeNetDMTetDataset
from ..models import create_model
from ..parallel import distributed, make_mesh
from ..utils.checkpoint import restore_checkpoint, save_checkpoint
from ..utils.device import resolve_device
from . import losses as L
from .evaler import _is_set, load_grid_mask
from .vpsde import VPSDE

logger = logging.getLogger(__name__)


class MetricWriter:
    """Scalar logger: ``metrics.jsonl`` always, TensorBoard events too when
    ``tensorboard`` is installed (reference trainer.py:32-33).

    TensorBoard runs in its no-TensorFlow mode (the ``tensorboard.compat.notf``
    marker module; its stub writes the event files): otherwise importing
    ``torch.utils.tensorboard`` imports TensorFlow where that is installed,
    and TensorFlow imports jax, which the port keeps out of its process."""

    def __init__(self, workdir: str):
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, 'metrics.jsonl')
        self._fh = open(self.path, 'a')
        self._tb = None
        sys.modules.setdefault('tensorboard.compat.notf',
                               types.ModuleType('tensorboard.compat.notf'))
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(os.path.join(workdir, 'tensorboard'))

    def scalar(self, tag: str, value: float, step: int):
        self._fh.write(json.dumps({'tag': tag, 'value': float(value), 'step': int(step),
                                   'time': time.time()}) + '\n')
        self._fh.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self):
        self._fh.close()
        if self._tb is not None:
            self._tb.close()


def _loader(config, mask_host, seed: int, mesh):
    """The native C++ loader for ``.npy`` grids (a warning and the Python
    loader where it cannot be built), the Python loader otherwise, over the
    mesh data row's share of the dataset: (loader, 'native' or 'python')."""
    d = config.data
    dataset = ShapeNetDMTetDataset(
        d.meta_path, mask_host, deform_scale=config.model.deform_scale, aug=d.aug,
        filter_meta_path=d.filter_meta_path if _is_set(d.filter_meta_path) else None,
        normalize_sdf=d.normalize_sdf, extension=d.extension, seed=seed)
    if mesh.data > 1:
        dataset.fpath_list = dataset.fpath_list[mesh.data_index::mesh.data]
        if not dataset.fpath_list:
            raise ValueError(f'dataset smaller than the data axis ({mesh.data}): no samples '
                             f'for data row {mesh.data_index}')
    batch = (distributed.process_local_batch_size(config.training.batch_size, mesh.data)
             * config.training.iter_size)
    if d.extension == 'npy':
        from ..native import NativeGridLoader, native_available
        if native_available():
            return NativeGridLoader(dataset.fpath_list, mask_host, batch_size=batch, aug=d.aug,
                                    normalize_sdf=d.normalize_sdf, num_workers=d.num_workers,
                                    seed=seed), 'native'
        logger.warning('native grid loader unavailable; using the Python loader')
    return GridLoader(dataset, batch_size=batch, num_workers=d.num_workers, seed=seed), 'python'


def _mesh(config):
    """The (data, spatial) mesh over the process group's ranks (JAX
    trainer's): the data axis must divide the global micro-batch, or with
    ``gpu.allow_device_idle`` it shrinks until it does. None on a rank past
    the mesh."""
    n, _ = distributed.world()
    spatial = config.gpu.mesh_spatial_axis
    data = config.gpu.mesh_data_axis
    if data == -1:
        data = n // spatial
    bs = config.training.batch_size
    if bs % data != 0:
        if not config.gpu.allow_device_idle:
            raise ValueError(
                f'training.batch_size={bs} is not divisible by the data mesh axis ({data} = '
                f'{n} ranks / spatial {spatial}); pick a divisible batch, set '
                f'gpu.mesh_data_axis, or set gpu.allow_device_idle=True to shrink the mesh')
        while data > 1 and bs % data != 0:
            data -= 1
        logger.warning('mesh uses %d of %d ranks (batch %d not divisible)', data * spatial, n, bs)
    return make_mesh(data, spatial, world_size=data * spatial, rank=distributed.world()[1])


def train(config, max_steps: Optional[int] = None, device='cuda') -> Optional[L.TrainState]:
    """Run the training loop on ``device`` (in a process group: this rank's
    card); returns the final TrainState, None on a rank left idle by
    ``gpu.allow_device_idle``. ``max_steps`` in the place of
    ``training.n_iters``."""
    distributed.maybe_initialize(config.gpu.dist_backend)
    device = distributed.rank_device(resolve_device(device))
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    distributed.check_devices(device)
    mesh = _mesh(config)
    if mesh is None:
        logger.warning('rank %d is outside the mesh: idle', distributed.world()[1])
        return None
    is_main = mesh.rank == 0
    workdir = config.training.train_dir
    logger.info('working dir: %s', workdir)
    writer = MetricWriter(workdir) if is_main else None

    mask_host = load_grid_mask(config)
    mask = torch.as_tensor(mask_host, device=device)[None, ..., None]
    model = create_model(config, device, torch.Generator(device=device).manual_seed(config.seed))
    sde = VPSDE(beta_min=config.model.beta_min, beta_max=config.model.beta_max,
                N=config.model.num_scales)
    state = L.TrainState.create(model, config, torch.Generator(device=device))
    n_params = sum(p.numel() for p in model.parameters())
    logger.info('model %s: %.1fM params', config.model.name, n_params / 1e6)

    # preemption resume (reference trainer.py:44-52)
    ckpt_meta = os.path.join(workdir, 'checkpoints-meta', 'checkpoint.pth')
    ckpt_dir = os.path.join(workdir, 'checkpoints')
    restored = restore_checkpoint(ckpt_meta, {'model': model, 'ema': state.ema,
                                              'optimizer': state.optimizer, 'step': 0}, config)
    state.step = initial_step = restored['step']
    seed = config.seed + 1000003 * initial_step
    # labels, noise and data: one stream a data row, its spatial peers alike;
    # dropout: one stream a rank
    row_seed = seed + 1031 * mesh.data_index
    state.generator.manual_seed(row_seed)
    torch.manual_seed(seed + 7919 * mesh.rank)

    train_step = L.make_train_step(sde, mask, config.training.loss_type, mesh)
    iter_size = config.training.iter_size
    bs = distributed.process_local_batch_size(config.training.batch_size, mesh.data)
    loader, kind = _loader(config, mask_host, row_seed, mesh)
    n_iters = config.training.n_iters if max_steps is None else max_steps
    log_freq = config.training.log_freq
    logger.info('Starting training loop at step %d (%s loader).', initial_step, kind)
    t_last, load_s, n_run = time.perf_counter(), 0.0, 0
    try:
        for step in range(initial_step, n_iters + 1):
            t0 = time.perf_counter()
            batch = torch.from_numpy(next(loader))     # this data row's samples
            batch = batch.reshape((iter_size, bs) + batch.shape[1:])
            if mesh.spatial > 1:                         # this rank's depth slab
                batch = batch[:, :, slice(*mesh.depth_range(batch.shape[2]))].contiguous()
            load_s += time.perf_counter() - t0
            if device.type == 'cuda':
                batch = batch.pin_memory()   # so that the copy does not wait for the card
            batch = batch.to(device, non_blocking=True)
            metrics = train_step(state, batch)
            n_run += 1

            if step % log_freq == 0:
                loss = float(metrics['loss'])
                dt = time.perf_counter() - t_last
                logger.info('step: %d, training_loss: %.5e (%.3f s for %d steps; loader %.3f s)',
                            step, loss, dt, n_run, load_s,
                            extra={'train_log': (step, loss, dt, n_run, load_s, kind)})
                if writer is not None:
                    writer.scalar('training_loss', loss, step)
                t_last, load_s, n_run = time.perf_counter(), 0.0, 0

            snap = {'model': model, 'ema': state.ema, 'optimizer': state.optimizer,
                    'step': state.step}
            if not is_main:
                continue
            if step != 0 and step % config.training.snapshot_freq_for_preemption == 0:
                logger.info('save meta at iter %d', step)
                save_checkpoint(ckpt_meta, snap, config)
            if step != 0 and step % config.training.snapshot_freq == 0 or step == n_iters:
                logger.info('save model: %d-th', step)
                save_checkpoint(os.path.join(ckpt_dir, f'checkpoint_{state.step}.pth'), snap,
                                config)
    finally:
        loader.close()
        if writer is not None:
            writer.close()
    return state
