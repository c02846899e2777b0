"""Multi-process launch: one process a rank, ranks joined by torch.distributed.

Counterpart of ``meshdiffusion_tpu/parallel/distributed.py``. The launch
contract is the JAX package's: every process is started with

    MESHDIFFUSION_COORDINATOR=host0:1234
    MESHDIFFUSION_NUM_PROCESSES=N
    MESHDIFFUSION_PROCESS_ID=<0..N-1>

or is given the same values as arguments of :func:`maybe_initialize`, which
then calls ``torch.distributed.init_process_group`` on
``tcp://{coordinator}``. Without them it does nothing and the run is a
single process, as before.

The backend is named by the caller (``config.gpu.dist_backend``, default
``'nccl'``), never chosen here: ``gloo`` is the one that runs on the CPU,
and the one to name where several ranks share a card (NCCL refuses two
ranks on one device, and raises then). A rank runs on
``cuda:{rank % torch.cuda.device_count()}`` (:func:`rank_device`), one
process a card, unless the caller names the CPU.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def maybe_initialize(backend: str = 'nccl', coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join the process group when a multi-process launch is asked for, by
    the arguments or the MESHDIFFUSION_* variables; a no-op otherwise, and
    when the group is already up. Call it before the first device use.
    Returns True iff the run is multi-process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = coordinator or os.environ.get('MESHDIFFUSION_COORDINATOR', '')
    if num_processes is None:
        num_processes = int(os.environ.get('MESHDIFFUSION_NUM_PROCESSES', '0') or 0)
    if process_id is None:
        pid = os.environ.get('MESHDIFFUSION_PROCESS_ID', '')
        process_id = int(pid) if pid != '' else None
    if not coordinator or num_processes <= 1 or process_id is None:
        return False
    dist.init_process_group(backend, init_method=f'tcp://{coordinator}',
                            world_size=num_processes, rank=process_id)
    logger.info('process group up (%s): rank %d of %d', backend, process_id, num_processes)
    return True


def world() -> tuple:
    """(world size, this process's rank): (1, 0) outside a process group."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def rank_device(device) -> torch.device:
    """The device this rank runs on: the CPU where ``device`` names it,
    else ``cuda:{rank % device count}``."""
    device = torch.device(device)
    if device.type != 'cuda':
        return device
    return torch.device('cuda', world()[1] % torch.cuda.device_count())


def check_devices(device) -> None:
    """Raise where an NCCL group would hold two ranks on one card (NCCL
    refuses them); nothing switches to another backend. Every rank calls it,
    after choosing its device."""
    device = torch.device(device)
    if not dist.is_initialized() or dist.get_backend() != 'nccl' or device.type != 'cuda':
        return
    import socket
    where = [None] * dist.get_world_size()
    dist.all_gather_object(where, (socket.gethostname(), device.index),
                           group=dist.new_group(backend='gloo'))
    shared = sorted({w for w in where if where.count(w) > 1})
    if shared:
        raise RuntimeError(f'NCCL with several ranks on one card {shared}: start one process a '
                           f'card, or name the gloo backend (gpu.dist_backend)')


def process_local_batch_size(global_batch: int, data: int) -> int:
    """The samples a rank loads a micro-batch: ``global_batch`` split over
    the mesh's ``data`` axis (spatial peers load the same samples); raises
    on a batch the axis does not divide."""
    if global_batch % data != 0:
        raise ValueError(f'global batch {global_batch} not divisible by the data axis {data}')
    return global_batch // data
