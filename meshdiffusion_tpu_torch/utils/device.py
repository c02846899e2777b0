"""The device the port's entry points run on: the card unless the caller
names the CPU. There is no fallback: asking for CUDA where there is none
raises."""

from __future__ import annotations

import torch


def resolve_device(device, what: str = 'device') -> torch.device:
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'{what} {device}: CUDA is not available')
    return dev
