"""Completion fence (port of ``fence`` in
``approximatenn_tpu/utils/profiling.py``).

PyTorch returns before the card finishes, so a host clock read without a
fence measures the enqueue.  :func:`fence` is ``torch.cuda.synchronize()``
on CUDA and does nothing on the CPU, where every op has finished when it
returns.
"""

from __future__ import annotations

import torch


def fence(device=None) -> None:
    """Wait for all queued work on ``device`` (a CUDA device, a tensor, or
    None for the current CUDA device); no-op on the CPU."""
    if isinstance(device, torch.Tensor):
        device = device.device
    if device is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
