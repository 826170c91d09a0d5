"""Device runtime management (port of ``approximatenn_tpu/utils/runtime.py``,
the role of the reference's ``gpu_comp.c``).

The reference's device layer discovers a platform, validates a capability
(double-precision support), and keeps a cleanup-callback registry.  Here
discovery returns a ``torch.device``, the capability check is a dtype the
device must hold, and the registry runs its callbacks at interpreter exit.
"""

from __future__ import annotations

import atexit
import subprocess
from typing import Callable

import torch

_cleanups: list[Callable[[], None]] = []
_registered = False

_PREFER = {"gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def device_init(prefer: str | None = None, require_dtype=None) -> torch.device:
    """Discover and return the compute device (role of ``gpu_init``).

    prefer: 'gpu' | 'cuda' | 'cpu' | None.  None means the CUDA card, and
    raises without one.  This differs from the JAX package on purpose: its
    ``device_init()`` falls back to the CPU when no accelerator is present,
    while every entry point of this package runs on the card unless the
    caller asks for the CPU (``config.default_device``), so no fallback
    hides a missing card.  'tpu' raises: this package runs no TPU.
    ``require_dtype`` (a torch dtype or its name, e.g. 'float64') must name
    a torch dtype; the CPU and the card hold every one (float64 needs no
    switch, unlike JAX's x64 flag)."""
    if prefer is None:
        prefer = "cuda"
    if prefer not in _PREFER:
        raise ValueError(f"prefer must be one of {sorted(_PREFER)} or None, got "
                         f"{prefer!r} (this package runs no TPU)")
    dev = torch.device(_PREFER[prefer])
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: call device_init('cpu') to run on the CPU")
        dev = torch.device("cuda", torch.cuda.current_device())
    if require_dtype is not None:
        dt = (getattr(torch, require_dtype, None) if isinstance(require_dtype, str)
              else require_dtype)
        if not isinstance(dt, torch.dtype):
            raise TypeError(f"unknown dtype {require_dtype!r}")
    return dev


def register_cleanup(fn: Callable[[], None]) -> None:
    """Run ``fn`` at interpreter exit (role of ``register_cleanup``).
    Callbacks run LIFO, exceptions suppressed."""
    global _registered
    _cleanups.append(fn)
    if not _registered:
        atexit.register(cleanup)
        _registered = True


def cleanup() -> None:
    """Run and clear all registered cleanups (role of ``gpu_cleanup``)."""
    while _cleanups:
        fn = _cleanups.pop()
        try:
            fn()
        except Exception:
            pass


def card_name_and_limit() -> str | None:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them, or
    None where nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0] if lines else None


def device_summary() -> dict:
    """Inventory of the visible platform (diagnostics): 'gpu' with the
    cards' names and the first card's name and power limit, else 'cpu'."""
    on_card = torch.cuda.is_available()
    dist = torch.distributed
    procs = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if on_card:
        devices = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    else:
        devices = ["cpu"]
    out = {"platform": "gpu" if on_card else "cpu", "device_count": len(devices),
           "process_count": procs, "devices": devices}
    if on_card:
        out["card"] = card_name_and_limit()
    return out
