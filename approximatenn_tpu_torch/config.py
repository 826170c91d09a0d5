"""Global numeric configuration and the precision policy.

PyTorch counterpart of ``approximatenn_tpu/config.py``: the default float
element type is a runtime value (float32 unless ``ANN_TORCH_FTYPE`` says
otherwise), ids are int32 at every public API, and the sentinel id of an
n-point corpus is ``n`` with a +inf distance.

Precision policy, fixed here once for the whole package.  On Hopper a
float32 ``matmul`` may run on the tensor cores in TF32 (10-bit mantissa)
when ``torch.backends.cuda.matmul.allow_tf32`` is set, and cuDNN uses TF32
by default.  TF32 is the twin of the TPU's bf16-truncating DEFAULT matmul
precision: it silently misranks neighbours whose squared distances differ
in the fourth significant digit, and it flips the signs of near-zero hash
projections, so the hash codes of build and query stop agreeing with each
other and with the CPU oracle.  Every float32 product in this package
(hash projections, the exact oracle, the plain twin of the exact kernel)
must be IEEE float32, so both switches are forced off at import and the
global matmul precision is pinned to "highest".
"""

from __future__ import annotations

import os

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
if torch.get_float32_matmul_precision() != "highest":
    torch.set_float32_matmul_precision("highest")

_FTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
}

_ftype = _FTYPES.get(os.environ.get("ANN_TORCH_FTYPE", "float32"), torch.float32)


def set_ftype(dtype) -> None:
    """Set the default element type ('float32' | 'float64' | 'bfloat16')."""
    global _ftype
    if isinstance(dtype, str):
        dtype = _FTYPES[dtype]
    _ftype = dtype


def ftype() -> torch.dtype:
    """Default floating element type."""
    return _ftype


# ids are int32 at the API (n < 2**31 is asserted at build time); torch
# indexing wants int64, so modules cast at the gather and keep outputs int32
itype = torch.int32


def default_device(points, device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else a
    tensor's own device, else the CUDA card.  A CPU tensor or
    ``device="cpu"`` is the caller asking for the CPU; without a card and
    without that request this raises rather than quietly running on the
    CPU."""
    if device is not None:
        return torch.device(device)
    if isinstance(points, torch.Tensor):
        return points.device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' (or a CPU tensor) "
                           "to run on the CPU")
    return torch.device("cuda")
