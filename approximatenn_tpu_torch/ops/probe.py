"""Per-table probe-window top-k over the packed bucket-CSR rows: the CUDA
kernel's wrapper and its plain PyTorch version.

Port of ``approximatenn_tpu/ops/pallas_probe.py`` (``probe_topk_pallas``
and its TPU kernel ``_kernel``); the kernel for Hopper is
``csrc/probe_knn.cu``.  For every (query, table): the slots of the P
windows ``[start, start + window)`` of that table's packed rows (table t at
rows ``[t * n_pad, (t + 1) * n_pad)``), squared L2 in fp32, slots at or
past the live bound ``n`` at +inf, and the k nearest by (distance, slot),
each slot once however many windows cover it.  Returns (slots (m, tries,
k) int32, sentinel ``n``; distances (m, tries, k) float32).

Before either version runs, :func:`prepare` does what the TPU wrapper
does before its launch: it widens the window to an aligned superset
(``align`` = 32 slots for int8 rows, 8 for float rows), clips the starts
to aligned offsets, and rounds the queries to a half row type (int8 rows
take the float ``q / scale`` as given).  The widening came from TPU DMA
alignment, but it decides which slots are candidates, so it is kept: the
port returns the JAX package's ids.

``probe_topk`` runs the kernel for a CUDA tensor and the plain version
for a CPU tensor, never anything else.
"""

from __future__ import annotations

import torch

from ..config import itype
from .exact import (_DTYPE_CODE, KMAX, _library, device_index, gather_geometry,
                    launch_error, launches)
from .twophase import smallest

_BLOCK_ELEMS = 64 << 20  # plain version: ~256 MB of float32 rows per query block
# warps the kernel gives a (query, table) pair, 8 / this pairs a block
# (PERF.md §6: the reading that chose it)
WARPS_PER_PAIR = 2


def prepare(pts_flat: torch.Tensor, queries: torch.Tensor, starts: torch.Tensor, *,
            n_pad: int, window: int):
    """(queries as the kernel reads them, widened starts, widened window):
    window <- min(ceil((window + align - 1) / align) * align, n_pad), starts
    <- clip(starts // align, 0, (n_pad - window) // align) * align."""
    align = 32 if pts_flat.dtype == torch.int8 else 8
    if n_pad % align:
        raise ValueError(f"n_pad={n_pad} must be a multiple of {align} "
                         "(repack with ANNIndex.packed())")
    window = min(-(-(window + align - 1) // align) * align, n_pad)
    starts = torch.clamp(starts // align, 0, (n_pad - window) // align) * align
    if pts_flat.dtype in (torch.bfloat16, torch.float16):
        queries = queries.to(pts_flat.dtype)
    return queries.float().contiguous(), starts.to(torch.int32).contiguous(), window


def probe_topk(pts_flat: torch.Tensor, queries: torch.Tensor, starts: torch.Tensor, *,
               k: int, n: int, n_pad: int, window: int,
               geometry: tuple[int, int] | None = None,
               warps_per_pair: int = WARPS_PER_PAIR):
    """Per-table probe-window top-k (see the module docstring).
    ``pts_flat`` (tries * n_pad, d) f32/bf16/f16/int8 rows; ``queries`` (m,
    d) float (for int8 rows, q / scale); ``starts`` (m, tries, P) int32
    within [0, n_pad - window]; ``n`` the live bound; k <= 128 (the
    kernel's selection width, a limit of this port).  ``geometry`` (the
    row scorer's (V, G), :func:`~.exact.gather_geometry` by default)
    and ``warps_per_pair`` (1, 2, 4 or 8) set the kernel's launch, for
    readings; the result does not depend on them."""
    if pts_flat.dim() != 2 or queries.dim() != 2 or starts.dim() != 3:
        raise ValueError("pts_flat and queries must be 2-D, starts 3-D")
    if pts_flat.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported row dtype {pts_flat.dtype}")
    m, d = queries.shape
    tries, P = starts.shape[1], starts.shape[2]
    if pts_flat.shape != (tries * n_pad, d) or starts.shape[0] != m:
        raise ValueError(f"shapes disagree: rows {tuple(pts_flat.shape)}, queries "
                         f"{tuple(queries.shape)}, starts {tuple(starts.shape)}, "
                         f"n_pad {n_pad}")
    if not 1 <= k <= KMAX:
        raise ValueError(f"probe_topk selects 1 <= k <= {KMAX}, got {k}")
    if not 0 <= n < n_pad:
        raise ValueError(f"live bound n={n} must lie in [0, n_pad)")
    q, starts, window = prepare(pts_flat, queries, starts, n_pad=n_pad, window=window)
    if pts_flat.device.type == "cpu":
        return probe_topk_plain(pts_flat, q, starts, k=k, n=n, n_pad=n_pad, window=window)
    if pts_flat.device.type != "cuda":
        raise ValueError(f"probe_topk runs on cuda or cpu, not {pts_flat.device}")
    if not pts_flat.is_contiguous():
        raise ValueError("pts_flat must be contiguous")
    dev = pts_flat.device
    if q.device != dev or starts.device != dev:
        raise ValueError("queries and starts must live on the rows' device")
    out_d = torch.empty((m, tries, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, tries, k), dtype=itype, device=dev)
    if m == 0:
        return out_i, out_d
    lib = _library("probe_knn")
    vec, lanes = geometry or gather_geometry(d, pts_flat.element_size(), pts_flat.data_ptr())
    err = lib.probe_topk_launch(
        device_index(dev), pts_flat.data_ptr(), _DTYPE_CODE[pts_flat.dtype], q.data_ptr(),
        starts.data_ptr(), m, tries, P, d, n_pad, window, n, k, vec, lanes, warps_per_pair,
        out_d.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise launch_error(lib, "probe_topk", err)
    launches["probe_topk"] += 1
    return out_i, out_d


def probe_topk_plain(pts_flat: torch.Tensor, queries: torch.Tensor,
                     starts: torch.Tensor, *, k: int, n: int, n_pad: int, window: int):
    """Plain PyTorch version of the kernel on already widened ``starts`` and
    ``window`` and prepared ``queries`` (:func:`prepare`): gather the
    ``(m, tries, P * window)`` slots, diff-form squared L2 in fp32, +inf at
    slots >= ``n`` and on repeated slots (sorted by slot first), then the k
    smallest by (distance, slot) (:func:`~.twophase.smallest`)."""
    m, tries, P = starts.shape
    d = pts_flat.shape[1]
    L = P * window
    dev = pts_flat.device
    lane = torch.arange(window, device=dev)
    toff = (torch.arange(tries, device=dev) * n_pad)[None, :, None]
    block = max(1, min(m, _BLOCK_ELEMS // max(1, tries * L * d)))
    out_i, out_d = [], []
    for lo in range(0, m, block):
        st = starts[lo: lo + block].long()
        b = st.shape[0]
        pos, _ = torch.sort((st[..., None] + lane).reshape(b, tries, L), dim=-1)
        dup = torch.zeros_like(pos, dtype=torch.bool)
        dup[..., 1:] = pos[..., 1:] == pos[..., :-1]
        diff = pts_flat[pos + toff].float() - queries[lo: lo + b, None, None, :]
        dd = torch.where(dup | (pos >= n), float("inf"), (diff * diff).sum(-1))
        d_k, p_k = smallest(dd, pos, k)
        out_i.append(torch.where(torch.isinf(d_k), n, p_k))
        out_d.append(d_k)
    if not out_i:
        return (torch.empty((0, tries, k), dtype=itype, device=dev),
                torch.empty((0, tries, k), device=dev))
    return torch.cat(out_i), torch.cat(out_d)
