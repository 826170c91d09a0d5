"""Bucket (hash-table) construction and multiprobe candidate gather (port
of ``approximatenn_tpu/ops/buckets.py``): the padded tables and the packed
bucket-CSR layout.

Within-bucket order decides which entries an overflowing bucket drops and
where every point sits in the packed layout, so the sort is stable
(``torch.argsort(..., stable=True)``) and the JAX ``mode="drop"`` scatter
becomes an explicit ``rank < capacity`` mask.
"""

from __future__ import annotations

import torch

from ..config import itype
from .hash import probe_codes


def bucket_counts(codes: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Occupancy of every bucket, int32."""
    return torch.bincount(codes.long(), minlength=n_buckets)[:n_buckets].to(itype)


def build_table(codes: torch.Tensor, n_buckets: int, capacity: int,
                sentinel: int) -> torch.Tensor:
    """Padded bucket table ``(n_buckets, capacity)`` of int32 point ids:
    argsort by code, rank within bucket, scatter the ranks below
    ``capacity``; empty slots hold ``sentinel``."""
    n = codes.shape[0]
    order = torch.argsort(codes, stable=True)
    sorted_codes = codes[order]
    first = torch.searchsorted(sorted_codes, sorted_codes, side="left")
    rank = torch.arange(n, device=codes.device) - first
    keep = rank < capacity
    table = torch.full((n_buckets, capacity), sentinel, dtype=itype,
                       device=codes.device)
    table[sorted_codes[keep].long(), rank[keep]] = order[keep].to(itype)
    return table


def build_tables(codes: torch.Tensor, n_buckets: int, capacity: int,
                 sentinel: int) -> torch.Tensor:
    """Per-table build: codes ``(tries, n)`` -> ``(tries, n_buckets,
    capacity)``, one table at a time (one sort workspace live)."""
    return torch.stack([build_table(c, n_buckets, capacity, sentinel)
                        for c in codes])


def pack_table(codes: torch.Tensor, n_buckets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """CSR layout of one table: ``(order (n,), starts (n_buckets,))`` int32,
    point ids sorted stably by bucket code and the first slot of every
    bucket in that order.  Bucket ``b`` owns ``order[starts[b]:starts[b+1]]``
    (the final boundary is n); codes >= ``n_buckets`` sort past every
    bucket."""
    order = torch.argsort(codes, stable=True)
    sorted_codes = codes[order]
    starts = torch.searchsorted(
        sorted_codes, torch.arange(n_buckets, dtype=codes.dtype, device=codes.device),
        side="left")
    return order.to(itype), starts.to(itype)


def pack_tables(codes: torch.Tensor, n_buckets: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-table :func:`pack_table`: codes ``(tries, n)`` -> ``(order
    (tries, n), starts (tries, n_buckets))``."""
    parts = [pack_table(c, n_buckets) for c in codes]
    return torch.stack([o for o, _ in parts]), torch.stack([s for _, s in parts])


def multiprobe_gather(table: torch.Tensor, codes: torch.Tensor,
                      d_short: int) -> torch.Tensor:
    """Candidates of each code's own bucket and every Hamming-1 bucket:
    ``(m, (d_short + 1) * capacity)`` ids, sentinel-padded."""
    probes = probe_codes(codes, d_short)
    return table[probes.long()].reshape(codes.shape[0], -1)
