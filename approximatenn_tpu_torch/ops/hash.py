"""Sign-bit bucket codes and multiprobe code expansion (port of
``approximatenn_tpu/ops/hash.py``)."""

from __future__ import annotations

import torch

from ..config import itype
from .topk import topk_iter


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """Pack the sign bits of the last axis into an int32 code, MSB first.

    ``torch.signbit`` reads the IEEE sign bit, so -0.0 counts as negative,
    as in the JAX twin.  d_short <= 31 (the build enforces far less)."""
    d_short = x.shape[-1]
    if d_short == 0:
        return torch.zeros(x.shape[:-1], dtype=itype, device=x.device)
    bits = torch.signbit(x).to(itype)
    weights = torch.ones((), dtype=itype, device=x.device) << torch.arange(
        d_short - 1, -1, -1, dtype=itype, device=x.device)
    return (bits * weights).sum(-1, dtype=itype)


def query_codes(row_means, bases: torch.Tensor, x: torch.Tensor):
    """Center rows, project against every table's basis in one matmul, pack
    sign codes.  THE hashing convention: the build, the search and the
    graph stage all delegate here.

    x (m, d); bases (tries, d_short, d).  Returns (codes (m, tries) int32,
    proj (m, tries, d_short)).  The product is IEEE float32 (TF32 is off
    package-wide, see ``config``): a TF32 projection flips the signs of
    near-zero coordinates.
    """
    tries, d_short, d = bases.shape
    m = x.shape[0]
    if d_short == 0:
        return (torch.zeros((m, tries), dtype=itype, device=x.device),
                torch.zeros((m, tries, 0), dtype=bases.dtype, device=x.device))
    xc = x.to(bases.dtype) - row_means
    proj = (xc @ bases.reshape(tries * d_short, d).T).reshape(m, tries, d_short)
    return pack_signs(proj), proj


def probe_codes(codes: torch.Tensor, d_short: int) -> torch.Tensor:
    """Each code plus all its Hamming-1 neighbours, shape ``(..., d_short+1)``;
    probe 0 is the code itself, probe y >= 1 flips bit y-1."""
    dev = codes.device
    flips = torch.cat([torch.zeros((1,), dtype=itype, device=dev),
                       torch.ones((d_short,), dtype=itype, device=dev)
                       << torch.arange(d_short, dtype=itype, device=dev)])
    return codes[..., None] ^ flips


def probe_codes_directed(codes: torch.Tensor, proj: torch.Tensor,
                         n_probes: int) -> torch.Tensor:
    """Query-directed multiprobe: the own bucket, then the ``n_probes - 1``
    cheapest 1- and 2-bit flips, where a flip costs |proj| summed over its
    bits.  Returns (..., n_probes) codes; repeats the own code when
    ``n_probes`` exceeds the candidate set."""
    d_short = proj.shape[-1]
    dev = codes.device
    a = proj.abs()
    bit_of_coord = torch.arange(d_short - 1, -1, -1, dtype=itype, device=dev)
    single_masks = torch.ones((), dtype=itype, device=dev) << bit_of_coord
    iu, ju = torch.triu_indices(d_short, d_short, offset=1, device=dev)
    pair_masks = single_masks[iu] | single_masks[ju]
    costs = torch.cat([a, a[..., iu] + a[..., ju]], dim=-1)
    masks = torch.cat([single_masks, pair_masks])
    n_extra = min(n_probes - 1, masks.shape[0])
    pos, _ = topk_iter(costs, n_extra)
    sel = masks[pos.long()]
    probes = torch.cat([torch.zeros(sel.shape[:-1] + (1,), dtype=itype,
                                    device=dev), sel], dim=-1)
    out = codes[..., None] ^ probes
    if n_extra + 1 < n_probes:
        pad = codes[..., None].expand(codes.shape + (n_probes - n_extra - 1,))
        out = torch.cat([out, pad], dim=-1)
    return out
