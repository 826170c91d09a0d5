"""Random structured-orthogonal transforms (port of
``approximatenn_tpu/ops/transforms.py``).

The chain, per table: ``rots_before`` Givens layers in dim d ->
permutation-embed d -> d_max (next power of two) -> orthonormal
Walsh-Hadamard -> ``rots_after`` Givens layers in d_max -> projection
d_max -> d_short.  :func:`materialize_basis` pushes the identity through it
once, so build and query hash with one matmul against the bases.

Parameters are sampled from an explicit ``torch.Generator``.  Torch cannot
reproduce ``jax.random``'s bits, so a parity test hands both packages the
same parameters (or the same saved index) instead of the same seed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import itype


class OrthoParams(NamedTuple):
    """One table's transform; every field may carry a leading ``tries``
    axis when stacked (:func:`sample_ortho_params_batch`)."""

    rb_i: torch.Tensor  # (rots_b, rot_len_b) int32, first coords pre-WHT
    rb_j: torch.Tensor  # (rots_b, rot_len_b) int32, second coords
    rb_a: torch.Tensor  # (rots_b, rot_len_b) float, angles in [0, pi)
    perm_b: torch.Tensor  # (d_max,) int32, embed permutation d -> d_max
    ra_i: torch.Tensor  # (rots_a, rot_len_a) int32, post-WHT rotation coords
    ra_j: torch.Tensor  # (rots_a, rot_len_a) int32
    ra_a: torch.Tensor  # (rots_a, rot_len_a) float
    perm_ai: torch.Tensor  # (d_max,) int32, projection d_max -> d_short


def next_pow2(d: int) -> int:
    """Smallest power of two >= d."""
    return 1 if d <= 1 else 1 << (d - 1).bit_length()


def derive_dims(n: int, k: int, d: int) -> tuple[int, int]:
    """(d_short, d_max): d_short = ceil(log2(n/k)) clamped to d_max; the
    reference's unsigned arithmetic makes n < k clamp to d_max."""
    d_max = next_pow2(d)
    if n < k:
        return d_max, d_max
    return min(max(0, math.ceil(math.log2(n / k))), d_max), d_max


def _sample_rot_layer(gen, rot_len: int, dim: int, dtype, device):
    coords = torch.randperm(dim, generator=gen)[: 2 * rot_len]
    a = torch.rand(rot_len, generator=gen, dtype=torch.float64) * math.pi
    return (coords[0::2].to(itype).to(device), coords[1::2].to(itype).to(device),
            a.to(dtype).to(device))


def sample_ortho_params(gen: torch.Generator, d: int, d_max: int,
                        rots_before: int, rot_len_before: int,
                        rots_after: int, rot_len_after: int,
                        dtype=torch.float32, device=None) -> OrthoParams:
    """Sample one table's transform from ``gen`` (a CPU generator; the
    tensors land on ``device``)."""
    if rots_before > 0 and 2 * rot_len_before > d:
        raise ValueError(f"rot_len_before={rot_len_before} needs 2*len <= d={d}")
    if rots_after > 0 and 2 * rot_len_after > d_max:
        raise ValueError(f"rot_len_after={rot_len_after} needs 2*len <= d_max={d_max}")

    def layers(rots, rot_len, dim):
        if rots == 0:
            z = torch.zeros((0, rot_len), dtype=itype, device=device)
            return z, z, torch.zeros((0, rot_len), dtype=dtype, device=device)
        parts = [_sample_rot_layer(gen, rot_len, dim, dtype, device)
                 for _ in range(rots)]
        return tuple(torch.stack(p) for p in zip(*parts))

    rb_i, rb_j, rb_a = layers(rots_before, rot_len_before, d)
    ra_i, ra_j, ra_a = layers(rots_after, rot_len_after, d_max)
    perm_b = torch.randperm(d_max, generator=gen).to(itype).to(device)
    perm_ai = torch.randperm(d_max, generator=gen).to(itype).to(device)
    return OrthoParams(rb_i, rb_j, rb_a, perm_b, ra_i, ra_j, ra_a, perm_ai)


def sample_ortho_params_batch(gen: torch.Generator, tries: int, d: int,
                              d_max: int, rots_before: int,
                              rot_len_before: int, rots_after: int,
                              rot_len_after: int, dtype=torch.float32,
                              device=None) -> OrthoParams:
    """Stack ``tries`` independent transforms along a leading axis."""
    ps = [sample_ortho_params(gen, d, d_max, rots_before, rot_len_before,
                              rots_after, rot_len_after, dtype, device)
          for _ in range(tries)]
    return OrthoParams(*(torch.stack(f) for f in zip(*ps)))


def apply_rotation(x: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
                   a: torch.Tensor) -> torch.Tensor:
    """Rotate the disjoint coordinate planes (i[p], j[p]) by a[p]."""
    c = torch.cos(a).to(x.dtype)
    s = torch.sin(a).to(x.dtype)
    i, j = i.long(), j.long()
    xi, xj = x[..., i], x[..., j]
    x = x.clone()
    x[..., i] = xi * c - xj * s
    x[..., j] = xi * s + xj * c
    return x


def apply_permutation(x: torch.Tensor, perm: torch.Tensor, d_pre: int):
    """Embed (..., d_pre) -> (..., len(perm)): out[y] = x[perm[y]], zero
    where perm[y] >= d_pre."""
    vals = x[..., perm.clamp(0, d_pre - 1).long()]
    return torch.where(perm < d_pre, vals, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def apply_perm_inv(x: torch.Tensor, perm: torch.Tensor, d_post: int):
    """Project (..., d_pre) -> (..., d_post): out[perm[y]] = x[y] for
    perm[y] < d_post, a gather through argsort(perm)."""
    inv = torch.argsort(perm)
    return x[..., inv[:d_post]]


def walsh(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal fast Walsh-Hadamard transform over the last axis (width
    a power of two; width 1 is the identity)."""
    d = x.shape[-1]
    if d & (d - 1):
        raise ValueError(f"walsh width must be a power of two, got {d}")
    if d == 1:
        return x
    shape = x.shape
    x = x.reshape(-1, d)
    h = 1
    while h < d:
        y = x.reshape(-1, d // (2 * h), 2, h)
        a, b = y[:, :, 0, :], y[:, :, 1, :]
        x = torch.stack((a + b, a - b), dim=2).reshape(-1, d)
        h *= 2
    x = x * torch.tensor(1.0 / math.sqrt(d), dtype=x.dtype)
    return x.reshape(shape)


def apply_ortho(x: torch.Tensor, p: OrthoParams, d_short: int) -> torch.Tensor:
    """The full chain (..., d) -> (..., d_short)."""
    d = x.shape[-1]
    for r in range(p.rb_i.shape[0]):
        x = apply_rotation(x, p.rb_i[r], p.rb_j[r], p.rb_a[r])
    x = apply_permutation(x, p.perm_b, d)
    x = walsh(x)
    for r in range(p.ra_i.shape[0]):
        x = apply_rotation(x, p.ra_i[r], p.ra_j[r], p.ra_a[r])
    return apply_perm_inv(x, p.perm_ai, d_short)


def materialize_basis(p: OrthoParams, d: int, d_short: int, dtype) -> torch.Tensor:
    """The chain as an explicit (d_short, d) matrix with orthonormal rows."""
    eye = torch.eye(d, dtype=dtype, device=p.perm_b.device)
    return apply_ortho(eye, p, d_short).T


def materialize_bases(params: OrthoParams, d: int, d_short: int,
                      dtype) -> torch.Tensor:
    """Stacked per-table bases (tries, d_short, d)."""
    tries = params.perm_b.shape[0]
    return torch.stack([
        materialize_basis(OrthoParams(*(f[t] for f in params)), d, d_short, dtype)
        for t in range(tries)])
