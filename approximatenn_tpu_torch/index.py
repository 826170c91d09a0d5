"""The ANN index structure (port of ``approximatenn_tpu/index.py``).

``ANNIndex`` holds the same fields as the JAX dataclass, as tensors on one
device: ``row_means (d,)``, ``bases (tries, d_short, d)``, ``tables
(tries, 2^d_short, tmax)`` int32 with sentinel n, ``counts (tries,
2^d_short)`` int32, ``graph (n, k)`` int32, optional stored ``points`` and
the ``dead`` tombstone mask.

``save``/``load`` write and read the JAX package's npz layout byte for
byte, including the ``<key>_dtype`` tags that carry half-precision floats
as raw uint16 words.  :meth:`ANNIndex.from_numpy` is the weight carrier: it
takes those arrays as numpy (an ``np.load`` of a JAX-saved index, or the
JAX index's leaves) and returns the port's index on a given device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

_HALF = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_TORCH_NAME = {torch.bfloat16: "bfloat16", torch.float16: "float16"}


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch package yet (ROADMAP queue A, "
        f"item {item})")


def to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str | None]:
    """(numpy array, half-float tag or None): bf16/f16 travel as raw uint16
    words, because npz (and numpy) have no bfloat16."""
    t = t.detach().cpu()
    tag = _TORCH_NAME.get(t.dtype)
    if tag is not None:
        return t.view(torch.int16).numpy().view(np.uint16), tag
    return t.numpy(), None


def from_numpy(a: np.ndarray, tag: str | None = None, device=None) -> torch.Tensor:
    """Inverse of :func:`to_numpy`; also accepts ml_dtypes half arrays as
    ``np.asarray`` returns them from a JAX bf16 array."""
    a = np.asarray(a)
    if tag is None and a.dtype.itemsize == 2 and a.dtype.kind not in "iuf":
        tag = str(a.dtype)  # ml_dtypes bfloat16 and friends
        a = a.view(np.uint16)
    if tag is not None and a.dtype == np.uint16:
        t = torch.from_numpy(a.view(np.int16).copy()).view(_HALF[tag])
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t if device is None else t.to(device)


def _stash(arrays: dict, key: str, t: torch.Tensor) -> None:
    a, tag = to_numpy(t)
    arrays[key] = a
    if tag is not None:
        arrays[key + "_dtype"] = np.array(tag)


def _unstash(z, key: str, device):
    if key not in z:
        return None
    tk = key + "_dtype"
    return from_numpy(z[key], str(z[tk]) if tk in z else None, device)


@dataclasses.dataclass(frozen=True)
class ANNIndex:
    row_means: Any  # (d,) float
    bases: Any  # (tries, d_short, d) float
    tables: Any  # (tries, 2^d_short, tmax) int32, sentinel = n
    counts: Any  # (tries, 2^d_short) int32 true occupancy
    graph: Any  # (n, k) int32, sentinel = n
    n: int
    k: int
    d: int
    d_short: int
    tries: int
    tmax: int
    points: Any = None  # (n, d) float or None
    dead: Any = None  # (n + 1,) bool tombstones or None
    metric: str = "l2"

    @property
    def n_buckets(self) -> int:
        return 1 << self.d_short

    @property
    def device(self) -> torch.device:
        return self.tables.device

    def par_maxes(self) -> np.ndarray:
        """Per-table max occupancy, capped by the stored capacity."""
        return np.minimum(self.counts.max(dim=1).values.cpu().numpy(), self.tmax)

    def memory_bytes(self, ragged: bool = True) -> int:
        """Index memory; ragged=True prices the tables at the reference's
        ragged layout, False at the padded layout actually held."""
        f = self.row_means.element_size()
        base = (self.row_means.numel() * f + self.bases.numel() * f
                + self.graph.numel() * 4)
        if ragged:
            tables = int(self.par_maxes().sum()) * self.n_buckets * 4
        else:
            tables = self.tables.numel() * 4
        pts = 0 if self.points is None else self.points.numel() * f
        return int(base + tables + pts)

    # -- not ported yet ------------------------------------------------------
    def add_points(self, *a, **kw):
        _not_ported("ANNIndex.add_points", "10")

    def remove_points(self, *a, **kw):
        _not_ported("ANNIndex.remove_points", "10")

    def with_depth(self, *a, **kw):
        _not_ported("ANNIndex.with_depth", "10")

    def drop_tables(self, *a, **kw):
        _not_ported("ANNIndex.drop_tables", "10")

    def packed(self, *a, **kw):
        _not_ported("ANNIndex.packed (the packed layout)", "9")

    # -- persistence -----------------------------------------------------------
    def to_numpy_dict(self) -> dict:
        """The index as the JAX package's npz arrays."""
        arrays = dict(
            tables=self.tables.cpu().numpy(),
            counts=self.counts.cpu().numpy(),
            graph=self.graph.cpu().numpy(),
            meta=np.array([self.n, self.k, self.d, self.d_short, self.tries,
                           self.tmax]),
            metric=np.array(self.metric),
        )
        _stash(arrays, "row_means", self.row_means)
        _stash(arrays, "bases", self.bases)
        if self.points is not None:
            _stash(arrays, "points", self.points)
        if self.dead is not None:
            arrays["dead"] = self.dead.cpu().numpy()
        return arrays

    def save(self, path: str) -> None:
        np.savez_compressed(path, **self.to_numpy_dict())

    @classmethod
    def from_numpy(cls, arrays, device=None) -> "ANNIndex":
        """Build the port's index from the JAX index's arrays (the npz keys:
        tables, counts, graph, meta, metric, row_means, bases, optional
        points and dead, with ``<key>_dtype`` tags for half floats).  A data
        carrier: the tensors land on ``device``, and with ``device=None``
        they stay on the CPU where numpy made them; the caller places the
        index (``device="cuda"`` for the card)."""
        n, k, d, d_short, tries, tmax = (int(v) for v in arrays["meta"])
        return cls(
            row_means=_unstash(arrays, "row_means", device),
            bases=_unstash(arrays, "bases", device),
            tables=from_numpy(arrays["tables"], device=device),
            counts=from_numpy(arrays["counts"], device=device),
            graph=from_numpy(arrays["graph"], device=device),
            n=n, k=k, d=d, d_short=d_short, tries=tries, tmax=tmax,
            points=_unstash(arrays, "points", device),
            dead=from_numpy(arrays["dead"], device=device) if "dead" in arrays else None,
            metric=str(arrays["metric"]) if "metric" in arrays else "l2",
        )

    @classmethod
    def load(cls, path: str, device=None) -> "ANNIndex":
        """Read an npz index (see :meth:`from_numpy`: ``device=None`` leaves
        it on the CPU)."""
        with np.load(path) as z:
            return cls.from_numpy(z, device)
