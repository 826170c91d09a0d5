"""Checkpoints of the sharded index and its packed view (port of
``approximatenn_tpu/parallel/checkpoint.py``).

A checkpoint is a directory in the JAX package's npz layout: ``meta.json``
with the JAX keys and ``format: "npz"``, and ``arrays.npz`` holding the
stacked arrays (a leading shard axis, or the whole row-sharded corpus),
half floats as uint16 words beside a ``<key>_dtype`` tag
(``index.py:_stash``).  A checkpoint that the JAX package writes without
orbax loads here, and one written here loads in the JAX package's npz
branch.

Saving is a collective: every rank calls it with the mesh, each rank
sends its shard to rank 0 (one shard in flight at a time), rank 0 writes
and a barrier follows.  Loading: every rank reads the files and keeps its
own slice on ``mesh.device``; the shard count must be the mesh's.  An
orbax checkpoint (``format: "orbax"``) raises ``ValueError``, and saving
from a process group that spans more than one host raises
``RuntimeError``, as the JAX npz branch does beyond one process: the
files are written on rank 0's host and read on every rank's.
"""

from __future__ import annotations

import json
import socket
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..index import _stash, _unstash
from .sharded import Mesh, ShardedIndex, ShardedPacked, _all_gather_stacked, _gather_stacked

_META_FIELDS = ("n", "n_local", "k", "d", "d_short", "tries", "tmax", "n_shards")
_PK_ARRAY_FIELDS = ("point_rows", "ids", "starts")  # leading shard axis


def _dtype_name(dtype: torch.dtype) -> str:
    """The JAX name of a torch type ("float32", "bfloat16", "int8", ...)."""
    return str(dtype).replace("torch.", "")


def _check_one_host(mesh: Mesh) -> None:
    """Raise ``RuntimeError`` when the mesh's ranks run on more than one
    host (their host names, all-gathered, differ)."""
    if mesh.size == 1:
        return
    name = socket.gethostname().encode()[:255].ljust(256, b"\0")
    names = _all_gather_stacked(mesh, torch.frombuffer(bytearray(name), dtype=torch.uint8)
                                .to(mesh.device))
    if not bool((names == names[0]).all()):
        raise RuntimeError("the npz checkpoint is written on one host and read on every "
                           "rank's: this process group spans more than one host")


def _write_files(mesh: Mesh, path, meta: dict | None, arrays: dict | None = None,
                 meta_file: str = "meta.json") -> None:
    """Rank 0 writes ``arrays.npz`` (when ``arrays`` is given) and
    ``meta`` as ``meta_file`` under ``path`` (the other ranks may pass
    None); every rank returns once they exist."""
    path = Path(path)
    if mesh.rank == 0:
        path.mkdir(parents=True, exist_ok=True)
        if arrays is not None:
            np.savez(path / "arrays.npz", **arrays)
        (path / meta_file).write_text(json.dumps(meta))
    if mesh.size > 1:
        dist.barrier(group=mesh.group)


def _check_format(meta: dict, path) -> None:
    """``ValueError`` unless the checkpoint's metadata names the npz layout."""
    if meta.get("format") != "npz":
        raise ValueError(f"{path}: a {meta.get('format')!r} checkpoint; only the npz layout "
                         "is read here (orbax is not supported: save it again with the JAX "
                         "package where orbax is not installed)")


def _read_meta(path) -> dict:
    """A checkpoint's ``meta.json``, checked by :func:`_check_format`."""
    meta = json.loads((Path(path) / "meta.json").read_text())
    _check_format(meta, path)
    return meta


def _read_scale(z, device):
    """The stored () float32 scale, or None."""
    return torch.tensor(np.asarray(z["scale"], np.float32), device=device) if "scale" in z \
        else None


def save_sharded_index(sidx: ShardedIndex, path, mesh: Mesh) -> None:
    """Persist a :class:`~.sharded.ShardedIndex` (a collective: every rank
    calls it with the index's mesh)."""
    _check_one_host(mesh)
    arrays = sidx.to_numpy(mesh, rank0_only=True)
    meta = None
    if arrays is not None:  # rank 0
        del arrays["meta"], arrays["metric"]  # they go to meta.json
        meta = {f: getattr(sidx, f) for f in _META_FIELDS}
        meta.update(metric=sidx.metric, has_points=sidx.points is not None, format="npz")
        if sidx.points is not None:
            # the metric-prepared corpus (serving angular needs the unit rows)
            meta["points_dtype"] = _dtype_name(sidx.points.dtype)
    _write_files(mesh, path, meta, arrays)


def load_sharded_index(path, mesh: Mesh) -> ShardedIndex:
    """This rank's shard of a saved index on ``mesh.device``; the shard
    count must be the mesh's (``ValueError``)."""
    path = Path(path)
    meta = _read_meta(path)
    if meta["n_shards"] != mesh.size:
        raise ValueError(f"mesh has {mesh.size} shards but index was built with "
                         f"{meta['n_shards']}")
    with np.load(path / "arrays.npz") as z:
        arrays = {key: z[key] for key in z.files}
    pts = arrays.get("points")
    if pts is not None and pts.dtype.kind == "V":
        # a JAX half-float corpus, which its save writes untagged
        arrays["points"] = pts.view(np.uint16)
        arrays["points_dtype"] = np.array(meta["points_dtype"])
    arrays["meta"] = np.array([meta[f] for f in _META_FIELDS])
    arrays["metric"] = np.array(meta.get("metric", "l2"))
    return ShardedIndex.from_numpy(arrays, mesh)


def save_sharded_packed(spk: ShardedPacked, path, mesh: Mesh) -> None:
    """Persist a :class:`~.sharded.ShardedPacked` (a collective, as
    :func:`save_sharded_index`).  The rows keep width d: ``d_pad`` is d,
    the port having no 128-lane padding."""
    _check_one_host(mesh)
    tensors = {f: _gather_stacked(mesh, getattr(spk, f), rank0_only=True)
               for f in _PK_ARRAY_FIELDS}
    meta = arrays = None
    if mesh.rank == 0:
        if spk.scale is not None:
            tensors["scale"] = spk.scale.detach().cpu()
        meta = dict(n_pad_l=spk.n_pad_l, d_pad=spk.point_rows.shape[1], window=spk.window,
                    super_width=spk.super_width, has_scale=spk.scale is not None,
                    shapes={f: [list(v.shape), _dtype_name(v.dtype)]
                            for f, v in tensors.items()},
                    format="npz")
        arrays = {}
        for f, v in tensors.items():
            _stash(arrays, f, v)
    _write_files(mesh, path, meta, arrays)


def load_sharded_packed(path, mesh: Mesh, d: int | None = None) -> ShardedPacked:
    """This rank's packed view of a saved one on ``mesh.device`` (the shard
    count must be the mesh's, ``ValueError``).  ``d``: the logical width;
    lanes past it (the JAX package's zero lane padding to ``d_pad``) are
    dropped."""
    path = Path(path)
    meta = _read_meta(path)
    saved = meta["shapes"]["point_rows"][0][0]
    if saved != mesh.size:
        raise ValueError(f"mesh has {mesh.size} shards but the packed view was saved with "
                         f"{saved}")
    r, dev = mesh.rank, mesh.device
    with np.load(path / "arrays.npz") as z:
        rows, ids, starts = (_unstash(z, f, None)[r] for f in _PK_ARRAY_FIELDS)
        scale = _read_scale(z, dev)
    if d is not None:
        rows = rows[:, :d]
    return ShardedPacked(point_rows=rows.contiguous().to(dev), ids=ids.to(dev),
                         starts=starts.to(dev), scale=scale, n_pad_l=meta["n_pad_l"],
                         window=meta["window"], super_width=meta["super_width"])
