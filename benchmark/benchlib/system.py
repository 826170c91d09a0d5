"""The system under test, as the benchmark drives it: the port's ``Server``
built from a configuration's serving spec, its search and build entries,
its launch counters, and the controls that stand in its place.

This is the only file of the benchmark that imports the program
(``approximatenn_tpu_torch``); it imports it when an engine is made, never
when this module is imported.
"""

from __future__ import annotations

import time
import warnings
from types import SimpleNamespace

import torch

from . import reference as ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
          "int8": torch.int8}
_DTYPE_KEYS = ("storage_dtype", "packed_dtype")


def server_kwargs(spec: dict) -> dict:
    """``Server.build`` keywords from a serving spec (dtype names mapped)."""
    kw = {key: v for key, v in spec.items() if not key.startswith("_")}
    for key in _DTYPE_KEYS:
        if key in kw:
            kw[key] = DTYPES[kw[key]]
    return kw


def prepare() -> float:
    """Build (first run of a checkout) or find the program's kernel
    libraries; returns the seconds it took."""
    from approximatenn_tpu_torch.ops.exact import build_libraries

    t = time.perf_counter()
    build_libraries()
    return time.perf_counter() - t


def launch_counts() -> dict:
    from approximatenn_tpu_torch.ops.exact import launches

    return dict(launches)


class ServerEngine:
    """Search through ``Server.search`` of a server built once."""

    def __init__(self, corpus, k: int, spec: dict, seed: int):
        from approximatenn_tpu_torch import Server

        kw = server_kwargs(spec)
        if kw.get("mode") == "hash":
            kw.setdefault("seed", seed)
        self.server = Server.build(corpus, k, **kw)

    def search(self, q_host: torch.Tensor):
        return self.server.search(q_host)

    def describe(self) -> dict:
        return self.server.describe()

    def index_state(self):
        """(index, packed view) of a hash server, as the check reads them."""
        return self.server.index, self.server.packed


class ReferenceSearch:
    """The control of a float32 exact configuration: exhaustive search with
    TF32 products, in the program's place."""

    def __init__(self, corpus, k: int):
        self.corpus, self.k = corpus, k

    def search(self, q_host: torch.Tensor):
        q = q_host.to(self.corpus.device)
        ids, d = ref.knn(self.corpus, q, self.k, precision="tf32",
                         corpus_block=self.corpus.shape[0], query_block=q.shape[0])
        return ids.int(), d

    def describe(self) -> dict:
        return {"control": "reference search with TF32 products"}


class ReferenceHashSearch:
    """The control of a float32 hash configuration: the reference's index
    (:func:`reference_build`: TF32 projections and exact graph) and its
    packed search with TF32 projections and distances, in the program's
    place."""

    def __init__(self, corpus, k: int, spec: dict, seed: int):
        self.built = reference_build(corpus, k, spec, seed)
        idx = self.built.index
        self.ref = ref.HashReference(
            corpus, k=k, seed=seed, tries=spec["tries"], n_probes=spec["n_probes"],
            window=spec["window"], row_dtype=DTYPES[spec["packed_dtype"]],
            bases=idx.bases_f64, mean=idx.mean, codes=idx.codes, graph=idx.graph,
            precision="tf32")

    def search(self, q_host: torch.Tensor):
        # blocks of 128 queries: the reference's gathers stay near 1 GB
        ids, d, _, _ = self.ref.search(q_host.to(self.ref.corpus.device), block=128)
        return ids.int(), d.float()

    def describe(self) -> dict:
        return {"control": "reference hash index and search with TF32 products"}

    def index_state(self):
        return self.built.index, self.built.packed


def server_build(corpus, k: int, spec: dict, seed: int, stage_times=None):
    """One whole build of a hash index, as served: ``Server.build`` on the
    spec, with the build's ``seed``; the card is fenced before it returns."""
    from approximatenn_tpu_torch import Server

    kw = server_kwargs(spec)
    kw["seed"] = seed
    if stage_times is not None:
        kw["stage_times"] = stage_times
    srv = Server.build(corpus, k, **kw)
    if corpus.device.type == "cuda":
        torch.cuda.synchronize(corpus.device)
    return srv


def reference_build(corpus, k: int, spec: dict, seed: int, stage_times=None):
    """The control of a float32 build: the reference's index, its hash
    projections and its exact graph computed with TF32 products."""
    n, d = corpus.shape
    tries = spec["tries"]
    bases = ref.sample_bases(seed, n, k, d, tries).to(corpus.device)
    mean = corpus.mean(0)
    codes = ref.corpus_codes(corpus, mean, bases, precision="tf32")
    lay = ref.layout(codes, 1 << bases.shape[1], spec.get("capacity"))
    rows = ref.stored_rows(corpus, lay.ids.reshape(-1), DTYPES[spec.get("packed_dtype",
                                                                      "float32")])
    own = torch.arange(n, device=corpus.device)
    graph, _ = ref.knn(corpus, corpus, k, exclude=own, precision="tf32")
    index = SimpleNamespace(bases=bases.float(), tables=lay.tables, counts=lay.counts,
                            graph=graph, bases_f64=bases, mean=mean.to(ref.F64),
                            codes=codes)
    packed = SimpleNamespace(ids=lay.ids, starts=lay.starts, point_rows=rows, graph=graph)
    return SimpleNamespace(index=index, packed=packed)


def count_syncs(fn) -> int:
    """Host syncs ``fn()`` makes, counted by
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchronizing CUDA operation" in str(w.message) for w in caught)
