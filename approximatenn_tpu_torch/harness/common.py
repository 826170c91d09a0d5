"""Shared CLI plumbing for the harnesses (port of
``approximatenn_tpu/harness/common.py``).

Flag vocabulary mirrors the reference harnesses (its
``test_correctness.c:30-93``): ``-n -k -d -t -o -y -b -s -a -r -v -c -z -h``
with identical meanings and defaults (n=1000, k=10, d=80, tries=10, o=100,
ycnt=50, rots_before=6 len 1, rots_after=1 len 1).  ``-c`` runs on the CPU
(role of ``use_cpu``), the numerical oracle; without it the harness runs
on the CUDA card and fails where there is none.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def make_parser(prog: str, desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=prog, description=desc)
    p.add_argument("-n", type=int, default=1000, help="point count (default 1000)")
    p.add_argument("-k", type=int, default=10, help="nearest neighbors (default 10)")
    p.add_argument("-d", type=int, default=80, help="dimensionality (default 80)")
    p.add_argument("-t", dest="tries", type=int, default=10, help="try count (default 10)")
    p.add_argument("-o", dest="average_over", type=int, default=100,
                   help="repetitions to average over (default 100)")
    p.add_argument("-y", dest="ycnt", type=int, default=None,
                   help="query-point count (enables query mode)")
    p.add_argument("-z", action="store_true", help="query mode with default ycnt=50")
    p.add_argument("-b", dest="rots_before", type=int, default=6,
                   help="pre-Walsh rotation count (default 6)")
    p.add_argument("-s", dest="rot_len_before", type=int, default=1,
                   help="pre-Walsh rotation size (default 1)")
    p.add_argument("-a", dest="rots_after", type=int, default=1,
                   help="post-Walsh rotation count (default 1)")
    p.add_argument("-r", dest="rot_len_after", type=int, default=1,
                   help="post-Walsh rotation size (default 1)")
    p.add_argument("-v", dest="verbose", action="store_true", help="progress output")
    p.add_argument("-c", dest="use_cpu", action="store_true",
                   help="run on the CPU (the numerical oracle) instead of the card")
    p.add_argument("--seed", type=int, default=None, help="PRNG seed (default: time)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"],
                   help="element type (role of ftype.h's -DUSE_FLOAT switch)")
    return p


def resolve_backend(use_cpu: bool) -> torch.device:
    """The device to run on: the CPU for ``-c``, else the CUDA card.
    Without a card and without ``-c`` this raises: a harness never
    quietly runs on the CPU."""
    if use_cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass -c to run on the CPU")
    return torch.device("cuda")


def gen_gaussian(rng: np.random.Generator, n: int, d: int, dtype) -> np.ndarray:
    """Gaussian test data (role of the reference's ``genRand``)."""
    return rng.standard_normal((n, d)).astype(dtype)


def np_dtype(name: str):
    return {"float32": np.float32, "float64": np.float64, "bfloat16": np.float32}[name]


def seeded_generator(rng: np.random.Generator) -> torch.Generator:
    """A CPU ``torch.Generator`` seeded from ``rng`` (the role of a fresh
    ``jax.random`` key): a build given it draws the same bases on any
    device."""
    return torch.Generator().manual_seed(int(rng.integers(2**63)))
