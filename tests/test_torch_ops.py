"""Parity of the PyTorch port's ops with their JAX twins on the CPU.

Inputs are made from a seed with numpy and handed to both packages.
Integer outputs must be equal; float outputs agree at rtol=1e-5,
atol=1e-5 (the two frameworks sum in different orders).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from approximatenn_tpu.ops import buckets as jb
from approximatenn_tpu.ops import distance as jd
from approximatenn_tpu.ops import hash as jh
from approximatenn_tpu.ops import topk as jt
from approximatenn_tpu.ops import transforms as jtr
from approximatenn_tpu_torch.ops import buckets as tb
from approximatenn_tpu_torch.ops import distance as td
from approximatenn_tpu_torch.ops import hash as th
from approximatenn_tpu_torch.ops import topk as tt
from approximatenn_tpu_torch.ops import transforms as ttr

torch.set_num_threads(1)

RTOL = ATOL = 1e-5


def T(a):
    return torch.from_numpy(np.array(a))


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d_short", [0, 5, 17])
def test_pack_signs(rng, d_short):
    x = rng.standard_normal((64, d_short)).astype(np.float32)
    if d_short:
        x[0, 0] = -0.0  # the IEEE sign bit counts: -0.0 is negative
        x[1, 0] = 0.0
    out = th.pack_signs(T(x))
    assert out.dtype == torch.int32
    eq(out, jh.pack_signs(jnp.asarray(x)))
    if d_short:
        assert int(out[0]) >> (d_short - 1) == 1 and int(out[1]) >> (d_short - 1) == 0


def test_query_codes_and_probes(rng):
    tries, ds, d = 3, 7, 16
    x = rng.standard_normal((200, d)).astype(np.float32)
    bases = rng.standard_normal((tries, ds, d)).astype(np.float32)
    means = rng.standard_normal((d,)).astype(np.float32)
    jc, jp = jh.query_codes(jnp.asarray(means), jnp.asarray(bases), jnp.asarray(x))
    tc, tp = th.query_codes(T(means), T(bases), T(x))
    close(tp, jp)
    # a projection within rounding of zero may take either sign
    assert np.mean(np.asarray(tc) == np.asarray(jc)) >= 0.995
    eq(th.probe_codes(T(np.asarray(jc)), ds), jh.probe_codes(jc, ds))
    for n_probes in (2, 6, 40):  # 40 > 1 + 7 + 21: pads with the own code
        eq(th.probe_codes_directed(T(np.asarray(jc)), T(np.asarray(jp)), n_probes),
           jh.probe_codes_directed(jc, jp, n_probes))


def test_build_tables_with_overflow(rng):
    tries, n, ds = 3, 500, 5
    # skewed codes so a pinned capacity overflows: stable order decides drops
    codes = (rng.zipf(1.5, (tries, n)) % (1 << ds)).astype(np.int32)
    for cap in (4, 60):
        jt_ = jb.build_tables(jnp.asarray(codes), 1 << ds, cap, n)
        tt_ = tb.build_tables(T(codes), 1 << ds, cap, n)
        assert tt_.dtype == torch.int32
        eq(tt_, jt_)
    eq(torch.stack([tb.bucket_counts(T(c), 1 << ds) for c in codes]),
       np.stack([np.asarray(jb.bucket_counts(jnp.asarray(c), 1 << ds)) for c in codes]))
    table = np.asarray(jb.build_table(jnp.asarray(codes[0]), 1 << ds, 8, n))
    q = codes[1, :40]
    eq(tb.multiprobe_gather(T(table), T(q), ds),
       jb.multiprobe_gather(jnp.asarray(table), jnp.asarray(q), ds))


def test_candidate_dists(rng):
    n, m, L, d = 300, 20, 50, 12
    p = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((m, d)).astype(np.float32)
    cand = rng.integers(0, n + 1, (m, L)).astype(np.int32)  # n = sentinel
    rows = rng.integers(0, n, (m,)).astype(np.int32)
    cand[:, 0] = rows  # make the self-exclusion bite
    for method in ("diff", "dot"):
        jo = jd.candidate_dists(jnp.asarray(q), jnp.asarray(p), jnp.asarray(cand),
                                exclude_self=jnp.asarray(rows), method=method)
        to = td.candidate_dists(T(q), T(p), T(cand), exclude_self=T(rows),
                                method=method)
        close(to, jo)
        assert np.isinf(np.asarray(to)[:, 0]).all()


@pytest.mark.parametrize("which", ["dedup_topk", "dedup_topk_sort"])
@pytest.mark.parametrize("k", [5, 30])
def test_dedup_topk(rng, which, k):
    m, L, n = 16, 24, 40
    ids = rng.integers(0, n + 1, (m, L)).astype(np.int32)  # duplicates + sentinels
    dd = rng.random((m, L)).astype(np.float32)
    dd[ids == n] = np.inf
    ji, jdd = getattr(jt, which)(jnp.asarray(ids), jnp.asarray(dd), k, n)
    ti, tdd = getattr(tt, which)(T(ids), T(dd), k, n)
    eq(ti, ji)
    close(tdd, jdd)
    ji, jdd = jt.merge_topk(jnp.asarray(ids), jnp.asarray(dd), jnp.asarray(ids[::-1]),
                            jnp.asarray(dd[::-1]), k, n)
    ti, tdd = tt.merge_topk(T(ids), T(dd), T(ids[::-1]), T(dd[::-1]), k, n)
    eq(ti, ji)
    close(tdd, jdd)


@pytest.mark.parametrize("k", [3, 12, 130])
def test_topk_iter_and_no_dedup(rng, k):
    dd = rng.random((9, 10)).astype(np.float32)
    dd[0, 3] = np.inf
    dd[1, :] = np.inf  # an exhausted row: argmin keeps returning position 0
    jj, jv = jt.topk_iter(jnp.asarray(dd), k)
    tj, tv = tt.topk_iter(T(dd), k)
    eq(tj, jj)
    close(tv, jv)
    ids = rng.permutation(90).reshape(9, 10).astype(np.int32)
    ji, jv = jt.topk_no_dedup(jnp.asarray(dd), jnp.asarray(ids), k)
    ti, tv = tt.topk_no_dedup(T(dd), T(ids), k)
    eq(ti, ji)
    close(tv, jv)
    si, sd = tt.sentinel_pad(T(ids), T(dd), 50)
    ji, jv = jt.sentinel_pad(jnp.asarray(ids), jnp.asarray(dd), 50)
    eq(si, ji)
    close(sd, jv)


def test_brute_force_knn(rng):
    p = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((40, 16)).astype(np.float32)
    ji, jv = jd.brute_force_knn(jnp.asarray(p), jnp.asarray(q), 7)
    ti, tv = td.brute_force_knn(T(p), T(q), 7)
    assert ti.dtype == torch.int32
    eq(ti, ji)
    close(tv, jv)
    ji, jv = jd.brute_force_knn_self(jnp.asarray(p), 5)
    ti, tv = td.brute_force_knn_self(T(p), 5)
    eq(ti, ji)
    close(tv, jv)
    assert not (ti.numpy() == np.arange(300)[:, None]).any()


def test_materialize_bases_from_jax_params():
    d, tries = 24, 3
    ds, d_max = jtr.derive_dims(1000, 10, d)
    assert ttr.derive_dims(1000, 10, d) == (ds, d_max)
    params = jtr.sample_ortho_params_batch(jax.random.key(3), tries, d, d_max, 6, 2, 1, 3)
    tparams = ttr.OrthoParams(*(T(f) for f in params))
    close(ttr.materialize_bases(tparams, d, ds, torch.float32),
          jtr.materialize_bases(params, d, ds, jnp.float32))
    x = np.random.default_rng(0).standard_normal((5, d_max)).astype(np.float32)
    close(ttr.walsh(T(x)), jtr.walsh(jnp.asarray(x)))


def test_derive_dims_and_sampling_edges():
    # n < k wraps in the reference's unsigned arithmetic: clamp to d_max
    for args in [(5, 10, 20), (10, 10, 20), (1 << 20, 10, 128), (100, 10, 1)]:
        assert ttr.derive_dims(*args) == jtr.derive_dims(*args)
    assert ttr.next_pow2(1) == 1 and ttr.next_pow2(96) == 128
    g = torch.Generator().manual_seed(0)
    p = ttr.sample_ortho_params_batch(g, 4, 32, 32, 6, 1, 1, 2, dtype=torch.float64)
    B = ttr.materialize_bases(p, 32, 6, torch.float64)
    assert B.shape == (4, 6, 32)
    # orthonormal rows (d a power of two: the embed is a permutation)
    eye = torch.eye(6, dtype=torch.float64).expand(4, 6, 6)
    assert torch.allclose(B @ B.transpose(1, 2), eye, atol=1e-12)
    assert math.isclose(float(B.norm(dim=2).mean()), 1.0, rel_tol=1e-12)
