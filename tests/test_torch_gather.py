"""The two gather kernels' launch geometry, on the CPU: the row scorer's
lane groups (``ops/exact.py:gather_geometry``, shared by the probe and the
two-phase rescan, ``csrc/knn_gather.cuh``), the rescan's split count
(``ops/twophase.py:rescan_splits``) and its split boundaries, mirrored in
``rescan_windows_plain_by_splits``.  The kernels themselves are held
against their plain versions by the ``cuda``-marked cases of
tests/test_torch_probe.py and tests/test_torch_twophase.py.
"""

import numpy as np
import pytest
import torch

from approximatenn_tpu_torch.ops import exact as ex
from approximatenn_tpu_torch.ops import twophase as tp

SMS = 132  # the H100 SXM
ITEMSIZE = {"f32": 4, "bf16": 2, "f16": 2, "int8": 1}


@pytest.mark.parametrize("dt", sorted(ITEMSIZE))
@pytest.mark.parametrize("d", [33, 96, 128])
def test_gather_geometry(dt, d):
    """16-byte loads wherever a row's bytes allow them (d = 96 and 128 in
    every type), a narrower vector that divides the row otherwise (d = 33:
    4-byte f32, 2-byte bf16/f16, 1-byte int8 loads); lane groups of the
    least power of two in [R, 32] that covers a row in two passes; a data
    pointer off the vector's alignment narrows the load."""
    size = ITEMSIZE[dt]
    v, g = ex.gather_geometry(d, size)
    row_bytes = d * size
    assert row_bytes % v == 0 and size <= v <= 16
    assert v == (16 if row_bytes % 16 == 0 else {33: size}[d])
    assert g & (g - 1) == 0 and ex.GATHER_ROWS <= g <= 32
    nvec = row_bytes // v
    assert 2 * g >= nvec or g == 32  # two passes a row where 32 lanes allow it
    assert g == ex.GATHER_ROWS or nvec > g  # and no more lanes than that
    if d == 128:
        assert (v, g) == (16, {"f32": 16, "bf16": 8, "f16": 8, "int8": 4}[dt])
    # a pointer aligned to 4 bytes only (an offset view) takes 4-byte loads
    if size <= 4 and row_bytes % 16 == 0:
        assert ex.gather_geometry(d, size, ptr=4)[0] == 4
    assert ex.gather_geometry(d, size, lanes=32)[1] == 32
    for bad in (2, 3, 64):
        with pytest.raises(ValueError):
            ex.gather_geometry(d, size, lanes=bad)


def test_rescan_split_count():
    """One block a query at the serving shape (m = 1000, P = 12), many for
    add_points' emit-all blocks (m = 26 queries, P = 10,013 windows), never
    more than the 32 lists split_merge_kernel merges nor an empty split,
    whatever the number of resident blocks an SM holds."""
    for per_sm in range(1, 9):
        assert tp.rescan_splits(1000, 12, SMS, per_sm) == 1
        s = tp.rescan_splits(26, 10_013, SMS, per_sm)
        assert 5 <= s <= 32
        assert 26 * s >= 7 / 8 * SMS * per_sm or s == 32  # the slots filled
        assert s == 1 or 26 * (s - 1) < 7 / 8 * SMS * per_sm  # by the fewest splits
    for m in (1, 2, 26, 100, 1000, 65_536):
        for P in (1, 3, 12, 130, 10_013):
            for per_sm in (1, 4, 8):
                s = tp.rescan_splits(m, P, SMS, per_sm)
                per = -(-P // s)
                assert 1 <= s <= min(32, P) and -(-P // per) == s
                assert (s - 1) * per < P  # the last split holds a window


def _windows(rng, n, d, m, P, seg):
    """Corpus, queries and per-query window starts: distinct segments in
    random order, then exhausted picks (start n) past the segments."""
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    n_seg = -(-n // seg)
    starts = np.full((m, P), n, dtype=np.int32)
    for i in range(m):
        segs = rng.permutation(n_seg)[:P]
        starts[i, :segs.size] = segs * seg
    return x, q, torch.from_numpy(starts)


@pytest.mark.parametrize("k", [1, 10, 128, None])
@pytest.mark.parametrize("seg", [32, 128, 512])
def test_rescan_plain_by_splits_is_the_plain_version(seg, k):
    """The rescan's plain version cut at the kernel's split boundaries
    equals the plain version in ids and distances: selecting (k = 1, 10,
    128) and emit-all, with a partial last segment, exhausted windows and
    P x seg past n."""
    rng = np.random.default_rng(seg + (k or 0))
    n = 5 * seg + seg // 3  # a partial last segment
    P = 8  # more windows than the 6 segments: two exhausted picks a query
    assert P * seg > n
    x, q, starts = _windows(rng, n, 16, 7, P, seg)
    ia, da = tp.rescan_windows_plain(x, q, starts, seg, k)
    assert (starts == n).sum() == 7 * (P - 6)
    for n_splits in (1, 2, 3, 5, P):
        ib, db = tp.rescan_windows_plain_by_splits(x, q, starts, seg, k, n_splits)
        assert torch.equal(ia, ib) and torch.equal(da, db), n_splits
    if k is not None:  # past the real rows: (n, +inf)
        real = (n - starts.long().clamp(max=n)).clamp(max=seg).sum(1)
        assert bool((torch.isinf(da) == (torch.arange(k)[None] >= real[:, None])).all())
        assert bool((ia[torch.isinf(da)] == n).all())
