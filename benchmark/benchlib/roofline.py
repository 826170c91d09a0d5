"""The table of peaks and each kernel's operations and bytes.

A kernel's roofline share is the least time any implementation could take
for the call, the larger of its operations over the fastest data-sheet
rate for the configuration's stated precision and its bytes (each input
read once, each output written once) over HBM bandwidth, divided by the
kernel's time on the device.  The counts depend on the call's shapes only
(and, for the probe, on the distinct rows these inputs need), never on how
the kernel is written, so no share can pass 100% unless work is left out.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_OPS = {
    # float32 products at "highest": three TF32 passes is the fastest
    # implementation that keeps float32's ranking (TF32: 495 TFLOP/s)
    "float32": 495e12 / 3,
    "bfloat16": 989e12,
    "float16": 989e12,
    "int8": 1979e12,
}
HBM_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


def bound_s(ops: float, nbytes: float, precision: str) -> float:
    """Least seconds for ``ops`` operations and ``nbytes`` bytes."""
    return max(ops / PEAK_OPS[precision], nbytes / HBM_BYTES_PER_S)


def rank_call(n: int, d: int, m: int, k: int, storage: str, exclude: bool = False):
    """(operations, bytes) of one rank-kernel call: m queries against n
    stored rows of width d, k winners each (ids and distances out)."""
    ops = 2.0 * m * n * d
    nbytes = n * d * ELEM_BYTES[storage] + m * d * 4 + m * k * 8 + (m * 4 if exclude else 0)
    return ops, nbytes


def emit_call(n: int, d: int, m: int, seg: int, storage: str):
    """(operations, bytes) of one two-phase emit call: every query's least
    score and its row in each ``seg``-row segment."""
    n_seg = -(-n // seg)
    return 2.0 * m * n * d, n * d * ELEM_BYTES[storage] + m * d * 4 + m * n_seg * 8


def probe_call(slots: int, d: int, m: int, tries: int, probes: int, window: int, k: int,
               storage: str):
    """(operations, bytes) of one probe-kernel call: ``slots`` distinct
    stored rows read (the union of the windows these queries need), the
    starts in, per (query, table) k winners out.  Operations count one
    window's rows per (query, table), the least any pass can score."""
    ops = 2.0 * m * tries * window * d
    nbytes = slots * d * ELEM_BYTES[storage] + m * d * 4 + m * tries * probes * 4 \
        + m * tries * k * 8
    return ops, nbytes


def share_pct(bound: float, device_s: float) -> float | None:
    """Bound over time, in percent; None without a time."""
    if not device_s or device_s <= 0:
        return None
    return 100.0 * bound / device_s


# a kernel's group from its name in the device trace (mangled or not);
# split_merge_kernel belongs to the call that launched it just before
_GROUPS = (("RankSelect", "rank"), ("EmitSelect", "emit"), ("RescanSelect", "rescan_merge"),
           ("rescan_kernel", "rescan"), ("probe_kernel", "probe"),
           ("stream_kernel", "stream"))
# the program's launch counters each group's instances must match
LAUNCH_KEYS = {"rank": ("exact_knn",), "emit": ("twophase_emit",),
               "rescan": ("twophase_rescan", "twophase_rescan_all"),
               "probe": ("probe_topk",), "rescan_merge": ("exact_knn_rescan",),
               "stream": ("exact_knn_stream",)}


def kernel_group(name: str) -> str | None:
    for key, group in _GROUPS:
        if key in name:
            return group
    return None
