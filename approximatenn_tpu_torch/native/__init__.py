"""Native (C++) host runtime (port of ``approximatenn_tpu/native``):
ground-truth oracle, bucket-table builder and rank scoring, the
equivalents of the reference's C host side.  Compiled at first use; numpy
fallbacks keep everything working without g++."""

from .lib import available, brute_force_knn, bucket_table, rank_guesses

__all__ = ["available", "brute_force_knn", "bucket_table", "rank_guesses"]
