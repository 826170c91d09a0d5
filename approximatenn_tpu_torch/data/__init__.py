"""Dataset layer (port of ``approximatenn_tpu/data``): benchmark corpora,
file formats, synthetic generators and metric preprocessing."""

from .datasets import SPECS, Dataset, ensure_groundtruth, load, synthesize
from .formats import read_any, read_vecs, vecs_info, write_vecs
from .preprocess import METRICS, normalize, prepare_points
from .synthetic import clustered_gaussian, gaussian

__all__ = [
    "SPECS", "Dataset", "ensure_groundtruth", "load", "synthesize",
    "read_any", "read_vecs", "vecs_info", "write_vecs",
    "METRICS", "normalize", "prepare_points",
    "clustered_gaussian", "gaussian",
]
