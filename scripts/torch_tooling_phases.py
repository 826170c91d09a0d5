"""The PyTorch port's tuner and tooling phases of ``chip_smoke.py`` alone,
on one CUDA card: ``[tune]`` on the packed-1M corpus (drawn as the smoke's
``packed`` phase draws it, from ``--seed``), ``[harness]`` and
``[parity_band]``, with the launch counts each path must show.  A quicker
rerun of those three phases than the whole smoke.

    PYTHONPATH=. python scripts/torch_tooling_phases.py [--seed 0]
"""

import argparse
import time

import numpy as np
import torch

import chip_smoke as cs
from approximatenn_tpu_torch.ops import exact as ex
from approximatenn_tpu_torch.utils.runtime import card_name_and_limit


def read_counts(path: str, need: tuple) -> None:
    counts = dict(ex.launches)
    cs.phase("counts", f"{path}: " + ", ".join(f"{a} {b}" for a, b in counts.items()))
    for name in need:
        if counts[name] < 1:
            raise AssertionError(f"{path}: kernel {name} was not launched")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cs.phase("env", f"card [{card_name_and_limit()}]")
    t0 = time.perf_counter()
    ex.build_libraries()
    cs.phase("build", f"kernels in {time.perf_counter() - t0:.2f} s")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    xc = cs.clustered_gaussian(rng, cs.N, 128, n_clusters=cs.N_CLUSTERS)
    yc = xc[rng.integers(0, cs.N, cs.M)] + 0.1 * cs.gaussian(rng, cs.M, 128)
    Xc = torch.from_numpy(xc).to(dev)
    Yc = torch.from_numpy(yc.astype(np.float32)).to(dev)
    del xc
    cs.tune_phase(Xc, Yc, args.seed, read_counts)
    cs.harness_phase(args.seed, read_counts)
    cs.parity_band(read_counts)


if __name__ == "__main__":
    main()
