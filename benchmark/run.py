"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix, the kind of run the mix names,
limits and per-layer metrics are found by name from ``BENCHMARK.json`` at
the checkout's root.  The run
draws its inputs on the card from ``--seed``, sets up and warms up
(``setup_s``), runs the traffic for ``--seconds``, checks the answers the
window produced against the plain reference, and prints one JSON line as
the last line of standard output; the compared numbers and their limits
are the last lines of standard error.  Without a CUDA card, with fewer
cards than the cell asks for, or with the JAX package loaded after the
window, it exits non-zero and prints no result.

``--control`` puts the cell's control in the program's place (the numbers
that set the limits); the benchmark's own runs never pass it.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the program under test sits at the checkout's root, the library here
for p in (str(ROOT), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "approximatenn_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``approximatenn_tpu_torch`` is not ``approximatenn_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def report(result: dict, run) -> None:
    """Everything but the result line goes to standard error; the compared
    numbers and their limits come last there."""
    from benchlib.harness import card_line

    err = sys.stderr
    print(f"card: {card_line()}", file=err)
    print(f"workload {run.cell.name} seed {run.seed} seconds {run.seconds} "
          f"trace {int(run.trace)} control {int(run.control)}", file=err)
    if getattr(run, "describe_line", None):
        print(f"server: {json.dumps(run.describe_line)}", file=err)
    if hasattr(run, "kernel_build_s"):
        print(f"kernel libraries ready in {run.kernel_build_s:.3f} s", file=err)
    for name, m in result["metrics"].items():
        print(f"metric {name} {m['value']!r} {m['unit']}", file=err)
    print(f"device {json.dumps(result['device'])}", file=err)
    for name, c in result["checks"].items():
        lim = "none" if c["limit"] is None else repr(c["limit"])
        print(f"check {name} {c['value']!r} limit {lim}", file=err)
    err.flush()


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only", file=sys.stderr)
        return 2
    from benchlib.harness import load_cell, make_run

    cell = load_cell(args.workload)
    if torch.cuda.device_count() < int(cell.workload["chips"]):
        print(f"{cell.name} needs {cell.workload['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    run = make_run(cell, args.seed, args.seconds, bool(args.trace), device="cuda:0",
                   control=args.control, t0=T0)
    result = run.run()
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    report(result, run)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
