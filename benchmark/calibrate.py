"""Read the numbers that set a cell's limits: the program on many seeds, the
control on a few, and planted faults on a few, each a whole run (set-up,
a short window at the cell's own load, the check), all in one process so
the set-up is paid once.

    python benchmark/calibrate.py --workload <cell> --seconds 3 \\
        --seeds 101 102 ... --control-seeds 201 202 203 \\
        [--faults drop_table drop_probes --fault-seeds 301 302 303]

Prints one JSON line a run ({"seed", "control", "fault", "correct",
"checks", "metrics"}) and a last line with, for each number, the largest
reading of the program (the lower reading), the smallest of the control
and of each fault that reads three times the lower or more (the upper
reading), and the limits :func:`limit` sets from them.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


# compared exactly: the limit is 0 whatever the control reads
EXACT = ("layout_errors",)


def limit(name: str, lower: float, upper: float | None):
    """The limit set from the two readings: 0 for an exact comparison; none
    where the control does not read three times the program or more;
    otherwise two thirds of the way from the lower to the upper reading on
    a log scale (upper / 3 where the lower reads 0), so that fresh seeds
    find more room above the lower reading than the control finds below
    the upper one."""
    if name in EXACT:
        return 0.0
    if upper is None or upper < 3 * lower or upper <= 0:
        return None
    if lower <= 0:
        return upper / 3
    return lower ** (1 / 3) * upper ** (2 / 3)


def upper_readings(lower: dict, sides: dict) -> dict:
    """Per number, the smallest reading of the control or of a fault, over
    the sides (control, each fault) whose smallest reading of it is three
    times the lower reading or more; a side that reads less is another
    number's to catch."""
    out: dict = {}
    for side in sides.values():
        for k, v in side.items():
            if v > 0 and v >= 3 * lower.get(k, 0.0):
                out[k] = min(out.get(k, v), v)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from benchlib import faults
    from benchlib.harness import load_cell, make_run

    cell = load_cell(args.workload)
    lower: dict = {}
    sides: dict = {}
    runs = ([(s, False, None) for s in args.seeds]
            + [(s, True, None) for s in args.control_seeds]
            + [(s, False, f) for f in args.faults for s in args.fault_seeds])
    for seed, control, fault in runs:
        wrap = faults.wrap(fault) if fault else None
        result = make_run(cell, seed, args.seconds, False, device="cuda:0", control=control,
                          wrap=wrap).run()
        numbers = {k: v["value"] for k, v in result["checks"].items()}
        print(json.dumps({"seed": seed, "control": control, "fault": fault,
                          "correct": result["correct"], "checks": numbers,
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()}}),
              flush=True)
        if control or fault:
            side = sides.setdefault("control" if control else fault, {})
            for k, v in numbers.items():
                side[k] = min(side.get(k, v), v)
        else:
            for k, v in numbers.items():
                lower[k] = max(lower.get(k, v), v)
        torch.cuda.empty_cache()
    upper = upper_readings(lower, sides)
    print(json.dumps({"workload": cell.name, "lower": lower, "upper": upper,
                      "sides": sides,
                      "limits": {k: limit(k, v, upper.get(k)) for k, v in lower.items()},
                      "seeds": args.seeds, "control_seeds": args.control_seeds,
                      "faults": args.faults, "fault_seeds": args.fault_seeds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
