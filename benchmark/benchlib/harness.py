"""One run of one cell: draw the inputs, set up, run the window, read the
trace, check the answers, and assemble the result line.

The cell's files are found by name: its configuration through
``BENCHMARK.json``, its traffic mix in ``traffic/<mix>.json``, the kind of
run that mix names (its loop, its end-to-end quantities and its check) in
``kinds/<kind>.py``, its limits in ``limits/<cell>.json`` and each
per-layer metric's reader in ``metrics/<metric>.py``, all under the
benchmark's folder.  A metric name ``a.b.c`` with no file of its own takes
the reader of its longest dotted prefix that has one, and an end-to-end
name the kind's quantity of its longest dotted prefix, so that a metric
split by configuration (``exact_qps.sift-1m``) needs no code.  Adding a
cell, a mix, a kind or a metric adds files and entries; nothing here
names one.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import torch

HERE = Path(__file__).resolve().parents[1]


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def prefixes(name: str):
    """``a.b.c``, ``a.b``, ``a``: the name and its dotted prefixes, longest
    first."""
    parts = name.split(".")
    return [".".join(parts[:i]) for i in range(len(parts), 0, -1)]


def _module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict | None
    end_to_end: list
    per_layer: list
    bench_dir: Path
    kind_module: object = None
    readers: dict = field(default_factory=dict)

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    @property
    def spec(self) -> dict:
        return self.config["serving"][self.kind]


def load_cell(name: str, bench_dir: Path = HERE, root: Path | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench_dir = Path(bench_dir)
    root = bench_dir.parent if root is None else Path(root)
    spec = load_json(root / "BENCHMARK.json")
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    centry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    config = load_json(root / centry["file"])
    traffic = load_json(bench_dir / "traffic" / f"{wl['traffic']}.json")
    lim_path = bench_dir / "limits" / f"{name}.json"
    limits = load_json(lim_path)["limits"] if lim_path.exists() else None

    def applies(m):
        return name in m["workloads"] if "workloads" in m else True

    e2e = [m for m in spec["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    cell = Cell(name, wl, config, traffic, limits, e2e, per_layer, bench_dir)
    kind_path = bench_dir / "kinds" / f"{traffic['kind']}.py"
    if not kind_path.exists():
        raise KeyError(f"traffic {wl['traffic']!r} names kind {traffic['kind']!r}, "
                       f"which has no {kind_path}")
    cell.kind_module = _module(kind_path, f"bench_kind_{traffic['kind']}")
    for i, m in enumerate(per_layer):
        path = next((bench_dir / "metrics" / f"{p}.py" for p in prefixes(m["name"])
                     if (bench_dir / "metrics" / f"{p}.py").exists()), None)
        if path is None:
            raise KeyError(f"no reader metrics/<prefix>.py for metric {m['name']!r}")
        cell.readers[m["name"]] = _module(path, f"bench_metric_{i}").read
    return cell


def make_run(cell: Cell, seed: int, seconds: float, trace: bool, **kw):
    """The run of ``cell``'s kind (``kinds/<kind>.py:Run``)."""
    return cell.kind_module.Run(cell, seed, seconds, trace, **kw)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def fence(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def resolve(name: str, values: dict):
    """The value of end-to-end metric ``name``: the kind's quantity under
    the name's longest dotted prefix."""
    for p in prefixes(name):
        if p in values:
            return values[p]
    raise KeyError(f"the run's kind reports no quantity for metric {name!r} "
                   f"(it reports {sorted(values)})")


class RunBase:
    """A run's state; ``run()`` does the steps in order.  A kind subclasses
    it with ``setup``, ``window``, ``quantities``, ``release``, ``check``,
    ``attempted`` and ``context``."""

    # the distances the plain reference computes; a kind that adds a
    # metric's reference widens this
    METRICS = ("l2",)

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, *,
                 device="cuda", control: bool = False, t0: float | None = None,
                 wrap=None, sizes: dict | None = None):
        metric = cell.config.get("metric", "l2")
        if metric not in self.METRICS:
            raise ValueError(f"{cell.name}: metric {metric!r}; kind {cell.kind!r} checks "
                             f"only {self.METRICS}")
        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), seconds, trace
        self.device, self.control, self.wrap = device, control, wrap
        self.t0 = time.perf_counter() if t0 is None else t0
        self.sizes = sizes or {}
        self.on_card = torch.device(device).type == "cuda"
        self.slice = None

    def draw(self):
        from . import data

        return data.draw(self.cell.config, self.seed, self.device, n=self.sizes.get("n"),
                         n_queries=self.sizes.get("n_queries"))

    def control_spec(self) -> dict:
        """The cell's control (``config["controls"][kind]``) when this run
        puts it in the program's place, else {}."""
        if not self.control:
            return {}
        return self.cell.config.get("controls", {}).get(self.cell.kind, {})

    def prepare(self):
        """Build or find the program's kernel libraries (on the card)."""
        from . import system

        self.system = system
        if self.on_card:
            self.kernel_build_s = system.prepare()

    def sample(self, total: int, count: int, salt: int = 0) -> torch.Tensor:
        g = torch.Generator().manual_seed((self.seed * 2654435761 + 97 + salt) % (1 << 63))
        return torch.randperm(total, generator=g)[: min(count, total)].sort().values

    def counters(self):
        return self.system.launch_counts() if self.on_card else {}

    def after_window(self):
        """Readings taken after the window, outside the traced slice."""

    def run(self) -> dict:
        self.setup()
        fence(self.device)
        self.setup_s = time.perf_counter() - self.t0
        self.window()
        peak = torch.cuda.max_memory_allocated(self.device) if self.on_card else 0
        self.after_window()
        values = dict(self.quantities(), setup_s=self.setup_s)
        describe = self.describe() if hasattr(self, "describe") else None
        # the program's state is freed before the reference runs, all but
        # what the check reads
        self.release()
        if self.on_card:
            torch.cuda.empty_cache()
        numbers = self.check()
        from . import check

        correct, checks = check.judge(numbers, self.cell.limits)
        attempted = self.attempted()
        device = {"platform": "gpu" if self.on_card else "cpu",
                  "kind": torch.cuda.get_device_name(self.device) if self.on_card else "cpu",
                  "count": 1, "memory_peak_bytes": int(peak)}
        result = {"correct": correct, "attempted": attempted, "failed": 0}
        if self.trace:
            ctx = self.context()
            metrics = {}
            for m in self.cell.per_layer:
                v = self.cell.readers[m["name"]](ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            result["metrics"] = metrics
            if self.slice is not None:
                device["busy_s"] = self.slice.busy_s
                device["window_s"] = self.slice.window_s
            result["device"] = device
            if self.slice is not None:
                result["breakdown"] = {"device_ops": self.slice.device_ops,
                                       "idle_gaps": self.slice.idle_gaps}
        else:
            result["metrics"] = {m["name"]: {"value": resolve(m["name"], values),
                                             "unit": m["unit"]}
                                 for m in self.cell.end_to_end}
            result["device"] = device
        result["checks"] = checks
        self.describe_line = describe
        return result

    def base_context(self, **extra) -> SimpleNamespace:
        cfg = self.cell.config
        return SimpleNamespace(cell=self.cell.name, kind=self.cell.kind, config=cfg,
                               traffic=self.cell.traffic, spec=self.cell.spec, n=self.n,
                               d=self.d, k=cfg["k"], trace=self.slice, **extra)
