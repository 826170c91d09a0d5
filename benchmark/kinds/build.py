"""Whole builds of the configuration's hash index back to back, from
points on the card to a servable index (``Server.build`` on the
``serving["build"]`` spec, with its packed view): build i of the window
seeded with the run's seed + 1 + i, none started after the window;
``build_s`` is the window's build seconds over their count.

The check, on every build of the window: ``code_flips``, ``layout_errors``
and ``graph_gap`` (a sample of graph rows drawn from the seed) as
:func:`benchlib.check.build_numbers` computes them, the worst over the
builds.  The control ``{"reference": "tf32"}`` puts the reference's build
with TF32 products in the program's place.
"""

import time

from benchlib import check, system, tracing
from benchlib.harness import RunBase, fence

# graph rows the check reads a build
SAMPLE = 1024


class Run(RunBase):
    def setup(self):
        self.prepare()
        spec = {**self.cell.spec, **self.control_spec().get("server", {})}
        self.build_fn = (system.reference_build
                         if self.control_spec().get("reference") == "tf32"
                         else system.server_build)
        if self.wrap:
            self.build_fn = self.wrap(self.build_fn)
        self.build_spec = spec
        self.corpus, _ = self.draw()
        self.n, self.d = self.corpus.shape
        # warm-up: one whole build of a prefix (two graph chunks at most)
        m = min(self.n, self.cell.traffic.get("warmup_rows", self.n))
        self.build_fn(self.corpus[:m].contiguous(), self.cell.config["k"], spec, self.seed)

    def window(self):
        k = self.cell.config["k"]
        self.builds, self.build_times, self.stages = [], [], []
        start = time.perf_counter()
        end = start + self.seconds
        i = 0
        while i == 0 or time.perf_counter() < end:
            seed_i = self.seed + 1 + i
            st = None
            if self.trace:
                from approximatenn_tpu_torch.utils.profiling import StageTimes

                st = StageTimes()
            t = time.perf_counter()
            if self.trace and i == 0:
                with tracing.Slice(self.counters) as s:
                    built = self.build_fn(self.corpus, k, self.build_spec, seed_i, st)
                    s.calls = 1
                self.slice = s.result
            else:
                built = self.build_fn(self.corpus, k, self.build_spec, seed_i, st)
            fence(self.device)
            self.build_times.append(time.perf_counter() - t)
            self.builds.append((seed_i, built))
            if st is not None:
                self.stages.append({name: st.totals[name] for name in st.totals})
            i += 1
        self.window_s = time.perf_counter() - start

    def quantities(self) -> dict:
        return {"build_s": sum(self.build_times) / len(self.build_times)}

    def release(self):
        self.corpus = None

    def attempted(self) -> int:
        return len(self.build_times)

    def check(self) -> dict:
        k = self.cell.config["k"]
        corpus, _ = self.draw()
        med = check.median_sq_norm(corpus)
        rows = self.sample(self.n, SAMPLE).to(corpus.device)
        numbers: dict = {}
        row_dtype = system.DTYPES[self.build_spec.get("packed_dtype", "float32")]
        for seed_i, built in self.builds:
            got = check.build_numbers(
                built, corpus, seed=seed_i, k=k, tries=self.build_spec["tries"],
                capacity=self.build_spec.get("capacity"), row_dtype=row_dtype,
                sample=rows, med=med)
            for key, v in got.items():
                numbers[key] = max(numbers.get(key, 0.0), v)
        self.builds = None
        return numbers

    def context(self):
        return self.base_context(batch=None, host_s=None, latency_s=None, syncs=None,
                                 stages=self.stages, probe_slots=None)
