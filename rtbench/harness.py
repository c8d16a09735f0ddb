"""The harness's data-driven parts: BENCHMARK.json, the files it finds
by name, the run record, the window statistics and the result line.

Files found by name (a later cell, mix or metric is new files only):
  rtbench/configs/<config>.json    a deployment: scene, camera, light,
                                   material, build settings
  rtbench/geometry/<generator>.py  generate(n_tris, seed, **generator_args)
                                   -> verts, tris
  rtbench/traffic/<traffic>.json   a mix: {"driver": <name>, ...}
  rtbench/drivers/<driver>.py      setup / window / check of a mix kind
  rtbench/metrics/<metric>.py      read(run) -> float or None
  rtbench/limits/<workload>.json   the limits of the correctness check
"""

import importlib.util
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "radiance_tpu", "bench", "chip_smoke")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find(kind: str, name: str, ext: str, base=HERE) -> str:
    """The path of rtbench/<kind>/<name><ext>; FileNotFoundError names
    what is missing."""
    path = os.path.join(base, kind, name + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def load_module(kind: str, name: str, base=HERE):
    """The module rtbench/<kind>/<name>.py (a metric's name may hold
    dots, so it is loaded from its path)."""
    path = find(kind, name, ".py", base)
    mod_name = f"rtbench_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_metrics(bench, cell: str, traced: bool):
    """The metric entries a run of `cell` reports: its end-to-end metrics
    untraced, its per-layer metrics traced (an entry without "workloads"
    belongs to every cell)."""
    key = "per_layer" if traced else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules(modules=None):
    """Top-level names in sys.modules that the benchmark may not load,
    compared whole (radiance_tpu_torch is not radiance_tpu)."""
    modules = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in list(modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


class Run:
    """One run's record: its settings, the host spans and counters the
    harness takes around its calls into the program, the CUDA-event
    spans of a traced run, and what the window and the profile gave."""

    def __init__(self, cell, cfg, traffic, seed, seconds, trace, dev):
        self.cell, self.cfg, self.traffic = cell, cfg, traffic
        self.seed, self.seconds, self.trace, self.dev = (seed, seconds,
                                                         trace, dev)
        self.spans = []          # (name, start ns, end ns), perf_counter
        self.counters = {}
        self.events = {}         # name -> [(start event, end event)]
        self.window = {}         # the driver's window record
        self.profile = None      # dict: records, busy_s, window_s, ...

    def span(self, name):
        run = self

        class _Span:
            def __enter__(self):
                self.t0 = time.perf_counter_ns()
                return self

            def __exit__(self, *exc):
                run.spans.append((name, self.t0, time.perf_counter_ns()))

        return _Span()

    def span_s(self, name) -> float:
        return sum(e - s for n, s, e in self.spans if n == name) / 1e9

    def event_span(self, name):
        """CUDA events around a block, kept in a traced run only."""
        import torch
        run = self

        class _Ev:
            def __enter__(self):
                if run.trace:
                    self.a = torch.cuda.Event(enable_timing=True)
                    self.a.record()
                return self

            def __exit__(self, *exc):
                if run.trace:
                    b = torch.cuda.Event(enable_timing=True)
                    b.record()
                    run.events.setdefault(name, []).append((self.a, b))

        return _Ev()

    def event_ms(self, name):
        return [a.elapsed_time(b) for a, b in self.events.get(name, [])]


def p95(values):
    """The 95th percentile by the inclusive method (statistics)."""
    if len(values) < 2:
        return values[0] if values else None
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def frame_intervals(t0, completions):
    """Seconds between successive completions, the first from t0."""
    out, prev = [], t0
    for t in completions:
        out.append(t - prev)
        prev = t
    return out


def result_line(correct, attempted, failed, metrics, device, numbers,
                breakdown=None):
    """The contract's last line; `numbers` (name, value, limit) last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checked"] = {n: {"value": v, "limit": lim} for n, v, lim in numbers}
    return json.dumps(out)
