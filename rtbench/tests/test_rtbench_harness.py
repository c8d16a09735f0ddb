"""The harness on the CPU: a run without a card fails, the last line's
keys, a configuration, mix and metric added as new files only, the
window statistics, and the imports."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, make_tiny, run_cli

sys.path.insert(0, ROOT)
from rtbench import harness  # noqa: E402

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_no_card_fails_without_a_result(tiny):
    # the harness's own check for a card, without --cpu, in this sandbox
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "rtbench/run.py", "--workload",
                        "city_waves", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tiny, capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=ROOT),
                       timeout=300)
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert "needs 1 CUDA card" in p.stderr


def test_only_the_benchmark_fails(tmp_path):
    # a directory with only BENCHMARK.json and rtbench/: no program
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "rtbench"), tmp_path / "rtbench")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "rtbench/run.py", "--workload",
                        "city_waves", "--seed", "1", "--seconds", "1",
                        "--trace", "0", "--cpu"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_new_files_only_add_a_cell_and_a_metric(tmp_path):
    """A configuration, a mix, a metric and a limits file added as new
    files, with new BENCHMARK.json entries, run without any edit."""
    root = make_tiny(str(tmp_path))
    rt = os.path.join(root, "rtbench")
    with open(os.path.join(rt, "configs", "city_1m.json")) as f:
        cfg = json.load(f)
    cfg.update(name="city_small", n_tris=2000)
    with open(os.path.join(rt, "configs", "city_small.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(rt, "traffic", "waves.json")) as f:
        tr = json.load(f)
    tr.update(width=32, height=32)
    with open(os.path.join(rt, "traffic", "waves_small.json"), "w") as f:
        json.dump(tr, f)
    shutil.copy(os.path.join(rt, "limits", "city_waves.json"),
                os.path.join(rt, "limits", "small_waves.json"))
    with open(os.path.join(rt, "metrics", "iterations.count.py"), "w") as f:
        f.write("def read(run):\n    return float(run.window['done'])\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append(dict(b["configs"][0], name="city_small",
                             file="rtbench/configs/city_small.json"))
    b["workloads"].append(dict(b["workloads"][0], name="small_waves",
                               config="city_small", traffic="waves_small"))
    for m in b["end_to_end"]:
        if "workloads" in m and "city_waves" in m["workloads"]:
            m["workloads"].append("small_waves")
    b["end_to_end"].append(dict(name="iterations.count", unit="iters",
                                better="higher", bound=0.05,
                                source="host_clock",
                                workloads=["small_waves"]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    rc, out, err = run_cli(root, ["--workload", "small_waves", "--seed",
                                  "3000000000", "--seconds", "1", "--trace",
                                  "0", "--cpu"])
    assert rc == 0, err[-3000:]
    line = last_json(out)
    assert list(line)[:5] == KEYS and list(line)[5:] == ["checked"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"wave_mrays_per_s", "setup_s",
                                    "iterations.count"}
    assert line["metrics"]["iterations.count"]["value"] >= 1
    # the checked numbers are also the last lines of stderr
    tail = err.strip().splitlines()[-len(line["checked"]):]
    assert all(t.startswith("checked ") for t in tail)


class _Run:
    def __init__(self, t0, completions, pixels=1920 * 1080):
        self.window = dict(unit="frames", t0=t0, completions=completions,
                           done=len(completions),
                           window_s=completions[-1] - t0,
                           samples=pixels * len(completions))


def test_a_stall_moves_the_tail_and_the_rate():
    p95 = harness.load_module("metrics", "frame_ms_p95")
    rate = harness.load_module("metrics", "frame_msamples_per_s")
    steady = [0.1 * (i + 1) for i in range(200)]
    stalled = [t + (1.0 if i >= 100 else 0.0) for i, t in enumerate(steady)]
    # eleven 1-s stalls among 200 frames lie above the 95th percentile
    many = [0.1 * (i + 1) + 1.0 * min(max(i - 188, 0), 11)
            for i in range(200)]
    r0, r1, r2 = _Run(0.0, steady), _Run(0.0, stalled), _Run(0.0, many)
    assert p95.read(r0) == pytest.approx(100.0)
    assert rate.read(r1) < rate.read(r0)
    assert p95.read(r2) > 1000.0
    assert rate.read(r0) == pytest.approx(1920 * 1080 * 200 / 20.0 / 1e6)


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules({"radiance_tpu_torch.ops": 1,
                                      "jaxtyping": 1, "benchmarks": 1}) == []
    assert harness.forbidden_modules({"radiance_tpu.ops.x": 1, "jax": 1,
                                      "jaxlib.xla": 1}) == [
        "jax", "jaxlib", "radiance_tpu"]


def test_nothing_loads_jax():
    """Every harness module and the program modules the drivers use,
    imported in a fresh interpreter, load none of the forbidden names."""
    mods = ["rtbench.run", "rtbench.harness", "rtbench.prof",
            "rtbench.check", "rtbench.rays", "rtbench.roofline",
            "rtbench.launches", "rtbench.reference.trace",
            "rtbench.reference.shade",
            "radiance_tpu_torch.api.accel", "radiance_tpu_torch.api.pipeline",
            "radiance_tpu_torch.samples.sample1",
            "radiance_tpu_torch.scene.procedural",
            "radiance_tpu_torch.ops.stream3",
            "radiance_tpu_torch.ops.packet_trace"]
    code = ("import sys, importlib\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "from rtbench import harness\n"
            "for kind in ('drivers', 'metrics', 'geometry'):\n"
            "    import os\n"
            "    for f in os.listdir(os.path.join(harness.HERE, kind)):\n"
            "        if f.endswith('.py') and f != '__init__.py':\n"
            "            harness.load_module(kind, f[:-3])\n"
            "print(harness.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_no_source_imports_jax():
    found = []
    for base, _, files in os.walk(os.path.join(ROOT, "rtbench")):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(base, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                found += [(f, n) for n in names
                          if n.split(".")[0] in harness.FORBIDDEN]
    assert found == []


def test_a_traced_window_keeps_the_setup_spans(monkeypatch):
    """The per-layer metrics read set-up spans (bvh.build_s) after the
    traced window, also when a profile is taken again."""
    import contextlib
    import types

    import torch

    from rtbench import launches, prof, run as rrun

    @contextlib.contextmanager
    def no_profile():
        yield None

    lost = iter([1, 0])
    monkeypatch.setattr(prof, "device_profile", no_profile)
    monkeypatch.setattr(prof, "records", lambda p: [])
    monkeypatch.setattr(launches, "reset", lambda: None)
    monkeypatch.setattr(launches, "lost_records", lambda recs: next(lost))
    r = harness.Run("city_waves", {}, {}, 1, 0.0, True,
                    torch.device("cpu"))
    with r.span("bvh.build"):
        pass

    def window(run, state, seconds):
        with run.span("wave.primary"):
            pass
        return dict(window_s=1.0, done=1, unit="iterations")

    rrun.traced_window(r, types.SimpleNamespace(window=window), None, prof,
                       torch)
    assert [s[0] for s in r.spans] == ["bvh.build", "wave.primary"]
    assert harness.load_module("metrics", "bvh.build_s").read(r) is not None
