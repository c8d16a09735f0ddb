"""The harness on the CPU: a run without a card fails, the last line's
keys, a cell with its configuration, mix, driver, metric and test files
added as new files only, a missing test file named, the window
statistics, and the imports."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, cell_drivers, faults, make_tiny, run_cell

sys.path.insert(0, ROOT)
from rtbench import harness  # noqa: E402

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


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


def untouched_copy(dst):
    """BENCHMARK.json and rtbench/, its tests' files included, as the
    repository holds them, under a new directory `dst`; returns dst."""
    os.makedirs(dst)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "rtbench"), os.path.join(dst, "rtbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def add_file(root, rel, text=None, like=None, **changes):
    """A new file rtbench/<rel> of `root`: `text`, or the JSON of
    rtbench/<like> with `changes`, or rtbench/<like> as it is."""
    path = os.path.join(root, "rtbench", rel)
    assert not os.path.exists(path), rel
    if like is not None:
        with open(os.path.join(root, "rtbench", like)) as f:
            text = f.read()
        if changes:
            text = json.dumps(dict(json.loads(text), **changes))
    with open(path, "w") as f:
        f.write(text)


def add_config(src):
    add_file(src, "configs/city_small.json", like="configs/city_1m.json",
             name="city_small")


def add_mix(src):
    add_file(src, "traffic/view_inst.json", like="traffic/view.json",
             driver="view_inst")


def add_cell_files(src):
    """The files of a new cell small_view: the configuration city_small,
    the mix view_inst of a new driver view_inst that is the view driver,
    their tiny and faults files, the cell's limits."""
    add_config(src)
    add_mix(src)
    add_file(src, "drivers/view_inst.py",
             "from rtbench.drivers.view import (  # noqa: F401\n"
             "    check, control, control_setup, release, setup, window)\n")
    add_file(src, "limits/small_view.json", like="limits/city_view.json")
    add_file(src, "tests/tiny/configs/city_small.json",
             like="tests/tiny/configs/city_1m.json")
    add_file(src, "tests/tiny/drivers/view_inst.json",
             like="tests/tiny/drivers/view.json")
    add_file(src, "tests/faults/view_inst.py", like="tests/faults/view.py")


def test_new_files_only_add_a_cell_and_a_metric(tmp_path):
    """A configuration, a mix of a new driver, limits, a metric, their
    tiny and faults files and BENCHMARK.json entries, added to an
    untouched copy with no edit to any file that was there, before it is
    cut to tiny sizes: the new cell runs correct, and its control and a
    fault of its driver do not."""
    src = untouched_copy(str(tmp_path / "src"))
    add_cell_files(src)
    add_file(src, "metrics/frames.count.py",
             "def read(run):\n    return float(run.window['done'])\n")
    with open(os.path.join(src, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append(dict(b["configs"][0], name="city_small",
                             file="rtbench/configs/city_small.json"))
    b["workloads"].append(dict(name="small_view", config="city_small",
                               traffic="view_inst", chips=1, why="a test"))
    for m in b["end_to_end"]:
        if "workloads" in m and "city_view" in m["workloads"]:
            m["workloads"].append("small_view")
    b["end_to_end"].append(dict(name="frames.count", unit="frames",
                                better="higher", bound=0.05,
                                source="host_clock",
                                workloads=["small_view"]))
    with open(os.path.join(src, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    os.makedirs(tmp_path / "tiny")
    root = make_tiny(str(tmp_path / "tiny"), src)

    line, err = run_cell(root, "small_view", 3000000000, seconds=1)
    assert list(line)[:5] == KEYS and list(line)[5:] == ["checked"]
    assert line["correct"] is True, err[-2000:]
    assert set(line["metrics"]) == {"frame_msamples_per_s", "setup_s",
                                    "frames.count"}
    assert line["metrics"]["frames.count"]["value"] >= 1
    # the checked numbers are also the last lines of stderr
    tail = err.strip().splitlines()[-len(line["checked"]):]
    assert all(t.startswith("checked ") for t in tail)

    line, _ = run_cell(root, "small_view", 11, ["--control", "bf16"])
    assert line["correct"] is False

    fl = faults(cell_drivers(src)["small_view"], src)
    fault = sorted(fl.FAULTS)[0]
    line, err = run_cell(root, "small_view", 5, prelude=fl.FAULTS[fault],
                         seconds=fl.SECONDS)
    assert line["attempted"] >= fl.MIN_ATTEMPTED
    assert line["correct"] is False, (fault, err[-2000:])


@pytest.mark.parametrize("change, named", [
    (add_config, "rtbench/tests/tiny/configs/city_small.json"),
    (add_mix, "rtbench/tests/tiny/drivers/view_inst.json"),
    (None, "rtbench/tests/tiny/configs/interior_1m.json"),
    (None, "rtbench/tests/tiny/drivers/view.json"),
    (None, "rtbench/tests/faults/waves.py"),
], ids=["new-config", "new-driver", "config-removed", "driver-removed",
        "faults-removed"])
def test_a_missing_test_file_is_named(tmp_path, change, named):
    """Cutting a copy to tiny sizes and finding its cells' faults, as the
    cells tests do, stops at a configuration or driver without its tiny
    file, and a driver without its faults file, naming the file."""
    src = untouched_copy(str(tmp_path / "src"))
    if change is None:
        os.remove(os.path.join(src, named))
    else:
        change(src)
    os.makedirs(tmp_path / "tiny")
    with pytest.raises(FileNotFoundError, match=re.escape(named)):
        make_tiny(str(tmp_path / "tiny"), src)
        for driver in set(cell_drivers(src).values()):
            faults(driver, src)


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
