"""rtbench's tests: `python -m pytest rtbench/tests` from the repository
root.  Tests marked `card` need a CUDA card and skip without one (the
decision is made inside a fixture, never at import).

The CPU tests run every cell of BENCHMARK.json on a copy of the
benchmark cut to tiny sizes (make_tiny), its control and the faults its
driver can have.  A later cell, configuration, mix, driver or metric is
new files only, each found by its name:

  rtbench/configs/<config>.json              the configuration
  rtbench/geometry/<generator>.py            its geometry's generator
  rtbench/traffic/<traffic>.json             the mix: {"driver": ...}
  rtbench/drivers/<driver>.py                setup / window / check
  rtbench/metrics/<metric>.py                read(run) -> float or None
  rtbench/limits/<workload>.json             the cell's limits
  rtbench/tests/tiny/configs/<config>.json   the configuration's tiny cut
  rtbench/tests/tiny/drivers/<driver>.json   the tiny cut of every mix of
                                             that driver
  rtbench/tests/faults/<driver>.py           the faults planted in its
                                             cells' runs (see faults/*.py)

and the entries in BENCHMARK.json.  A tiny file is the keys it changes,
with their values, and a "why" that is not copied.  A missing file raises
FileNotFoundError that names it.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from rtbench import harness  # noqa: E402

FAULT_KEYS = ("NAME", "SECONDS", "MIN_ATTEMPTED", "FAULTS")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (python -m pytest rtbench/tests "
                   "-m card, on the card)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tests_dir(src=ROOT):
    return os.path.join(src, "rtbench", "tests")


def tiny_cut(kind, name, src=ROOT):
    """The keys rtbench/tests/tiny/<kind>/<name>.json of `src` changes
    (kind "configs" or "drivers"), without its "why"."""
    cut = harness.load_json(harness.find(os.path.join("tiny", kind), name,
                                         ".json", tests_dir(src)))
    cut.pop("why", None)
    return cut


def faults(driver, src=ROOT):
    """The module rtbench/tests/faults/<driver>.py of `src`: NAME, SECONDS,
    MIN_ATTEMPTED and FAULTS, at least one."""
    mod = harness.load_module("faults", driver, tests_dir(src))
    missing = [k for k in FAULT_KEYS if not hasattr(mod, k)]
    if missing:
        raise ValueError(f"{mod.__file__} lacks {', '.join(missing)}")
    if not mod.FAULTS:
        raise ValueError(f"{mod.__file__} holds no fault")
    return mod


def cell_drivers(src=ROOT):
    """Each cell of `src`'s BENCHMARK.json, in order, with the driver its
    traffic names."""
    rt = os.path.join(src, "rtbench")
    return {w["name"]: harness.load_json(harness.find(
        "traffic", w["traffic"], ".json", rt))["driver"]
        for w in harness.benchmark(src)["workloads"]}


def make_tiny(dst, src=ROOT):
    """A copy of `src`'s BENCHMARK.json and rtbench/ under `dst` with every
    configuration and mix cut to its tiny file; returns dst."""
    shutil.copy(os.path.join(src, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(src, "rtbench"), os.path.join(dst, "rtbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for kind, key, cuts in (("configs", "name", "configs"),
                            ("traffic", "driver", "drivers")):
        folder = os.path.join(dst, "rtbench", kind)
        for f in os.listdir(folder):
            p = os.path.join(folder, f)
            d = harness.load_json(p)
            d.update(tiny_cut(cuts, d[key], src))
            with open(p, "w") as fh:
                json.dump(d, fh)
    return dst


def run_cli(root, args, prelude="", timeout=600):
    """Run rtbench/run.py of `root` in a fresh interpreter on the CPU,
    after `prelude` (Python that patches the program); returns
    (returncode, stdout, stderr)."""
    code = (f"import sys; sys.path[:0] = [{root!r}, {ROOT!r}]\n"
            f"{prelude}\n"
            f"from rtbench import run\n"
            f"sys.exit(run.main({list(args)!r}))\n")
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr


def run_cell(root, cell, seed, extra=(), prelude="", seconds=2):
    """A CPU run of `cell` in `root` that must exit 0: its last line, parsed,
    and its stderr."""
    rc, out, err = run_cli(root, ["--workload", cell, "--seed", str(seed),
                                  "--seconds", str(seconds), "--trace", "0",
                                  "--cpu", *extra], prelude=prelude)
    assert rc == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return make_tiny(str(tmp_path_factory.mktemp("tiny")))
