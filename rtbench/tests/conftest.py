"""rtbench's tests: `python -m pytest rtbench/tests` from the repository
root.  Tests marked `card` need a CUDA card and skip without one (the
decision is made inside a fixture, never at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


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


TINY = {  # the tiny sizes the CPU runs use, over a copy of the benchmark
    # the city's clusters packed in front of a nearer eye, so that a
    # 64 x 64 image hits them
    "city_1m": {"n_tris": 20000, "eye": [0.0, 0.0, 20.0],
                "generator_args": {"n_clusters": 100, "spread": 8.0}},
    "interior_1m": {"n_tris": 6000},
    "waves": {"width": 64, "height": 64, "check_rays": 512, "check_iters": 2,
              "control_iters": 8, "warmup_iters": 1},
    "view": {"width": 32, "height": 24, "batch": 2, "check_pixels": 64,
             "control_frames": 4, "warmup_frames": 1, "check_lanes": 1024,
             "check_frames": 48},
}


def make_tiny(dst):
    """A copy of BENCHMARK.json and rtbench/ under `dst` with every
    configuration and mix cut to TINY; returns dst."""
    import json
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "rtbench"), os.path.join(dst, "rtbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for kind, names in (("configs", None), ("traffic", ("waves", "view"))):
        folder = os.path.join(dst, "rtbench", kind)
        for f in os.listdir(folder):
            p = os.path.join(folder, f)
            with open(p) as fh:
                d = json.load(fh)
            d.update(TINY[d["name"]] if kind == "configs"
                     else TINY[d["driver"]])
            with open(p, "w") as fh:
                json.dump(d, fh)
    return dst


def run_cli(root, args, prelude="", timeout=600):
    """Run rtbench/run.py of `root` in a fresh interpreter on the CPU,
    after `prelude` (Python that patches the program); returns
    (returncode, stdout, stderr)."""
    import subprocess

    code = (f"import sys; sys.path[:0] = [{root!r}, {ROOT!r}]\n"
            f"{prelude}\n"
            f"from rtbench import run\n"
            f"sys.exit(run.main({list(args)!r}))\n")
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    return make_tiny(str(tmp_path_factory.mktemp("tiny")))
