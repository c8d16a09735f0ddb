"""BENCHMARK.json against the contract's form: names, units, keys, the
files each entry needs (the CPU tests' tiny and faults files too), and
the check's time budget."""

import json
import os
import re

from conftest import ROOT, cell_drivers, faults, tiny_cut

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RT = os.path.join(ROOT, "rtbench")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_sizes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "rtbench/run.py"]
    assert b["paths"] == ["rtbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_text():
    b = bench()
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in b[k]]
    names += [w[k] for w in b["workloads"] for k in ("config", "traffic")]
    names += [r for c in b["configs"] for r in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in b[k]}) == len(b[k])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    texts = [e["why"] for k in ("configs", "workloads") for e in b[k]]
    texts += [c["source"] for c in b["configs"]]
    texts += [m["layer"] for m in b["per_layer"]] + b["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_every_entry_has_its_files():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith("rtbench/") and os.path.isfile(path)
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(RT, "geometry",
                                           cfg["generator"] + ".py"))
    for w in b["workloads"]:
        with open(os.path.join(RT, "traffic", w["traffic"] + ".json")) as f:
            tr = json.load(f)
        assert os.path.isfile(os.path.join(RT, "drivers",
                                           tr["driver"] + ".py"))
        assert os.path.isfile(os.path.join(RT, "limits",
                                           w["name"] + ".json"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.isfile(os.path.join(RT, "metrics", m["name"] + ".py"))
    # the CPU tests' files; a missing one raises FileNotFoundError naming it
    for c in b["configs"]:
        tiny_cut("configs", c["name"])
    for driver in set(cell_drivers().values()):
        tiny_cut("drivers", driver)
        faults(driver)


def test_each_cell_reports_what_it_needs():
    b = bench()
    cells = [w["name"] for w in b["workloads"]]

    def has(m, cell):
        return "workloads" not in m or cell in m["workloads"]

    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in cells:
        assert sum(has(m, cell) for m in b["end_to_end"]) >= 2
        assert any(has(m, cell) for m in b["per_layer"])
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and has(e2e[m["moves"]], cell), (m, cell)


def test_a_full_check_fits_its_time():
    rs = bench()["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
