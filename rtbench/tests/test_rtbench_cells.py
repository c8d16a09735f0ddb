"""Whole runs of every cell of BENCHMARK.json on the CPU at tiny sizes (a
copy of the benchmark cut to its tiny files, the program's kernels in
their plain versions): the control comes out not correct, and so does
every fault of the cell's driver (rtbench/tests/faults/<driver>.py)
planted in the timed path underneath the harness."""

import pytest

from conftest import cell_drivers, faults, run_cell

CELLS = cell_drivers()


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_run_checks_its_numbers(tiny, cell):
    line, err = run_cell(tiny, cell, 2 ** 31 + 17)
    assert line["correct"] is True, err[-2000:]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["checked"] and all(
        set(v) == {"value", "limit"} for v in line["checked"].values())


@pytest.mark.parametrize("cell", list(CELLS))
def test_the_control_is_not_correct(tiny, cell):
    line, _ = run_cell(tiny, cell, 11, ["--control", "bf16"])
    assert line["correct"] is False


def fault_test(driver):
    """test_a_<NAME>_fault_is_not_correct over every fault of `driver` on
    every cell whose traffic names it."""
    fl = faults(driver)

    @pytest.mark.parametrize(("cell", "fault"), [
        (cell, fault) for cell, d in CELLS.items() if d == driver
        for fault in sorted(fl.FAULTS)])
    def test(tiny, cell, fault):
        line, err = run_cell(tiny, cell, 5, prelude=fl.FAULTS[fault],
                             seconds=fl.SECONDS)
        assert line["attempted"] >= fl.MIN_ATTEMPTED
        assert line["correct"] is False, err[-2000:]

    test.__name__ = test.__qualname__ = \
        f"test_a_{fl.NAME}_fault_is_not_correct"
    return test


for _driver in dict.fromkeys(CELLS.values()):
    _test = fault_test(_driver)
    assert _test.__name__ not in globals(), f"two drivers' NAME: {_driver}"
    globals()[_test.__name__] = _test
