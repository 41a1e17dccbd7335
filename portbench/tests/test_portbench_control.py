"""The comparison fails what it must: the control (the reference in
bfloat16 in the program's place) and the faults a training cell can have
(a step that returns its state unchanged; half of the batch left out, the
mean over the rest), each driven through the rest of a run. At a tiny
size on the CPU; the `card` tests repeat them at the size of each cell
of BENCHMARK.json."""

import pytest

from conftest import tiny
from harness import check, control, registry

SEEDS = (2**31 + 5, 2**31 + 6, 2**31 + 7)
NAMES = ["lego.train", "flame_salmon.train"]


def limits(name):
    return check.load_limits(registry.BENCH_DIR, name)


@pytest.mark.parametrize("name", NAMES)
def test_control_is_not_correct(cells, tmp_path, name):
    nums = control.control_numbers(tiny(cells[name]), SEEDS[0], "cpu",
                                   root=str(tmp_path))
    assert not check.judge(nums, limits(name)), nums


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", NAMES)
def test_fault_is_not_correct(cells, tmp_path, name, fault):
    out = control.fault_run(tiny(cells[name]), SEEDS[0], 0.5, fault, "cpu",
                            root=str(tmp_path))
    assert not out["correct"], out["check"]


@pytest.mark.card
@pytest.mark.parametrize("name", ["lego.train"])
def test_control_at_cell_size(card, cells, name):
    for seed in SEEDS:
        nums = control.control_numbers(cells[name], seed, "cuda")
        assert not check.judge(nums, limits(name)), (seed, nums)


@pytest.mark.card
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("name", ["lego.train"])
def test_fault_at_cell_size(card, cells, name, fault):
    for seed in SEEDS:
        out = control.fault_run(cells[name], seed, 2.0, fault, "cuda")
        assert not out["correct"], (seed, out["check"])


def test_a_number_that_is_not_finite_fails():
    """A nan in any step's loss or any leaf's norm is not correct, wherever
    it falls."""
    from harness.training import CheckReadings

    ones = {k: 1.0 for k in ("a", "b", "c")}
    ref = dict(losses=[1.0, 1.0, 1.0], grad_norms=ones, change_norms=ones)
    loose = dict(loss_gap=1.0, grad_gap=1.0, change_gap=1.0)
    sound = CheckReadings([1.0, 1.0, 1.0], ones, ones, [])
    assert check.judge(check.numbers(sound, ref), loose)
    nan = float("nan")
    for bad in (CheckReadings([1.0, nan, 1.0], ones, ones, []),
                CheckReadings([1.0] * 3, dict(ones, c=nan), ones, []),
                CheckReadings([1.0] * 3, ones, dict(ones, b=nan), [])):
        assert not check.judge(check.numbers(bad, ref), loose)
