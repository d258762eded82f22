"""A run with the timed path broken underneath turns ``correct`` false:
each fault a cell can have, planted in the program's path, through the
whole of a run but the look for a card (on the CPU at 32px, with the
cells' own limits)."""

import pytest
import torch

import run
from harness import faults

CELLS = {"serve": ("flagship.serve_b8", "sanet.serve_b4"),
         "train": ("flagship.train_b8", "sanet.train_b4")}
CASES = ([(c, f) for c in CELLS["serve"] for f in faults.SERVE]
         + [(c, f) for c in CELLS["train"] for f in faults.TRAIN])


@pytest.fixture(autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_turns_correct_false(manifest, cell, fault):
    # a window long enough that the sample holds the check's 16 requests
    seconds = 2.0 if cell in CELLS["serve"] else 0.5
    res, limits = run.drive(manifest, cell, 31337, seconds, False,
                            torch.device("cpu"),
                            overrides={"img_size": 32}, fault=fault)
    out, lines = run.result_line(manifest, cell, res, limits, False, {})
    assert out["correct"] is False, lines
    assert list(out)[-1] == "checks"
    assert all(line.startswith("check ") for line in lines)


def test_unknown_fault_is_refused():
    with pytest.raises(ValueError):
        faults.serve(lambda c, s: c, "nothing")
    with pytest.raises(ValueError):
        faults.train(lambda *a: None, "nothing")
