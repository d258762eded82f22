"""On the card, at each cell's own size: the configuration's lower
precision in the program's place (the program's int8 path, its int8 loss
targets, or the reference in float8) comes out as not correct on three
seeds. ``python3 -m pytest benchmark/tests -q -m cuda``."""

import pytest

import run

CELLS = ("flagship.serve_b8", "sanet.train_b4", "flagship.train_b8",
         "sanet.serve_b4")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(manifest, cuda_device, cell):
    for seed in (101, 2 ** 31 + 3, 4_000_000_007):
        res, limits = run.drive(manifest, cell, seed, 3.0, False,
                                cuda_device, control=True)
        out, lines = run.result_line(manifest, cell, res, limits, False, {})
        assert out["correct"] is False, (seed, lines)
