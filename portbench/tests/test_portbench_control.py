"""The control of every cell, on the card: the plain reference put in the
program's place at the next lower precision than the configuration states
(int4 weights and TF32 for the slide path's int8 and float32, float8 e4m3
for training's bfloat16) has to come out as not correct, while the program
at the same size comes out correct. Cut to a size a test run holds: slides
of 512-2,048 tiles, the training step at its full size.

    python -m pytest portbench/tests -q -m cuda
"""

from __future__ import annotations

import pytest

from portbench import runners, harness

SMALL = {
    "slide-mixed": {"sizes": {"dist": "loguniform", "low": 512, "high": 2048, "count": 4},
                    "pool_tiles": 4096, "check_tiles": 2048},
    "train-b64x200": {},
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SMALL))
@pytest.mark.parametrize("side", ["program", "control"])
def test_the_control_fails_where_the_program_passes(cuda_device, cut, name, side):
    _, config, traffic = harness.cell_parts(name)
    cell = runners.Cell(name=name, config=config, traffic=cut(traffic, SMALL[name]),
                        seed=2 ** 31 + 101, seconds=1.0, device=cuda_device, side=side)
    out = runners.run(cell)
    assert out.correct == (side == "program"), out.checks
