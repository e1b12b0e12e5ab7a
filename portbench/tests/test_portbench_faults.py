"""Each cell driven through a whole run on the CPU at a tiny size (the plain
versions stand in for the kernels, the harness's look for a card is
skipped): sound, ``correct`` is true; with a fault planted in the timed
path underneath, ``correct`` comes out false. The faults a cell can have:
an answer altered where it is produced (slides), a step that
leaves the state unchanged and half of the batch left out (training). A
cell runs on one chip, so it has no exchange between chips to leave out.
The limits are the configurations' own."""

from __future__ import annotations

import pytest

from portbench import runners

CASES = [("slide-mixed", None), ("slide-mixed", "answer"),
         ("train-b64x200", None), ("train-b64x200", "unchanged"),
         ("train-b64x200", "half_batch")]


@pytest.mark.parametrize("cell,plant", CASES, ids=[f"{c}-{p or 'sound'}" for c, p in CASES])
def test_a_planted_fault_turns_correct_false(tiny, cell, plant):
    out = runners.run(tiny(cell, plant=plant))
    assert out.checks
    if plant is None:
        assert out.correct, out.checks
        assert out.metrics and all(v > 0 for v in out.metrics.values())
    else:
        assert not out.correct, out.checks


def test_the_slide_window_times_whole_blocks_and_checks_its_longest_slide(tiny):
    cell = tiny("slide-mixed")
    out = runners.run(cell)
    slides, block = out.work["slides"], cell.traffic["sizes"]["count"]
    assert slides and len(slides) % block == 0
    checked, budget = out.work["checked"], cell.traffic["check_tiles"]
    assert max(slides) in checked and sum(checked) <= max(budget, max(slides))
