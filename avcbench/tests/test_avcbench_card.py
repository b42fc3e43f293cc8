"""On the card, at each cell's own size: the control (the program's
planes cut to 7 bits, ``control.lower_precision``) is judged not correct
on three seeds, and the program is judged correct beside it.  Skips
without a card:

    python -m pytest avcbench/tests -q -m card
"""
import pytest

from conftest import ROOT

from avcbench.control import lower_precision
from avcbench.entries import ENTRIES
from avcbench.run import load_cell, measure

CELLS = ("ipb.gop10", "intra.stream128")


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(card, workload):
    _, cell, folder, cfg, mix = load_cell(ROOT, workload)
    entry = ENTRIES[mix["entry"]](mix, cfg, "cuda")
    for seed in (7001, 7002, 7003):
        _, numbers = measure(folder, cfg, mix, seed, 10.0, False, "cuda",
                             lower_precision(entry))
        assert numbers["pictures_wrong"] > 0
    _, numbers = measure(folder, cfg, mix, 7004, 10.0, False, "cuda",
                         entry)
    assert numbers == {"pictures_wrong": 0, "requests_failed": 0}
