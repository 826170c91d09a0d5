"""On the card, at each cell's own size: the program reads correct and its
control does not, on three seeds each, and each fault a cell can have
makes ``correct`` false.  Marked ``cuda``; skips without a card.

    python -m pytest benchmark/tests/test_benchmark_card.py -m cuda -q
"""

import pytest

from benchlib import faults
from benchlib.harness import load_cell, make_run

CELLS = ["sift-1m.exact-b10000-pinned", "sift-1m.hash-b10000", "deep-10m-bf16.exact-b10000",
         "sift-1m.build"]
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def _run(card, name, seed, control=False, wrap=None, seconds=2.0):
    return make_run(load_cell(name), seed, seconds, False, device=card, control=control,
                    wrap=wrap).run()


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_program_holds(card, name):
    for seed in SEEDS:
        assert _run(card, name, seed)["correct"] is True
        assert _run(card, name, seed, control=True)["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS[:3])
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_search_faults_fail(card, name, fault):
    assert _run(card, name, SEEDS[0], wrap=faults.wrap(fault))["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["drop_table", "drop_probes", "codes", "graph"])
def test_hash_index_and_probe_faults_fail(card, fault):
    assert _run(card, CELLS[1], SEEDS[1], wrap=faults.wrap(fault))["correct"] is False
