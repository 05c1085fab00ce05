"""The serving cells' runs with the timed path broken underneath: each
fault a serving cell can have (``perfbench/faults.py``) must turn
``correct`` false.  The cells run on one card, so they have no exchange
between chips to leave out."""
import time

import pytest

from perfbench import faults, run
from perfbench.tests import smoke

CELLS = ["mixtral-8x22b.serve-longdoc", "mixtral-8x22b.serve-chat"]


def _run_with(workload, fault):
    undo = faults.plant(fault)
    try:
        return run.execute(smoke.cell(workload), 4242, 0.0, False,
                           device="cpu", t_start=time.perf_counter())
    finally:
        undo()


@pytest.mark.parametrize("workload", CELLS)
def test_tokens_altered_where_they_are_produced(workload):
    assert _run_with(workload, "altered_token")["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_half_the_batch_left_out(workload):
    assert _run_with(workload, "half_batch")["correct"] is False
