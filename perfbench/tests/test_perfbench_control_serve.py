"""The serving cells' control at a size a test run holds: the reference
in fp8 in the program's place reads a mean gap far above the program's
on the same requests.  On the card, at the cells' own size, the readings
that set the limits come from ``perfbench/readings.py``; each limit file
keeps them, and the run's own judge passes the sound runs' largest and
fails the control's least against the committed limits."""
import pytest

from perfbench import run, spec
from perfbench.readings import as_control
from perfbench.serve_cell import ServeCell
from perfbench.tests import smoke


@pytest.mark.parametrize("workload", ["mixtral-8x22b.serve-longdoc",
                                      "mixtral-8x22b.serve-chat"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_reads_far_above_the_program(workload, seed):
    c = smoke.cell(workload)
    c.traffic.update(max_new_tokens=16, check_requests=8)
    d = ServeCell(c, "cpu")
    d.setup(seed)
    d.window(0.0, waves=2)
    d.release()
    got = d.check(seed, control=True)
    assert got["control_gap_sd_mean"] > 0.01
    assert got["control_gap_sd_mean"] >= 3 * got["gap_sd_mean"]
    assert set(as_control(got)) >= set(c.limits["numbers"])


@pytest.mark.parametrize("workload", ["mixtral-8x22b.serve-longdoc",
                                      "mixtral-8x22b.serve-chat"])
def test_committed_limits_pass_the_program_and_fail_the_control(workload):
    limits = spec.load_cell(workload).limits
    for name, lim in limits["numbers"].items():
        assert lim["lower"] < lim["limit"] < lim["upper"]
        others = {n: v["lower"] for n, v in limits["numbers"].items()}
        assert run.judge(others, limits)[0] is True
        assert run.judge(dict(others, **{name: lim["upper"]}),
                         limits)[0] is False
