"""The program's span reduction (``perfbench/spans.py``) and the numbers
read from it: by hand on planted spans and summaries, and on a CPU wave of
each cell served under the port's tracer."""
import pytest

from perfbench import spans
from perfbench.serve_cell import ServeCell
from perfbench.tests import smoke
from repro_torch.obs import trace as obs_trace

Span = obs_trace.Span


def _span(sid, name, dev, parent=None, args=None, start=None, end=1.0):
    s = Span(sid, name, "", "t", dev[0] if start is None else start, end,
             args, parent)
    s.device = list(dev)
    return s


def test_reduce_on_planted_spans():
    planted = [
        _span(0, "queue", (0.0, 0.5), args={"rid": 7}),
        _span(1, "request", (0.0, 3.0), args={"rid": 7,
                                              "first_token": 2.0}),
        _span(2, "model.prefill", (0.5, 2.0)),
        _span(3, "attn", (0.5, 0.9), parent=2),
        _span(4, "moe", (0.9, 1.9), parent=2),
        _span(5, "model.decode", (2.0, 3.0)),
        _span(6, "moe", (2.1, 2.8), parent=5),
        _span(7, "moe.gather", (2.2, 2.6), parent=6,
              args={"gathered_bytes": 1000}),
        _span(8, "moe.experts", (2.6, 2.8), parent=6),
        _span(9, "moe", (2.8, 2.9), parent=4),       # not under a model span
        _span(10, "queue", (3.0, None), args={"rid": 8}),   # never settled
        _span(11, "model.decode", (3.0, 3.5), end=None),      # still open
    ]
    got = spans.reduce(planted)
    assert got["requests"] == [{"rid": 7, "queue_s": 0.5, "ttft_s": 2.0}]
    assert got["prefill"] == [{"device_s": 1.5, "moe_s": pytest.approx(1.0),
                               "gather_s": 0, "experts_s": 0,
                               "gathered_bytes": 0}]
    [dec] = got["decode"]
    assert dec["device_s"] == 1.0 and dec["gathered_bytes"] == 1000
    assert dec["moe_s"] == pytest.approx(0.7)
    assert dec["gather_s"] == pytest.approx(0.4)
    assert dec["experts_s"] == pytest.approx(0.2)
    assert got["names"]["moe"] == 3 and "model.decode" in got["names"]
    assert got["names"]["model.decode"] == 1


PROGRAM = {
    "requests": [{"rid": 0, "queue_s": 0.0, "ttft_s": 0.25},
                 {"rid": 1, "queue_s": 0.25, "ttft_s": 0.5},
                 {"rid": 2, "queue_s": 0.5, "ttft_s": 0.75}],
    "prefill": [{"device_s": 0.25, "moe_s": 0.2, "gather_s": 0,
                 "experts_s": 0, "gathered_bytes": 0},
                {"device_s": 0.75, "moe_s": 0.6, "gather_s": 0,
                 "experts_s": 0, "gathered_bytes": 0}],
    "decode": [{"device_s": 0.3, "moe_s": 0.25, "gather_s": 0.2,
                "experts_s": 0.05, "gathered_bytes": 150_000_000_000},
               {"device_s": 0.3, "moe_s": 0.27, "gather_s": 0.2,
                "experts_s": 0.07, "gathered_bytes": 160_000_000_000}],
}
WANT = {"queue_wait_share.longdoc": 50.0,        # 0.75 / 1.5
        "moe_prefill_share.longdoc": 80.0,       # 0.8 / 1.0
        "moe_decode_ms_per_step.chat": 260.0,    # 520 ms / 2
        "moe_gather_gb_per_step.chat": 155.0}    # 310 GB / 2


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_number_by_hand_and_none_on_nothing(name):
    read = spans.METRICS[name]
    assert read({"trace": {"program": PROGRAM}}) == pytest.approx(WANT[name])
    empty = {"requests": [], "prefill": [], "decode": [], "names": {}}
    assert read({"trace": {"program": empty}}) is None
    assert read({"trace": {"busy_s": 1.0}}) is None      # no program key
    assert read({"trace": None}) is None


@pytest.mark.parametrize("workload", ["mixtral-8x22b.serve-longdoc",
                                      "mixtral-8x22b.serve-chat"])
def test_a_wave_under_the_tracer(workload):
    cell = smoke.cell(workload)
    server = ServeCell(cell, "cpu")
    server.setup(2**31 + 5)
    tr = obs_trace.Tracer()
    prev = obs_trace.set_tracer(tr)
    try:
        server._serve_wave()
    finally:
        obs_trace.set_tracer(prev)
    got = spans.reduce(tr.spans)
    run, mix = cell.run, cell.traffic
    slots, steps = int(mix["slots"]), int(mix["max_new_tokens"]) - 1
    assert [r["rid"] for r in got["requests"]] == sorted(
        r["rid"] for r in got["requests"])
    assert len(got["requests"]) == len(got["prefill"]) == slots
    assert len(got["decode"]) == steps
    for r in got["requests"]:
        assert 0 <= r["queue_s"] <= r["ttft_s"]
    for c in got["prefill"] + got["decode"]:
        assert 0 < c["moe_s"] < c["device_s"]
    gathered = (slots * int(run["num_experts_per_tok"]) * 3
                * int(run["hidden_size"]) * int(run["intermediate_size"])
                * 2 * int(run["num_hidden_layers"]))      # bf16 weights
    ctx = {"trace": {"program": got}}
    assert spans.moe_gather_gb_per_step(ctx) == pytest.approx(
        gathered / 1e9)
    for c in got["decode"]:
        assert c["gather_s"] + c["experts_s"] <= c["moe_s"]
    assert 0 < spans.queue_wait_share(ctx) < 100
    assert 0 < spans.moe_prefill_share(ctx) < 100
    assert 0 < spans.moe_decode_ms_per_step(ctx)
