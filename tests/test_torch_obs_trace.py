"""The port's tracer (``repro_torch.obs.trace``): the disabled path, parent
links, device-timed spans on the CPU's host clock, spans that outlive a
call, serialization, the Perfetto export of parents and device intervals,
and the profiler ranges."""
import json
import threading

import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.nn.model import Model
from repro_torch.obs import perfetto
from repro_torch.obs import trace as obs_trace


def fixed_clock(times):
    it = iter(times)
    return lambda: next(it)


@pytest.fixture
def no_tracer():
    prev = obs_trace.set_tracer(None)
    yield
    obs_trace.set_tracer(prev)


@pytest.fixture(scope="module")
def moe_model():
    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    m = Model(cfg, device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


def test_disabled_path_allocates_no_device_span(no_tracer, moe_model):
    m, params = moe_model
    before = obs_trace.Span.allocated
    for _ in range(50):
        with obs_trace.span("hot", cat="x", track="t", device=True) as s:
            assert s is None
    assert obs_trace.span("again", device=True) is obs_trace.NULL_SPAN
    tokens = torch.randint(0, m.cfg.vocab_size, (1, 6))
    with torch.inference_mode():
        logits, cache = m.prefill(params, tokens)
        full = m.init_cache(1, 8)
        m.decode_step(params, full, tokens[:, 0], torch.tensor(6))
    assert obs_trace.Span.allocated == before


def test_parent_links_nest_per_thread(no_tracer):
    tr = obs_trace.Tracer()
    obs_trace.set_tracer(tr)
    seen = {}

    def other():
        with obs_trace.span("elsewhere") as s:
            seen["other"] = s

    with obs_trace.span("outer") as outer:
        with obs_trace.span("mid", device=True) as mid:
            with obs_trace.span("leaf") as leaf:
                t = threading.Thread(target=other)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
        with obs_trace.span("sibling") as sib:
            pass
        waiting = tr.open("queue", args={"rid": 0})
        with obs_trace.span("after_open") as after:
            pass
    with obs_trace.span("top") as top:
        pass
    assert outer.parent is None and top.parent is None
    assert mid.parent == outer.sid and leaf.parent == mid.sid
    assert sib.parent == outer.sid and after.parent == outer.sid
    assert waiting.parent is None            # never on the stack
    assert seen["other"].parent is None      # another thread's stack
    assert all(s.end is not None for s in (outer, mid, leaf, sib, top))


def test_json_round_trips_parent_and_device():
    tr = obs_trace.Tracer(clock=fixed_clock([0.0, 1.0, 1.5, 2.0, 2.5, 3.0,
                                             4.0, 5.0]))
    with tr.span("a", cat="c", track="t") as a:
        with tr.span("b", cat="c", track="t", args={"n": 1},
                     device=True) as b:
            pass
    q = tr.open("queue", "engine", "engine", {"rid": 3})
    tr.close(q, device_end=4.5)
    assert b.parent == a.sid and b.device == [1.5, 2.0]
    assert q.device == [q.start, 4.5]
    text = tr.to_json()
    back = obs_trace.Tracer.from_json(text)
    assert back == tr.spans
    assert back[1].parent == a.sid and back[1].device == [1.5, 2.0]
    d = json.loads(text)["spans"]
    assert "parent" not in d[0] and "device" not in d[0]


def test_device_marks_place_on_the_host_clock_of_the_cpu():
    tr = obs_trace.Tracer(clock=fixed_clock([0.0, 0.25, 0.5, 0.75]))
    r = tr.open("request", args={"rid": 1})          # 0.0
    m = tr.mark()                                    # 0.25
    assert isinstance(m, float)
    tr.place(r, "first_token", m)
    tr.close(r, device_end=tr.mark())                # mark 0.5, end 0.75
    tr.settle()                                      # nothing pending
    assert r.args == {"rid": 1, "first_token": 0.25}
    assert r.end == 0.75 and r.device == [0.0, 0.5]


def test_event_timer_on_the_cpu():
    t = iter([1.0, 3.5])
    timer = obs_trace.EventTimer(False, clock=lambda: next(t))
    a, b = timer.mark(), timer.mark()
    assert timer.seconds(a, b) == 2.5
    assert obs_trace.EventTimer.place(a, (None, 0.0)) == 1.0


def test_perfetto_export_writes_parent_and_device_row(tmp_path):
    tr = obs_trace.Tracer(clock=fixed_clock([0.0, 0.1, 0.2, 0.3, 0.4,
                                             0.5]))
    with tr.span("outer", track="engine"):
        with tr.span("inner", track="model", device=True):
            pass
    doc = perfetto.export_chrome_trace(str(tmp_path / "t.json"), tr.spans)
    evs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    outer = [e for e in evs if e["name"] == "outer"]
    inner = [e for e in evs if e["name"] == "inner"]
    assert len(outer) == 1 and "parent" not in outer[0]["args"]
    assert len(inner) == 2                      # host row and device row
    assert all(e["args"]["parent"] == 0 and e["args"]["sid"] == 1
               for e in inner)
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["name"] == "thread_name"}
    assert names == {"engine", "model", "model (device)"}
    dev = [e for e in inner if e["tid"] != inner[0]["tid"]][0]
    assert dev["ts"] == pytest.approx(0.2e6)
    assert dev["dur"] == pytest.approx(0.1e6)


def test_spans_open_profiler_ranges_while_it_records(no_tracer):
    from torch.profiler import ProfilerActivity, profile
    tr = obs_trace.Tracer()
    obs_trace.set_tracer(tr)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs_trace.span("engine_step", device=True):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "engine_step" in names
    with obs_trace.span("unprofiled"):
        pass
    assert [s.name for s in tr.spans] == ["engine_step", "unprofiled"]


def test_a_following_span_starts_at_the_last_device_end():
    tr = obs_trace.Tracer(clock=fixed_clock([float(t) for t in range(20)]))
    with tr.span("a", device=True) as a:
        pass
    with tr.span("b", device=True, follows=True) as b:
        pass
    with tr.span("host"):
        pass
    with tr.span("c", device=True, follows=True) as c:
        pass
    assert b.device[0] == a.device[1] and b.device[1] > b.device[0]
    assert c.device[0] > b.device[1]        # a host span closed between
