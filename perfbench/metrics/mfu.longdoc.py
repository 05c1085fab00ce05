"""Per-layer reader: see BENCHMARK.json for its unit, layer and the
end-to-end metric it moves; None where the run gives nothing to read."""
from perfbench import work


def read(ctx):
    """The window's prefill flops (2 N_active T, causal attention, the
    head's one row) over the prefills' device time at the bf16 peak."""
    win, pk = ctx["window"], ctx["peaks"]
    if pk is None or not win["prefill_ms"]:
        return None
    flops = sum(work.prefill_flops(ctx["run"], t)
                for t in win["prefill_tokens"])
    return 100.0 * flops / (sum(win["prefill_ms"]) / 1e3
                            * pk["bf16_flops_per_s"])
