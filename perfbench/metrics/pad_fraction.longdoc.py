"""Per-layer reader: see BENCHMARK.json for its unit, layer and the
end-to-end metric it moves; None where the run gives nothing to read."""


def read(ctx):
    """The share of the prefill rows that were padding, from the engine's
    real and padded row counters."""
    win = ctx["window"]
    if not win["padded_rows"]:
        return None
    return 100.0 * (1.0 - win["real_rows"] / win["padded_rows"])
