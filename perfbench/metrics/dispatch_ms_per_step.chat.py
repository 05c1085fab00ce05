"""Per-layer reader: see BENCHMARK.json for its unit, layer and the
end-to-end metric it moves; None where the run gives nothing to read."""


def read(ctx):
    """The engine's host seconds around each decode call
    (``dispatch_s_mean`` of every wave, weighted by its steps), in ms."""
    win = ctx["window"]
    if not win["decode_steps"]:
        return None
    return win["dispatch_ms"] / win["decode_steps"]
