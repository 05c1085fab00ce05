"""Per-layer reader: see BENCHMARK.json for its unit, layer and the
end-to-end metric it moves; None where the run gives nothing to read."""


def read(ctx):
    """The least bytes of the window's decode steps (every weight once,
    the rows' keys and values) over their time at the HBM peak."""
    win, pk = ctx["window"], ctx["peaks"]
    if pk is None or not win["decode_steps"]:
        return None
    return 100.0 * win["decode_least_bytes"] / (
        win["decode_ms"] / 1e3 * pk["hbm_bytes_per_s"])
