"""Per-layer reader: see BENCHMARK.json for its unit, layer and the
end-to-end metric it moves; None where the run gives nothing to read."""
from perfbench.trace import roofline_share


def read(ctx):
    return roofline_share(ctx, "flash")
