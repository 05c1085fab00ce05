"""Per-layer reader: see BENCHMARK.json for its unit, layer and the
end-to-end metric it moves; None where the run gives nothing to read."""
from perfbench.trace import idle_share


def read(ctx):
    return idle_share(ctx)
