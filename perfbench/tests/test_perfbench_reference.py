"""The plain reference held to the port's plain CPU route at smoke widths,
both in f32: dense (phi4-mini's configuration) and MoE (mixtral-8x22b's)
prefill logits, exact and right-padded, with capacity drops, and decode
through the cache.  This test imports both; the reference itself imports
neither the port nor JAX."""
import pytest
import torch

from perfbench import spec, weights
from perfbench.reference import model as ref
from perfbench.tests import smoke

CONFIGS = {"dense": "phi4-mini", "moe": "mixtral-8x22b"}


def _setup(kind, capacity_factor=None, seed=20240611):
    run = spec.as_run(smoke.shrink(spec.load_json(
        spec.BENCH_DIR / "configs" / f"{CONFIGS[kind]}.json")))
    run["torch_dtype"] = "float32"
    if capacity_factor is not None:
        run["capacity_factor"] = capacity_factor
    from repro_torch.nn.model import Model
    flat = weights.make(run, seed, "cpu", dtype=torch.float32)
    model = Model(spec.port_config(run), device="cpu")
    return run, flat, model


def _close(a, b, tol=2e-4):
    a, b = a.float(), b.float()
    assert float((a - b).norm() / b.norm()) < tol


@pytest.mark.parametrize("kind", ["dense", "moe"])
@pytest.mark.parametrize("padded", [0, 9])
def test_prefill_logits(kind, padded):
    # capacity 0.25 makes experts drop copies at these lengths.
    run, flat, model = _setup(kind, capacity_factor=0.25)
    S = 37
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, run["vocab_size"], (1, S + padded), generator=g)
    tokens[0, S:] = 0
    last = torch.tensor([S - 1]) if padded else None
    with torch.no_grad():
        got, _ = model.prefill(weights.nest(flat), tokens, last)
        want = ref.logits_at(flat, run, [(tokens[0, :S], S - 1, 1, S,
                                          S + padded)])[0]
    _close(got, want)


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_decode_through_the_cache(kind):
    run, flat, model = _setup(kind)
    S, n = 21, 5
    g = torch.Generator().manual_seed(4)
    seq = torch.randint(0, run["vocab_size"], (S + n,), generator=g)
    params = weights.nest(flat)
    with torch.no_grad():
        logits, pc = model.prefill(params, seq[None, :S])
        cache = model.init_cache(1, S + n)
        for name in ("k", "v"):
            cache[name][:, :, :, :S] = pc[name]
        rows = [logits[0]]
        for j in range(n - 1):
            out, cache = model.decode_step(params, cache, seq[S + j][None],
                                           torch.tensor([S + j]))
            rows.append(out[0])
        want = ref.logits_at(flat, run, [(seq[:S + n - 1], S - 1, n, S, S)])
    # The port keeps its decode cache in bf16 whatever the param dtype
    # (``transformer.init_cache_specs``): keys and values rounded to 8
    # bits move the logits by 5e-4 to 3e-3 of their norm.
    _close(torch.stack(rows), want[0], tol=5e-3)

