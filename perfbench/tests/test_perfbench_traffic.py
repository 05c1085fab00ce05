"""The traffic generator: deterministic for a seed, lengths in range,
the same waves of lengths for every seed in another order inside each
wave, every wave one length a stratum."""
import itertools

import numpy as np
import pytest

from perfbench import spec, traffic

MIXES = ["serve-longdoc", "serve-chat"]
SEEDS = [0, 1, 2**31 + 11, 9_876_543_210]


def _mix(name):
    return spec.load_json(spec.BENCH_DIR / "traffic" / f"{name}.json")


def _waves(mix, seed, n):
    return list(itertools.islice(traffic.waves(mix, seed, 32768), n))


@pytest.mark.parametrize("name", MIXES)
@pytest.mark.parametrize("seed", SEEDS)
def test_serve_waves_deterministic_and_in_range(name, seed):
    mix = _mix(name)
    cycle = int(mix["set"]) // int(mix["slots"])
    a, b = _waves(mix, seed, cycle + 2), _waves(mix, seed, cycle + 2)
    for wa, wb in zip(a, b):
        assert [r for r, _ in wa] == [r for r, _ in wb]
        for (_, pa), (_, pb) in zip(wa, wb):
            assert np.array_equal(pa, pb)
    lo, hi = mix["prompt"]["lo"], mix["prompt"]["hi"]
    for wave in a:
        assert len(wave) == mix["slots"]
        for _, p in wave:
            assert lo <= len(p) <= hi and p.dtype == np.int32
            assert p.min() >= 0 and p.max() < 32768


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_serves_the_same_lengths(name):
    mix = _mix(name)
    cycle = int(mix["set"]) // int(mix["slots"])
    want = sorted(traffic.lengths(mix))
    orders, waves = [], []
    for seed in SEEDS:
        got = [[len(p) for _, p in w] for w in _waves(mix, seed, cycle)]
        assert sorted(n for w in got for n in w) == want
        orders.append(tuple(n for w in got for n in w))
        waves.append([sorted(w) for w in got])
    assert len(set(orders)) == len(SEEDS)
    assert all(w == waves[0] for w in waves)


@pytest.mark.parametrize("name", MIXES)
def test_each_wave_takes_one_length_a_stratum(name):
    mix = _mix(name)
    lens = traffic.lengths(mix)
    per = len(lens) // int(mix["slots"])
    stratum = {n: i // per for i, n in enumerate(lens)}
    for wave in _waves(mix, 5, 3 * per):
        assert sorted(stratum[len(p)] for _, p in wave) \
            == list(range(int(mix["slots"])))

