"""The one generator of traffic: it reads a mix's data file and makes the
inputs from the seed.

A serving mix fixes a set of ``set`` prompt lengths at the strata
midpoints of its distribution (``loguniform`` or ``uniform`` over [lo,
hi]). A closed wave fills the engine's ``slots``: the lengths fall into
``slots`` strata of equal size; wave j of a cycle takes the j-th length of
the even strata and the j-th from the top of the odd ones, so the waves
carry close to the same work, and a cycle of ``set / slots`` waves uses
each length once. Every seed serves the same waves in the same order: a
window that ends inside a cycle then holds the same lengths whatever the
seed, and the seed changes only the order of the requests inside each wave
and their tokens (drawn from the seed and the request's number).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np

_MASK63 = (1 << 63) - 1


def lengths(mix: Dict) -> List[int]:
    """The mix's prompt lengths: the midpoints of ``set`` equal strata of
    its distribution, ascending."""
    p, n = mix["prompt"], int(mix["set"])
    lo, hi = float(p["lo"]), float(p["hi"])
    qs = [(i + 0.5) / n for i in range(n)]
    if p["dist"] == "loguniform":
        vals = [math.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
                for q in qs]
    elif p["dist"] == "uniform":
        vals = [lo + q * (hi - lo) for q in qs]
    else:
        raise ValueError(f"unknown prompt distribution {p['dist']!r}")
    return [int(round(v)) for v in vals]


def wave_lengths(mix: Dict, seed: int) -> Iterator[List[int]]:
    """The prompt lengths of each wave, in submission order, endlessly."""
    lens, w = lengths(mix), int(mix["slots"])
    if len(lens) % w:
        raise ValueError(f"set {len(lens)} is not a multiple of wave {w}")
    per = len(lens) // w
    strata = [lens[s * per:(s + 1) * per] for s in range(w)]
    cycle = 0
    while True:
        rng = np.random.default_rng([seed & _MASK63, cycle])
        for j in range(per):
            wave = [st[j if s % 2 == 0 else per - 1 - j]
                    for s, st in enumerate(strata)]
            rng.shuffle(wave)
            yield wave
        cycle += 1


def prompt(seed: int, rid: int, length: int, vocab: int) -> np.ndarray:
    """Request ``rid``'s prompt: ``length`` token ids from the seed."""
    rng = np.random.default_rng([seed & _MASK63, 1 << 40, rid])
    return rng.integers(0, vocab, size=length, dtype=np.int64) \
        .astype(np.int32)


def waves(mix: Dict, seed: int, vocab: int
          ) -> Iterator[List[Tuple[int, np.ndarray]]]:
    """Closed waves of (request number, prompt), numbered from 0."""
    rid = 0
    for lens in wave_lengths(mix, seed):
        wave = []
        for n in lens:
            wave.append((rid, prompt(seed, rid, n, vocab)))
            rid += 1
        yield wave

