"""Faults planted under a serving cell's timed path: the harness's tests
must see each turn ``correct`` false, and ``readings.py`` reads them on
the card at a cell's own load.  ``plant(name)`` patches the port in place
and returns the function that undoes it."""
from __future__ import annotations

from typing import Callable

import torch


def altered_token() -> Callable[[], None]:
    """At the engine's decode step 1, where it chooses the tokens, each
    running request's token is replaced by the next token id: one token
    of each request of a closed wave."""
    from repro_torch.launch.engine import ServingEngine
    sample = ServingEngine._sample

    def altered(self, logits, step):
        tok = sample(self, logits, step)
        if step == 1:
            tok = (tok + 1) % logits.shape[-1]
        return tok
    ServingEngine._sample = altered
    return lambda: setattr(ServingEngine, "_sample", sample)


def half_batch() -> Callable[[], None]:
    """Half of the batch left out of each decode step: the second half of
    the rows get the first half's logits."""
    from repro_torch.nn import transformer as T
    step = T.decode_step

    def half(params, cache, tokens, pos, cfg):
        logits, cache = step(params, cache, tokens, pos, cfg)
        n = logits.shape[0] // 2
        return torch.cat([logits[:logits.shape[0] - n], logits[:n]]), cache
    T.decode_step = half
    return lambda: setattr(T, "decode_step", step)


FAULTS = {"altered_token": altered_token, "half_batch": half_batch}


def plant(name: str) -> Callable[[], None]:
    return FAULTS[name]()
