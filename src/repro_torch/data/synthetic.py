"""Deterministic synthetic LM data pipeline (the port of
``repro/data/synthetic.py``).

Every batch is a pure function of (seed, step, host): restart-safe by
construction (a resumed run continues the stream exactly), sharded per
host, with a background prefetch thread.  Token draws follow a power law
over the vocab so the loss curve behaves like language rather than uniform
noise.  Batches are numpy arrays equal to the reference's, since both draw
them with numpy; the host index and count, which the reference reads from
``jax.process_index/count``, are arguments (one host by default).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    skew: float = 3.0            # power-law exponent for token frequencies


class SyntheticLM:
    """Host-sharded deterministic token stream."""

    def __init__(self, cfg: DataConfig, process_index: int = 0,
                 process_count: int = 1):
        if cfg.global_batch % process_count:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {process_count} hosts")
        self.cfg = cfg
        self.pi = process_index
        self.pc = process_count
        self.local_batch = cfg.global_batch // process_count

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The (deterministic) local batch for a given global step."""
        c = self.cfg
        rng = np.random.default_rng(
            np.uint64(hash((c.seed, int(step), self.pi)) & 0x7FFFFFFFFFFFFFF))
        u = rng.random((self.local_batch, c.seq_len))
        tokens = np.floor((u ** c.skew) * c.vocab_size).astype(np.int32)
        # Inject structure: short repeated motifs so the LM has signal.
        motif = rng.integers(0, c.vocab_size, size=(8,), dtype=np.int32)
        pos = rng.integers(0, max(1, c.seq_len - 8))
        tokens[:, pos:pos + 8] = motif
        return {"tokens": tokens}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (depth-N) over any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)
            self.q.put(None)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
