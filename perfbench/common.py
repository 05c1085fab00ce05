"""Device stamps, the kernel build, and freeing the program's state
before the reference runs."""
from __future__ import annotations

import gc
import time

import torch


class Clock:
    """Stamps on the device's own timeline (CUDA events) on the card and
    the host clock on the CPU; ``ms(a, b)`` reads one once both passed."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def stamp(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def build_kernels(device: torch.device) -> None:
    """The port's CUDA sources, built once into the checkout's
    ``build/repro_torch`` (one nvcc a source, all at once)."""
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.build(("matmul", "flash_attention"))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
