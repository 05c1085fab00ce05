"""The served tokens judged by the reference.

For each sampled request the reference runs once over its prompt and its
served tokens, and each served token is read at the position that chose
it: its gap is how far its logit lies below the reference's best there,
in units of the standard deviation of the reference's logits at that
position (a gap of 0 is the reference's own choice).  The number compared
is the mean gap over the positions the reference's routing decides (the
widest is printed beside it): in an MoE model, a position at which some
layer's k-th and (k+1)-th router logits lie within ``router_margin`` of
each other could take either expert in any arithmetic near bf16 (a plain
bf16 computation does flip there), and the two choices lead to different
tokens; such a position is not judged.  A dense model's positions are
all judged.  That holds for greedy tokens only, which all cells serve.

The control reads, at the same positions of the same sequences, the gap
of the token the lower precision puts first.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench.reference.fp8 import fp8_mm
from perfbench.reference.model import f32_mm, logits_at, no_tf32


def _seqs(requests: Sequence[Dict], device) -> list:
    out = []
    for r in requests:
        prompt, served = np.asarray(r["prompt"]), np.asarray(r["tokens"])
        toks = np.concatenate([prompt, served[:-1]]).astype(np.int64)
        out.append((torch.as_tensor(toks, device=device), len(prompt) - 1,
                    len(served), len(prompt), int(r["padded"])))
    return out


def _gaps(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    best = ref.max(-1).values
    return (best - ref.gather(-1, chosen[:, None])[:, 0]) / ref.std(-1)


def _widest(gaps: List[torch.Tensor], judged: List[torch.Tensor]) -> float:
    return max((float(g[j].max()) for g, j in zip(gaps, judged)
                if bool(j.any())), default=0.0)


def _mean(gaps: List[torch.Tensor], judged: List[torch.Tensor]) -> float:
    n = sum(int(j.sum()) for j in judged)
    return sum(float(g[j].sum()) for g, j in zip(gaps, judged)) / max(n, 1)


@torch.no_grad()
def judge(flat: Dict, run: Dict, requests: Sequence[Dict], device,
          router_margin: float, control: bool = False) -> Dict[str, float]:
    """{"gap_sd_mean", "gap_sd_widest": the mean and the widest gap of
    the served tokens at the judged positions, "judged": their share of
    the served tokens} and, with ``control``, "control_gap_sd_mean" and
    "control_gap_sd_widest": those of the fp8 reference's first choices
    at the same positions."""
    no_tf32()
    seqs = _seqs(requests, device)
    margins: list = []
    ref = logits_at(flat, run, seqs, f32_mm, margins)
    judged = [torch.ones(l.shape[0], dtype=torch.bool, device=device)
              if m is None else m >= router_margin
              for l, m in zip(ref, margins)]
    served = [torch.as_tensor(np.asarray(r["tokens"], np.int64),
                              device=device) for r in requests]
    gaps = [_gaps(l, t) for l, t in zip(ref, served)]
    out = {"gap_sd_mean": _mean(gaps, judged),
           "gap_sd_widest": _widest(gaps, judged),
           "judged": float(sum(int(j.sum()) for j in judged)
                           / sum(j.numel() for j in judged))}
    if control:
        low = [_gaps(l, q.argmax(-1))
               for l, q in zip(ref, logits_at(flat, run, seqs, fp8_mm))]
        out["control_gap_sd_mean"] = _mean(low, judged)
        out["control_gap_sd_widest"] = _widest(low, judged)
    return out
