"""Model-priced shape bucketing for ragged serving workloads.

A serving engine cannot compile a kernel per request shape: ragged token
batches (the GEMM M extent) must be padded up to a small set of *bucket
edges*, one compiled executable per edge.  The classic policy pads to powers
of two — shape-blind, and on multi-core chips it routinely parks an edge
just past a wave boundary, where the tail-wave quantization the occupancy
model prices (Alg. 4; reproduced by ``benchmarks/wave_quantization.py`` as
38-47% throughput dips) wastes most of a wave.

Here the bucket set itself is an output of the analytical model.  For a
measured M-distribution the planner prices every candidate edge with the
real selection pipeline — one :func:`repro_torch.core.select_gemm_config_batch`
call for the whole ``candidates x gemms`` grid — and a small DP picks the
edge set minimizing model-predicted *total* serving time:

    total(edges) = sum_m  w(m) * step_cost(edge(m))         padding waste
                 + n_edges * bucket_overhead_s              compile/warm-up

``step_cost(e)`` is the modeled latency of one transformer step's GEMMs at
M = e, so a cliff edge (occupancy dip) prices itself out and the chosen
edges land on wave boundaries instead of powers of two.  Per-bucket edge
choice is independent: a bucket covering sizes up to s needs only
``edge >= s``, and the best such edge is a pure argmin over the priced
candidates — the DP composes those argmins over contiguous size ranges.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.selector import Selection, select_gemm_config_batch
from repro_torch.core.topology import Topology
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


def step_gemms(d_model: int, d_ff: int, *, kv_dim: Optional[int] = None,
               vocab: Optional[int] = None, swiglu: bool = True
               ) -> List[Tuple[int, int]]:
    """The (N, K) extents of one decoder step's GEMMs — the per-token work a
    bucket edge multiplies.  Mirrors ``configs.llama3_shapes`` structure:
    fused QKV, attention output, up (doubled when the MLP is gated), down,
    and optionally the LM head."""
    kv = kv_dim if kv_dim is not None else d_model
    gemms = [
        (d_model + 2 * kv, d_model),          # fused QKV projection
        (d_model, d_model),                   # attention output
        ((2 if swiglu else 1) * d_ff, d_model),  # MLP up (+gate when gated)
        (d_model, d_ff),                      # MLP down
    ]
    if vocab:
        gemms.append((vocab, d_model))
    return gemms


@dataclass(frozen=True)
class BucketPlan:
    """A priced bucket policy: ascending pad targets + the model's receipts.

    ``edges`` are the only M extents the engine ever launches; ``bucket_for``
    maps a ragged size to its pad target.  ``modeled_total_s`` is the DP
    objective value (padding waste + per-bucket overhead) for the planning
    distribution; ``edge_step_s`` the per-request step cost at each edge —
    kept so serving stats can attribute measured time to modeled time."""
    edges: Tuple[int, ...]
    policy: str
    modeled_total_s: float
    modeled_request_s: float            # weighted mean step cost per request
    pad_fraction: float                 # padded-away share of launched rows
    bucket_overhead_s: float
    edge_step_s: Dict[int, float] = field(default_factory=dict, repr=False)
    selections: Dict[int, Tuple[Selection, ...]] = field(
        default_factory=dict, repr=False, compare=False)

    def bucket_for(self, size: int) -> int:
        """Smallest edge >= size.  Sizes beyond the largest edge raise —
        admission must clamp/chunk before asking for a bucket."""
        i = bisect.bisect_left(self.edges, size)
        if i == len(self.edges):
            raise ValueError(
                f"request size {size} exceeds largest bucket edge "
                f"{self.edges[-1]}")
        return self.edges[i]


def _price_edges(candidates: Sequence[int], gemms: Sequence[Tuple[int, int]],
                 hw: Topology, in_dtype: str, out_dtype: str
                 ) -> Tuple[Dict[int, float], Dict[int, Tuple[Selection, ...]]]:
    """Model-predicted one-step cost at M = each candidate edge — ONE
    batched selection call for the whole (edge x gemm) grid."""
    shapes = [(e, n, k) for e in candidates for (n, k) in gemms]
    sels = select_gemm_config_batch(shapes, in_dtype=in_dtype,
                                    out_dtype=out_dtype, hw=hw)
    g = len(gemms)
    cost: Dict[int, float] = {}
    per_edge: Dict[int, Tuple[Selection, ...]] = {}
    for i, e in enumerate(candidates):
        block = sels[i * g:(i + 1) * g]
        cost[e] = sum(s.predicted.total for s in block)
        per_edge[e] = tuple(block)
    return cost, per_edge


def _normalize(sizes: Sequence[int], weights: Optional[Sequence[float]]
               ) -> Tuple[List[int], List[float]]:
    if len(sizes) == 0:
        raise ValueError("plan_buckets needs at least one request size")
    w = [1.0] * len(sizes) if weights is None else [float(x) for x in weights]
    if len(w) != len(sizes):
        raise ValueError(f"{len(sizes)} sizes but {len(w)} weights")
    agg: Dict[int, float] = {}
    for s, ww in zip(sizes, w):
        s = int(s)
        if s < 1:
            raise ValueError(f"request size {s} < 1")
        if ww < 0:
            raise ValueError(f"negative weight {ww}")
        agg[s] = agg.get(s, 0.0) + ww
    ss = sorted(agg)
    return ss, [agg[s] for s in ss]


def _plan_stats(ss: List[int], ws: List[float], edges: List[int],
                cost: Dict[int, float], overhead: float
                ) -> Tuple[float, float, float]:
    tot_w = sum(ws)
    total = len(edges) * overhead
    req_s = 0.0
    padded_rows = real_rows = 0.0
    for s, w in zip(ss, ws):
        e = edges[bisect.bisect_left(edges, s)]
        total += w * cost[e]
        req_s += w * cost[e]
        padded_rows += w * e
        real_rows += w * s
    pad_frac = 1.0 - real_rows / padded_rows if padded_rows else 0.0
    return total, req_s / tot_w if tot_w else 0.0, pad_frac


def plan_buckets(sizes: Sequence[int], weights: Optional[Sequence[float]]
                 = None, *, gemms: Sequence[Tuple[int, int]],
                 hw: Topology, max_buckets: int = 8,
                 bucket_overhead_s: float = 1e-3,
                 granularity: int = 8,
                 in_dtype: str = "bfloat16", out_dtype: str = "float32"
                 ) -> BucketPlan:
    """Pick <= max_buckets pad targets minimizing model-predicted total time.

    Candidate edges are every multiple of ``granularity`` covering the size
    range (plus the exact maximum), all priced in one batched selection
    pass.  DP over the sorted distinct sizes: a bucket covers a contiguous
    size range and pays ``weight * best_cost(range max)`` where
    ``best_cost(s) = min over candidates e >= s of step_cost(e)`` — the
    per-bucket best-edge independence that makes the DP exact.  Because
    ``step_cost`` is *not* monotone in M on multi-core chips (tail-wave
    cliffs), best_cost frequently picks an edge above the minimal cover —
    that is the model steering edges onto wave boundaries."""
    if max_buckets < 1:
        raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
    if granularity < 1:
        raise ValueError(f"granularity must be >= 1, got {granularity}")
    with obs_trace.span("plan_buckets", cat="bucketing", track="bucketing",
                        args={"n_sizes": len(sizes),
                              "max_buckets": max_buckets}) as _sp:
        plan = _plan_buckets(sizes, weights, gemms=gemms, hw=hw,
                             max_buckets=max_buckets,
                             bucket_overhead_s=bucket_overhead_s,
                             granularity=granularity,
                             in_dtype=in_dtype, out_dtype=out_dtype)
        if _sp is not None:
            _sp.args["edges"] = list(plan.edges)
            _sp.args["modeled_total_s"] = plan.modeled_total_s
            _sp.args["pad_fraction"] = plan.pad_fraction
    obs_metrics.set_gauge("bucket_plan_edges", len(plan.edges))
    obs_metrics.set_gauge("bucket_plan_pad_fraction", plan.pad_fraction)
    obs_metrics.set_gauge("bucket_plan_modeled_total_s",
                          plan.modeled_total_s)
    return plan


def _plan_buckets(sizes: Sequence[int], weights: Optional[Sequence[float]]
                  = None, *, gemms: Sequence[Tuple[int, int]],
                  hw: Topology, max_buckets: int = 8,
                  bucket_overhead_s: float = 1e-3,
                  granularity: int = 8,
                  in_dtype: str = "bfloat16", out_dtype: str = "float32"
                  ) -> BucketPlan:
    ss, ws = _normalize(sizes, weights)
    hi = ss[-1]
    # Candidates: every granularity multiple covering the range, with 25%
    # headroom above the max — when a cliff sits exactly at the max size,
    # padding PAST it can be cheaper than landing on it — plus the exact max.
    top = ((hi + hi // 4) // granularity + 1) * granularity
    cands = sorted(set(range(granularity, top + 1, granularity)) | {hi})
    cost, per_edge = _price_edges(cands, gemms, hw, in_dtype, out_dtype)

    # best edge covering size >= s, for every distinct size (suffix argmin
    # over candidates — cliffs make this genuinely non-trivial).
    carr = np.asarray([cost[e] for e in cands])
    best_edge_for: Dict[int, int] = {}
    suffix_best: List[int] = [0] * len(cands)
    bi_ = len(cands) - 1
    suffix_best[-1] = len(cands) - 1
    for i in range(len(cands) - 2, -1, -1):
        bi_ = i if carr[i] <= carr[suffix_best[i + 1]] else suffix_best[i + 1]
        suffix_best[i] = bi_
    for s in ss:
        j = bisect.bisect_left(cands, s)
        best_edge_for[s] = cands[suffix_best[j]]

    n = len(ss)
    kmax = min(max_buckets, n)
    # dp[j][i]: min cost covering sizes[0:i] with exactly j buckets.
    w_pref = np.concatenate(([0.0], np.cumsum(ws)))
    INF = float("inf")
    dp = np.full((kmax + 1, n + 1), INF)
    dp[0][0] = 0.0
    choice = np.zeros((kmax + 1, n + 1), np.int64)
    for j in range(1, kmax + 1):
        for i in range(j, n + 1):
            best, arg = INF, i - 1
            e_cost_cache = cost[best_edge_for[ss[i - 1]]]
            for sp in range(j - 1, i):
                if dp[j - 1][sp] == INF:
                    continue
                c = dp[j - 1][sp] \
                    + (w_pref[i] - w_pref[sp]) * e_cost_cache \
                    + bucket_overhead_s
                if c < best:
                    best, arg = c, sp
            dp[j][i] = best
            choice[j][i] = arg
    # ^ note the bucket's edge depends only on its top size ss[i-1] — the
    #   per-bucket best-edge independence argument above.
    jbest = int(np.argmin(dp[1:, n])) + 1
    edges: List[int] = []
    i = n
    for j in range(jbest, 0, -1):
        edges.append(best_edge_for[ss[i - 1]])
        i = int(choice[j][i])
    edges = sorted(set(edges))
    total, req_s, pad_frac = _plan_stats(ss, ws, edges, cost,
                                         bucket_overhead_s)
    return BucketPlan(edges=tuple(edges), policy="model_priced",
                      modeled_total_s=total, modeled_request_s=req_s,
                      pad_fraction=pad_frac,
                      bucket_overhead_s=bucket_overhead_s,
                      edge_step_s={e: cost[e] for e in edges},
                      selections={e: per_edge[e] for e in edges})


def pow2_plan(sizes: Sequence[int], weights: Optional[Sequence[float]]
              = None, *, gemms: Sequence[Tuple[int, int]], hw: Topology,
              bucket_overhead_s: float = 1e-3,
              in_dtype: str = "bfloat16", out_dtype: str = "float32"
              ) -> BucketPlan:
    """The shape-blind baseline: pad every request to the next power of two.
    Priced with the same model so the comparison is apples-to-apples."""
    ss, ws = _normalize(sizes, weights)
    edges = sorted({1 << (int(s) - 1).bit_length() for s in ss})
    cost, per_edge = _price_edges(edges, gemms, hw, in_dtype, out_dtype)
    total, req_s, pad_frac = _plan_stats(ss, ws, edges, cost,
                                         bucket_overhead_s)
    return BucketPlan(edges=tuple(edges), policy="pow2",
                      modeled_total_s=total, modeled_request_s=req_s,
                      pad_fraction=pad_frac,
                      bucket_overhead_s=bucket_overhead_s,
                      edge_step_s=cost,
                      selections=per_edge)
