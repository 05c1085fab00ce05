"""What a cell is: its entry in ``BENCHMARK.json`` and the data files the
harness finds by the names there.

* ``perfbench/configs/<file>``: the model configuration.  Its top-level
  keys hold the published values as run (a key cut to fit one chip is
  listed in ``reduced`` and its published value under ``published``);
  ``assumed`` holds every value the run takes where the source gives none
  or the port departs from it, each with the published value beside it.
* ``perfbench/traffic/<traffic>.json``: the traffic mix, read by
  ``perfbench/traffic.py``.
* ``perfbench/limits/<workload>.json``: the limits that decide ``correct``,
  each with the readings it was set from.
* ``perfbench/metrics/<metric>.py``: one reader a per-layer metric.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict                 # the configuration file as it is
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]       # BENCHMARK.json entries this cell reports
    per_layer: List[Dict]

    @property
    def run(self) -> Dict:
        return as_run(self.config)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench: Dict = None) -> Cell:
    """The cell named ``workload`` in ``BENCHMARK.json`` with its files."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(ROOT / cfg_entry["file"]),
        traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH_DIR / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)])


def as_run(config: Dict) -> Dict:
    """The configuration's numbers as the run takes them: the top-level
    keys, then each ``assumed`` key's run value."""
    out = {k: v for k, v in config.items()
           if k not in ("assumed", "published")}
    out.update({k: a["run"] for k, a in config.get("assumed", {}).items()})
    return out


def is_moe(run: Dict) -> bool:
    return int(run.get("num_local_experts") or 0) > 0


def port_config(run: Dict):
    """The port's ``ModelConfig`` for a configuration as run."""
    from repro_torch.nn.config import ModelConfig
    if run.get("partial_rotary_factor", 1.0) != 1.0 \
            or run.get("rope_scaling") is not None \
            or run.get("rms_norm_eps") != 1e-6:
        raise ValueError("the port runs full-width RoPE without scaling "
                         "and RMSNorm at eps 1e-6; the configuration "
                         "asks for something else")
    moe = is_moe(run)
    kw = dict(
        name=run["name"], family="moe" if moe else "dense",
        num_layers=int(run["num_hidden_layers"]),
        d_model=int(run["hidden_size"]),
        vocab_size=int(run["vocab_size"]),
        num_heads=int(run["num_attention_heads"]),
        num_kv_heads=int(run["num_key_value_heads"]),
        head_dim=int(run["head_dim"]),
        d_ff=int(run["intermediate_size"]),
        rope_theta=float(run["rope_theta"]),
        sliding_window=int(run.get("sliding_window") or 0),
        tie_embeddings=bool(run["tie_word_embeddings"]),
        dtype=run["torch_dtype"], remat=True)
    if moe:
        kw.update(num_experts=int(run["num_local_experts"]),
                  experts_per_token=int(run["num_experts_per_tok"]),
                  moe_d_ff=int(run["intermediate_size"]),
                  capacity_factor=float(run["capacity_factor"]))
    return ModelConfig(**kw)
