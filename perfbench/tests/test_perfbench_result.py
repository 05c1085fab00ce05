"""The run's result line and BENCHMARK.json: the keys, the names and units
in the allowed characters, every cell's files present, and a run on a
host without a card refused rather than moved to the CPU."""
import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from perfbench import run, spec
from perfbench.tests import smoke

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
WIDTH = re.compile(r"(_dim|_rank)$|^hidden_size$|intermediate|latent|state"
                   r"|proj|expansion|experts_per_tok")


@pytest.mark.parametrize("workload", CELLS)
def test_result_line_of_a_sound_run(workload):
    t = time.perf_counter()
    out = run.execute(smoke.cell(workload), 2**31 + 99, 0.0, False,
                      device="cpu", t_start=t)
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "check"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    cell = spec.load_cell(workload)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    for name, m in out["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"])
        assert m["value"] > 0
    assert set(out["check"]) == set(cell.limits["numbers"])
    json.loads(json.dumps(out))


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert (spec.ROOT / c["file"]).exists()
        assert not any(WIDTH.search(k) for k in c["reduced"])
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert cfg["source"] == c["source"]
        assert set(c["reduced"]) == set(cfg["published"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert (spec.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        for w in m["workloads"]:
            assert w in CELLS
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        cell = spec.load_cell(w["name"], BENCH)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal is for hosts "
                    "without one")
    p = subprocess.run(
        [sys.executable, str(spec.BENCH_DIR / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=spec.ROOT,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode == 2
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
