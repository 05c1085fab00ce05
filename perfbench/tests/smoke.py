"""Cells of the benchmark cut to CPU size for its tests: the real cell's
configuration and mix with every size shrunk, the limits as they are."""
from __future__ import annotations

import copy
from typing import Dict

from perfbench import spec

_SIZES = {"hidden_size": 64, "intermediate_size": 128,
          "num_attention_heads": 4, "num_key_value_heads": 2,
          "num_hidden_layers": 2, "vocab_size": 256}


def shrink(config: Dict) -> Dict:
    """A configuration file's contents with every size cut to CPU size."""
    config = copy.deepcopy(config)
    config.update(_SIZES)
    config["assumed"]["head_dim"]["run"] = 16
    if "num_local_experts" in config:
        config["num_local_experts"] = 4
    return config


def cell(workload: str) -> spec.Cell:
    c = spec.load_cell(workload)
    c.config = shrink(c.config)
    mix = copy.deepcopy(c.traffic)
    mix.update(slots=4, set=8, max_new_tokens=4, buckets=2,
               check_requests=3)
    mix["prompt"].update(lo=8, hi=40)
    c.traffic = mix
    return c
