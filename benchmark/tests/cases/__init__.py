"""The benchmark's CPU test cases, one file a model family:
``cases/<name>.json`` beside ``tests/tiny_<name>.py``.

- ``tiny``: the tiny config the reference is held to the port at;
- ``feature_hw``: the input size of the feature test;
- ``train_step``: the traffic and the limits of the first train steps
  at the tiny size, each limit with its reason (``value``, ``why``);
- ``small``: the published layout at widths a CPU counts quickly
  (``repo_configs``, ``overrides``, ``hw``) for the MAC test;
- ``mac_depth_cut``: the meta keys that keep the MAC test's archs inside
  the small layout's depths.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List

CASES_DIR = os.path.dirname(os.path.abspath(__file__))


def names() -> List[str]:
    return sorted(os.path.basename(p)[:-len(".json")]
                  for p in glob.glob(os.path.join(CASES_DIR, "*.json")))


def load(name: str) -> Dict[str, Any]:
    with open(os.path.join(CASES_DIR, name + ".json")) as f:
        return json.load(f)


def limits(case: Dict[str, Any]) -> Dict[str, float]:
    """The train-step limits without their reasons."""
    return {k: v["value"] for k, v in case["train_step"]["limits"].items()}
