"""The portable model export: writing and reading it.

`export_model` writes what the JAX package's `utils/checkpoint.py:
export_model` writes: `model_config.json` and `params.npz`, f32 arrays in the
JAX pytree layout (`params_to_numpy`; an int8 table is written as the f32
rows it dequantizes to). `load_model` reads such a directory
with json and numpy only. So either package serves a model the other trained
(`params_from_numpy`, `serving.scorer.load_scorer`). Training checkpoints
(orbax in the JAX package) are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np

from two_tower_recommender_model_tpu_torch.config import ModelConfig, model_config_from_dict
from two_tower_recommender_model_tpu_torch.models.two_tower import params_to_numpy


def export_model(path: str, model_cfg: ModelConfig, state) -> None:
    """Write `state.model` (a `train.step.TrainState`) as a portable export.
    The arrays are f32 whatever the storage dtype, so the stored config
    names no table dtype."""
    os.makedirs(path, exist_ok=True)
    cfg_dict = dataclasses.asdict(model_cfg)
    cfg_dict["table_dtype"] = None
    for t in cfg_dict.get("tables", []):
        t["dtype"] = None
    with open(os.path.join(path, "model_config.json"), "w") as f:
        json.dump(cfg_dict, f, indent=1)
    params = params_to_numpy(state.model, dequantize=True)
    flat = {f"tables/{name}": arr for name, arr in params["tables"].items()}
    for tower in ("query_tower", "candidate_tower"):
        for lname, layer in params[tower].items():
            for p, arr in layer.items():
                flat[f"{tower}/{lname}/{p}"] = arr
    np.savez(os.path.join(path, "params.npz"), **flat)


def load_model(path: str) -> tuple[ModelConfig, dict]:
    """(model_cfg, params) from an export directory; params are numpy arrays
    in the JAX pytree layout."""
    with open(os.path.join(path, "model_config.json")) as f:
        model_cfg = model_config_from_dict(json.load(f))
    params: dict[str, Any] = {"tables": {}, "query_tower": {}, "candidate_tower": {}}
    with np.load(os.path.join(path, "params.npz")) as data:
        for key in data.files:
            parts = key.split("/")
            if parts[0] == "tables":
                params["tables"][parts[1]] = data[key]
            else:
                params[parts[0]].setdefault(parts[1], {})[parts[2]] = data[key]
    return model_cfg, params
