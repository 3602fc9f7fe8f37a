"""Reading the portable model export.

`load_model` reads the directory that the JAX package's
`utils/checkpoint.py:export_model` writes (`model_config.json` +
`params.npz`), with json and numpy only, so a model trained and exported by
the JAX package is served by the port (`params_from_numpy`,
`serving.scorer.load_scorer`). Training checkpoints (orbax in the JAX
package) are not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from two_tower_recommender_model_tpu_torch.config import ModelConfig, model_config_from_dict


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
