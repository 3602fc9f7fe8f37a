"""Batch scoring with the PyFunc-style dict-of-arrays contract.

Port of `two_tower_recommender_model_tpu/serving/scorer.py`: raw id columns
in, per-row interaction probabilities out (sigmoid over the dot-product
logits), with the training featurizer's hash/drop semantics. The reference
pads requests to power-of-two buckets to bound XLA recompiles; PyTorch runs
eagerly, so requests run at their own size (rows are independent, so the
results are the same).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from two_tower_recommender_model_tpu_torch.data.featurizer import Batch, Featurizer
from two_tower_recommender_model_tpu_torch.models.two_tower import (
    TwoTower,
    forward,
    params_from_numpy,
)


class Scorer:
    def __init__(self, model: TwoTower, drop_zero_ids: bool = True,
                 dense_cols: tuple[str, ...] = ()):
        self.model = model
        self.featurizer = Featurizer(model.cfg, drop_zero_ids, dense_cols, device=model.device)

    def _prepare(self, inputs: Mapping[str, Any]) -> Batch:
        cols = {k: np.asarray(v) for k, v in inputs.items()}
        if "label" not in cols:
            first = next(iter(cols.values()))
            cols["label"] = np.zeros(len(first), np.int64)
        return self.featurizer(cols)

    @torch.no_grad()
    def predict(self, inputs: Mapping[str, Any]) -> np.ndarray:
        """dict of id columns (+optional dense) -> [n] probabilities."""
        q, c = forward(self.model, self._prepare(inputs))
        return torch.sigmoid(torch.sum(q * c, dim=1)).float().cpu().numpy()

    @torch.no_grad()
    def embed(self, inputs: Mapping[str, Any]) -> tuple[np.ndarray, np.ndarray]:
        """dict of id columns -> (query_embeddings, candidate_embeddings).
        Outputs come back as float32 (bfloat16 widens exactly)."""
        q, c = forward(self.model, self._prepare(inputs))
        return q.float().cpu().numpy(), c.float().cpu().numpy()


def load_scorer(path: str, device: torch.device | str | None = None, **kwargs) -> Scorer:
    """A Scorer on `device` from an `export_model` directory of the JAX
    package (`model_config.json` + `params.npz`)."""
    from two_tower_recommender_model_tpu_torch.utils.checkpoint import load_model

    model_cfg, params = load_model(path)
    return Scorer(params_from_numpy(params, model_cfg, device), **kwargs)


def load_scorer_from_registry(registry_root: str, name: str, version="Production",
                              device: torch.device | str | None = None, **kwargs) -> Scorer:
    """A Scorer on `device` for a registered model by stage, number or
    "latest" (the `models:/<name>/<stage>` serving-URI role)."""
    from two_tower_recommender_model_tpu_torch.utils.registry import ModelRegistry

    model_cfg, params = ModelRegistry(registry_root).load(name, version)
    return Scorer(params_from_numpy(params, model_cfg, device), **kwargs)
