"""Full-corpus tower embedding export.

Port of `two_tower_recommender_model_tpu/evaluation/retrieval.py:
export_feature_embeddings`. The row gather goes through `pooled_lookup` with
one slot and weight 1, so on a CUDA model the export runs the pooled-gather
kernel too. `retrieval_metrics` and `evaluate_retrieval` are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from two_tower_recommender_model_tpu_torch.config import ModelConfig
from two_tower_recommender_model_tpu_torch.models.two_tower import TwoTower, torch_dtype
from two_tower_recommender_model_tpu_torch.ops.embedding_ops import pooled_lookup


def _tower_for_feature(model_cfg: ModelConfig, feature_name: str):
    for key, tower in (("query_tower", model_cfg.query_tower),
                       ("candidate_tower", model_cfg.candidate_tower)):
        if feature_name in tower.features:
            return key, tower
    raise ValueError(f"feature {feature_name!r} feeds no tower")


@torch.no_grad()
def export_feature_embeddings(
    model: TwoTower,
    feature_name: str,
    ids: np.ndarray | None = None,
    batch_size: int = 8192,
    dense: np.ndarray | None = None,
) -> torch.Tensor:
    """Tower-space embeddings `[len(ids), out]` on the model's device for
    every id of one feature (all of them when `ids` is None). The tower's
    other features pool to zero (the reference's 0-length-bag trick), and
    `dense` ([len(ids), tower.dense_dim]) supplies its dense side input per
    id, zeros when omitted."""
    cfg = model.cfg
    tower_key, tower = _tower_for_feature(cfg, feature_name)
    fc = cfg.feature(feature_name)
    table_cfg = cfg.table(fc.table)
    table = model.tables[fc.table]
    mlp = getattr(model, tower_key)
    device = table.device
    compute_dtype = torch_dtype(cfg.compute_dtype)
    if ids is None:
        ids = np.arange(table_cfg.num_embeddings)
    # the featurizer's modulo hash: raw ids outside [0, N) hit the row they trained on
    ids = np.asarray(ids) % table_cfg.num_embeddings
    if dense is not None:
        dense = np.asarray(dense, np.float32)
        if dense.shape != (len(ids), tower.dense_dim):
            raise ValueError(f"dense {dense.shape} != ({len(ids)}, {tower.dense_dim})")
        dense = torch.from_numpy(dense).to(device)
    ids_dev = torch.from_numpy(ids.astype(np.int32).reshape(-1, 1)).to(device)

    out = []
    for start in range(0, len(ids), batch_size):
        chunk = ids_dev[start : start + batch_size]
        ones = torch.ones(chunk.shape, dtype=torch.float32, device=device)
        rows = pooled_lookup(table, chunk, ones, "sum", compute_dtype)
        xs = []
        for f in tower.features:
            if f == feature_name:
                xs.append(rows)
            else:
                dim = cfg.feature_table(f).embedding_dim
                xs.append(rows.new_zeros((rows.shape[0], dim)))
        if tower.dense_dim:
            xs.append(rows.new_zeros((rows.shape[0], tower.dense_dim)) if dense is None
                      else dense[start : start + batch_size].to(rows.dtype))
        x = torch.cat(xs, dim=1) if len(xs) > 1 else xs[0]
        out.append(mlp(x, compute_dtype))
    if not out:
        return torch.empty((0, tower.layer_sizes[-1]), dtype=compute_dtype, device=device)
    return torch.cat(out)
