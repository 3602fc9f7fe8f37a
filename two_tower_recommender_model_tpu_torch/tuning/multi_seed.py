"""Multi-seed trials: S independent models trained on the same batches.

Port of `two_tower_recommender_model_tpu/tuning/multi_seed.py`. The
reference stacks S `TrainState`s and runs them as one program through
`jax.vmap`. The port's train step updates its tables in place through its
CUDA kernels (#4, #6), which `torch.func.vmap` cannot batch, so here each
seed keeps its own state and its own train step (`make_train_step`), and
every batch goes through the S steps one after another, on the batch's one
device copy. The result is the reference's: per seed, the last train loss
and the eval AUROC.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from two_tower_recommender_model_tpu_torch.config import ModelConfig, TrainConfig
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.device import resolve_device
from two_tower_recommender_model_tpu_torch.models import two_tower
from two_tower_recommender_model_tpu_torch.models.metrics import exact_auroc
from two_tower_recommender_model_tpu_torch.train.step import create_train_state, make_train_step


def multi_seed_train(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    seeds: Iterable[int],
    train_batches: Iterable[dict],
    eval_batch: dict,
    featurizer: Featurizer | None = None,
    device: torch.device | str | None = None,
) -> dict[str, np.ndarray]:
    """Train one model per seed (its state drawn from a generator seeded with
    it, on `device`: the card unless given) on the same batches; returns
    `{"seeds", "final_train_loss", "eval_auroc"}`, arrays aligned with
    `seeds` (the loss NaN when no batch came)."""
    seeds = list(seeds)
    device = resolve_device(device)
    featurizer = featurizer or Featurizer(model_cfg, device=device)

    runs = []
    for s in seeds:
        state, dense_opt = create_train_state(torch.Generator(device=device).manual_seed(s),
                                              model_cfg, train_cfg)
        runs.append((state, make_train_step(model_cfg, train_cfg, dense_opt)))

    losses = None
    for cols in train_batches:
        batch = featurizer(cols)
        losses = [step(state, batch)[1]["loss"] for state, step in runs]

    ev = featurizer(eval_batch)
    labels = ev.labels.cpu().numpy()
    aurocs = []
    with torch.no_grad():
        for state, _ in runs:
            q, c = two_tower.forward(state.model, ev)
            aurocs.append(exact_auroc(torch.sum(q * c, dim=1).float().cpu().numpy(), labels))
    return {
        "seeds": np.array(seeds),
        "final_train_loss": (np.array([loss.float().item() for loss in losses], np.float32)
                             if losses is not None else np.full(len(seeds), np.nan)),
        "eval_auroc": np.array(aurocs),
    }
