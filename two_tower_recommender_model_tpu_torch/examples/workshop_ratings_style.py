"""The ratings path: explicit ratings -> binary labels (below the mean: 0)
-> a small-table two-tower model -> a check of the serving input -> an HTTP
endpoint on localhost, asked for two predictions.

    python -m two_tower_recommender_model_tpu_torch.examples.workshop_ratings_style \\
        [--device cpu] [--batches 150]

The port of `examples/workshop_ratings_style.py` (193 users, 9,740 items).
Its HTTP requests go only to the `ModelServer` it starts on 127.0.0.1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import urllib.request

import numpy as np
import torch

from two_tower_recommender_model_tpu_torch import config as cfg
from two_tower_recommender_model_tpu_torch.data import Featurizer
from two_tower_recommender_model_tpu_torch.data.feature_engineering import binarize_ratings
from two_tower_recommender_model_tpu_torch.device import resolve_device
from two_tower_recommender_model_tpu_torch.serving import Scorer
from two_tower_recommender_model_tpu_torch.serving.server import (
    ModelServer,
    validate_serving_input,
)
from two_tower_recommender_model_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_train_step,
    train_val_test,
)


def synth_ratings(n, n_users=193, n_items=9740, seed=0):
    """Ratings-shaped synthetic data (the workshop's sample dims): ratings
    anchored on each user and item, so labels carry signal."""
    rng = np.random.default_rng(seed)
    users = rng.integers(1, n_users + 1, n)
    items = rng.integers(1, n_items + 1, n)
    base = 2.5 + 1.5 * np.sin(users * 0.7) * np.cos(items * 0.3)
    ratings = np.clip(base + rng.normal(0, 0.8, n), 0.5, 5.0)
    return {"user_id": users, "product_id": items, "rating": ratings}


def main(device: str | None = None, train_batches: int = 150) -> dict:
    device = resolve_device(device)
    n_users, n_items = 193, 9740
    mcfg = cfg.two_tower_model_config(n_users + 1, n_items + 1, embedding_dim=64,
                                      layer_sizes=(128, 64))
    # linear heads and a hot sparse lr: the small-table config learns per-id biases quickly
    mcfg = dataclasses.replace(
        mcfg,
        query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(mcfg.candidate_tower, final_activation=False))
    tcfg = cfg.TrainConfig(epochs=2, sparse_learning_rate=0.1, learning_rate=3e-3,
                           limit_val_batches=4, limit_test_batches=4)
    feat = Featurizer(mcfg, device="cpu")

    def batches(n_batches, seed):
        for i in range(n_batches):
            cols = synth_ratings(1024, seed=seed * 1000 + i)
            cols["label"] = binarize_ratings(cols.pop("rating"))
            yield cols

    state, dense_opt = create_train_state(torch.Generator(device=device).manual_seed(0),
                                          mcfg, tcfg)
    state, results = train_val_test(
        state, make_train_step(mcfg, tcfg, dense_opt), make_eval_step(mcfg, tcfg),
        mcfg, tcfg, feat,
        train_batches_factory=lambda ep: batches(train_batches, ep),
        val_batches_factory=lambda: batches(4, 777),
        test_batches_factory=lambda: batches(4, 888))
    print("train:", {k: round(v, 4) for k, v in results.items() if "auroc" in k})

    scorer = Scorer(state.model)
    payload = {"dataframe_split": {"columns": ["user_id", "product_id"],
                                   "data": [[1, 42], [2, 99]]}}
    validate_serving_input(scorer, payload)  # the contract check before deployment
    with ModelServer(scorer) as srv:
        req = urllib.request.Request(srv.url + "/invocations", json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            out = json.loads(r.read())
    print("endpoint predictions:", [round(p, 4) for p in out["predictions"]])
    return {**results, "predictions": out["predictions"]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--batches", type=int, default=150, help="train batches an epoch")
    a = ap.parse_args()
    res = main(a.device, a.batches)
    assert res["test_auroc"] > 0.6, res
    print("WORKSHOP E2E OK")
