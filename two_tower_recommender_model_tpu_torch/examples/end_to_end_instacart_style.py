"""End to end: raw interactions -> feature engineering -> TTRS shards ->
streaming training with checkpoints and tracking -> restore -> export ->
serving -> retrieval eval on held-out positives.

    python -m two_tower_recommender_model_tpu_torch.examples.end_to_end_instacart_style \\
        [--work DIR] [--device cpu] [--users 800 --items 300 --rows 40000]

The port of `examples/end_to_end_instacart_style.py`, on the port's numpy
feature engineering (tables are dicts of numpy columns). Prints the splits,
the train and test metrics, a few scores and recall@10 / @100.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from two_tower_recommender_model_tpu_torch import config as cfg
from two_tower_recommender_model_tpu_torch.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model_tpu_torch.data.feature_engineering import (
    build_positive_pairs,
    index_ids,
    per_user_split,
    sample_negatives,
    splits_to_columns,
    union_pos_neg,
)
from two_tower_recommender_model_tpu_torch.data.loader import StreamLoader
from two_tower_recommender_model_tpu_torch.data.shards import write_dataset
from two_tower_recommender_model_tpu_torch.device import resolve_device
from two_tower_recommender_model_tpu_torch.evaluation import evaluate_retrieval
from two_tower_recommender_model_tpu_torch.serving import load_scorer
from two_tower_recommender_model_tpu_torch.train import (
    create_train_state,
    make_eval_step,
    make_train_step,
    train_val_test,
)
from two_tower_recommender_model_tpu_torch.utils.checkpoint import Checkpointer, export_model
from two_tower_recommender_model_tpu_torch.utils.tracking import ExperimentLogger


def test_positives(indexed: dict) -> dict[int, list]:
    """The test split's positives grouped per user index, in row order."""
    m = (indexed["split"] == "test") & (indexed["label"] == 1)
    users, items = indexed["user_id_index"][m], indexed["product_id_index"][m]
    out: dict[int, list] = {}
    for u, i in zip(users.tolist(), items.tolist()):
        out.setdefault(u, []).append(i)
    return out


def main(work: str | None = None, device: str | None = None, num_users: int = 800,
         num_items: int = 300, rows: int = 40_000, epochs: int = 3) -> dict:
    device = resolve_device(device)
    work = work or tempfile.mkdtemp(prefix="two_tower_e2e_")

    # 1. "raw" interactions -> positives + sampled negatives -> split -> index
    raw = SyntheticClickstream(num_users, num_items, seed=9, noise=0.05,
                               latent_dim=4).sample(rows)
    clicked = np.asarray(raw["label"]) == 1
    inter = {"user_id": np.asarray(raw["user_id"])[clicked],
             "product_id": np.asarray(raw["product_id"])[clicked]}
    pos = build_positive_pairs(inter)
    neg = sample_negatives(pos, np.arange(1, num_items + 1), seed=0)
    df = per_user_split(union_pos_neg(pos, neg), seed=0)
    indexed, mappings = index_ids(df)
    splits = splits_to_columns(indexed)
    print("splits:", {k: len(v["label"]) for k, v in splits.items()})
    for name, cols in splits.items():
        write_dataset(os.path.join(work, name), cols, rows_per_shard=2048)

    # 2. model + streaming training with checkpoints + tracking
    n_users, n_items = len(mappings["user_id"]), len(mappings["product_id"])
    mcfg = cfg.two_tower_model_config(n_users + 1, n_items + 1, embedding_dim=32,
                                      layer_sizes=(64, 32))
    mcfg = dataclasses.replace(
        mcfg,
        query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(mcfg.candidate_tower, final_activation=False))
    tcfg = cfg.TrainConfig(epochs=epochs, sparse_learning_rate=0.1, learning_rate=3e-3)
    feat = Featurizer(mcfg, device="cpu")  # host batches; the loop moves them
    logger = ExperimentLogger(os.path.join(work, "runs"))
    logger.log_params({"n_users": n_users, "n_items": n_items})
    ckpt = Checkpointer(os.path.join(work, "ckpt"))
    state, dense_opt = create_train_state(torch.Generator(device=device).manual_seed(0),
                                          mcfg, tcfg)

    def train_factory(ep):
        loader = StreamLoader(os.path.join(work, "train"), 512, seed=1)
        loader.set_epoch(ep)
        return loader

    state, results = train_val_test(
        state, make_train_step(mcfg, tcfg, dense_opt), make_eval_step(mcfg, tcfg),
        mcfg, tcfg, feat,
        train_batches_factory=train_factory,
        val_batches_factory=lambda: StreamLoader(os.path.join(work, "val"), 512,
                                                 shuffle=False, drop_last=False),
        test_batches_factory=lambda: StreamLoader(os.path.join(work, "test"), 512,
                                                  shuffle=False, drop_last=False),
        logger=logger,
        checkpoint_fn=lambda s, ep: ckpt.save(int(s.step), s, wait=True),
    )
    print("train:", {k: round(v, 4) for k, v in results.items() if "auroc" in k or "loss" in k})

    # 3. restore the latest checkpoint -> export -> serve
    template, _ = create_train_state(torch.Generator(device=device).manual_seed(9), mcfg, tcfg)
    restored, _, _ = ckpt.restore(template)
    export_model(os.path.join(work, "model"), mcfg, restored)
    scorer = load_scorer(os.path.join(work, "model"), device=device)
    print("scorer probs:",
          scorer.predict({"user_id": [1, 2, 3], "product_id": [5, 6, 7]}).round(3))

    # 4. retrieval eval on the held-out test positives
    m = evaluate_retrieval(restored.model, test_positives(indexed), k=100, ks=(10, 100))
    print("retrieval:", {k: round(v, 4) for k, v in m.items()})
    print("metric lines:", len(logger.metrics()))
    return {**results, **m}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=None, help="working directory (default: a new temp dir)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--users", type=int, default=800)
    ap.add_argument("--items", type=int, default=300)
    ap.add_argument("--rows", type=int, default=40_000)
    ap.add_argument("--epochs", type=int, default=3)
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    out = main(a.work, a.device, a.users, a.items, a.rows, a.epochs)
    assert out["test_auroc"] > 0.6 and out["recall_at_100"] > 0.3, out
    print("E2E OK")
