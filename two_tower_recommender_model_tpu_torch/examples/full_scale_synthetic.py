"""Full-scale integration run: an Instacart-sized synthetic market basket
(206,209 users, 49,688 items, 26M interactions drawn, duplicates dropped)
through the real pipeline: the per-user split, the train split written
pre-packed, streaming training of the flagship (K-step graphs on the card),
validation, and exact retrieval at the reference protocol (10,000 users,
k = 100, the whole corpus). Prints each stage's seconds.

    python -m two_tower_recommender_model_tpu_torch.examples.full_scale_synthetic \\
        [WORKDIR] [--device cpu] [--users N --items N --rows N --epochs N --batch-size N]

The port of `examples/full_scale_synthetic.py`, on numpy (no pandas). The
flags cut the scale (a CPU run needs a few hundred users); the defaults are
the reference's. `FS_BLOCK_KERNEL` sets `block_sorted_kernel` as there.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch


def stage(name, t0):
    print(f"[{name}] {time.perf_counter() - t0:.1f}s", flush=True)
    return time.perf_counter()


def first_pairs(cols: dict) -> dict:
    """The rows of the first occurrence of each (user, product) pair, in row
    order (`drop_duplicates(["user_id", "product_id"], keep="first")`)."""
    key = cols["user_id"].astype(np.int64) * (int(cols["product_id"].max()) + 1) \
        + cols["product_id"].astype(np.int64)
    _, first = np.unique(key, return_index=True)
    first = np.sort(first)
    return {k: np.asarray(v)[first] for k, v in cols.items()}


def test_positives(split: dict, limit: int = 10_000) -> dict[int, list]:
    """The test split's positives per user, the first `limit` users by id."""
    m = (split["split"] == "test") & (split["label"] == 1)
    users, items = split["user_id"][m], split["product_id"][m]
    order = np.argsort(users, kind="stable")
    out: dict[int, list] = {}
    for u, i in zip(users[order].tolist(), items[order].tolist()):
        if u not in out and len(out) == limit:
            break
        out.setdefault(u, []).append(i)
    return out


def main(work: str | None = None, device: str | None = None, num_users: int = 206_209,
         num_items: int = 49_688, rows: int = 26_000_000, epochs: int = 8,
         batch_size: int = 65_536, macro: int = 16) -> dict:
    from two_tower_recommender_model_tpu_torch import config as cfg
    from two_tower_recommender_model_tpu_torch.data import Featurizer, SyntheticClickstream
    from two_tower_recommender_model_tpu_torch.data.device_featurizer import unpack_batch
    from two_tower_recommender_model_tpu_torch.data.feature_engineering import (
        per_user_split,
        splits_to_columns,
    )
    from two_tower_recommender_model_tpu_torch.data.loader import StreamLoader
    from two_tower_recommender_model_tpu_torch.data.prepacked import (
        PrepackedFeaturizer,
        pack_dataset,
    )
    from two_tower_recommender_model_tpu_torch.data.shards import ShardedDataset, write_dataset
    from two_tower_recommender_model_tpu_torch.device import resolve_device
    from two_tower_recommender_model_tpu_torch.evaluation import evaluate_retrieval
    from two_tower_recommender_model_tpu_torch.train import (
        create_train_state,
        evaluate,
        make_eval_step,
        make_multi_step,
        make_train_step,
    )
    from two_tower_recommender_model_tpu_torch.train.loop import train_one_epoch_packed

    device = resolve_device(device)
    work = work or tempfile.mkdtemp(prefix="full_scale_")
    t0 = time.perf_counter()

    # 1. interactions at scale (a synthetic market basket with latent preferences,
    #    items drawn as rank^-1); positives and negatives 1:1 as the reference's union
    ds = SyntheticClickstream(num_users, num_items, seed=0, noise=0.05, latent_dim=4,
                              popularity=1.0)
    df = first_pairs({k: np.asarray(v) for k, v in ds.sample(rows).items()
                      if k in ("user_id", "product_id", "label")})
    t0 = stage(f"interactions ({len(df['label'])} rows, "
               f"{len(np.unique(df['user_id']))} users)", t0)

    # 2. the per-user split and the shards: train pre-packed (featurized once at
    #    write time, mmap reads), val and test as raw columns for the eval path
    mcfg = cfg.two_tower_model_config(num_users + 1, num_items + 1, embedding_dim=128,
                                      layer_sizes=(128, 64))
    split = per_user_split(df, seed=0)
    splits = splits_to_columns(split, user_col="user_id", item_col="product_id")
    for name, c in splits.items():
        if name == "train":
            pack_dataset(os.path.join(work, name), mcfg, c, rows_per_shard=1 << 19)
        else:
            write_dataset(os.path.join(work, name), c, rows_per_shard=1 << 19)
    t0 = stage("split+shards (" + ", ".join(f"{k}={len(v['label'])}"
                                            for k, v in splits.items()) + ")", t0)

    # 3. streaming training of the flagship, host-sorted by user id
    mcfg = dataclasses.replace(
        mcfg,
        query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(mcfg.candidate_tower, final_activation=False))
    tcfg = cfg.TrainConfig(epochs=epochs, batch_size=batch_size, sparse_learning_rate=0.2,
                           learning_rate=3e-3, limit_val_batches=8, sorted_feature="user_id",
                           block_sorted_kernel=os.environ.get("FS_BLOCK_KERNEL", "off"))
    feat = Featurizer(mcfg, device="cpu")
    train_ds = ShardedDataset(os.path.join(work, "train"))
    pf = PrepackedFeaturizer.for_dataset(train_ds, mcfg, sort_feature="user_id")
    state, dense_opt = create_train_state(torch.Generator(device=device).manual_seed(0),
                                          mcfg, tcfg)
    core = make_train_step(mcfg, tcfg, dense_opt)
    multi = make_multi_step(lambda s, pb: core(s, unpack_batch(pb, mcfg, pack_label=True)))
    estep = make_eval_step(mcfg, tcfg)

    results = {}
    for epoch in range(tcfg.epochs):
        loader = StreamLoader(train_ds, tcfg.batch_size, seed=1, read_workers=2)
        loader.set_epoch(epoch)
        state, stats = train_one_epoch_packed(state, multi, loader, pf, macro=macro)
        print(f"  epoch {epoch}: {stats['train_examples']} examples, "
              f"{stats['epoch_time_s']:.2f}s, {stats['examples_per_sec'] / 1e6:.1f}M ex/s",
              flush=True)
        results.update(stats)
    t0 = stage(f"train {tcfg.epochs} epochs", t0)

    val = evaluate(state, estep, StreamLoader(os.path.join(work, "val"), tcfg.batch_size,
                                              shuffle=False, drop_last=False), feat, 8)
    print("  val:", {k: round(v, 4) for k, v in val.items()}, flush=True)
    results.update(val)
    t0 = stage("val eval", t0)

    # 4. retrieval at the reference protocol: 10,000 users, k = 100, the whole corpus
    m = evaluate_retrieval(state.model, test_positives(split), k=100, ks=(10, 100))
    print("  retrieval:", {k: round(v, 4) for k, v in m.items()}, flush=True)
    results.update(m)
    stage(f"retrieval eval ({int(m['num_users'])} users x {num_items} items, exact k=100)", t0)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("work", nargs="?", default=None, help="working directory (default: temp)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--users", type=int, default=206_209)
    ap.add_argument("--items", type=int, default=49_688)
    ap.add_argument("--rows", type=int, default=26_000_000)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=65_536)
    ap.add_argument("--macro", type=int, default=16, help="steps a CUDA graph")
    a = ap.parse_args()
    out = main(a.work, a.device, a.users, a.items, a.rows, a.epochs, a.batch_size, a.macro)
    assert out["val_auroc"] > 0.55, out
    assert out["recall_at_100"] > 0.1, out
    print("FULL SCALE OK")
