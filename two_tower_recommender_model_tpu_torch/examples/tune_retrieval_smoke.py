"""TPE-tune the in-batch sampled-softmax objective on the retrieval metric:
recall@100 at the exact eval protocol (k = 100, exact top-k) over the
smoke-scale Instacart replica (8,000 users, 4,000 products), selected on the
val split, the winner reported on the test split.

    python -m two_tower_recommender_model_tpu_torch.examples.tune_retrieval_smoke \\
        [--work DIR] [--device cpu] [--trials 10] [--users 8000 --products 4000]

The port of `examples/tune_retrieval_smoke.py`. The data come from the
port's entry points, run as child processes (`python -m
two_tower_recommender_model_tpu_torch.cli.fetch_instacart --replica` and
`cli.prepare_instacart`), once per work directory; each trial trains through
`train_one_epoch_packed` with K-step graphs on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def prepare_smoke(work: str, users: int = 8000, products: int = 4000) -> tuple[str, dict]:
    """The replica's CSVs and its shards, built once (skipped when the
    shards' meta.json exists)."""
    csv_dir = os.path.join(work, "csv")
    shards = os.path.join(work, "shards")
    if not os.path.exists(os.path.join(shards, "meta.json")):
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (PACKAGE_ROOT, os.environ.get("PYTHONPATH")) if p)}
        cli = "two_tower_recommender_model_tpu_torch.cli."
        subprocess.run([sys.executable, "-m", cli + "fetch_instacart", "--out", csv_dir,
                        "--replica", "--replica-users", str(users), "--replica-products",
                        str(products), "--seed", "0"], check=True, env=env)
        subprocess.run([sys.executable, "-m", cli + "prepare_instacart", "--csv-dir", csv_dir,
                        "--out", shards, "--seed", "0"], check=True, env=env)
    with open(os.path.join(shards, "meta.json")) as f:
        return shards, json.load(f)


def main(work: str | None = None, device: str | None = None, num_trials: int = 10,
         users: int = 8000, products: int = 4000, epochs: int = 3, batch_size: int = 8192,
         macro: int = 8, max_users: int = 10_000):
    from two_tower_recommender_model_tpu_torch import config as cfg
    from two_tower_recommender_model_tpu_torch.data.device_featurizer import (
        PackedFeaturizer,
        make_packed_train_step,
        unpack_batch,
    )
    from two_tower_recommender_model_tpu_torch.data.loader import StreamLoader
    from two_tower_recommender_model_tpu_torch.device import resolve_device
    from two_tower_recommender_model_tpu_torch.evaluation.retrieval import (
        evaluate_retrieval,
        split_positives,
    )
    from two_tower_recommender_model_tpu_torch.train.loop import train_one_epoch_packed
    from two_tower_recommender_model_tpu_torch.train.step import (
        create_train_state,
        make_multi_step,
        make_train_step,
    )
    from two_tower_recommender_model_tpu_torch.tuning.adaptive import run_adaptive_sweep
    from two_tower_recommender_model_tpu_torch.tuning.sweep import Choice, LogUniform

    device = resolve_device(device)
    work = work or tempfile.mkdtemp(prefix="tune_retrieval_smoke_")
    shards, meta = prepare_smoke(work, users, products)
    # model SELECTION scores on the val split; the test split is kept for the
    # winner's report (no test leakage into tuning)
    val_positives = split_positives(os.path.join(shards, "val"))
    test_positives = split_positives(os.path.join(shards, "test"))
    print(f"smoke data ready: {meta}; {len(val_positives)} val / "
          f"{len(test_positives)} test users", flush=True)

    mcfg = cfg.two_tower_model_config(num_users=meta["num_users"], num_items=meta["num_items"],
                                      embedding_dim=128, layer_sizes=(128, 64))

    def trial(config):
        t0 = time.perf_counter()
        tcfg = cfg.TrainConfig(
            epochs=epochs, batch_size=batch_size, loss="sampled_softmax",
            softmax_temperature=float(config["temperature"]),
            sparse_learning_rate=float(config["sparse_lr"]),
            learning_rate=float(config["lr"]),
            logq_correction=bool(config["logq"]))
        feat = PackedFeaturizer(mcfg, pack_label=True)
        state, dense_opt = create_train_state(torch.Generator(device=device).manual_seed(0),
                                              mcfg, tcfg)
        core = make_train_step(mcfg, tcfg, dense_opt)
        multi = make_multi_step(lambda s, pb: core(s, unpack_batch(pb, mcfg, pack_label=True)))
        tail_step = make_packed_train_step(core, mcfg, pack_label=True)
        for epoch in range(tcfg.epochs):
            loader = StreamLoader(os.path.join(shards, "train"), tcfg.batch_size, seed=1)
            loader.set_epoch(epoch)
            state, stats = train_one_epoch_packed(state, multi, loader, feat, macro=macro,
                                                  tail_step=tail_step)
        m = evaluate_retrieval(state.model, val_positives, k=100, max_users=max_users,
                               ks=(100,))
        return {"recall_at_100": float(m["recall_at_100"]), "train_loss": stats["train_loss"],
                "trial_time_s": round(time.perf_counter() - t0, 1), "_model": state.model}

    space = {
        "temperature": LogUniform(0.05, 3.0),
        "sparse_lr": LogUniform(0.02, 0.5),
        "lr": LogUniform(3e-4, 1e-2),
        "logq": Choice((True, False)),
    }
    res = run_adaptive_sweep(trial, space, num_trials=num_trials, metric="recall_at_100",
                             mode="max", seed=0, n_startup=4)
    print(res.table(), flush=True)
    best = res.best()
    test_m = evaluate_retrieval(best.metrics["_model"], test_positives, k=100,
                                max_users=max_users, ks=(100,))
    print(f"BEST val recall@100 = {best.metrics['recall_at_100']:.4f} @ {best.config}")
    print(f"TEST recall@100 (winning config, held out) = {test_m['recall_at_100']:.4f}")
    return res, test_m


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", default=None, help="working directory (default: a new temp dir)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--trials", type=int, default=int(os.environ.get("TRIALS", 10)))
    ap.add_argument("--users", type=int, default=8000)
    ap.add_argument("--products", type=int, default=4000)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=8192)
    a = ap.parse_args()
    main(a.work, a.device, a.trials, a.users, a.products, a.epochs, a.batch_size)
