"""One command, end to end: CSVs -> shards -> training -> retrieval eval at
the reference protocol (k = 100 over up to 10,000 users, exact top-k).

    python -m two_tower_recommender_model_tpu_torch.cli.instacart_pipeline --work out/run

The port of `scripts/instacart_pipeline.py`. Its four stages run in this
process, not as subprocesses, so one `--device` holds for all of them (the
card unless given `--device cpu`):

  1. fetch_instacart      the schema-faithful replica (206,209 users /
                          49,688 products / ~30M prior rows), unless
                          --csv-dir names existing CSVs
  2. prepare_instacart    ingest, negatives, per-user split, id indexing,
                          TTRS shards
  3. train                the flagship two-tower (dim 128, towers [128, 64]),
                          the packed path (through a wire cache under
                          <work>/wirecache with --wire-cache), the model
                          exported
  4. evaluate_retrieval   recall@100 over up to 10,000 test users

`--smoke` runs the same path on 8,000 users and 4,000 products.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from two_tower_recommender_model_tpu_torch.cli import (
    evaluate_retrieval,
    fetch_instacart,
    prepare_instacart,
    train,
)
from two_tower_recommender_model_tpu_torch.device import resolve_device

SMOKE_USERS, SMOKE_PRODUCTS = 8000, 4000


def apply_fast_preset(args: argparse.Namespace) -> None:
    """`--fast`: pre-packed mmap shards and a wire cache (the per-epoch host
    work drops to mmap and one copy), batches sorted by user id, bf16
    gradients into the table kernels and bf16 tower compute (params and both
    optimizers stay f32); flags given explicitly win."""
    args.packed = True
    args.wire_cache = True
    if args.sorted_feature is None:
        args.sorted_feature = "user_id"
    if args.block_sorted_kernel is None:
        args.block_sorted_kernel = "bfloat16"
    if args.compute_dtype is None:
        args.compute_dtype = "bfloat16"


def main(argv: list[str] | None = None) -> dict:
    """Run the stages; returns {"seconds": per stage, "fetch", "prepare",
    "train", "retrieval": each stage's results}."""
    ap = argparse.ArgumentParser(prog="python -m two_tower_recommender_model_tpu_torch.cli."
                                 "instacart_pipeline", description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", required=True, help="working directory for all stages")
    ap.add_argument("--csv-dir", default=None, help="existing Instacart CSVs (skips fetch)")
    ap.add_argument("--smoke", action="store_true",
                    help=f"replica of {SMOKE_USERS:,} users and {SMOKE_PRODUCTS:,} products")
    ap.add_argument("--packed", action="store_true",
                    help="write pre-packed shards (the mmap fast path)")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--loss", choices=["bce", "sampled_softmax", "weighted_bce"], default="bce")
    ap.add_argument("--sparse-learning-rate", type=float, default=0.1)
    ap.add_argument("--learning-rate", type=float, default=1e-3)
    ap.add_argument("--softmax-temperature", type=float, default=1.0,
                    help="sampled_softmax logit temperature")
    ap.add_argument("--block-sorted-kernel", default=None, choices=["off", "float32", "bfloat16"],
                    help="passed to cli.train")
    ap.add_argument("--wire-cache", action="store_true",
                    help="train through a pre-encoded wire cache under <work>/wirecache "
                         "(data/wirecache.py)")
    ap.add_argument("--macro-batches", type=int, default=None, help="passed to cli.train")
    ap.add_argument("--sorted-feature", default=None, help="passed to cli.train")
    ap.add_argument("--compute-dtype", default=None, choices=["float32", "bfloat16"],
                    help="tower matmul dtype, passed to cli.train")
    ap.add_argument("--fast", action="store_true",
                    help="the single-card preset: pre-packed shards, the wire cache, batches "
                         "sorted by user id, bf16 table-kernel gradients, bf16 tower compute")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device for training and eval; default the card (raises "
                         "without one): pass cpu to run on the CPU")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))  # before any stage: no card, no run
    if args.fast:
        apply_fast_preset(args)
        print("--fast: packed shards, wire cache, sorted user_id, bf16 table kernels, bf16 "
              "compute", flush=True)

    csv_dir = args.csv_dir or os.path.join(args.work, "csv")
    shards = os.path.join(args.work, "shards")
    model_dir = os.path.join(args.work, "model")
    seconds: dict[str, float] = {}
    out: dict = {"seconds": seconds}

    def stage(name, fn, argv):
        print(f"\n>>> {name} {' '.join(argv)}", flush=True)
        t0 = time.perf_counter()
        out[name] = fn(argv)
        seconds[name] = time.perf_counter() - t0
        print(f"<<< {name} done in {seconds[name]:.1f}s", flush=True)

    if args.csv_dir is None:
        fetch = ["--out", csv_dir, "--seed", str(args.seed)]
        if args.smoke:
            fetch += ["--replica", "--replica-users", str(SMOKE_USERS),
                      "--replica-products", str(SMOKE_PRODUCTS)]
        stage("fetch", fetch_instacart.main, fetch)
    stage("prepare", prepare_instacart.main,
          ["--csv-dir", csv_dir, "--out", shards, "--seed", str(args.seed)]
          + (["--packed"] if args.packed else []))
    with open(os.path.join(shards, "meta.json")) as f:
        meta = json.load(f)
    train_argv = [
        "--data-dir", shards, "--num-users", str(meta["num_users"]),
        "--num-items", str(meta["num_items"]), "--epochs", str(args.epochs),
        "--batch-size", str(args.batch_size), "--loss", args.loss,
        "--sparse-learning-rate", str(args.sparse_learning_rate),
        "--learning-rate", str(args.learning_rate),
        "--softmax-temperature", str(args.softmax_temperature), "--seed", str(args.seed),
        "--runs-root", os.path.join(args.work, "runs"), "--export-dir", model_dir,
        "--device", device,
    ] + (["--wire-cache", os.path.join(args.work, "wirecache")] if args.wire_cache else [])
    for flag, value in (("--sorted-feature", args.sorted_feature),
                        ("--block-sorted-kernel", args.block_sorted_kernel),
                        ("--macro-batches", args.macro_batches),
                        ("--compute-dtype", args.compute_dtype)):
        if value is not None:
            train_argv += [flag, str(value)]
    stage("train", train.main, train_argv)
    json_out = os.path.join(args.work, "retrieval_metrics.json")
    stage("retrieval", evaluate_retrieval.main,
          ["--model-dir", model_dir, "--data-dir", shards, "--k", "100", "--max-users", "10000",
           "--json-out", json_out, "--device", device])
    m = out["retrieval"]
    print(f"\nPIPELINE COMPLETE: recall@100 = {m['recall_at_100']:.4f} over "
          f"{int(m['num_users'])} users (protocol: k=100, up to 10k users, exact top-k)")
    return out


if __name__ == "__main__":
    main()
