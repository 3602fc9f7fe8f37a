"""Instacart raw CSVs -> training shards.

    python -m two_tower_recommender_model_tpu_torch.cli.prepare_instacart \\
        --csv-dir data/instacart --out out/instacart [--packed]

The port of `scripts/prepare_instacart.py`, on numpy alone; it writes the
same shard files, `meta.json` and `id_mappings.npz`. Runs on the host alone.
Steps:
  1. ingest the CSVs with their schemas, join order_detail;
  2. positives = distinct (user, product); sampled complement negatives 1:1;
  3. per-user 80/10/10 split with the every-user-trains invariant;
  4. contiguous 1-based id indexing (0 reserved for missing);
  5. TTRS shard datasets for train/val/test, the id mappings and the counts.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from two_tower_recommender_model_tpu_torch import config as cfg_lib
from two_tower_recommender_model_tpu_torch.data.feature_engineering import (
    build_positive_pairs,
    index_ids,
    per_user_split,
    sample_negatives,
    splits_to_columns,
    union_pos_neg,
)
from two_tower_recommender_model_tpu_torch.data.ingest import build_order_detail, read_csv_table
from two_tower_recommender_model_tpu_torch.data.prepacked import pack_dataset
from two_tower_recommender_model_tpu_torch.data.shards import write_dataset


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m two_tower_recommender_model_tpu_torch.cli."
                                 "prepare_instacart", description=__doc__.split("\n\n")[0])
    ap.add_argument("--csv-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows-per-shard", type=int, default=1 << 18)
    ap.add_argument("--max-users", type=int, default=None,
                    help="keep the first N users in order of appearance (smoke runs)")
    ap.add_argument("--packed", action="store_true",
                    help="write PRE-PACKED uncompressed shards (device-layout columns, the "
                         "mmap fast path of data/prepacked.py); cli.train detects them")
    args = ap.parse_args(argv)

    orders = read_csv_table(os.path.join(args.csv_dir, "orders.csv"), "orders")
    products = read_csv_table(os.path.join(args.csv_dir, "products.csv"), "products")
    prior = read_csv_table(os.path.join(args.csv_dir, "order_products__prior.csv"),
                           "order_products")
    detail = build_order_detail(orders, prior, products)
    if args.max_users:
        _, first = np.unique(detail["user_id"], return_index=True)
        keep = detail["user_id"][np.sort(first)[: args.max_users]]
        m = np.isin(detail["user_id"], keep)
        detail = {k: v[m] for k, v in detail.items()}
    print(f"order_detail rows: {len(detail['user_id'])}")

    pos = build_positive_pairs(detail)
    print(f"positives: {len(pos['user_id'])}")
    neg = sample_negatives(pos, products["product_id"], seed=args.seed)
    df = per_user_split(union_pos_neg(pos, neg), seed=args.seed)
    indexed, mappings = index_ids(df)
    splits = splits_to_columns(indexed)

    os.makedirs(args.out, exist_ok=True)
    # +1: the tables hold the reserved id-0 missing sentinel as well, since
    # indices run 1..len(mapping): a table of len(mapping) rows would alias
    # the largest id onto row 0 through the modulo hash
    meta = {
        "num_users": len(mappings["user_id"]) + 1,
        "num_items": len(mappings["product_id"]) + 1,
        "distinct_users": len(mappings["user_id"]),
        "distinct_items": len(mappings["product_id"]),
        "seed": args.seed,
    }
    mcfg = cfg_lib.two_tower_model_config(num_users=meta["num_users"],
                                          num_items=meta["num_items"])
    rows = {}
    for name, cols in splits.items():
        if args.packed:
            idx = pack_dataset(os.path.join(args.out, name), mcfg, cols,
                               rows_per_shard=args.rows_per_shard)
        else:
            idx = write_dataset(os.path.join(args.out, name), cols, args.rows_per_shard)
        rows[name] = idx["total_rows"]
        print(f"{name}: {idx['total_rows']} rows, {len(idx['shards'])} shards"
              + (" (packed)" if args.packed else ""))

    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    np.savez(os.path.join(args.out, "id_mappings.npz"),
             user_ids=np.array(list(mappings["user_id"].keys())),
             product_ids=np.array(list(mappings["product_id"].keys())))
    print("meta:", meta)
    return {"meta": meta, "rows": rows}


if __name__ == "__main__":
    main()
