"""Retrieval evaluation at the reference protocol: held-out positives per
user from a split, an exact top-k search (k = 100 over up to 10,000 users),
retriever metrics averaged per user.

    python -m two_tower_recommender_model_tpu_torch.cli.evaluate_retrieval \\
        --model-dir out/model --data-dir out/instacart [--k 100] [--max-users 10000] \\
        [--per-user-table users.csv]

The port of `scripts/evaluate_retrieval.py`: `load_model` -> `split_positives`
-> `evaluate_retrieval`, on the card unless given `--device cpu`.
`--per-user-table` also writes one CSV row per evaluated user
(`per_user_retrieval_table`, a pandas DataFrame).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from two_tower_recommender_model_tpu_torch.device import resolve_device
from two_tower_recommender_model_tpu_torch.evaluation.retrieval import (
    evaluate_retrieval,
    export_feature_embeddings,
    per_user_retrieval_table,
    split_positives,
)
from two_tower_recommender_model_tpu_torch.models.two_tower import params_from_numpy
from two_tower_recommender_model_tpu_torch.ops.topk import chunked_topk
from two_tower_recommender_model_tpu_torch.utils.checkpoint import load_model


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m two_tower_recommender_model_tpu_torch.cli."
                                 "evaluate_retrieval", description=__doc__.split("\n\n")[0])
    ap.add_argument("--model-dir", required=True, help="export_model directory")
    ap.add_argument("--data-dir", required=True, help="prepare_instacart output dir")
    ap.add_argument("--split", default="test")
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--max-users", type=int, default=10_000)
    ap.add_argument("--per-user-table", default=None,
                    help="write the per-user results table (csv) here")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without one): pass cpu to "
                         "run on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model_cfg, params = load_model(args.model_dir)
    model = params_from_numpy(params, model_cfg, device)
    user_positives = split_positives(os.path.join(args.data_dir, args.split))
    print(f"{args.split} positives: {sum(map(len, user_positives.values()))} over "
          f"{len(user_positives)} users; evaluating {min(len(user_positives), args.max_users)} "
          f"users at k={args.k}")
    metrics = evaluate_retrieval(model, user_positives, k=args.k, max_users=args.max_users,
                                 ks=(10, args.k))
    print(json.dumps({k: round(float(v), 5) for k, v in metrics.items()}, indent=1))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(metrics, f, indent=1)

    if args.per_user_table:
        users = np.array(sorted(user_positives.keys())[: args.max_users])
        q = export_feature_embeddings(model, "user_id", ids=users)
        c = export_feature_embeddings(model, "product_id")
        _, idx = chunked_topk(q, c[1:], k=args.k)
        df = per_user_retrieval_table(idx.cpu().numpy() + 1, users,
                                      [user_positives[u] for u in users], ks=(args.k,))
        df.to_csv(args.per_user_table, index=False)
        print(f"per-user table -> {args.per_user_table}")
    return metrics


if __name__ == "__main__":
    main()
