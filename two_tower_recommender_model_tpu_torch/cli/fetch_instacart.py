"""Put the Instacart CSVs in a directory: the schema-faithful replica.

    python -m two_tower_recommender_model_tpu_torch.cli.fetch_instacart --out data/instacart

The port of `scripts/fetch_instacart.py`'s replica route. Its Kaggle download
route is not ported (ROADMAP): with no network there is nothing to download,
so real CSVs (orders.csv, products.csv, order_products__prior.csv,
order_products__train.csv, departments.csv, aisles.csv) are placed in --out
by hand, and the replica is written only where they are missing. Runs on the
host alone.
"""

from __future__ import annotations

import argparse
import os
import sys

from two_tower_recommender_model_tpu_torch.data.replica import (
    REAL_PRODUCTS,
    REAL_USERS,
    write_instacart_replica,
)

EXPECTED = [
    "orders.csv", "products.csv", "order_products__prior.csv",
    "order_products__train.csv", "departments.csv", "aisles.csv",
]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m two_tower_recommender_model_tpu_torch.cli."
                                 "fetch_instacart", description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="data/instacart")
    ap.add_argument("--replica", action="store_true",
                    help="generate the schema-faithful replica (the only route of the port: "
                         "the Kaggle download waits, see ROADMAP)")
    ap.add_argument("--replica-users", type=int, default=None,
                    help="replica user count (default: the real 206,209)")
    ap.add_argument("--replica-products", type=int, default=None,
                    help="replica product count (default: the real 49,688)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    missing = [f for f in EXPECTED if not os.path.exists(os.path.join(args.out, f))]
    if not missing:
        print(f"all {len(EXPECTED)} CSVs already present in {args.out}")
        return {"out": args.out, "generated": False}
    if not args.replica:
        print("the Kaggle download is not ported: generating the schema-faithful replica "
              "(put real CSVs in --out to use organic data)", file=sys.stderr)
    stats = write_instacart_replica(
        args.out, num_users=args.replica_users or REAL_USERS,
        num_products=args.replica_products or REAL_PRODUCTS, seed=args.seed)
    print(f"replica ready in {args.out}: {stats}")
    return {"out": args.out, "generated": True, **stats}


if __name__ == "__main__":
    main()
