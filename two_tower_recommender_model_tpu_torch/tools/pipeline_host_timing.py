"""Time the Instacart pipeline's host stages: the replica CSVs
(`cli.fetch_instacart`) and `cli.prepare_instacart --packed`, by default at
the real scale (206,209 users, 49,688 products). Each stage runs in a child
process of its own, so its peak resident memory is its own.

    python -m two_tower_recommender_model_tpu_torch.tools.pipeline_host_timing \\
        --work DIR [--users N] [--products N]

Prints the card's name and power limit (nvidia-smi) where there is one, one
JSON line a stage ({"stage", "seconds", "peak_rss_bytes", "result"}) and, last,
one JSON line of both. The stages use no device; the timing is the host's.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import time

_MODULE = "two_tower_recommender_model_tpu_torch.tools.pipeline_host_timing"


def _run_stage(stage: str, work: str, users: int, products: int) -> dict:
    """One stage in this process: {"stage", "seconds", "peak_rss_bytes",
    "result"}."""
    from two_tower_recommender_model_tpu_torch.cli import fetch_instacart, prepare_instacart

    csv_dir, shards = os.path.join(work, "csv"), os.path.join(work, "shards")
    t0 = time.perf_counter()
    if stage == "fetch":
        result = fetch_instacart.main(["--out", csv_dir, "--replica", "--replica-users",
                                       str(users), "--replica-products", str(products)])
    else:
        result = prepare_instacart.main(["--csv-dir", csv_dir, "--out", shards, "--packed"])
    seconds = time.perf_counter() - t0
    # ru_maxrss is in KiB on Linux
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return {"stage": stage, "seconds": seconds, "peak_rss_bytes": peak, "result": result}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog=f"python -m {_MODULE}",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", required=True, help="directory for the CSVs and the shards")
    ap.add_argument("--users", type=int, default=206_209)
    ap.add_argument("--products", type=int, default=49_688)
    ap.add_argument("--stage", choices=["fetch", "prepare"], default=None,
                    help="run one stage in this process (what the parent starts)")
    args = ap.parse_args(argv)
    if args.stage:
        rec = _run_stage(args.stage, args.work, args.users, args.products)
        print(json.dumps(rec), flush=True)
        return rec

    if shutil.which("nvidia-smi"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60)
        print(smi.stdout.strip().splitlines()[0], flush=True)
    else:
        print("no nvidia-smi: the host is not a card's", flush=True)
    stages = {}
    for stage in ("fetch", "prepare"):
        proc = subprocess.run(
            [sys.executable, "-m", _MODULE, "--work", args.work, "--users", str(args.users),
             "--products", str(args.products), "--stage", stage],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"stage {stage} exited {proc.returncode}: {proc.stderr[-4000:]}")
        stages[stage] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(stages[stage]), flush=True)
    out = {"users": args.users, "products": args.products,
           "seconds": {k: v["seconds"] for k, v in stages.items()},
           "peak_rss_bytes": {k: v["peak_rss_bytes"] for k, v in stages.items()}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
