"""The Instacart pipeline's full-scale quality runs, through the entry
points: the replica at the real scale (206,209 users, 49,688 products; seed
0), `cli.prepare_instacart --packed`, then for each objective `cli.train
--checkpoint-dir` and `cli.evaluate_retrieval` at the reference protocol (k
= 100 over up to 10,000 test users, exact top-k):

- "bce": f32 compute, 3 epochs of 16,384, batches sorted by user id,
  `--block-sorted-kernel float32`, sparse learning rate 0.1 (the reference
  pipeline's); the reference's seed band is recall@100 0.2371-0.2487
  (BENCH_FULL_SCALE.md, round 2c);
- "bce-wirecache": "bce" through a wire cache of one generation in `auto`
  order (epoch 0 in the loader's order, then rotations), the cache built in
  the run; the reference's one-generation run gave 0.2482, inside the same
  band (BENCH_FULL_SCALE.md, round 3);
- "softmax": the in-batch sampled softmax, 4 epochs of 8,192, the epoch kept
  by `--select-best val_recall_at_100` over 10,000 val users,
  `--sorted-feature auto`, sparse learning rate 0.1 (the reference
  pipeline's; at `cli.train`'s default 0.01 the run lands near 0.27); its
  target is recall@100 0.2945 (BENCH_FULL_SCALE.md, round 4).

    python -m two_tower_recommender_model_tpu_torch.tools.full_scale_quality \\
        --work DIR [--runs bce softmax] [--json-out FILE] [--users N --products N] \\
        [--device cpu]

Prints the card's name and power limit (nvidia-smi) where there is one, one
JSON line a run (the retrieval metrics, val AUROC, each epoch's seconds,
examples/s and val metrics, the eval's seconds, each checkpoint's bytes and
save seconds, the wire cache's build seconds and bytes)
and, last, one JSON line of everything; `--json-out` writes that too. The
CSVs, shards, checkpoints and exports go into a new directory made inside
`--work` (nothing else there is touched), removed when every run has ended
well; after a failure it is kept, and its path printed, so that a run can be
resumed from its checkpoints (`cli.train ... --checkpoint-dir
<dir>/<run>/ckpt --resume` with the run's flags). Never run the real scale
on a shared small host: the prepare stage peaks at ~13 GB.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

_MODULE = "two_tower_recommender_model_tpu_torch.tools.full_scale_quality"
RUNS = {
    "bce": ["--loss", "bce", "--epochs", "3", "--batch-size", "16384", "--sorted-feature",
            "user_id", "--block-sorted-kernel", "float32", "--sparse-learning-rate", "0.1"],
    "bce-wirecache": ["--loss", "bce", "--epochs", "3", "--batch-size", "16384",
                      "--sorted-feature", "user_id", "--block-sorted-kernel", "float32",
                      "--sparse-learning-rate", "0.1", "--wire-cache-generations", "1",
                      "--wire-cache-order", "auto"],
    "softmax": ["--loss", "sampled_softmax", "--batch-size", "8192", "--epochs", "4",
                "--select-best", "val_recall_at_100", "--retrieval-eval-users", "10000",
                "--sorted-feature", "auto", "--sparse-learning-rate", "0.1"],
}
CACHED = {"bce-wirecache"}  # runs that train through a wire cache in their directory


def card_line() -> str:
    if not shutil.which("nvidia-smi"):
        return "no nvidia-smi: not a card's host"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def main(argv: list[str] | None = None) -> dict:
    from two_tower_recommender_model_tpu_torch.cli import (
        evaluate_retrieval,
        fetch_instacart,
        prepare_instacart,
        train,
    )
    from two_tower_recommender_model_tpu_torch.device import resolve_device
    from two_tower_recommender_model_tpu_torch.utils.tracking import ExperimentLogger

    ap = argparse.ArgumentParser(prog=f"python -m {_MODULE}",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", required=True,
                    help="directory in which the run makes its own directory for the CSVs, "
                         "shards and runs")
    ap.add_argument("--runs", nargs="+", choices=list(RUNS), default=list(RUNS))
    ap.add_argument("--users", type=int, default=206_209)
    ap.add_argument("--products", type=int, default=49_688)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without one): pass cpu to "
                         "run on the CPU")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))  # no card, no run
    out: dict = {"card": card_line(), "users": args.users, "products": args.products,
                 "seconds": {}, "runs": {}}
    print(out["card"], flush=True)
    os.makedirs(args.work, exist_ok=True)
    work = tempfile.mkdtemp(prefix="full_scale_", dir=args.work)
    csv_dir, shards = os.path.join(work, "csv"), os.path.join(work, "shards")
    try:
        t0 = time.perf_counter()
        fetch_instacart.main(["--out", csv_dir, "--replica", "--replica-users", str(args.users),
                              "--replica-products", str(args.products), "--seed", "0"])
        out["seconds"]["fetch"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        prepared = prepare_instacart.main(["--csv-dir", csv_dir, "--out", shards, "--seed", "0",
                                           "--packed"])
        out["seconds"]["prepare"] = time.perf_counter() - t0
        out["rows"], meta = prepared["rows"], prepared["meta"]
        for name in args.runs:
            run_dir = os.path.join(work, name)
            cache = ["--wire-cache", os.path.join(run_dir, "wirecache")] if name in CACHED else []
            t0 = time.perf_counter()
            trained = train.main([
                "--data-dir", shards, "--num-users", str(meta["num_users"]),
                "--num-items", str(meta["num_items"]), "--seed", "0",
                "--runs-root", os.path.join(run_dir, "runs"),
                "--checkpoint-dir", os.path.join(run_dir, "ckpt"),
                "--export-dir", os.path.join(run_dir, "model"), "--device", device, *RUNS[name],
                *cache])
            train_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            retrieval = evaluate_retrieval.main([
                "--model-dir", os.path.join(run_dir, "model"), "--data-dir", shards, "--k", "100",
                "--max-users", "10000", "--device", device])
            m = trained["metrics"]
            logged = ExperimentLogger(os.path.dirname(trained["run_dir"]),
                                      run_id=os.path.basename(trained["run_dir"])).metrics()
            rec = {"flags": RUNS[name], "retrieval": retrieval,
                   "eval_seconds": time.perf_counter() - t0, "train_seconds": train_s,
                   "val_auroc": m["val_auroc"], "baseline_val_auroc": m["baseline_val_auroc"],
                   "test_auroc": m["test_auroc"], "best_epoch": m.get("best_epoch"),
                   "val_recall_at_100": m.get("val_recall_at_100"),
                   "epochs": [{k: e[k] for k in ("train_steps", "epoch_time_s",
                                                 "examples_per_sec")}
                              for e in trained["epochs"]],
                   "val_by_epoch": [{k: v for k, v in line.items()
                                     if k in ("epoch", "val_auroc", "val_recall_at_100")}
                                    for line in logged if "epoch" in line],
                   "checkpoints": trained["checkpoints"],
                   "wire_format": trained["wire_format"], "wire_cache": trained["wire_cache"]}
            out["runs"][name] = rec
            print(json.dumps({"run": name, **rec}), flush=True)
    except BaseException:
        print(f"failed; its shards, checkpoints and exports are kept in {work}",
              file=sys.stderr, flush=True)
        raise
    shutil.rmtree(work)
    print(json.dumps(out), flush=True)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
