"""Train the two-tower model on TTRS shards, on one device or on N ranks.

    python -m two_tower_recommender_model_tpu_torch.cli.train \\
        --data-dir out/instacart --num-users 206210 --num-items 49689
    python -m torch.distributed.run --nproc-per-node 2 \\
        -m two_tower_recommender_model_tpu_torch.cli.train --data-dir ... [--device cpu]

The port of `scripts/train.py`, on the card unless given `--device cpu`: the packed epoch (pre-packed shards or raw columns
packed on the host) through `train_one_epoch_packed` and `make_multi_step`
(on the card one CUDA graph of `--macro-batches` steps, replayed), or the
per-batch loop with `--no-packed`; validation, the test eval, the run logged
through `ExperimentLogger`, the model exported with `export_model`. The
packed path ships batches on the compact wire (`data/compact.py`) when
`--wire-format` says so, which `auto` does when the batch size is a multiple
of 8; `--wire-cache DIR` encodes the epoch's batches once into a wire cache
(`data/wirecache.py`) and streams them from it every epoch.
`--checkpoint-dir` saves the whole training state and the loader's position
after every epoch (`utils.checkpoint.Checkpointer`); `--resume` restores the
latest one before anything is captured and trains on from the next epoch.

Under torchrun with more than one rank (and without `--no-shard`) it takes
the mesh path of `scripts/train.py`: a `data x model` mesh (`--mesh-model`)
of NCCL ranks, one a card (gloo ranks with `--device cpu`); the plan of
`parallel.planner.plan_sharding` within the card's memory, printed by rank
0; every rank runs the same loader and trains on its slice of each global
batch through the sharded step (`parallel/sharded.py`), the packed path as
one CUDA graph of `--macro-batches` sharded steps; f32, bf16 and int8 tables
(`--table-dtype`), and the all-to-all exchange for the row-sharded float
tables the host does not sort (`--sharded-exchange alltoall`,
`--exchange-capacity-factor`, `--exchange-wire-dtype`; an epoch or an eval
that dropped ids past the capacity raises), the sampled softmax (each rank
its stripe of the score matrix), and the compact wire (each rank decodes its
slice; `auto` picks it when the batch splits into groups of 8 a rank, on
one host) with `--wire-cache` (the host's first rank builds it). The sorted
feature's auto choice turns itself off where the plan puts its table where
the sorted paths do not go. Rank 0 logs, saves the checkpoint of the
unsharded state (any mesh, or one device, restores it) and exports it.

`--multi-host` under torchrun over several nodes (`--nnodes`): each host
streams its own slice of the shards (`--batch-size` is a host's batch; the
global batch is the hosts' batches), every rank keeps its data slice of its
host's batch (`parallel.launch.put_global_batch`), the evals pad every batch
to the batch size and run every host to the longest host's count, the
sorted feature is off (a host sorts only its own batch; the compact wire
still delta-encodes each host's batch as one segment), and the wire cache
is one a host (`DIR/host-{i}-of-{n}`):

    python -m torch.distributed.run --nnodes 2 --node-rank 0 --nproc-per-node 4 \
        --master-addr HOST0 --master-port 29500 \
        -m two_tower_recommender_model_tpu_torch.cli.train --multi-host --data-dir ...
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import re
import time

import torch

from two_tower_recommender_model_tpu_torch import config as cfg_lib
from two_tower_recommender_model_tpu_torch.data.compact import (
    CompactFeaturizer,
    CompactScheme,
    batch_from_compact,
    make_compact_train_step,
)
from two_tower_recommender_model_tpu_torch.data.device_featurizer import (
    PackedFeaturizer,
    make_packed_eval_step,
    make_packed_train_step,
    unpack_batch,
)
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.data.loader import StreamLoader
from two_tower_recommender_model_tpu_torch.data.prepacked import PrepackedFeaturizer
from two_tower_recommender_model_tpu_torch.data.shards import ShardedDataset
from two_tower_recommender_model_tpu_torch.data.wirecache import WireCache, build_wire_cache
from two_tower_recommender_model_tpu_torch.device import resolve_device
from two_tower_recommender_model_tpu_torch.evaluation.retrieval import (
    make_retrieval_eval_fn,
    split_positives,
)
from two_tower_recommender_model_tpu_torch.parallel import launch, planner
from two_tower_recommender_model_tpu_torch.parallel.mesh import make_mesh, topology_summary
from two_tower_recommender_model_tpu_torch.parallel.sharded import (
    alltoall_tables,
    batch_sharding,
    compact_shardings,
    macro_batch_sharding,
    make_sharded_compact_multi_step,
    make_sharded_eval_step,
    make_sharded_multi_step,
    make_sharded_train_step,
    shard_train_state,
    sharded_compact_decoder,
    unshard_train_state,
)
from two_tower_recommender_model_tpu_torch.train.loop import (
    train_one_epoch,
    train_one_epoch_packed,
    train_val_test,
)
from two_tower_recommender_model_tpu_torch.train.step import (
    auto_sorted_feature,
    create_train_state,
    make_eval_step,
    make_multi_step,
    make_train_step,
    validate_sorted_feature,
)
from two_tower_recommender_model_tpu_torch.utils.checkpoint import Checkpointer, export_model
from two_tower_recommender_model_tpu_torch.utils.tracking import ExperimentLogger

log = logging.getLogger(__name__)

def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m two_tower_recommender_model_tpu_torch.cli.train",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", required=True, help="dir with train/ val/ test/ TTRS datasets")
    ap.add_argument("--num-users", type=int, required=True)
    ap.add_argument("--num-items", type=int, required=True)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--embedding-dim", type=int, default=128)
    ap.add_argument("--layer-sizes", type=int, nargs="+", default=[128, 64])
    ap.add_argument("--learning-rate", type=float, default=1e-3)
    ap.add_argument("--sparse-learning-rate", type=float, default=1e-2)
    ap.add_argument("--loss", choices=["bce", "sampled_softmax", "weighted_bce"], default="bce")
    ap.add_argument("--softmax-temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--validation-freq", type=int, default=None)
    ap.add_argument("--limit-train-batches", type=int, default=None)
    ap.add_argument("--limit-val-batches", type=int, default=None)
    ap.add_argument("--limit-test-batches", type=int, default=None)
    ap.add_argument("--runs-root", default="runs")
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without one): pass cpu to "
                         "run on the CPU")
    ap.add_argument("--no-packed", action="store_true",
                    help="train batch by batch through the host Featurizer instead of the "
                         "packed macro-batch path")
    ap.add_argument("--macro-batches", type=int, default=32,
                    help="steps per call of the packed path (on the card one CUDA graph of "
                         "this many steps); mid-epoch validation lands on macro boundaries")
    ap.add_argument("--export-dir", default=None, help="export the model here at the end")
    ap.add_argument("--sorted-feature", default="auto",
                    help="single-slot feature to host-sort each batch by (packed path): its "
                         "table's ids reach the update kernel sorted. 'auto' (default) picks "
                         "the largest eligible table, and is off on --no-packed; 'off' disables")
    ap.add_argument("--block-sorted-kernel", choices=["auto", "off", "float32", "bfloat16"],
                    default="auto",
                    help="the reference's block-sorted kernel mode. In the port one kernel "
                         "serves every table at every shape, and the mode sets the dtype of "
                         "the gradients the row-wise Adagrad kernel takes: bfloat16 rounds "
                         "them, float32 and off pass f32. 'auto' (default) takes the kernels "
                         "wherever the port's kernels take the shapes, which is everywhere "
                         "but a sorted bf16 table (the reference refuses that pair): bfloat16 "
                         "under --compute-dtype bfloat16, else float32. The reference's "
                         "profitability rule is a TPU measurement and is not ported")
    ap.add_argument("--select-best", default=None, metavar="METRIC",
                    help="keep the state of the best epoch by this val metric (names "
                         "containing 'loss' minimize); the test eval and --export-dir use it. "
                         "Retrieval metrics (val_recall_at_100, val_ndcg_at_10, ...) run an "
                         "exact top-k eval on a val-user subsample each epoch")
    ap.add_argument("--retrieval-eval-users", type=int, default=2000,
                    help="user subsample of the per-epoch retrieval eval")
    ap.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default="float32",
                    help="tower matmul dtype (params and optimizer state stay float32)")
    ap.add_argument("--table-dtype", choices=["float32", "bfloat16", "int8"], default="float32",
                    help="embedding-table storage dtype (Adagrad math stays float32)")
    ap.add_argument("--wire-format", choices=["auto", "packed", "compact"], default="auto",
                    help="host->device batch encoding of the packed path: 'compact' ships "
                         "pre-hashed ids at their bit width (3.125 B an example for the "
                         "flagship with the sorted user slot delta-encoded, against 8; the "
                         "same numerics). 'auto' (default) picks compact when the batch size "
                         "is a multiple of 8")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="model axis of the mesh under torchrun (ranks = data x model)")
    ap.add_argument("--no-shard", action="store_true",
                    help="skip the mesh: the one-device path in each process")
    ap.add_argument("--sharded-exchange", choices=["dense", "alltoall"], default="dense",
                    help="the exchange of the row-sharded float tables the host does not "
                         "sort on a mesh: 'alltoall' sends each id's row and gradient "
                         "straight between its data rank and its owner through buckets of "
                         "fixed capacity (distinct ids; the epoch raises if any overflow); "
                         "'dense' (default) all-gathers and reduce-scatters")
    ap.add_argument("--exchange-capacity-factor", type=float, default=1.25,
                    help="alltoall: a bucket holds this multiple of B_local * L / ranks "
                         "distinct ids")
    ap.add_argument("--exchange-wire-dtype", choices=["float32", "bfloat16"],
                    default="float32",
                    help="alltoall: the rows' and gradients' dtype on the wire (bfloat16 "
                         "rounds them once)")
    ap.add_argument("--multi-host", action="store_true",
                    help="torchrun over several hosts: each host streams its own slice of "
                         "the shards at --batch-size a host, the global batch the hosts' "
                         "batches")
    ap.add_argument("--wire-cache", default=None, metavar="DIR",
                    help="pre-encoded batch cache (data/wirecache.py): built on first use "
                         "from the loader's order, reused after; an epoch's host work drops "
                         "to mmap and one copy. Epochs reorder whole batches (a batch's rows "
                         "are fixed at build: rebuild to re-roll them) and the ragged last "
                         "batch is dropped. Needs the packed path and the compact wire")
    ap.add_argument("--wire-cache-order", choices=["auto", "loader", "rotate", "shuffle"],
                    default="auto",
                    help="batch order of a wire-cache epoch. 'auto' (default): the loader's "
                         "order on a fresh generation (bit for bit the dynamic path), a "
                         "seeded rotation on reuse. A uniform 'shuffle' cost recall at full "
                         "scale in the reference (0.222-0.227 against 0.249; "
                         "BENCH_FULL_SCALE.md)")
    ap.add_argument("--wire-cache-generations", type=int, default=1,
                    help="distinct batch compositions to pre-encode (DIR/gen-N, one per "
                         "loader epoch's row shuffle), cycled across the epochs")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save the training state and the loader position here every epoch")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint of --checkpoint-dir and train on from "
                         "the epoch after it")
    return ap.parse_args(argv)


def block_sorted_kernel_auto(mcfg: cfg_lib.ModelConfig, sorted_feature: str | None,
                             compute_dtype: str) -> str:
    """The port's `--block-sorted-kernel auto`: the kernels wherever the
    port's kernels take the shapes. One kernel serves every table at every
    size, so only the pair the reference refuses (a host-sorted bf16 table)
    stays off; the gradients' dtype follows the tower compute's."""
    if sorted_feature and mcfg.table_dtype_of(mcfg.feature(sorted_feature).table) == "bfloat16":
        return "off"
    return "bfloat16" if compute_dtype == "bfloat16" else "float32"


def open_wire_caches(args: argparse.Namespace, train_loader: StreamLoader, featurizer,
                     host_index: int = 0, num_hosts: int = 1
                     ) -> tuple[list[WireCache], list[dict]]:
    """`--wire-cache`: each generation's cache (DIR/gen-N, across hosts
    DIR/host-{i}-of-{n}/gen-N from the host's own loader slice), built from
    the loader's epoch N when it is missing, by the host's first rank while
    its other ranks wait, opened with the run's scheme, batch size and
    dataset fingerprint. Returns the caches and, for each, its directory,
    whether this run built it, the build's seconds, its bytes and batch
    counts."""
    scheme = getattr(featurizer, "scheme", None)
    if scheme is None:
        raise SystemExit("--wire-cache requires the compact wire format "
                         "(drop --wire-format packed)")
    # the dataset's identity: a reused cache must come from the same shards at the
    # same batch size (a stale cache would train old data)
    fingerprint = {
        "data_dir": os.path.abspath(args.data_dir),
        "total_rows": train_loader.dataset.index.get("total_rows"),
        "num_shards": len(train_loader.dataset.index.get("shards", [])),
    }
    root = args.wire_cache
    if num_hosts > 1:
        root = os.path.join(root, f"host-{host_index}-of-{num_hosts}")
    # every rank of a host streams the same batches: its first rank builds, the rest wait
    first_rank = int(os.environ.get("LOCAL_RANK", "0")) == 0
    distributed = torch.distributed.is_initialized()
    caches, info = [], []
    for g in range(max(1, args.wire_cache_generations)):
        gdir = os.path.join(root, f"gen-{g}")
        built, seconds = False, 0.0
        if first_rank and not os.path.exists(os.path.join(gdir, "meta.json")):
            train_loader.set_epoch(g)
            t0 = time.perf_counter()
            meta = build_wire_cache(gdir, train_loader, featurizer, fingerprint=fingerprint)
            built, seconds = True, time.perf_counter() - t0
            log.info("wire cache built: %d batches (%d tail rows dropped) -> %s in %.2f s",
                     meta["num_batches"], meta["dropped_tail_rows"], gdir, seconds)
        if distributed:
            torch.distributed.barrier()
        try:
            cache = WireCache(gdir, scheme=scheme, seed=args.seed, batch_size=args.batch_size,
                              fingerprint=fingerprint)
        except ValueError as e:
            raise SystemExit(f"--wire-cache: {e}")
        caches.append(cache)
        info.append({"dir": gdir, "built": built, "build_seconds": seconds,
                     "bytes": sum(e.stat().st_size for e in os.scandir(gdir)),
                     "num_batches": cache.num_batches,
                     "dropped_tail_rows": cache.meta["dropped_tail_rows"]})
    if args.loss == "sampled_softmax" and len(caches) < args.epochs:
        # the reference measured recall at parity (0.2924 against 0.2942), but the
        # in-batch objective's val AUROC drifts faster when negatives repeat
        log.warning("wire cache: %d generation(s) < %d epochs with an in-batch loss: "
                    "reused compositions speed up the val-AUROC drift (retrieval recall "
                    "unaffected; BENCH_FULL_SCALE.md). --wire-cache-generations %d gives "
                    "fresh compositions.", len(caches), args.epochs, args.epochs)
    return caches, info


def main(argv: list[str] | None = None) -> dict:
    """Train, evaluate and export; returns {"metrics": train_val_test's
    results, "epochs": each epoch's train stats (of the epochs this run
    trained), "captures"/"replays" of the packed path's multi-step,
    "run_dir" (None on ranks but 0), "resumed_from" (the restored
    checkpoint's step, or None), "restore_seconds", "checkpoints" (each
    save's step, epoch, seconds and bytes), "wire_format" (the packed path's
    "packed" or "compact", None on --no-packed), "wire_cache"
    (`open_wire_caches`'s per-generation facts, or None), "rank" and "mesh"
    ({"data", "model", "hosts", "plan"} on the mesh path, else None)}."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    sharded = world > 1 and not args.no_shard
    if args.mesh_model != 1 and not sharded:
        raise SystemExit("--mesh-model needs a mesh: run data x model ranks under torchrun")
    if sharded:
        # a host's batch splits over its ranks (the whole mesh's on one host)
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world)) if args.multi_host else world
        if args.batch_size % local:
            raise SystemExit(f"--batch-size {args.batch_size} must be divisible by {local} "
                             "ranks")
        device = launch.initialize_distributed(args.device)
        try:
            return _main(args, device, make_mesh(model=args.mesh_model))
        finally:
            torch.distributed.destroy_process_group()
    return _main(args, resolve_device(args.device), None)


def _main(args: argparse.Namespace, device: torch.device, mesh) -> dict:
    rank0 = mesh is None or mesh.rank == 0
    # --multi-host: this host's slice of the shards, and the hosts the mesh spans
    host_index, num_hosts = launch.per_host_loader_slice() if args.multi_host else (0, 1)
    hosts = 1 if mesh is None else launch.mesh_hosts(mesh) if args.multi_host else 1
    mcfg = cfg_lib.two_tower_model_config(
        num_users=args.num_users, num_items=args.num_items, embedding_dim=args.embedding_dim,
        layer_sizes=tuple(args.layer_sizes), compute_dtype=args.compute_dtype)
    if args.table_dtype != "float32":
        mcfg = dataclasses.replace(mcfg, table_dtype=args.table_dtype)
    sorted_feature, sorted_auto = args.sorted_feature, False
    if sorted_feature == "off":
        sorted_feature = None
    elif sorted_feature == "auto":
        # across hosts a host sorts only its own batch: the sorted paths need the global one
        sorted_feature = (auto_sorted_feature(mcfg) if not args.no_packed and num_hosts == 1
                          else None)
        sorted_auto = sorted_feature is not None
        log.info("sorted-feature auto: %s", sorted_feature)
    elif args.no_packed or num_hosts > 1:
        # the host-sorted ids live in the packed path: the per-batch Featurizer does not sort
        raise SystemExit("--sorted-feature requires the packed path on a single host")
    if args.wire_format == "compact" and args.no_packed:
        raise SystemExit("--wire-format compact requires the packed path")
    if args.wire_cache and args.no_packed:
        raise SystemExit("--wire-cache requires the packed path (drop --no-packed)")
    block_kernel = args.block_sorted_kernel
    if block_kernel == "auto":
        block_kernel = block_sorted_kernel_auto(mcfg, sorted_feature, args.compute_dtype)
        log.info("block-sorted-kernel auto: %s", block_kernel)
    tcfg = cfg_lib.TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, learning_rate=args.learning_rate,
        sparse_learning_rate=args.sparse_learning_rate, loss=args.loss, seed=args.seed,
        validation_freq=args.validation_freq, softmax_temperature=args.softmax_temperature,
        limit_train_batches=args.limit_train_batches,
        limit_val_batches=args.limit_val_batches, limit_test_batches=args.limit_test_batches,
        sorted_feature=sorted_feature, block_sorted_kernel=block_kernel,
        sharded_exchange=args.sharded_exchange,
        exchange_capacity_factor=args.exchange_capacity_factor,
        exchange_wire_dtype=args.exchange_wire_dtype)

    plan = None
    if mesh is not None:
        hbm = torch.cuda.mem_get_info(device)[1] if device.type == "cuda" else None
        plan = planner.plan_sharding(mcfg, mesh.size, hbm_budget_bytes=hbm)
        if sorted_auto:
            # the auto choice steps aside where the plan puts the sorted table where the
            # sorted paths do not go (the block kernels stay on, in device-sort mode)
            strategy = plan[validate_sorted_feature(mcfg, tcfg)].strategy
            if strategy not in (planner.ROW_SHARDED, planner.REPLICATED) or (
                    block_kernel != "off" and strategy != planner.ROW_SHARDED):
                log.info("sorted-feature auto: off (table is %s)", strategy)
                sorted_feature = None
                tcfg = dataclasses.replace(tcfg, sorted_feature=None)
        if tcfg.print_sharding_plan and rank0:
            print(plan.describe())
            if tcfg.sharded_exchange == "alltoall":
                print("alltoall exchange: " + (", ".join(sorted(alltoall_tables(
                    mcfg, tcfg, plan, validate_sorted_feature(mcfg, tcfg)))) or "no table"))

    state, dense_opt = create_train_state(torch.Generator(device=device).manual_seed(args.seed),
                                          mcfg, tcfg)
    featurizer = Featurizer(mcfg, device="cpu")  # host batches; the loop moves them

    topo = topology_summary(device)
    logger = ExperimentLogger(args.runs_root) if rank0 else None
    if logger is not None:
        logger.log_params({
            "num_users": args.num_users, "num_items": args.num_items,
            "embedding_dim": args.embedding_dim, "layer_sizes": args.layer_sizes,
            "batch_size": args.batch_size, "loss": args.loss,
            "devices": 1 if mesh is None else mesh.size, "hosts": topo.num_hosts,
            "platform": topo.platform, "device_kind": topo.device_kind,
            "devices_per_host": 1 if mesh is None else topo.devices_per_host,
        })

    ckpt = Checkpointer(args.checkpoint_dir) if args.checkpoint_dir else None
    train_loader = StreamLoader(os.path.join(args.data_dir, "train"), args.batch_size,
                                seed=args.seed, host_index=host_index, num_hosts=num_hosts)
    if args.no_packed and train_loader.dataset.index.get("packed"):
        raise SystemExit("--no-packed cannot train on a PRE-PACKED dataset (its columns are "
                         "device-layout packed_ids, not raw features): drop --no-packed or "
                         "prepare the data without --packed")
    start_epoch, resumed_from, restore_seconds = 0, None, None
    if args.resume and ckpt is not None and ckpt.latest_step() is not None:
        t0 = time.perf_counter()
        # the checkpoint holds the whole state: restored whole, then sharded
        state, _, extra = ckpt.restore(state)
        restore_seconds = time.perf_counter() - t0
        # checkpoints are taken at epoch boundaries: resume at the NEXT epoch
        start_epoch = int(extra.get("completed_epoch", -1)) + 1
        resumed_from = state.step
        if rank0:
            print(f"resumed from step {state.step}, epoch {start_epoch}")

    sharding, pad_multiple, pad_to = None, None, None
    if mesh is None:
        train_step = make_train_step(mcfg, tcfg, dense_opt)
        eval_step = make_eval_step(mcfg, tcfg)
    else:
        state = shard_train_state(state, plan, mesh)
        train_step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan)
        eval_step = make_sharded_eval_step(mcfg, tcfg, mesh, plan)
        sharding, pad_multiple = batch_sharding(mesh, hosts), mesh.size
        if num_hosts > 1:
            # every host's eval batches padded to the batch size, and every host run to the
            # longest host's count (align_hosts="pad"): the collectives line up, no sample
            # is dropped
            pad_to = args.batch_size

    def whole(s):
        """The unsharded state on rank 0 (None elsewhere; every rank takes part)."""
        return s if mesh is None else unshard_train_state(s, plan, mcfg, mesh, dst=0)

    saves: list[dict] = []

    def checkpoint_fn(s, epoch):
        if ckpt is None:
            return
        t0 = time.perf_counter()
        full = whole(s)
        if not rank0:
            return
        ckpt.save(full.step, full, loader_state=train_loader.state_dict(),
                  extra={"completed_epoch": epoch}, wait=True)
        saves.append({"step": full.step, "epoch": epoch, "seconds": time.perf_counter() - t0,
                      "bytes": sum(e.stat().st_size for e in os.scandir(ckpt.step_dir(full.step)))})

    def eval_factory(split):
        return lambda: StreamLoader(os.path.join(args.data_dir, split), args.batch_size,
                                    shuffle=False, drop_last=False, host_index=host_index,
                                    num_hosts=num_hosts,
                                    align_hosts="pad" if num_hosts > 1 else "truncate")

    epochs: list[dict] = []
    multi = None
    wire, wire_cache_info = None, None
    if args.no_packed:
        def train_epoch_fn(state, epoch):
            train_loader.set_epoch(epoch)
            state, stats = train_one_epoch(state, train_step, train_loader, featurizer, tcfg,
                                           eval_step, eval_factory("val"), logger, epoch,
                                           sharding, pad_multiple, pad_to)
            epochs.append(stats)
            return state, stats
    else:
        if train_loader.dataset.index.get("packed"):
            packed_feat = PrepackedFeaturizer.for_dataset(train_loader.dataset, mcfg,
                                                          sort_feature=sorted_feature)
        else:
            packed_feat = PackedFeaturizer(mcfg, pack_label=True, sort_feature=sorted_feature)
        # unpack with the featurizer's own label encoding: a pre-packed dataset
        # written with pack_label=False keeps its labels in a column of their own
        pl = packed_feat.pack_label
        wire = args.wire_format
        if wire == "auto":
            # bit groups of 8 examples, then the groups split over the ranks; across
            # hosts auto stays packed, as the reference's does
            ranks = 1 if mesh is None else mesh.size
            wire = ("compact" if args.batch_size % (8 * ranks) == 0 and num_hosts == 1
                    else "packed")
        log.info("wire format: %s", wire)
        macro_sh = tail_sh = None
        if wire == "compact":
            # a sorted slot ships as uint8 deltas (3.125 B an example for the flagship
            # against 4.375; the same numerics: data/compact.py)
            delta_feature, segments = sorted_feature, 1
            if num_hosts > 1:
                # the wire needs no global sort: each host sorts its own batch (the loss
                # does not depend on the rows' order) and encodes it as one segment
                delta_feature, segments = auto_sorted_feature(mcfg), num_hosts
                if delta_feature is not None:
                    packed_feat = (PrepackedFeaturizer.for_dataset(
                        train_loader.dataset, mcfg, sort_feature=delta_feature)
                        if train_loader.dataset.index.get("packed") else PackedFeaturizer(
                            mcfg, pack_label=True, sort_feature=delta_feature))
                    pl = packed_feat.pack_label
                    log.info("multi-host delta wire: a host's sort by %s (%d segments)",
                             delta_feature, segments)
            scheme = CompactScheme.from_model(mcfg, pack_label=pl, delta_feature=delta_feature,
                                              delta_segments=segments)
            packed_feat = CompactFeaturizer(packed_feat, scheme)
            if mesh is None:
                multi = make_multi_step(lambda s, cb: train_step(
                    s, batch_from_compact(cb, mcfg, scheme)))
                tail_step = make_compact_train_step(train_step, mcfg, scheme)
            else:
                try:
                    macro_sh = tail_sh = compact_shardings(mesh, scheme, args.batch_size, hosts)
                except ValueError as e:
                    raise SystemExit(f"--wire-format compact: {e}")
                multi = make_sharded_compact_multi_step(mcfg, tcfg, dense_opt, mesh, plan,
                                                        scheme, hosts)
                decode = sharded_compact_decoder(mcfg, scheme, mesh, hosts)
                tail_step = lambda s, cb: train_step(s, decode(cb))  # noqa: E731
        elif mesh is not None:
            multi = make_sharded_multi_step(mcfg, tcfg, dense_opt, mesh, plan, pack_label=pl)
            tail_step = make_packed_train_step(train_step, mcfg, pack_label=pl)
            macro_sh, tail_sh = macro_batch_sharding(mesh, hosts), sharding
        else:
            multi = make_multi_step(lambda s, pb: train_step(s, unpack_batch(pb, mcfg,
                                                                             pack_label=pl)))
            tail_step = make_packed_train_step(train_step, mcfg, pack_label=pl)
        val_ds = ShardedDataset(os.path.join(args.data_dir, "val"))
        if val_ds.index.get("packed"):  # pre-packed val/test evaluate through the packed step
            featurizer = PrepackedFeaturizer.for_dataset(val_ds, mcfg)
            eval_step = make_packed_eval_step(eval_step, mcfg, pack_label=featurizer.pack_label)

        if args.wire_cache:
            wire_caches, wire_cache_info = open_wire_caches(args, train_loader, packed_feat,
                                                            host_index, num_hosts)
            wc_limit = min(c.num_batches for c in wire_caches)
            if num_hosts > 1:
                # every host takes as many steps: the fewest of the hosts' caches
                fewest = torch.tensor([wc_limit], device=device)
                torch.distributed.all_reduce(fewest, op=torch.distributed.ReduceOp.MIN)
                wc_limit = int(fewest.item())
            if wc_limit != wire_caches[0].num_batches:
                log.info("wire cache: truncating %d -> %d batches (the fewest of the "
                         "generations%s)", wire_caches[0].num_batches, wc_limit,
                         " and hosts" if num_hosts > 1 else "")

        def train_epoch_fn(state, epoch):
            if args.wire_cache:
                # the macro clamped to the cache, so a small dataset still takes the
                # macro path; the leftover (< one macro) trains batch by batch
                macro = max(1, min(args.macro_batches, wc_limit))
                cache = wire_caches[epoch % len(wire_caches)]
                mode = args.wire_cache_order
                if mode == "auto":
                    # a fresh generation in the loader's order (the dynamic path, bit
                    # for bit); on reuse a rotation (variety without the uniform
                    # shuffle's recall cost)
                    mode = "loader" if epoch < len(wire_caches) else "rotate"
                batches, feat = cache.batches(epoch, limit_batches=wc_limit,
                                              order_mode=mode), (lambda cb: cb)
            else:
                train_loader.set_epoch(epoch)
                macro, batches, feat = args.macro_batches, train_loader, packed_feat
            state, stats = train_one_epoch_packed(
                state, multi, batches, feat, macro=macro, train_cfg=tcfg, tail_step=tail_step,
                eval_step=eval_step, val_batches_factory=eval_factory("val"),
                val_featurizer=featurizer, logger=logger, epoch=epoch, sharding=macro_sh,
                tail_sharding=tail_sh, val_sharding=sharding, pad_multiple=pad_multiple,
                pad_to=pad_to)
            epochs.append(stats)
            return state, stats

    # --select-best on a retrieval metric: an exact top-k on a val-user subsample
    # each epoch (val AUROC is no selection signal for the in-batch objective)
    retrieval_eval_fn = None
    if args.select_best and any(t in args.select_best
                                for t in ("recall", "ndcg", "mrr", "precision", "hit")):
        positives = split_positives(os.path.join(args.data_dir, "val"))
        m = re.search(r"_at_(\d+)$", args.select_best)
        k_sel = int(m.group(1)) if m else 100
        params_fn = None
        if mesh is not None:
            def params_fn(s):
                return unshard_train_state(s, plan, mcfg, mesh, dst=None).model
        retrieval_eval_fn = make_retrieval_eval_fn(mcfg, positives, k=max(k_sel, 100),
                                                   ks=(k_sel,),
                                                   max_users=args.retrieval_eval_users,
                                                   params_fn=params_fn)
        if rank0:
            print(f"per-epoch retrieval eval: {len(positives)} users with val positives, "
                  f"subsample {args.retrieval_eval_users}, selecting on {args.select_best}")

    state, results = train_val_test(
        state, train_step, eval_step, mcfg, tcfg, featurizer,
        train_batches_factory=None, val_batches_factory=eval_factory("val"),
        test_batches_factory=eval_factory("test"), logger=logger,
        checkpoint_fn=checkpoint_fn, sharding=sharding, pad_multiple=pad_multiple,
        pad_to=pad_to, start_epoch=start_epoch, train_epoch_fn=train_epoch_fn,
        select_best=args.select_best, retrieval_eval_fn=retrieval_eval_fn)
    if rank0:
        print({k: round(v, 5) for k, v in results.items()})
    if args.export_dir:
        full = whole(state)
        if rank0:
            export_model(args.export_dir, mcfg, full)
            print(f"exported model to {args.export_dir}")
    return {"metrics": results, "epochs": epochs,
            "captures": multi.captures if multi else 0, "replays": multi.replays if multi else 0,
            "run_dir": logger.run_dir if logger is not None else None,
            "resumed_from": resumed_from, "restore_seconds": restore_seconds,
            "checkpoints": saves, "wire_format": wire, "wire_cache": wire_cache_info,
            "rank": 0 if mesh is None else mesh.rank,
            "mesh": None if mesh is None else {"data": mesh.data, "model": mesh.model,
                                               "hosts": hosts, "plan": plan.describe()}}


if __name__ == "__main__":
    main()
