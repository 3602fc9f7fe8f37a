"""Sharded tables and the data-parallel train step, on `torch.distributed`.

Port of `two_tower_recommender_model_tpu/parallel/sharded.py` (the dense
exchange). Tables are row-sharded over the flat rank index of the mesh
(`parallel/mesh.py`; each row exists once globally), table-wise tables live
in per-(dim, dtype) buckets that row-shard the same way, small tables are
replicated, and the dense towers are replicated with data-parallel
gradients:

  forward   all_gather(ids, weights over data)       # B_glob x L
            partial pool from this rank's rows         # kernel #1
            reduce_scatter(partials over data)         # B_glob x D f32
            all_reduce(over model)                     # B_loc x D (model > 1)
  backward  all_reduce(tower gradients over data)     # one flat f32 buffer
            all_gather(ids, row gradients over data)  # B_glob x L x D
            row-wise Adagrad on this rank's rows only  # kernel #4

A rank's local work is a plain function of (its shard, the gathered ids /
weights / gradients, its shard index): `partial_pool`, `sorted_partial_rows`,
`shard_local_ids` and the update picked by `train.step.pick_table_update_fn`.
The collectives wrap them, so one process can run every shard's work in turn
(`chip_smoke.py [shard-kernels]`).

Every update goes through kernel #4 (`ops/adagrad_kernel.py`), as the
one-device step's: the host-sorted table's shard passes its non-decreasing
local ids straight in (ids below the shard go negative, above it reach past
its rows: both are sentinels), every other table takes the stable device
sort first, which keeps replicas bit for bit in step. The fused tower
forward and backward run on each rank's slice of the batch. Each rank's BCE
is its sum over the global batch size, so the summed gradients are the
global batch's.

One host feeds a global batch (`batch_sharding`): the ranks of a data group
see its slices in order, so a batch sorted by the host-sorted feature stays
sorted after the all-gather.

Not ported here: int8 sharded tables, column-sharded tables and the
all-to-all exchange (ROADMAP M12(b)); the sharded sampled softmax, sharded
top-k and the compact wire on a mesh (M12(c)).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from two_tower_recommender_model_tpu_torch.config import ModelConfig, TrainConfig
from two_tower_recommender_model_tpu_torch.data.device_featurizer import unpack_batch
from two_tower_recommender_model_tpu_torch.data.featurizer import Batch
from two_tower_recommender_model_tpu_torch.models import losses as losses_lib
from two_tower_recommender_model_tpu_torch.models.metrics import auroc_update, mean_update
from two_tower_recommender_model_tpu_torch.models.two_tower import (
    TwoTower,
    torch_dtype,
    towers_forward,
)
from two_tower_recommender_model_tpu_torch.ops.embedding_kernel import pooled_gather
from two_tower_recommender_model_tpu_torch.ops.embedding_ops import (
    block_sorted_lookup,
    row_grads_from_pooled,
)
from two_tower_recommender_model_tpu_torch.ops.quantized import QuantizedTable
from two_tower_recommender_model_tpu_torch.parallel.mesh import Mesh
from two_tower_recommender_model_tpu_torch.parallel.planner import (
    COLUMN_SHARDED,
    REPLICATED,
    ROW_SHARDED,
    TABLE_WISE,
    ShardingPlan,
)
from two_tower_recommender_model_tpu_torch.train import optimizer as opt_lib
from two_tower_recommender_model_tpu_torch.train.step import (
    EvalState,
    TrainState,
    _check_train_config,
    make_multi_step,
    pick_table_update_fn,
    tower_parameters,
    validate_sorted_feature,
)

# the un-deprecated names where this torch has them
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_into = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

# ---------------------------------------------------------------------------
# placement


class BatchSharding:
    """Leaf -> this rank's slice of a global host batch along `axis` (0 for
    a batch, 1 for a `[K, B, ...]` macro-batch), the rows its data
    coordinate `d` owns. A macro leaf with fewer than two axes or an empty
    last axis (a packed label's placeholder) is kept whole, as the
    reference replicates it. `device` is the mesh's."""

    def __init__(self, mesh: Mesh, axis: int = 0):
        self.mesh, self.axis = mesh, axis

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def parts(self) -> int:
        return self.mesh.data

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.axis and (t.dim() <= self.axis or t.shape[-1] == 0):
            return t
        n = t.shape[self.axis]
        if n % self.mesh.data:
            raise ValueError(f"batch of {n} rows does not split over {self.mesh.data} data "
                             "ranks: pad it (pad_batch) or pick a multiple")
        part = n // self.mesh.data
        return t.narrow(self.axis, self.mesh.d * part, part).contiguous()


def batch_sharding(mesh: Mesh) -> BatchSharding:
    """Leaf -> this rank's slice of the leading (batch) axis."""
    return BatchSharding(mesh, 0)


def macro_batch_sharding(mesh: Mesh) -> BatchSharding:
    """Leaf -> this rank's slice of a stacked `[K, B, ...]` macro-batch's
    batch axis; the K axis whole."""
    return BatchSharding(mesh, 1)


# ---------------------------------------------------------------------------
# collectives


def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """[n * B, ...]: the group's tensors, in rank order, along axis 0."""
    t = t.contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    _all_gather_into(out, t, group=group)
    return out


def _reduce_scatter(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """This rank's [B / n, ...] slice of the group's sum."""
    t = t.contiguous()
    out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
    _reduce_scatter_into(out, t, group=group)
    return out


def _reduce_partials(part: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The partial pools [B_glob, D] of the ranks summed: this rank's
    [B_loc, D] slice over data, then over model."""
    out = _reduce_scatter(part, mesh.data_group, mesh.data)
    if mesh.model > 1:
        dist.all_reduce(out, group=mesh.model_group)
    return out


# ---------------------------------------------------------------------------
# state placement


def _check_plan(state_tables: dict, plan: ShardingPlan, mesh: Mesh) -> None:
    if plan.num_devices != mesh.size:
        raise ValueError(f"plan for {plan.num_devices} devices on a {mesh.size}-rank mesh")
    for name, t in state_tables.items():
        if isinstance(t, QuantizedTable):
            raise NotImplementedError(
                f"table {name!r} is int8: sharded int8 tables are not ported to the PyTorch "
                "package yet (ROADMAP M12(b))")
    for name, spec in plan.specs.items():
        if spec.strategy == COLUMN_SHARDED:
            raise NotImplementedError(
                f"table {name!r} is column_sharded: column-wise tables are not ported to the "
                "PyTorch package yet (ROADMAP M12(b))")


def _shard_rows(plan: ShardingPlan, name: str) -> int:
    """Rows of one rank's shard: the bucket's rows a device, the padded rows
    over the ranks for a row-sharded table, all of them when replicated."""
    if name in plan.buckets:
        return plan.buckets[name].rows_per_device
    spec = plan[name]
    return spec.padded_rows // plan.num_devices if spec.strategy == ROW_SHARDED \
        else spec.num_embeddings


def _sharded_model(cfg: ModelConfig, towers_from: TwoTower, tables: dict,
                   device: torch.device) -> TwoTower:
    model = TwoTower(cfg, device=device, tables=tables)
    for key in ("query_tower", "candidate_tower"):
        getattr(model, key).load_state_dict(getattr(towers_from, key).state_dict())
    return model


@torch.no_grad()
def shard_train_state(state: TrainState, plan: ShardingPlan, mesh: Mesh) -> TrainState:
    """This rank's part of a whole (one-device) state, on the mesh's device:
    a row-sharded table's rows `[r * R, (r + 1) * R)` of its padded rows
    (the padding zeros, never written), each bucket's shard holding the
    table-wise tables this rank owns at their offsets (the tables themselves
    are gone from the state), replicated tables whole; f32 or bf16. The
    towers, their optimizer's state and the step are copied."""
    _check_plan(state.model.tables, plan, mesh)
    dev, r = mesh.device, mesh.rank
    tables, accs = {}, {}
    for bname, b in plan.buckets.items():
        member0 = state.model.tables[b.tables[0]]
        big = torch.zeros((b.rows_per_device, b.embedding_dim), dtype=member0.dtype, device=dev)
        big_acc = torch.zeros(b.rows_per_device, dtype=torch.float32, device=dev)
        for tname in b.tables:
            spec = plan[tname]
            if spec.owner != r:
                continue
            t, a = state.model.tables[tname], state.adagrad_acc[tname]
            if t.dtype != big.dtype:
                raise ValueError(f"bucket {bname} mixes {t.dtype} and {big.dtype} tables")
            big[spec.bucket_offset:spec.bucket_offset + t.shape[0]] = t.to(dev)
            big_acc[spec.bucket_offset:spec.bucket_offset + t.shape[0]] = a.to(dev)
        tables[bname], accs[bname] = big, big_acc
    for name, spec in plan.specs.items():
        if spec.strategy == TABLE_WISE:
            continue  # lives inside its bucket
        t, a = state.model.tables[name], state.adagrad_acc[name]
        if spec.strategy == ROW_SHARDED:
            rows = _shard_rows(plan, name)
            lo, hi = r * rows, min((r + 1) * rows, spec.num_embeddings)
            shard = torch.zeros((rows, t.shape[1]), dtype=t.dtype, device=dev)
            acc = torch.zeros(rows, dtype=torch.float32, device=dev)
            if hi > lo:
                shard[:hi - lo] = t[lo:hi].to(dev)
                acc[:hi - lo] = a[lo:hi].to(dev)
            tables[name], accs[name] = shard, acc
        else:
            tables[name], accs[name] = t.to(dev, copy=True), a.to(dev, copy=True)
    model = _sharded_model(state.model.cfg, state.model, tables, dev)
    opt = opt_lib.clone_dense_optimizer(state.dense_opt_state, tower_parameters(model))
    return TrainState(step=state.step, model=model, adagrad_acc=accs, dense_opt_state=opt,
                      item_counts=None if state.item_counts is None
                      else state.item_counts.to(dev, copy=True))


def _gather_rows(t: torch.Tensor, mesh: Mesh, dst: int | None) -> torch.Tensor | None:
    """The ranks' shards stacked in flat rank order: on every rank
    (`dst=None`) or on rank `dst` (None elsewhere)."""
    t = t.contiguous()
    if dst is None:
        return _all_gather(t, mesh.group, mesh.size)
    parts = [torch.empty_like(t) for _ in range(mesh.size)] if mesh.rank == dst else None
    dist.gather(t, gather_list=parts, dst=dst, group=mesh.group)
    return None if parts is None else torch.cat(parts)


@torch.no_grad()
def unshard_train_state(state: TrainState, plan: ShardingPlan, model_cfg: ModelConfig,
                        mesh: Mesh, dst: int | None = 0,
                        device: torch.device | str | None = None) -> TrainState | None:
    """The whole one-device state gathered from the ranks' parts: on rank
    `dst` (None on the others, which take part), or on every rank with
    `dst=None`; on `device` (the mesh's when None). Row padding is stripped,
    table-wise tables are cut back out of their buckets; towers, optimizer
    state and step come from this rank's copy."""
    device = mesh.device if device is None else torch.device(device)
    gathered = {name: (_gather_rows(state.model.tables[name], mesh, dst),
                       _gather_rows(state.adagrad_acc[name], mesh, dst))
                for name in [*plan.buckets,
                             *(n for n, s in plan.specs.items() if s.strategy == ROW_SHARDED)]}
    if dst is not None and mesh.rank != dst:
        return None
    tables, accs = {}, {}
    for name, spec in plan.specs.items():
        n = spec.num_embeddings
        if spec.strategy == TABLE_WISE:
            start = spec.owner * plan.buckets[spec.bucket].rows_per_device + spec.bucket_offset
            t, a = gathered[spec.bucket]
            t, a = t[start:start + n], a[start:start + n]
        elif spec.strategy == ROW_SHARDED:
            t, a = gathered[name]
            t, a = t[:n], a[:n]
        else:
            t, a = state.model.tables[name], state.adagrad_acc[name]
        tables[name] = t.to(device, copy=True).contiguous()
        accs[name] = a.to(device, copy=True).contiguous()
    model = _sharded_model(model_cfg, state.model, {t.name: tables[t.name]
                                                    for t in model_cfg.tables}, device)
    opt = opt_lib.clone_dense_optimizer(state.dense_opt_state, tower_parameters(model))
    return TrainState(step=state.step, model=model, adagrad_acc=accs, dense_opt_state=opt,
                      item_counts=None if state.item_counts is None
                      else state.item_counts.to(device, copy=True))


# ---------------------------------------------------------------------------
# shard-local work: plain functions of the shard, the gathered batch and the index


def shard_local_ids(ids_all: torch.Tensor, shard_index: int, rows: int) -> torch.Tensor:
    """Global ids as a shard's local rows, in place of each position: ids
    outside the shard become the sentinel `rows` (the reference's unsorted
    path, `sharded.py:524`)."""
    local = ids_all - shard_index * rows
    return torch.where((local >= 0) & (local < rows), local, rows).to(torch.int32)


def partial_pool(shard: torch.Tensor, ids_all: torch.Tensor, w_all: torch.Tensor,
                 shard_index: int) -> torch.Tensor:
    """[B_glob, D] f32: each bag's weighted sum over the slots this shard
    owns (the reference's `_local_partial_pool`); slots outside the shard
    take weight 0. One launch of kernel #1."""
    local = shard_local_ids(ids_all, shard_index, shard.shape[0]).contiguous()
    w = torch.where(local < shard.shape[0], w_all, 0.0).contiguous()
    return pooled_gather(shard, local, w, out_dtype=torch.float32)


def sorted_partial_rows(shard: torch.Tensor, keys_all: torch.Tensor, w_all: torch.Tensor,
                        shard_index: int, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """[M, D]: `w * shard[key - shard_index * rows]` for the host-sorted
    single-slot feature's gathered keys (dead slots keyed past every shard),
    zero rows for the keys outside the shard, which go negative below it and
    past its rows above it: kernel #1 through the sorted lookup's call site."""
    local = (keys_all.reshape(-1) - shard_index * shard.shape[0]).to(torch.int32)
    return block_sorted_lookup(shard, local, w_all.reshape(-1), out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# lookups


def make_sharded_lookup(mesh: Mesh) -> Callable:
    """`lookup(shard, ids [B_loc, L], w [B_loc, L]) -> [B_loc, D]` f32: the
    weighted-sum pool of a row-sharded table (or bucket)."""

    def lookup(shard, ids, w):
        ids_all = _all_gather(ids.to(torch.int32), mesh.data_group, mesh.data)
        w_all = _all_gather(w.to(torch.float32), mesh.data_group, mesh.data)
        return _reduce_partials(partial_pool(shard, ids_all, w_all, mesh.rank), mesh)

    return lookup


def make_sorted_sharded_lookup(mesh: Mesh) -> Callable:
    """`lookup(shard, ids [B_loc, 1], w [B_loc, 1], out_dtype) -> [B_loc, D]`
    for the host-sorted feature's row-sharded table: after the all-gather
    the keys are non-decreasing, and each shard's rows come from kernel #1
    at one slot (`sorted_partial_rows`). One shard owns each row, so the sum
    of the partials is exact, in `out_dtype` too."""

    def lookup(shard, ids, w, out_dtype=None):
        ids_all = _all_gather(ids.to(torch.int32), mesh.data_group, mesh.data)
        w_all = _all_gather(w.to(torch.float32), mesh.data_group, mesh.data)
        key = torch.where(w_all != 0, ids_all, mesh.size * shard.shape[0])
        return _reduce_partials(sorted_partial_rows(shard, key, w_all, mesh.rank, out_dtype),
                                mesh)

    return lookup


# ---------------------------------------------------------------------------
# updates


def make_sharded_update(mesh: Mesh, update_fn: Callable) -> Callable:
    """`update(shard, acc, keys [B_loc, L], row_g [B_loc, L, D], lr, eps)`
    on a row-sharded table or a bucket (dead slots keyed past every shard):
    the keys and gradients all-gathered over data, then `update_fn` on this
    shard's local ids (`shard_local_ids`: kernel #4 after the stable device
    sort). Every row is updated once globally, by its owner."""

    def update(shard, acc, keys, row_g, lr, eps):
        keys_all = _all_gather(keys, mesh.data_group, mesh.data).reshape(-1)
        g_all = _all_gather(row_g, mesh.data_group, mesh.data)
        return update_fn(shard, acc, shard_local_ids(keys_all, mesh.rank, shard.shape[0]),
                         g_all.reshape(-1, g_all.shape[-1]), lr, eps)

    return update


def make_sorted_sharded_update(mesh: Mesh, update_fn: Callable) -> Callable:
    """The host-sorted feature's row-sharded table: the gathered keys minus
    the shard base stay non-decreasing, so `update_fn` (kernel #4 behind the
    sortedness assert, with the bf16 buffer where the reference takes it)
    takes them straight, negative and past-the-shard ids as sentinels."""

    def update(shard, acc, keys, row_g, lr, eps):
        keys_all = _all_gather(keys, mesh.data_group, mesh.data).reshape(-1)
        g_all = _all_gather(row_g, mesh.data_group, mesh.data)
        local = (keys_all - mesh.rank * shard.shape[0]).to(torch.int32)
        return update_fn(shard, acc, local, g_all.reshape(-1, g_all.shape[-1]), lr, eps)

    return update


def make_replicated_update(mesh: Mesh, update_fn: Callable) -> Callable:
    """A replicated table, as DDP does it: the batch's keys (dead slots
    keyed N) and gradients all-gathered over data, then the same
    deterministic update on every rank: `update_fn` is kernel #4 after the
    stable device sort, or for the host-sorted feature's table straight
    (`make_replicated_sorted_update`), so replicas stay bit for bit equal."""

    def update(table, acc, keys, row_g, lr, eps):
        keys_all = _all_gather(keys, mesh.data_group, mesh.data).reshape(-1)
        g_all = _all_gather(row_g, mesh.data_group, mesh.data)
        return update_fn(table, acc, keys_all.to(torch.int32), g_all.reshape(-1, g_all.shape[-1]),
                         lr, eps)

    return update


make_replicated_sorted_update = make_replicated_update


# ---------------------------------------------------------------------------
# forward / train / eval


def _pool_weights(fc, mask: torch.Tensor) -> torch.Tensor:
    """Per-slot weights: the mask for sum pooling, mask / count for mean."""
    w = mask.to(torch.float32)
    if fc.pooling == "mean":
        w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1.0)
    return w


def _bucket_base(plan: ShardingPlan, spec) -> int:
    """A table-wise table's first row in its bucket's global coordinates."""
    return spec.owner * plan.buckets[spec.bucket].rows_per_device + spec.bucket_offset


def _check_step_config(model_cfg: ModelConfig, train_cfg: TrainConfig,
                       plan: ShardingPlan) -> str | None:
    """The reference's checks of the sharded step (`sharded.py:983-1004`)
    and the port's refusals; returns the host-sorted table's name."""
    _check_train_config(model_cfg, train_cfg)
    if train_cfg.sharded_exchange == "alltoall":
        raise NotImplementedError("sharded_exchange='alltoall' is not ported to the PyTorch "
                                  "package yet (ROADMAP M12(b)); the dense exchange is")
    if train_cfg.sharded_exchange != "dense":
        raise ValueError(f"sharded_exchange must be dense|alltoall, got "
                         f"{train_cfg.sharded_exchange!r}")
    sorted_table = validate_sorted_feature(model_cfg, train_cfg)
    if sorted_table is not None:
        strategy = plan[sorted_table].strategy
        if strategy not in (ROW_SHARDED, REPLICATED):
            raise ValueError(f"sorted_feature table {sorted_table!r} must be row_sharded or "
                             f"replicated in the sharded step (plan says {strategy})")
        if train_cfg.block_sorted_kernel != "off" and strategy != ROW_SHARDED:
            raise ValueError(
                f"block_sorted_kernel needs table {sorted_table!r} row_sharded in the sharded "
                f"step (plan says {strategy}); force it via plan_sharding(..., "
                "force={...: 'row_sharded'})")
    return sorted_table


def make_sharded_forward(model_cfg: ModelConfig, mesh: Mesh, plan: ShardingPlan,
                         block_sorted_feature: str | None = None,
                         block_sorted_dtype: str = "float32"):
    """(forward(state, batch) -> (q, c), pooled_embeddings(tables, batch) ->
    (pooled, weights)): the towers on this rank's slice, each feature
    pooled by its table's placement. `block_sorted_feature` takes the
    sorted lookup, its rows rounded to bf16 under `block_sorted_dtype=
    "bfloat16"` as the one-device step's are. The pooled outputs are in the
    compute dtype when it differs from the tables' (`models/two_tower.py`)."""
    lookup = make_sharded_lookup(mesh)
    sorted_lookup = make_sorted_sharded_lookup(mesh)
    compute = (torch_dtype(model_cfg.compute_dtype)
               if model_cfg.compute_dtype != model_cfg.resolved_table_dtype else None)

    def pooled_embeddings(tables, batch: Batch):
        pooled, weights = {}, {}
        for fc in model_cfg.features:
            feat = batch.features[fc.name]
            w = _pool_weights(fc, feat.mask)
            weights[fc.name] = w
            spec = plan[fc.table]
            if spec.strategy == TABLE_WISE:
                table = tables[spec.bucket]
                out = lookup(table, feat.ids + _bucket_base(plan, spec), w)
            elif spec.strategy == ROW_SHARDED and fc.name == block_sorted_feature:
                table = tables[fc.table]
                rows_dtype = torch.bfloat16 if block_sorted_dtype == "bfloat16" else compute
                out = sorted_lookup(table, feat.ids, w, rows_dtype)
            elif spec.strategy == ROW_SHARDED:
                table = tables[fc.table]
                out = lookup(table, feat.ids, w)
            else:
                table = tables[fc.table]
                out = pooled_gather(table, feat.ids.to(torch.int32).contiguous(), w.contiguous(),
                                    out_dtype=torch.float32)
            pooled[fc.name] = out.to(compute or table.dtype)
        return pooled, weights

    def forward(state: TrainState, batch: Batch):
        pooled, _ = pooled_embeddings(state.model.tables, batch)
        return towers_forward(state.model, pooled, batch.dense)

    return forward, pooled_embeddings


def _sharded_loss_fn(train_cfg: TrainConfig, mesh: Mesh) -> Callable:
    """`loss_fn(q, c, batch, b_glob) -> (local loss, its value, logits)`:
    this rank's part of the global batch's loss (its sum over the global
    batch size, or over the global weight, in f32), whose gradients summed
    over data are the global batch's; and the part of the reported loss,
    which on one rank is the one-device step's value bit for bit (its mean
    in the logits' dtype)."""
    if train_cfg.loss == "sampled_softmax":
        losses_lib.sharded_in_batch_sampled_softmax(mesh)
    if train_cfg.loss == "bce":
        def loss_fn(q, c, batch, b_glob):
            logits = torch.sum(q * c, dim=1)
            per = losses_lib.bce_per_example(logits, batch.labels)
            value = per.detach().mean().float() * (per.shape[0] / b_glob)
            return per.float().sum() / b_glob, value, logits
        return loss_fn
    if train_cfg.loss == "weighted_bce":
        if not train_cfg.loss_type_weights:
            raise ValueError('loss="weighted_bce" requires non-empty type_weights')
        lo = train_cfg.loss_type_onehot_start
        hi = lo + len(train_cfg.loss_type_weights)

        def loss_fn(q, c, batch, b_glob):
            logits = torch.sum(q * c, dim=1)
            if batch.dense is None:
                raise ValueError("weighted_bce needs dense one-hot type columns in the batch")
            tw = torch.tensor(train_cfg.loss_type_weights, dtype=logits.dtype,
                              device=logits.device)
            w = batch.dense[:, lo:hi].to(logits.dtype) @ tw
            total = w.float().sum()
            dist.all_reduce(total, group=mesh.data_group)
            per = losses_lib.bce_per_example(logits, batch.labels) * w
            loss = per.float().sum() / torch.clamp(total, min=1.0)
            return loss, loss.detach(), logits
        return loss_fn
    raise ValueError(f"unknown loss {train_cfg.loss!r}")


def _sync_tower_grads(params: list[torch.nn.Parameter], mesh: Mesh) -> None:
    """Sum the towers' gradients over data: one flat f32 buffer, in the
    parameters' order, one all-reduce."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.data_group)
    off = 0
    for p, g in zip(params, grads):
        n = g.numel()
        if p.grad is None:
            p.grad = g
        p.grad.copy_(flat[off:off + n].view_as(g))
        off += n


def make_sharded_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                            dense_opt: opt_lib.DenseOptimizer, mesh: Mesh,
                            plan: ShardingPlan) -> Callable:
    """The data-parallel train step `step(state, batch) -> (state, out)` on
    a sharded state (`shard_train_state`) and this rank's slice of a global
    batch: the one-device step's two-stage backward with the sharded
    lookups and updates. In place, as the one-device step. `out["loss"]` is
    the global batch's loss (on every rank), `out["logits"]` this rank's
    slice's."""
    sorted_table = _check_step_config(model_cfg, train_cfg, plan)
    loss_fn = _sharded_loss_fn(train_cfg, mesh)
    bs_kernel = train_cfg.block_sorted_kernel
    _, pooled_embeddings = make_sharded_forward(
        model_cfg, mesh, plan,
        block_sorted_feature=(train_cfg.sorted_feature
                              if bs_kernel != "off" and train_cfg.block_sorted_gather
                              else None),
        block_sorted_dtype=bs_kernel if bs_kernel != "off" else "float32")
    # per table or bucket: its sentinel key and the maker of its placement's update
    groups: dict[str, tuple[int, Callable]] = {}
    for fc in model_cfg.features:
        spec = plan[fc.table]
        if spec.strategy == TABLE_WISE:
            groups[spec.bucket] = (mesh.size * plan.buckets[spec.bucket].rows_per_device,
                                   make_sharded_update)
        elif spec.strategy == ROW_SHARDED:
            groups[fc.table] = (mesh.size * _shard_rows(plan, fc.table),
                                make_sorted_sharded_update if fc.table == sorted_table
                                else make_sharded_update)
        else:
            groups[fc.table] = (spec.num_embeddings, make_replicated_update)
    updates: dict[str, Callable] = {}  # per table or bucket, picked at its first batch

    def step(state: TrainState, batch: Batch):
        model = state.model
        b_glob = batch.batch_size * mesh.data
        with torch.no_grad():  # stage A
            pooled, weights = pooled_embeddings(model.tables, batch)
        pooled = {k: v.detach().requires_grad_(True) for k, v in pooled.items()}

        state.dense_opt_state.zero_grad(set_to_none=True)  # stage B
        q, c = towers_forward(model, pooled, batch.dense)
        loss, value, logits = loss_fn(q, c, batch, b_glob)
        loss.backward()
        params = tower_parameters(model)
        _sync_tower_grads(params, mesh)

        dense_opt.step(state.dense_opt_state, state.step, lr=state.device_lr)  # stage C
        with torch.no_grad():
            parts: dict[str, list] = {}
            for fc in model_cfg.features:
                feat = batch.features[fc.name]
                g = pooled[fc.name].grad
                if g is None:
                    g = torch.zeros_like(pooled[fc.name])
                spec = plan[fc.table]
                name = spec.bucket if spec.strategy == TABLE_WISE else fc.table
                ids = feat.ids + _bucket_base(plan, spec) if spec.strategy == TABLE_WISE \
                    else feat.ids
                keys = torch.where(feat.mask > 0, ids, groups[name][0]).to(torch.int32)
                parts.setdefault(name, []).append(
                    (keys, row_grads_from_pooled(g, feat.mask, fc.pooling)))
            for name, group in parts.items():
                keys = torch.cat([p[0] for p in group], dim=1) if len(group) > 1 else group[0][0]
                row_g = torch.cat([p[1] for p in group], dim=1) if len(group) > 1 \
                    else group[0][1]
                table, acc = model.tables[name], state.adagrad_acc[name]
                if name not in updates:
                    fn = pick_table_update_fn(
                        model_cfg, train_cfg, sorted_table, name, keys.numel() * mesh.data,
                        quantized=False, table_dtype=str(table.dtype).replace("torch.", ""),
                        num_rows=table.shape[0])
                    updates[name] = groups[name][1](mesh, fn)
                new_table, new_acc = updates[name](table, acc, keys, row_g,
                                                   train_cfg.sparse_learning_rate,
                                                   train_cfg.adagrad_eps)
                if new_table is not table or new_acc is not acc:
                    raise RuntimeError(f"the update of {name!r} replaced its tensors")
            total = value.clone()
            dist.all_reduce(total, group=mesh.data_group)
        state.step += 1
        return state, {"loss": total.to(logits.dtype), "logits": logits.detach()}

    return step


def make_sharded_multi_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                            dense_opt: opt_lib.DenseOptimizer, mesh: Mesh, plan: ShardingPlan,
                            pack_label: bool = True):
    """K sharded train steps over a stacked packed macro-batch in one call
    (`make_multi_step` over the sharded step and `unpack_batch`): on the card
    one CUDA graph of the K steps with their collectives captured. Place the
    macro payload with `macro_batch_sharding`."""
    core = make_sharded_train_step(model_cfg, train_cfg, dense_opt, mesh, plan)
    return make_multi_step(lambda s, pb: core(s, unpack_batch(pb, model_cfg,
                                                              pack_label=pack_label)))


def make_sharded_eval_step(model_cfg: ModelConfig, train_cfg: TrainConfig, mesh: Mesh,
                           plan: ShardingPlan) -> Callable:
    """`step(state, eval_state, batch) -> eval_state` on this rank's slice:
    the logits, labels and weights all-gathered over data, then the
    one-device eval step's BCE and AUROC on the global batch, so every rank
    holds the same metrics. A batch of padding alone still runs its
    collectives."""
    del train_cfg
    forward, _ = make_sharded_forward(model_cfg, mesh, plan)

    @torch.no_grad()
    def step(state: TrainState, eval_state: EvalState, batch: Batch) -> EvalState:
        q, c = forward(state, batch)
        logits = _all_gather(torch.sum(q * c, dim=1), mesh.data_group, mesh.data)
        labels = _all_gather(batch.labels, mesh.data_group, mesh.data)
        w = None if batch.weights is None else _all_gather(batch.weights.to(torch.float32),
                                                           mesh.data_group, mesh.data)
        if w is None:
            n = float(labels.shape[0])
            loss = losses_lib.bce_with_logits(logits, labels)
        else:
            n = w.sum()
            loss = losses_lib.bce_with_logits(logits, labels, w)
        return EvalState(auroc=auroc_update(eval_state.auroc, logits, labels, w),
                         loss=mean_update(eval_state.loss, loss, n))

    return step
