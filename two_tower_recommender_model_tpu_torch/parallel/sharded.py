"""Sharded tables and the data-parallel train step, on `torch.distributed`.

Port of `two_tower_recommender_model_tpu/parallel/sharded.py`. Tables are
row-sharded over the flat rank index of the mesh (`parallel/mesh.py`; each
row exists once globally), table-wise tables live in per-(dim, dtype)
buckets that row-shard the same way, column-sharded tables split their dim
over the ranks (every rank holds every row's slice, and the rows'
accumulator whole), small tables are replicated, and the dense towers are
replicated with data-parallel gradients. The dense exchange:

  forward   all_gather(ids, weights over data)       # B_glob x L
            partial pool from this rank's rows         # kernel #1 (#5 int8)
            reduce_scatter(partials over data)         # B_glob x D f32
            all_reduce(over model)                     # B_loc x D (model > 1)
  backward  all_reduce(tower gradients over data)     # one flat f32 buffer
            all_gather(ids, row gradients over data)  # B_glob x L x D
            row-wise Adagrad on this rank's rows only  # kernel #4 (#6 int8)

The all-to-all exchange (`sharded_exchange="alltoall"`) takes a row-sharded
float table the host does not sort: each id's row and gradient go straight
between the data rank of its example and the rank that owns it, through a
`[ranks, cap]` bucket of fixed capacity per (sender, owner) pair that holds
each distinct id once (`a2a_cap`, `a2a_route`); the distinct ids past the
capacity are dropped from the step and counted (`exchange_overflow`, a
device tensor the loops raise on):

  forward   route, all_to_all(ids) -> the owner's rows (#1 at one slot)
            -> all_to_all back -> each bag pooled from the answers (#1)
  backward  route, pre-aggregate by slot (#3), all_to_all(ids, gradients)
            -> the owner's update (#4 after the stable device sort)

As the reference routes them, the host-sorted table, table-wise buckets and
int8 tables keep the dense exchange whatever `sharded_exchange` says.

A rank's local work is a plain function of (its shard, the gathered or
received tensors, its shard index): `partial_pool`, `sorted_partial_rows`,
`shard_local_ids`, `a2a_route`, `a2a_send_grads`, `a2a_owner_rows`,
`a2a_pool` and the updates picked by `train.step.pick_table_update_fn`. The collectives wrap them, so one process
can run every shard's work in turn (`chip_smoke.py [shard-kernels]`).

Every row-wise update goes through kernel #4 (#6 for an int8 table:
`ops/quantized_kernel.py`), as the one-device step's: the host-sorted
table's shard passes its non-decreasing local ids straight in (ids below the
shard go negative, above it reach past its rows: both are sentinels), every
other table takes the stable device sort first, which keeps replicas bit for
bit in step. A column slice takes kernel #3 and the epilogue
(`train.optimizer.sparse_rowwise_adagrad_columns`). The fused tower forward
and backward run on each rank's slice of the batch. Each rank's BCE is its
sum over the global batch size, so the summed gradients are the global
batch's.

One host feeds a global batch (`batch_sharding`): the ranks of a data group
see its slices in order, so a batch sorted by the host-sorted feature stays
sorted after the all-gather. Across hosts each host's ranks cut its own
batch (`batch_sharding(mesh, hosts)`, `launch.put_global_batch`).

The sampled softmax runs each rank's `[B_local, B]` stripe of the score
matrix at `row_offset = d x B_local` through kernels #9-#11
(`models.losses.sharded_in_batch_sampled_softmax`): the candidates are
all-gathered, their gradient reduce-scattered back (`all_gather_rows`), the
count of positives summed; the replicated logQ counts take the global
batch's candidate ids. The compact wire decodes each rank's slice
(`sharded_compact_decoder`; the delta-encoded sorted slot through an
exclusive prefix over the data group), placed leaf by leaf
(`compact_shardings`). Retrieval scans a row-sharded corpus on every rank
and merges the ranks' candidates (`make_sharded_topk`).
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
from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import block_sorted_aggregate
from two_tower_recommender_model_tpu_torch.ops.embedding_ops import (
    _gather,
    block_sorted_lookup,
    row_grads_from_pooled,
)
from two_tower_recommender_model_tpu_torch.ops.quantized import QuantizedTable
from two_tower_recommender_model_tpu_torch.ops.topk import chunked_topk
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
    """Leaf -> this rank's slice of a host batch along `axis` (0 for a
    batch, 1 for a `[K, B, ...]` macro-batch, -1 for the compact wire's
    planes, whose batch axis is last; -2 for its dense features). The batch
    a rank holds is the global batch when one host feeds every rank
    (`hosts=1`), else its host's part (`--multi-host`: the data slices of a
    host's ranks, in order), cut in `pieces` equal slices of which this rank
    keeps the one its data coordinate owns. A macro leaf with fewer than two
    axes or an empty last axis (a packed label's placeholder) is kept whole,
    as the reference replicates it. `device` is the mesh's; `parts` is the
    data ranks, the factor from a slice's examples to the global batch's."""

    def __init__(self, mesh: Mesh, axis: int = 0, hosts: int = 1):
        if mesh.data % hosts:
            raise ValueError(f"{mesh.data} data ranks do not split over {hosts} hosts")
        self.mesh, self.axis, self.hosts = mesh, axis, hosts

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def parts(self) -> int:
        return self.mesh.data

    @property
    def pieces(self) -> int:
        """The slices of the batch this rank holds."""
        return self.mesh.data // self.hosts

    @property
    def index(self) -> int:
        """This rank's slice of the batch it holds."""
        return self.mesh.d % self.pieces

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.axis > 0 and (t.dim() <= self.axis or t.shape[-1] == 0):
            return t
        n = t.shape[self.axis]
        if n % self.pieces:
            raise ValueError(f"batch of {n} rows does not split over {self.pieces} data "
                             "ranks: pad it (pad_batch) or pick a multiple")
        part = n // self.pieces
        return t.narrow(self.axis, self.index * part, part).contiguous()


def batch_sharding(mesh: Mesh, hosts: int = 1) -> BatchSharding:
    """Leaf -> this rank's slice of the leading (batch) axis."""
    return BatchSharding(mesh, 0, hosts)


def macro_batch_sharding(mesh: Mesh, hosts: int = 1) -> BatchSharding:
    """Leaf -> this rank's slice of a stacked `[K, B, ...]` macro-batch's
    batch axis; the K axis whole."""
    return BatchSharding(mesh, 1, hosts)


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


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """`[n * cap, ...]`: block j of `t` goes to rank j, and block i of the
    result came from rank i (equal splits, so a CUDA graph can capture it)."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def _reduce_partials(part: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The partial pools [B_glob, D] of the ranks summed: this rank's
    [B_loc, D] slice over data, then over model."""
    out = _reduce_scatter(part, mesh.data_group, mesh.data)
    if mesh.model > 1:
        dist.all_reduce(out, group=mesh.model_group)
    return out


class _AllGatherRows(torch.autograd.Function):
    """`[n * B, ...]`: the group's tensors in rank order (all-gather); its
    gradient is the reduce-scatter of the incoming one: each rank's rows
    get the sum over the group of what every rank's loss sent them."""

    @staticmethod
    def forward(ctx, t, group, n):
        ctx.group, ctx.n = group, n
        return _all_gather(t, group, n)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.n), None, None


def all_gather_rows(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The differentiable all-gather along axis 0 (`_AllGatherRows`): as the
    reference's `all_gather` under `shard_map`, whose transpose is the
    `psum_scatter`. Both collectives run on the current stream, so a CUDA
    graph captures them."""
    return _AllGatherRows.apply(t, group, n)


# ---------------------------------------------------------------------------
# state placement


def _check_plan(plan: ShardingPlan, mesh: Mesh) -> None:
    if plan.num_devices != mesh.size:
        raise ValueError(f"plan for {plan.num_devices} devices on a {mesh.size}-rank mesh")


def _shard_rows(plan: ShardingPlan, name: str) -> int:
    """Rows of one rank's shard: the bucket's rows a device, the padded rows
    over the ranks for a row-sharded table, all of them otherwise."""
    if name in plan.buckets:
        return plan.buckets[name].rows_per_device
    spec = plan[name]
    return spec.padded_rows // plan.num_devices if spec.strategy == ROW_SHARDED \
        else spec.num_embeddings


def _tensors(t) -> tuple[torch.Tensor, ...]:
    """A float table as itself, an int8 table as (values, scales)."""
    return (t.values, t.scales) if isinstance(t, QuantizedTable) else (t,)


def _zero_rows(like, rows: int, device: torch.device):
    """A table of `rows` zero rows of `like`'s kind, width and dtype."""
    if isinstance(like, QuantizedTable):
        return QuantizedTable(torch.zeros((rows, like.shape[1]), dtype=torch.int8, device=device),
                              torch.zeros(rows, dtype=torch.float32, device=device))
    return torch.zeros((rows, like.shape[1]), dtype=like.dtype, device=device)


def _put_rows(dst, at: int, src, lo: int = 0, hi: int | None = None) -> None:
    """`src`'s rows [lo, hi) into `dst` from row `at`."""
    for d, s in zip(_tensors(dst), _tensors(src)):
        part = s[lo:hi]
        d[at:at + part.shape[0]] = part.to(d.device)


def _copy_table(t, device: torch.device):
    if isinstance(t, QuantizedTable):
        return QuantizedTable(t.values.to(device, copy=True).contiguous(),
                              t.scales.to(device, copy=True).contiguous())
    return t.to(device, copy=True).contiguous()


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
    are gone from the state), a column-sharded table's columns `[r * C,
    (r + 1) * C)` of its dim padded to `padded_dim` with its accumulator
    whole, replicated tables whole; f32, bf16 or int8 (values and scales cut
    alike). The towers, their optimizer's state and the step are copied."""
    _check_plan(plan, mesh)
    dev, r = mesh.device, mesh.rank
    tables, accs = {}, {}
    for bname, b in plan.buckets.items():
        members = [state.model.tables[t] for t in b.tables]
        quantized = isinstance(members[0], QuantizedTable)
        if any(isinstance(t, QuantizedTable) != quantized for t in members):
            raise ValueError(f"bucket {bname} mixes quantized and float tables")
        big = _zero_rows(members[0], b.rows_per_device, dev)
        big_acc = torch.zeros(b.rows_per_device, dtype=torch.float32, device=dev)
        for tname in b.tables:
            spec = plan[tname]
            if spec.owner != r:
                continue
            t, a = state.model.tables[tname], state.adagrad_acc[tname]
            if t.dtype != big.dtype:
                raise ValueError(f"bucket {bname} mixes {t.dtype} and {big.dtype} tables")
            _put_rows(big, spec.bucket_offset, t)
            big_acc[spec.bucket_offset:spec.bucket_offset + t.shape[0]] = a.to(dev)
        tables[bname], accs[bname] = big, big_acc
    for name, spec in plan.specs.items():
        if spec.strategy == TABLE_WISE:
            continue  # lives inside its bucket
        t, a = state.model.tables[name], state.adagrad_acc[name]
        if isinstance(t, QuantizedTable) and spec.strategy == COLUMN_SHARDED:
            raise NotImplementedError(
                f"int8 table {name!r}: per-row scales do not split by columns; "
                "use row_sharded or replicated")
        if spec.strategy == ROW_SHARDED:
            rows = _shard_rows(plan, name)
            lo, hi = r * rows, min((r + 1) * rows, spec.num_embeddings)
            shard = _zero_rows(t, rows, dev)
            acc = torch.zeros(rows, dtype=torch.float32, device=dev)
            if hi > lo:
                _put_rows(shard, 0, t, lo, hi)
                acc[:hi - lo] = a[lo:hi].to(dev)
            tables[name], accs[name] = shard, acc
        elif spec.strategy == COLUMN_SHARDED:
            cols = spec.padded_dim // plan.num_devices
            lo, hi = r * cols, min((r + 1) * cols, spec.embedding_dim)
            shard = torch.zeros((spec.num_embeddings, cols), dtype=t.dtype, device=dev)
            if hi > lo:
                shard[:, :hi - lo] = t[:, lo:hi].to(dev)
            tables[name], accs[name] = shard, a.to(dev, copy=True)
        else:
            tables[name], accs[name] = _copy_table(t, dev), a.to(dev, copy=True)
    model = _sharded_model(state.model.cfg, state.model, tables, dev)
    opt = opt_lib.clone_dense_optimizer(state.dense_opt_state, tower_parameters(model))
    return TrainState(step=state.step, model=model, adagrad_acc=accs, dense_opt_state=opt,
                      item_counts=None if state.item_counts is None
                      else state.item_counts.to(dev, copy=True))


def _gather_parts(t: torch.Tensor, mesh: Mesh, dst: int | None, dim: int = 0):
    """The ranks' shards joined in flat rank order along `dim`: on every
    rank (`dst=None`) or on rank `dst` (None elsewhere)."""
    t = t.contiguous()
    if dst is None and dim == 0:
        return _all_gather(t, mesh.group, mesh.size)
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    if dst is None:
        dist.all_gather(parts, t, group=mesh.group)
    else:
        dist.gather(t, gather_list=parts if mesh.rank == dst else None, dst=dst,
                    group=mesh.group)
        if mesh.rank != dst:
            return None
    return torch.cat(parts, dim=dim)


def _gather_table(t, mesh: Mesh, dst: int | None, dim: int = 0):
    parts = [_gather_parts(x, mesh, dst, dim) for x in _tensors(t)]
    if parts[0] is None:
        return None
    return QuantizedTable(*parts) if isinstance(t, QuantizedTable) else parts[0]


def _table_rows(t, lo: int, hi: int):
    if isinstance(t, QuantizedTable):
        return QuantizedTable(t.values[lo:hi], t.scales[lo:hi])
    return t[lo:hi]


@torch.no_grad()
def unshard_train_state(state: TrainState, plan: ShardingPlan, model_cfg: ModelConfig,
                        mesh: Mesh, dst: int | None = 0,
                        device: torch.device | str | None = None) -> TrainState | None:
    """The whole one-device state gathered from the ranks' parts: on rank
    `dst` (None on the others, which take part), or on every rank with
    `dst=None`; on `device` (the mesh's when None). Row padding is stripped,
    table-wise tables are cut back out of their buckets, a column-sharded
    table's columns are joined and its dim padding cut; towers, optimizer
    state and step come from this rank's copy."""
    device = mesh.device if device is None else torch.device(device)
    gathered = {}
    for name in [*plan.buckets, *plan.specs]:
        spec = plan.specs.get(name)
        if spec is not None and spec.strategy not in (ROW_SHARDED, COLUMN_SHARDED):
            continue
        if spec is not None and spec.strategy == COLUMN_SHARDED:
            gathered[name] = (_gather_table(state.model.tables[name], mesh, dst, dim=1),
                              state.adagrad_acc[name])
        else:
            gathered[name] = (_gather_table(state.model.tables[name], mesh, dst),
                              _gather_parts(state.adagrad_acc[name], mesh, dst))
    if dst is not None and mesh.rank != dst:
        return None
    tables, accs = {}, {}
    for name, spec in plan.specs.items():
        n = spec.num_embeddings
        if spec.strategy == TABLE_WISE:
            start = spec.owner * plan.buckets[spec.bucket].rows_per_device + spec.bucket_offset
            t, a = gathered[spec.bucket]
            t, a = _table_rows(t, start, start + n), a[start:start + n]
        elif spec.strategy == ROW_SHARDED:
            t, a = gathered[name]
            t, a = _table_rows(t, 0, n), a[:n]
        elif spec.strategy == COLUMN_SHARDED:
            t, a = gathered[name]
            t = t[:, :spec.embedding_dim]
        else:
            t, a = state.model.tables[name], state.adagrad_acc[name]
        tables[name] = _copy_table(t, device)
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


def partial_pool(shard, ids_all: torch.Tensor, w_all: torch.Tensor,
                 shard_index: int) -> torch.Tensor:
    """[B_glob, D] f32: each bag's weighted sum over the slots this shard
    owns (the reference's `_local_partial_pool`, and for an int8 shard
    `make_quantized_sharded_lookup`'s); slots outside the shard take weight
    0. One launch of kernel #1 (#5 for an int8 shard)."""
    local = shard_local_ids(ids_all, shard_index, shard.shape[0])
    w = torch.where(local < shard.shape[0], w_all, 0.0)
    return _gather(shard, local, w, torch.float32)


def sorted_partial_rows(shard, keys_all: torch.Tensor, w_all: torch.Tensor,
                        shard_index: int, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """[M, D]: `w * shard[key - shard_index * rows]` for the host-sorted
    single-slot feature's gathered keys (dead slots keyed past every shard),
    zero rows for the keys outside the shard, which go negative below it and
    past its rows above it: kernel #1 (#5 for an int8 shard, f32 out when
    `out_dtype` is None) through the sorted lookup's call site."""
    local = (keys_all.reshape(-1) - shard_index * shard.shape[0]).to(torch.int32)
    return block_sorted_lookup(shard, local, w_all.reshape(-1), out_dtype=out_dtype)


def a2a_cap(m: int, ndev: int, capacity_factor: float, rows: int) -> int:
    """The all-to-all bucket's capacity in distinct ids: `int(m *
    capacity_factor) // ndev` (at least 1), at most the owner's `rows` (a
    sender cannot name more distinct rows of a shard than it holds, so where
    that bound binds nothing can overflow), rounded up to a multiple of 8.
    The reference's rule as its code computes it (`sharded.py:_a2a_cap`)."""
    cap = max(int(m * capacity_factor) // ndev, 1)
    cap = min(cap, rows)
    return -(-cap // 8) * 8


def a2a_responsible(flat_ids: torch.Tensor, rows: int, ndev: int, model: int,
                    model_index: int) -> torch.Tensor:
    """[M] bool: the ids this rank routes. The `model` ranks of a data slice
    hold the same batch, so the one whose model coordinate is the owner's
    flat index modulo `model` routes it: each id once globally."""
    owner = torch.clamp(torch.div(flat_ids, rows, rounding_mode="floor"), 0, ndev - 1)
    return (owner % model) == model_index


def a2a_route(flat_ids: torch.Tensor, w_flat: torch.Tensor, rows: int, ndev: int, cap: int,
              responsible: torch.Tensor):
    """The deduplicated bucket slots of the all-to-all exchange (the
    reference's `_a2a_route`): each distinct id takes ONE slot of its
    owner's bucket, however many positions repeat it. Returns (slot [M]
    int32 in [0, ndev * cap], where ndev * cap is the dump slot of the ids
    that do not route; ok [M] bool; overflow, the 0-dim count of DISTINCT ids
    past the capacity). The ids sorted (stably), each one's unique rank
    within its owner's group, slot = owner * cap + rank."""
    m = flat_ids.shape[0]
    ok = (w_flat != 0) & responsible
    key = torch.where(ok, flat_ids, ndev * rows).to(torch.int32)
    skey, pos = torch.sort(key, stable=True)
    owner = torch.clamp(torch.div(skey, rows, rounding_mode="floor"), max=ndev)
    is_new = torch.ones(m, dtype=torch.int32, device=flat_ids.device)
    is_new[1:] = (skey[1:] != skey[:-1]).to(torch.int32)
    urank = torch.cumsum(is_new, 0) - 1
    first = torch.searchsorted(owner, owner, side="left")
    rank = urank - urank[first]
    fits = (owner < ndev) & (rank < cap)
    slot_sorted = torch.where(fits, owner * cap + rank, ndev * cap).to(torch.int32)
    slot = torch.zeros(m, dtype=torch.int32, device=flat_ids.device).scatter_(0, pos,
                                                                              slot_sorted)
    overflow = torch.sum(is_new * ((owner < ndev) & (rank >= cap)).to(torch.int32))
    return slot, ok, overflow


def a2a_send_ids(flat_ids: torch.Tensor, slot: torch.Tensor, ok: torch.Tensor, n_slots: int,
                 sentinel: int) -> torch.Tensor:
    """[n_slots] int32: each routed id at its slot, the sentinel in the
    empty ones."""
    send = torch.full((n_slots + 1,), sentinel, dtype=torch.int32, device=flat_ids.device)
    send.scatter_(0, slot.long(), torch.where(ok, flat_ids, sentinel).to(torch.int32))
    return send[:n_slots]


def a2a_send_grads(slot: torch.Tensor, ok: torch.Tensor, g_flat: torch.Tensor,
                   n_slots: int) -> torch.Tensor:
    """[n_slots, D] f32: the gradients of each slot's positions summed, in
    position order (the reference's `send_g.at[slot].add`): kernel #3 on the
    stably sorted slots with the sort's permutation. The positions that do
    not route land in the dump slot, which is cut off."""
    slot = torch.where(ok, slot, n_slots).to(torch.int32)
    sslot, perm = torch.sort(slot, stable=True)
    agg = block_sorted_aggregate(n_slots + 1, sslot.contiguous(), g_flat.contiguous(),
                                 perm=perm.to(torch.int32))
    return agg[:n_slots]


def a2a_owner_rows(shard: torch.Tensor, recv_ids: torch.Tensor, shard_index: int,
                   wire_dtype: torch.dtype) -> torch.Tensor:
    """[n_slots, D] in the wire dtype: the owner's row of each received id,
    a zero row for an empty slot: kernel #1 at one slot, weight 1, through
    the sorted lookup's call site (an id outside the shard is dead there)."""
    local = (recv_ids - shard_index * shard.shape[0]).to(torch.int32)
    ones = torch.ones(local.shape, dtype=torch.float32, device=local.device)
    return block_sorted_lookup(shard, local, ones, out_dtype=wire_dtype)


def a2a_pool(resp: torch.Tensor, slot: torch.Tensor, ok: torch.Tensor, w_flat: torch.Tensor,
             b: int, slots: int) -> torch.Tensor:
    """[B, D] f32: each position reads its slot's row of the answers (in the
    wire dtype), weighted by `w` where it routed (a position that did not
    route reads nothing: the reference's dump slot, a zero row), pooled over
    the bag in f32: one launch of kernel #1 on the answers as a table."""
    ids = torch.where(ok, slot, resp.shape[0]).reshape(b, slots)
    w = torch.where(ok, w_flat, 0.0).reshape(b, slots)
    return _gather(resp, ids, w, torch.float32)


# ---------------------------------------------------------------------------
# lookups


def make_sharded_lookup(mesh: Mesh) -> Callable:
    """`lookup(shard, ids [B_loc, L], w [B_loc, L]) -> [B_loc, D]` f32: the
    weighted-sum pool of a row-sharded table (or bucket), f32 or int8."""

    def lookup(shard, ids, w):
        ids_all = _all_gather(ids.to(torch.int32), mesh.data_group, mesh.data)
        w_all = _all_gather(w.to(torch.float32), mesh.data_group, mesh.data)
        return _reduce_partials(partial_pool(shard, ids_all, w_all, mesh.rank), mesh)

    return lookup


def make_sorted_sharded_lookup(mesh: Mesh) -> Callable:
    """`lookup(shard, ids [B_loc, 1], w [B_loc, 1], out_dtype) -> [B_loc, D]`
    for the host-sorted feature's row-sharded table (f32 or int8): after the
    all-gather the keys are non-decreasing, and each shard's rows come from
    kernel #1 (#5) at one slot (`sorted_partial_rows`). One shard owns each
    row, so the sum of the partials is exact, in `out_dtype` too."""

    def lookup(shard, ids, w, out_dtype=None):
        ids_all = _all_gather(ids.to(torch.int32), mesh.data_group, mesh.data)
        w_all = _all_gather(w.to(torch.float32), mesh.data_group, mesh.data)
        key = torch.where(w_all != 0, ids_all, mesh.size * shard.shape[0])
        return _reduce_partials(sorted_partial_rows(shard, key, w_all, mesh.rank, out_dtype),
                                mesh)

    return lookup


def make_column_lookup(mesh: Mesh) -> Callable:
    """`lookup(cols [N, D_pad / W], ids [B_loc, L], w) -> [B_loc, D_pad]` f32
    for a column-sharded table: the ids and weights all-gathered over data,
    this rank's column slice pooled for the global batch (kernel #1), the
    slices all-gathered over the mesh and joined in column order, and this
    rank's data rows kept."""

    def lookup(cols, ids, w):
        ids_all = _all_gather(ids.to(torch.int32), mesh.data_group, mesh.data)
        w_all = _all_gather(w.to(torch.float32), mesh.data_group, mesh.data)
        part = _gather(cols, ids_all, w_all, torch.float32)  # [B_glob, D_loc]
        b_glob, d_loc = part.shape
        b_loc = b_glob // mesh.data
        full = _all_gather(part, mesh.group, mesh.size).view(mesh.size, b_glob, d_loc)
        mine = full[:, mesh.d * b_loc:(mesh.d + 1) * b_loc]
        return mine.permute(1, 0, 2).reshape(b_loc, mesh.size * d_loc)

    return lookup


def _a2a_setup(mesh: Mesh, ids: torch.Tensor, w: torch.Tensor, rows: int,
               capacity_factor: float):
    """(flat ids, flat weights, cap, slot, ok, overflow) of this rank's
    batch slice for the all-to-all exchange."""
    m = ids.numel()
    cap = a2a_cap(m, mesh.size, capacity_factor, rows)
    flat_ids = ids.reshape(m).to(torch.int32)
    w_flat = w.reshape(m).to(torch.float32)
    responsible = a2a_responsible(flat_ids, rows, mesh.size, mesh.model,
                                  mesh.rank % mesh.model)
    slot, ok, overflow = a2a_route(flat_ids, w_flat, rows, mesh.size, cap, responsible)
    return flat_ids, w_flat, cap, slot, ok, overflow


def make_alltoall_lookup(mesh: Mesh, capacity_factor: float = 1.25,
                         wire_dtype: str = "float32") -> Callable:
    """`lookup(shard, ids [B_loc, L], w) -> (pooled [B_loc, D] f32, overflow)`
    over a row-sharded float table by the all-to-all exchange: the routed
    ids go to their owners, each owner answers with its rows (#1 at one
    slot, in the wire dtype: `"bfloat16"` rounds a row once on the wire),
    the answers come back and each bag pools its slots' rows in f32 (#1).
    Over the model group the pools are summed. `overflow` is the distinct
    ids dropped, summed over the mesh."""
    wire = torch_dtype(wire_dtype)

    def lookup(shard, ids, w):
        rows = shard.shape[0]
        b, slots = ids.shape
        flat_ids, w_flat, cap, slot, ok, overflow = _a2a_setup(mesh, ids, w, rows,
                                                               capacity_factor)
        send = a2a_send_ids(flat_ids, slot, ok, mesh.size * cap, mesh.size * rows)
        recv = _all_to_all(send, mesh.group)
        resp = _all_to_all(a2a_owner_rows(shard, recv, mesh.rank, wire), mesh.group)
        pooled = a2a_pool(resp, slot, ok, w_flat, b, slots)
        if mesh.model > 1:
            dist.all_reduce(pooled, group=mesh.model_group)
        dist.all_reduce(overflow, group=mesh.group)
        return pooled, overflow

    return lookup


# ---------------------------------------------------------------------------
# updates


def make_sharded_update(mesh: Mesh, update_fn: Callable) -> Callable:
    """`update(shard, acc, keys [B_loc, L], row_g [B_loc, L, D], lr, eps)`
    on a row-sharded table or a bucket, f32 or int8 (dead slots keyed past
    every shard): the keys and gradients all-gathered over data, then
    `update_fn` on this shard's local ids (`shard_local_ids`: kernel #4, #6
    for int8, after the stable device sort). Every row is updated once
    globally, by its owner."""

    def update(shard, acc, keys, row_g, lr, eps):
        keys_all = _all_gather(keys, mesh.data_group, mesh.data).reshape(-1)
        g_all = _all_gather(row_g, mesh.data_group, mesh.data)
        return update_fn(shard, acc, shard_local_ids(keys_all, mesh.rank, shard.shape[0]),
                         g_all.reshape(-1, g_all.shape[-1]), lr, eps)

    return update


def make_sorted_sharded_update(mesh: Mesh, update_fn: Callable) -> Callable:
    """The host-sorted feature's row-sharded table (f32 or int8): the
    gathered keys minus the shard base stay non-decreasing, so `update_fn`
    (kernel #4 or #6 behind the sortedness assert, with the bf16 buffer where
    the reference takes it) takes them straight, negative and past-the-shard
    ids as sentinels."""

    def update(shard, acc, keys, row_g, lr, eps):
        keys_all = _all_gather(keys, mesh.data_group, mesh.data).reshape(-1)
        g_all = _all_gather(row_g, mesh.data_group, mesh.data)
        local = (keys_all - mesh.rank * shard.shape[0]).to(torch.int32)
        return update_fn(shard, acc, local, g_all.reshape(-1, g_all.shape[-1]), lr, eps)

    return update


def make_replicated_update(mesh: Mesh, update_fn: Callable) -> Callable:
    """A replicated table (f32, bf16 or int8), as DDP does it: the batch's
    keys (dead slots keyed N) and gradients all-gathered over data, then the
    same deterministic update on every rank: `update_fn` is kernel #4 (#6)
    after the stable device sort, or for the host-sorted feature's table
    straight (`make_replicated_sorted_update`), so replicas stay bit for bit
    equal."""

    def update(table, acc, keys, row_g, lr, eps):
        keys_all = _all_gather(keys, mesh.data_group, mesh.data).reshape(-1)
        g_all = _all_gather(row_g, mesh.data_group, mesh.data)
        return update_fn(table, acc, keys_all.to(torch.int32), g_all.reshape(-1, g_all.shape[-1]),
                         lr, eps)

    return update


make_replicated_sorted_update = make_replicated_update


def make_column_update(mesh: Mesh, full_dim: int) -> Callable:
    """`update(cols, acc, keys [B_loc, L], row_g [B_loc, L, D_pad], lr, eps)`
    on a column-sharded table: the keys and gradients all-gathered over
    data, this rank's columns of the gradients, then
    `sparse_rowwise_adagrad_columns` (kernel #3 and the epilogue, the rows'
    squared gradients all-reduced over the mesh and divided by `full_dim`,
    the unpadded dim). Every rank updates the same accumulator."""

    def update(cols, acc, keys, row_g, lr, eps):
        keys_all = _all_gather(keys, mesh.data_group, mesh.data).reshape(-1)
        g_all = _all_gather(row_g, mesh.data_group, mesh.data)
        d_loc = cols.shape[1]
        g_cols = g_all[..., mesh.rank * d_loc:(mesh.rank + 1) * d_loc].reshape(-1, d_loc)
        return opt_lib.sparse_rowwise_adagrad_columns(cols, acc, keys_all, g_cols, lr, eps,
                                                      full_dim, psum_group=mesh.group)

    return update


def make_alltoall_update(mesh: Mesh, update_fn: Callable, capacity_factor: float = 1.25,
                         wire_dtype: str = "float32") -> Callable:
    """`update(shard, acc, keys [B_loc, L], row_g [B_loc, L, D], lr, eps) ->
    (shard, acc, overflow)` on a row-sharded float table by the all-to-all
    exchange (dead slots keyed past every shard): this rank's slice routed
    as the lookup routes it, each slot's gradients pre-aggregated in f32
    (#3), the ids and the gradients (in the wire dtype) sent to their
    owners, and each owner's `update_fn` (kernel #4 after the stable device
    sort) on the received ids, an empty slot's as the sentinel. `overflow`
    is summed over the mesh."""
    wire = torch_dtype(wire_dtype)

    def update(shard, acc, keys, row_g, lr, eps):
        rows = shard.shape[0]
        sentinel = mesh.size * rows
        live = (keys != sentinel).to(torch.float32)
        flat_ids, _, cap, slot, ok, overflow = _a2a_setup(mesh, keys, live, rows,
                                                          capacity_factor)
        n_slots = mesh.size * cap
        send_ids = a2a_send_ids(flat_ids, slot, ok, n_slots, sentinel)
        send_g = a2a_send_grads(slot, ok, row_g.reshape(flat_ids.shape[0], -1), n_slots)
        recv_ids = _all_to_all(send_ids, mesh.group)
        recv_g = _all_to_all(send_g.to(wire), mesh.group).to(torch.float32)
        update_fn(shard, acc, shard_local_ids(recv_ids, mesh.rank, rows), recv_g, lr, eps)
        dist.all_reduce(overflow, group=mesh.group)
        return shard, acc, overflow

    return update


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
    """The reference's checks of the sharded step (`sharded.py:983-1004`);
    returns the host-sorted table's name."""
    _check_train_config(model_cfg, train_cfg)
    if train_cfg.sharded_exchange not in ("dense", "alltoall"):
        raise ValueError(f"sharded_exchange must be dense|alltoall, got "
                         f"{train_cfg.sharded_exchange!r}")
    if train_cfg.exchange_wire_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"exchange_wire_dtype must be float32|bfloat16, got "
                         f"{train_cfg.exchange_wire_dtype!r}")
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


def alltoall_tables(model_cfg: ModelConfig, train_cfg: TrainConfig, plan: ShardingPlan,
                     sorted_table: str | None) -> set[str]:
    """The tables the all-to-all exchange takes (the reference's routing,
    `sharded.py:921-930`, `:1135-1142`): row-sharded float tables other than
    the host-sorted one; none under the dense exchange."""
    if train_cfg.sharded_exchange != "alltoall":
        return set()
    return {t.name for t in model_cfg.tables
            if plan[t.name].strategy == ROW_SHARDED and t.name != sorted_table
            and model_cfg.table_dtype_of(t.name) != "int8"}


def make_sharded_forward(model_cfg: ModelConfig, mesh: Mesh, plan: ShardingPlan,
                         block_sorted_feature: str | None = None,
                         block_sorted_dtype: str = "float32",
                         train_cfg: TrainConfig | None = None):
    """(forward(state, batch) -> (q, c, overflow), pooled_embeddings(tables,
    batch) -> (pooled, weights, overflow)): the towers on this rank's slice,
    each feature pooled by its table's placement. `block_sorted_feature`
    takes the sorted lookup, its rows rounded to bf16 under
    `block_sorted_dtype="bfloat16"` as the one-device step's are. The pooled
    outputs are in the compute dtype when it differs from the tables'
    (`models/two_tower.py`). `train_cfg` picks the exchange: `overflow` is
    the all-to-all exchange's dropped-id count summed over its tables' lookups
    (None when no table takes it)."""
    lookup = make_sharded_lookup(mesh)
    sorted_lookup = make_sorted_sharded_lookup(mesh)
    column_lookup = make_column_lookup(mesh)
    train_cfg = train_cfg or TrainConfig()
    a2a = alltoall_tables(model_cfg, train_cfg, plan,
                           validate_sorted_feature(model_cfg, train_cfg))
    a2a_lookup = make_alltoall_lookup(mesh, train_cfg.exchange_capacity_factor,
                                      train_cfg.exchange_wire_dtype)
    compute = (torch_dtype(model_cfg.compute_dtype)
               if model_cfg.compute_dtype != model_cfg.resolved_table_dtype else None)

    def pooled_embeddings(tables, batch: Batch):
        pooled, weights, overflow = {}, {}, None
        for fc in model_cfg.features:
            feat = batch.features[fc.name]
            w = _pool_weights(fc, feat.mask)
            weights[fc.name] = w
            spec = plan[fc.table]
            table = tables[spec.bucket if spec.strategy == TABLE_WISE else fc.table]
            quantized = isinstance(table, QuantizedTable)
            if spec.strategy == TABLE_WISE:
                out = lookup(table, feat.ids + _bucket_base(plan, spec), w)
            elif spec.strategy == ROW_SHARDED and fc.name == block_sorted_feature:
                rows_dtype = compute
                if block_sorted_dtype == "bfloat16" and not quantized:
                    rows_dtype = torch.bfloat16
                out = sorted_lookup(table, feat.ids, w, rows_dtype)
            elif spec.strategy == ROW_SHARDED and fc.table in a2a:
                out, ovf = a2a_lookup(table, feat.ids, w)
                overflow = ovf if overflow is None else overflow + ovf
            elif spec.strategy == ROW_SHARDED:
                out = lookup(table, feat.ids, w)
            elif spec.strategy == COLUMN_SHARDED:
                out = column_lookup(table, feat.ids, w)[:, :spec.embedding_dim]
            else:
                out = _gather(table, feat.ids, w, torch.float32)
            pooled[fc.name] = out.to(compute or (torch.float32 if quantized else table.dtype))
        return pooled, weights, overflow

    def forward(state: TrainState, batch: Batch):
        pooled, _, overflow = pooled_embeddings(state.model.tables, batch)
        q, c = towers_forward(state.model, pooled, batch.dense)
        return q, c, overflow

    return forward, pooled_embeddings


def _sharded_loss_fn(model_cfg: ModelConfig, train_cfg: TrainConfig, mesh: Mesh) -> Callable:
    """`loss_fn(q, c, batch, b_glob, log_q=None) -> (local loss, its value,
    logits)`: this rank's part of the global batch's loss (its sum over the
    global batch size, or over the global weight, or for the sampled softmax
    its stripe's sum over the global count of label-1 rows, in f32), whose
    gradients summed over data are the global batch's; and the part of the
    reported loss, which on one rank is the one-device step's value bit for
    bit (the BCE's mean in the logits' dtype)."""
    if train_cfg.loss == "sampled_softmax":
        softmax = losses_lib.loss_fn_from_config(train_cfg, model_cfg, sharded=True, mesh=mesh)

        def loss_fn(q, c, batch, b_glob, log_q=None):
            loss, logits = softmax(q, c, batch, log_q=log_q)
            return loss, loss.detach(), logits
        return loss_fn
    if train_cfg.loss == "bce":
        def loss_fn(q, c, batch, b_glob, log_q=None):
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

        def loss_fn(q, c, batch, b_glob, log_q=None):
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
    slice's, and under the all-to-all exchange `out["exchange_overflow"]`
    the distinct ids its forward and backward dropped past the capacity,
    summed over the mesh (a device tensor: nothing here reads it)."""
    sorted_table = _check_step_config(model_cfg, train_cfg, plan)
    loss_fn = _sharded_loss_fn(model_cfg, train_cfg, mesh)
    cand_feature = model_cfg.candidate_tower.features[0]
    bs_kernel = train_cfg.block_sorted_kernel
    _, pooled_embeddings = make_sharded_forward(
        model_cfg, mesh, plan,
        block_sorted_feature=(train_cfg.sorted_feature
                              if bs_kernel != "off" and train_cfg.block_sorted_gather
                              else None),
        block_sorted_dtype=bs_kernel if bs_kernel != "off" else "float32",
        train_cfg=train_cfg)
    a2a = alltoall_tables(model_cfg, train_cfg, plan, sorted_table)

    def a2a_update(mesh, fn):
        return make_alltoall_update(mesh, fn, train_cfg.exchange_capacity_factor,
                                    train_cfg.exchange_wire_dtype)

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
                                else a2a_update if fc.table in a2a else make_sharded_update)
        elif spec.strategy == COLUMN_SHARDED:
            groups[fc.table] = (spec.num_embeddings,
                                lambda mesh, fn, d=spec.embedding_dim: make_column_update(mesh, d))
        else:
            groups[fc.table] = (spec.num_embeddings, make_replicated_update)
    updates: dict[str, Callable] = {}  # per table or bucket, picked at its first batch

    def step(state: TrainState, batch: Batch):
        model = state.model
        b_glob = batch.batch_size * mesh.data
        with torch.no_grad():  # stage A
            pooled, weights, overflow = pooled_embeddings(model.tables, batch)
            # streaming logQ: the replicated counts take the GLOBAL batch's candidate
            # ids (gathered over data), so every rank's counts stay the one-device
            # step's; then each row's logQ from the new counts
            log_q = None
            if state.item_counts is not None:
                cand_ids = batch.features[cand_feature].ids[:, 0]
                cand_all = _all_gather(cand_ids.to(torch.int32), mesh.data_group,
                                       mesh.data).long()
                state.item_counts.index_add_(
                    0, cand_all, torch.ones(cand_all.shape, dtype=torch.float32,
                                            device=cand_all.device))
                log_q = losses_lib.item_log_q_from_counts(state.item_counts, cand_ids)
        pooled = {k: v.detach().requires_grad_(True) for k, v in pooled.items()}

        state.dense_opt_state.zero_grad(set_to_none=True)  # stage B
        q, c = towers_forward(model, pooled, batch.dense)
        loss, value, logits = loss_fn(q, c, batch, b_glob, log_q)
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
                row_g = row_grads_from_pooled(g, feat.mask, fc.pooling)
                if spec.strategy == COLUMN_SHARDED and spec.padded_dim > spec.embedding_dim:
                    row_g = torch.nn.functional.pad(
                        row_g, (0, spec.padded_dim - spec.embedding_dim))
                parts.setdefault(name, []).append((keys, row_g))
            for name, group in parts.items():
                keys = torch.cat([p[0] for p in group], dim=1) if len(group) > 1 else group[0][0]
                row_g = torch.cat([p[1] for p in group], dim=1) if len(group) > 1 \
                    else group[0][1]
                table, acc = model.tables[name], state.adagrad_acc[name]
                if name not in updates:
                    fn = pick_table_update_fn(
                        model_cfg, train_cfg, sorted_table, name, keys.numel() * mesh.data,
                        quantized=isinstance(table, QuantizedTable),
                        table_dtype=str(table.dtype).replace("torch.", ""),
                        num_rows=table.shape[0])
                    updates[name] = groups[name][1](mesh, fn)
                new = updates[name](table, acc, keys, row_g, train_cfg.sparse_learning_rate,
                                    train_cfg.adagrad_eps)
                if name in a2a:
                    overflow = new[2] if overflow is None else overflow + new[2]
                if new[0] is not table or new[1] is not acc:
                    raise RuntimeError(f"the update of {name!r} replaced its tensors")
            total = value.clone()
            dist.all_reduce(total, group=mesh.data_group)
        state.step += 1
        # the softmax's loss is f32 as the one-device step's; the BCEs' in the logits' dtype
        out = {"loss": total if train_cfg.loss == "sampled_softmax" else total.to(logits.dtype),
               "logits": logits.detach()}
        if overflow is not None:
            # nonzero: ids were dropped this step; raise exchange_capacity_factor
            out["exchange_overflow"] = overflow
        return state, out

    return step


def make_sharded_multi_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                            dense_opt: opt_lib.DenseOptimizer, mesh: Mesh, plan: ShardingPlan,
                            pack_label: bool = True):
    """K sharded train steps over a stacked packed macro-batch in one call
    (`make_multi_step` over the sharded step and `unpack_batch`): on the card
    one CUDA graph of the K steps with their collectives captured. Place the
    macro payload with `macro_batch_sharding`. Under the all-to-all exchange
    the result carries the K steps' `exchange_overflow` summed."""
    core = make_sharded_train_step(model_cfg, train_cfg, dense_opt, mesh, plan)
    return make_multi_step(lambda s, pb: core(s, unpack_batch(pb, model_cfg,
                                                              pack_label=pack_label)))


def make_sharded_eval_step(model_cfg: ModelConfig, train_cfg: TrainConfig, mesh: Mesh,
                           plan: ShardingPlan) -> Callable:
    """`step(state, eval_state, batch) -> eval_state` on this rank's slice:
    the logits, labels and weights all-gathered over data, then the
    one-device eval step's BCE and AUROC on the global batch, so every rank
    holds the same metrics; the all-to-all exchange's overflow counts added
    into `eval_state.exchange_overflow`. A batch of padding alone still runs
    its collectives."""
    forward, _ = make_sharded_forward(model_cfg, mesh, plan, train_cfg=train_cfg)

    @torch.no_grad()
    def step(state: TrainState, eval_state: EvalState, batch: Batch) -> EvalState:
        q, c, overflow = forward(state, batch)
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
        total = eval_state.exchange_overflow
        if overflow is not None:
            total = overflow if total is None else total + overflow
        return EvalState(auroc=auroc_update(eval_state.auroc, logits, labels, w),
                         loss=mean_update(eval_state.loss, loss, n), exchange_overflow=total)

    return step


# ---------------------------------------------------------------------------
# the compact wire on a mesh


def compact_shardings(mesh: Mesh, scheme=None, batch_size: int | None = None,
                      hosts: int = 1):
    """The per-leaf placement of a `CompactBatch`, one batch or a stacked
    `[K, ...]` macro-batch alike: a `CompactBatch` of slicers, `wire`,
    `rem`, `labels` and `weights` cut on their last (batch, batch-group)
    axis, `dense` on its batch axis, the delta sidecars kept whole (the
    segment's positions: `batch_from_compact` takes the slice's own). The
    reference's `compact_macro_shardings` and
    `compact_macro_shardings_for_scheme` in one (their macro and one-batch
    placements are the same slicers), with the divisibility errors when
    `scheme` and `batch_size` (the host's batch under `hosts > 1`) are
    given."""
    from two_tower_recommender_model_tpu_torch.data.compact import CompactBatch

    last = BatchSharding(mesh, -1, hosts)
    if batch_size is not None:
        if batch_size % last.pieces:
            raise ValueError(f"batch {batch_size} must divide by data axis {last.pieces}")
        if scheme is not None and scheme.rem_bits_total and (batch_size // 8) % last.pieces:
            raise ValueError(
                f"compact rem groups {batch_size // 8} must divide by the data axis "
                f"{last.pieces} (need batch % {8 * last.pieces} == 0)")
    return CompactBatch(wire=last, rem=last, labels=last, dense=BatchSharding(mesh, -2, hosts),
                        weights=last, delta_pos=None, delta_extra=None)


def delta_prefix(mesh: Mesh, pieces: int, segments: int) -> Callable:
    """`prefix(total) -> the exclusive prefix of this rank's slice`: the
    sums of the delta-encoded slot over the slices before this rank's in its
    segment, from the slices' totals all-gathered over the data group (int32,
    exact; a collective a CUDA graph captures). A rank holds slice
    `d % pieces` of its batch, whose `segments` sorted segments each span
    `pieces // segments` slices."""
    if pieces % segments:
        raise ValueError(f"{segments} delta segments do not split over {pieces} data slices")
    per_segment = pieces // segments
    start = mesh.d // per_segment * per_segment

    def prefix(total: torch.Tensor) -> torch.Tensor:
        totals = _all_gather(total.reshape(1), mesh.data_group, mesh.data)
        return totals[start:mesh.d].sum(dtype=torch.int32)

    return prefix


def sharded_compact_decoder(model_cfg: ModelConfig, scheme, mesh: Mesh,
                            hosts: int = 1) -> Callable:
    """`decode(cb) -> Batch`: `batch_from_compact` of this rank's slice of a
    compact batch (placed by `compact_shardings`), the delta-encoded slot
    decoded from its slice, the sidecar exceptions that fall in it and the
    exclusive prefix over the data group (`delta_prefix`): bit for bit the
    one-device decode's rows."""
    from two_tower_recommender_model_tpu_torch.data.compact import batch_from_compact

    if scheme.delta_feature is not None and hosts > 1 and scheme.delta_segments != hosts:
        raise ValueError(f"delta wire across hosts needs CompactScheme.from_model(..., "
                         f"delta_segments={hosts}) — got {scheme.delta_segments}")
    pieces = mesh.data // hosts
    index = mesh.d % pieces
    held = scheme.delta_segments if hosts == 1 else 1  # segments in the batch a rank holds
    prefix = delta_prefix(mesh, pieces, held) if scheme.delta_feature is not None else None

    def decode(cb):
        return batch_from_compact(cb, model_cfg, scheme, part=(index, pieces, prefix))

    return decode


def make_sharded_compact_multi_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                                    dense_opt: opt_lib.DenseOptimizer, mesh: Mesh,
                                    plan: ShardingPlan, scheme, hosts: int = 1):
    """K sharded train steps over a stacked `CompactBatch` in one call, each
    decoding its slice (`sharded_compact_decoder`): on the card one CUDA
    graph of the K steps, decode and collectives captured. Place the payload
    with `compact_shardings`. A delta slot across hosts needs
    `scheme.delta_segments == hosts` (each host sorts and encodes its own
    part)."""
    core = make_sharded_train_step(model_cfg, train_cfg, dense_opt, mesh, plan)
    decode = sharded_compact_decoder(model_cfg, scheme, mesh, hosts)
    return make_multi_step(lambda s, cb: core(s, decode(cb)))


# ---------------------------------------------------------------------------
# sharded retrieval


def shard_corpus(corpus: torch.Tensor, mesh: Mesh) -> tuple[torch.Tensor, int]:
    """(this rank's shard of `corpus` padded with zero rows to a multiple of
    the ranks, the real rows): row shard `r` holds global rows `[r * R, (r +
    1) * R)`, the flat rank order of the tables."""
    n = corpus.shape[0]
    rows = -(-n // mesh.size)
    lo, hi = mesh.rank * rows, min((mesh.rank + 1) * rows, n)
    shard = corpus.new_zeros((rows, corpus.shape[1]))
    if hi > lo:
        shard[:hi - lo] = corpus[lo:hi]
    return shard, n


def topk_shard_candidates(queries: torch.Tensor, shard: torch.Tensor, k: int, corpus_chunk: int,
                          shard_index: int, valid: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One shard's k candidates, (scores [Q, k], global rows [Q, k]): the
    chunked running merge (`ops/topk.py`) over its rows, those at or past
    the global `valid` masked to -inf before the selection, local rows made
    global."""
    rows = shard.shape[0]
    local_valid = max(0, min(valid - shard_index * rows, rows))
    vals, idx = chunked_topk(queries, shard, k=k, corpus_chunk=min(corpus_chunk, rows),
                             valid=local_valid)
    return vals, idx + shard_index * rows


def topk_merge(vals: torch.Tensor, idx: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The top k of every shard's candidates (`[n, Q, k]` each, in shard
    order): concatenated in shard order and selected by a stable descending
    sort, so equal scores keep the lower shard and, within a shard, the
    lower row: ties go to the lower global row, as on one device."""
    n, q, _ = vals.shape
    av = vals.permute(1, 0, 2).reshape(q, n * k)
    ai = idx.permute(1, 0, 2).reshape(q, n * k)
    best, pos = torch.sort(av, dim=1, descending=True, stable=True)
    return best[:, :k], torch.gather(ai, 1, pos[:, :k])


def make_sharded_topk(mesh: Mesh, k: int, corpus_chunk: int = 4096) -> Callable:
    """`topk(queries [Q, D], shard [R, D], valid=None) -> (scores [Q, k],
    global rows [Q, k])`: the exact top-k over a corpus row-sharded over the
    mesh's flat ranks (`shard_corpus`), every rank passing the same queries.
    Each rank scans its shard (`topk_shard_candidates`), the k candidates of
    every rank are all-gathered (O(ranks x Q x k), never the scores) and
    merged (`topk_merge`). `valid` is the real rows of a padded corpus (its
    pad rows can never evict a real candidate); default every row."""

    def topk(queries: torch.Tensor, shard: torch.Tensor, valid: int | None = None):
        n = mesh.size
        valid = n * shard.shape[0] if valid is None else valid
        vals, idx = topk_shard_candidates(queries, shard, k, corpus_chunk, mesh.rank, valid)
        q = queries.shape[0]
        av = _all_gather(vals, mesh.group, n).view(n, q, k)
        ai = _all_gather(idx, mesh.group, n).view(n, q, k)
        return topk_merge(av, ai, k)

    return topk
