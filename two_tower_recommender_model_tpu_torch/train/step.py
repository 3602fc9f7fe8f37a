"""Train and eval steps: the two-stage backward with a fused sparse update.

Port of `two_tower_recommender_model_tpu/train/step.py`. One step:

  stage A  pooled = gather + pool(tables, ids)              (no autograd)
           sampled softmax with logQ: the streaming item counts take the
           batch's ids, and logQ comes from the new counts
  stage B  loss, logits; autograd w.r.t. the towers and the pooled rows
           (under bf16 compute each flagship tower's backward is the fused
           kernel #8; the sampled softmax runs kernels #9, #10 and #11)
  stage C  d_pooled -> per-slot row grads -> row-wise Adagrad (kernel #4;
           kernel #6 for an int8 table)
           d_towers -> Adam

The table gradient never exists as a dense [N, D] tensor, and stage C
touches only the rows the batch names.

PyTorch runs eagerly, so where the reference returns a new state the port
updates the state in place: the tables and accumulators by the kernel, the
towers by the optimizer. `step(state, batch)` returns the same `TrainState`.
A `sparse_update` override may return new tensors instead (the plain oracles
do); the step installs whatever the update returns.

With `table_dtype="int8"` a table is a `QuantizedTable` (int8 rows, f32
scales; accumulators stay f32 `[N]`): gathers through kernel #5, updates
through kernel #6. With `table_dtype="bfloat16"` a table is a bf16 tensor:
gathers through kernel #1, which widens the rows, and updates through kernel
#4 with f32 gradients, f32 row math, f32 accumulators and one rounding of the
new row to bf16, as the reference's plain updates do.

`make_multi_step(step_fn)` runs K steps over a stacked macro-batch in one
call: a plain loop on CPU tensors, and on CUDA tensors one CUDA graph of the
K steps, captured at the first call and replayed after, so the host issues
one launch for K steps' device work.

`scatter_buffer_dtype="bfloat16"` sums the host-sorted table's gradients in
the reference's bf16 buffer (kernels #4 and #6 in their bf16 mode) exactly
where the reference takes that buffer: see `pick_table_update_fn`.

Not ported yet: `device_sorted_gather` (raises `NotImplementedError`; ROADMAP
Queue 1 item 5: sorted ids gained 6-7% on a table that fits the card's 50 MB
L2, so it waits for a measurement on a larger table the host does not sort).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from two_tower_recommender_model_tpu_torch.config import ModelConfig, TrainConfig
from two_tower_recommender_model_tpu_torch.data.featurizer import Batch
from two_tower_recommender_model_tpu_torch.models import losses as losses_lib
from two_tower_recommender_model_tpu_torch.models.metrics import (
    AUROCState,
    MeanState,
    auroc_init,
    auroc_update,
    mean_init,
    mean_update,
)
from two_tower_recommender_model_tpu_torch.models.two_tower import (
    TwoTower,
    forward,
    init_params,
    params_from_numpy,
    pooled_embeddings,
    towers_forward,
)
from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import rowwise_adagrad
from two_tower_recommender_model_tpu_torch.ops.embedding_ops import row_grads_from_pooled
from two_tower_recommender_model_tpu_torch.ops.quantized import QuantizedTable
from two_tower_recommender_model_tpu_torch.ops.quantized_kernel import (
    quantized_rowwise_adagrad_fused,
)
from two_tower_recommender_model_tpu_torch.train import optimizer as opt_lib
from two_tower_recommender_model_tpu_torch.train.pipeline import map_leaves


@dataclasses.dataclass
class TrainState:
    """The model (tables and towers), the tables' row accumulators, the
    towers' optimizer and the step count. Updated in place by a train step."""

    step: int
    model: TwoTower
    adagrad_acc: dict[str, torch.Tensor]  # per-table [N] row accumulators
    dense_opt_state: torch.optim.Optimizer  # over the towers' parameters
    # streaming item-frequency counts [num_candidate_ids] f32 for the sampled
    # softmax's logQ popularity correction (None unless enabled)
    item_counts: torch.Tensor | None = None
    # set by a multi-step around each step it captures into a CUDA graph: the 0-dim
    # device tensor the towers' optimizer reads that update's learning rate from
    device_lr: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.model.device

    def copy(self, device: torch.device | str | None = None) -> TrainState:
        """A deep copy with its own optimizer state, on `device` (default:
        the same device)."""
        device = self.device if device is None else torch.device(device)
        model = copy.deepcopy(self.model).to(device)
        opt = opt_lib.clone_dense_optimizer(self.dense_opt_state, tower_parameters(model))
        return TrainState(self.step, model,
                          {k: v.to(device, copy=True) for k, v in self.adagrad_acc.items()}, opt,
                          None if self.item_counts is None
                          else self.item_counts.to(device, copy=True))


def full_params(state: TrainState) -> TwoTower:
    """The whole model of a state (tables and towers), as the retrieval eval
    and the export take it."""
    return state.model


def tower_parameters(model: TwoTower) -> list[torch.nn.Parameter]:
    return [*model.query_tower.parameters(), *model.candidate_tower.parameters()]


def _check_table_dtypes(model_cfg: ModelConfig) -> None:
    for t in model_cfg.tables:
        if model_cfg.table_dtype_of(t.name) not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"table {t.name!r}: table dtype must be float32|bfloat16|int8, got "
                             f"{model_cfg.table_dtype_of(t.name)!r}")


def create_train_state(generator: torch.Generator, model_cfg: ModelConfig,
                       train_cfg: TrainConfig) -> tuple[TrainState, opt_lib.DenseOptimizer]:
    """A fresh state on the generator's device: random weights drawn from
    `generator` (int8 tables drawn in f32 and quantized, the very large ones
    chunk by chunk, bf16 tables drawn in f32 and rounded: `init_params`), zero
    f32 accumulators, and Adam over the towers. Returns the state and the towers' optimizer recipe, which
    `make_train_step` takes."""
    _check_table_dtypes(model_cfg)
    model = init_params(model_cfg, generator)
    dense_opt = opt_lib.dense_optimizer(train_cfg.learning_rate)
    item_counts = None
    if train_cfg.loss == "sampled_softmax" and train_cfg.logq_correction:
        cand_table = model_cfg.feature_table(model_cfg.candidate_tower.features[0])
        item_counts = torch.zeros(cand_table.num_embeddings, dtype=torch.float32,
                                  device=model.device)
    state = TrainState(
        step=0,
        model=model,
        adagrad_acc={name: torch.zeros(t.shape[0], dtype=torch.float32, device=t.device)
                     for name, t in model.tables.items()},
        dense_opt_state=dense_opt.build(tower_parameters(model)),
        item_counts=item_counts,
    )
    return state, dense_opt


def train_state_from_numpy(state: dict, model_cfg: ModelConfig, train_cfg: TrainConfig,
                           device: torch.device | str | None = None,
                           ) -> tuple[TrainState, opt_lib.DenseOptimizer]:
    """A training state on `device` from the JAX package's `TrainState` as
    numpy arrays, so the port continues a run the JAX package started. The
    layout extends `params_from_numpy`'s:

        {"step": int, "tables": ..., "query_tower": ..., "candidate_tower": ...,
         "adagrad_acc": {table: [N] f32},
         "adam": {"count": int, "mu": {tower: {layer_i: {kernel, bias}}}, "nu": ...},
         "item_counts": [N] f32 or None}

    `adam` is optax Adam's state (`ScaleByAdamState`): its moments become
    torch Adam's `exp_avg` / `exp_avg_sq` (kernels transposed, as the
    weights are) and its `count` each parameter's `step`, from which both
    packages take the bias correction. Returns the state and the towers'
    optimizer recipe, as `create_train_state` does."""
    _check_table_dtypes(model_cfg)
    model = params_from_numpy(state, model_cfg, device)
    dense_opt = opt_lib.dense_optimizer(train_cfg.learning_rate)
    opt = dense_opt.build(tower_parameters(model))
    adam = state["adam"]
    with torch.no_grad():
        for key in ("query_tower", "candidate_tower"):
            for i, layer in enumerate(getattr(model, key).layers):
                for pname, p in (("kernel", layer.weight), ("bias", layer.bias)):
                    for moment, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                        src = np.asarray(adam[moment][key][f"layer_{i}"][pname], np.float32)
                        opt.state[p][name].copy_(torch.from_numpy(
                            np.ascontiguousarray(src.T if pname == "kernel" else src)))
                    opt.state[p]["step"].fill_(int(adam["count"]))

    def f32(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(model.device)

    item_counts = state.get("item_counts")
    if (item_counts is not None) != (train_cfg.loss == "sampled_softmax"
                                     and train_cfg.logq_correction):
        raise ValueError("item_counts must be given exactly when the sampled softmax's logQ "
                         "correction is on")
    return TrainState(
        step=int(state["step"]),
        model=model,
        adagrad_acc={name: f32(state["adagrad_acc"][name]) for name in model.tables.keys()},
        dense_opt_state=opt,
        item_counts=None if item_counts is None else f32(item_counts),
    ), dense_opt


def _table_flat_grads(model_cfg: ModelConfig, batch: Batch,
                      pooled_grads: dict[str, torch.Tensor]):
    """([M] ids, [M, D] grads) per table, concatenating every feature that
    reads it."""
    per_table: dict[str, list] = {t.name: [] for t in model_cfg.tables}
    for fc in model_cfg.features:
        table = model_cfg.table(fc.table)
        feat = batch.features[fc.name]
        rg = row_grads_from_pooled(pooled_grads[fc.name], feat.mask, fc.pooling)
        per_table[fc.table].append(
            opt_lib.row_grad_flatten(feat.ids, feat.mask, rg, table.num_embeddings))
    out = {}
    for name, parts in per_table.items():
        if parts:
            out[name] = (torch.cat([p[0] for p in parts]) if len(parts) > 1 else parts[0][0],
                         torch.cat([p[1] for p in parts]) if len(parts) > 1 else parts[0][1])
    return out


def validate_sorted_feature(model_cfg: ModelConfig, train_cfg: TrainConfig) -> str | None:
    """Resolve `TrainConfig.sorted_feature` to its table's name, enforcing the
    layout under which a host-sorted batch gives that table non-decreasing
    flat ids: the feature is single-slot and the table's only reader."""
    feat = train_cfg.sorted_feature
    if feat is None:
        return None
    fc = next((f for f in model_cfg.features if f.name == feat), None)
    if fc is None:
        raise ValueError(f"sorted_feature {feat!r}: no such feature")
    if fc.max_ids_per_sample != 1:
        raise ValueError(f"sorted_feature {feat!r} must be single-slot "
                         f"(has {fc.max_ids_per_sample})")
    readers = [f.name for f in model_cfg.features if f.table == fc.table]
    if readers != [feat]:
        raise ValueError(f"sorted_feature {feat!r}: table {fc.table!r} is also "
                         f"read by {readers} — flat ids would interleave")
    return fc.table


def auto_sorted_feature(model_cfg: ModelConfig) -> str | None:
    """The single-slot, sole-reader feature with the largest table (sorting
    saves the most on the largest update), or None."""
    best, best_rows = None, 0
    for fc in model_cfg.features:
        if fc.max_ids_per_sample != 1:
            continue
        if [f.name for f in model_cfg.features if f.table == fc.table] != [fc.name]:
            continue
        rows = model_cfg.table(fc.table).num_embeddings
        if rows > best_rows:
            best, best_rows = fc.name, rows
    return best


def pick_table_update_fn(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    sorted_table: str | None,
    tname: str,
    n_flat_ids: int,
    quantized: bool,
    sparse_update: Callable | None = None,
    *,
    table_dtype: str | None = None,
    num_rows: int | None = None,
) -> Callable:
    """The per-table update `(table, acc, flat_ids, flat_grads, lr, eps) ->
    (table, acc)`, with the reference's signature and priorities:

    - an int8 table (`quantized`) always takes kernel #6, also under a
      `sparse_update` override; there the reference takes its plain
      quantized update (`pick_quantized_update`: the override wins over the
      block-kernel routing), which sums f32 gradients, so kernel #6 gets f32
      gradients whatever `block_sorted_kernel` says;
    - a float table takes `sparse_update` when one is given;
    - else kernel #4.

    One kernel serves every table whatever its size and whatever
    `block_sorted_kernel` says: the option only sets the gradients' dtype,
    "bfloat16" rounds them to bf16, "off" and "float32" pass f32. A bf16
    table never reaches a block kernel in the reference, so its gradients go
    in as f32 under every value of the option. The host-sorted table's ids
    go straight in (they arrive sorted; an async device assert holds them to
    it, since unsorted ids would race in the kernel); every other table goes
    through the device-sort front-end.

    `scatter_buffer_dtype="bfloat16"` takes the kernel's bf16 buffer
    (`buffer_dtype=torch.bfloat16`) where the reference sums into its bf16
    buffer: the host-sorted table, no `sparse_update` override,
    `block_sorted_kernel="off"`, and the reference's transient-dense route
    chosen by its size policy, `num_rows <= 8 * n_flat_ids`
    (`pick_sparse_update`, `pick_quantized_update`). Everywhere else the
    option changes nothing, as in the reference.

    The sharded step (`parallel/sharded.py`) updates a shard or a bucket:
    `table_dtype` and `num_rows` then give its dtype and its local rows, where
    the reference's sharded updates apply the same size rule."""
    if sparse_update is not None and not quantized:
        return sparse_update
    rows = model_cfg.table(tname).num_embeddings if num_rows is None else num_rows
    bf16_buffer = (train_cfg.scatter_buffer_dtype == "bfloat16" and tname == sorted_table
                   and sparse_update is None and train_cfg.block_sorted_kernel == "off"
                   and rows <= 8 * n_flat_ids)
    buffer = {"buffer_dtype": torch.bfloat16} if bf16_buffer else {}
    matmul_dtype = "bfloat16" if train_cfg.block_sorted_kernel == "bfloat16" else "float32"
    dtype = model_cfg.table_dtype_of(tname) if table_dtype is None else table_dtype
    if dtype == "bfloat16" or sparse_update is not None:
        matmul_dtype = "float32"
    if tname != sorted_table:
        def upd(table, acc, fids, fgrads, lr, eps):
            return opt_lib.device_sorted_fused_adagrad(table, acc, fids, fgrads, lr, eps,
                                                       matmul_dtype=matmul_dtype)
        return upd
    grad_dtype = opt_lib.grad_wire_dtype(matmul_dtype)

    def upd_sorted(table, acc, fids, fgrads, lr, eps):
        torch._assert_async(torch.all(fids[1:] >= fids[:-1]),
                            f"sorted_feature table {tname!r}: flat ids are not sorted")
        fids, fgrads = fids.contiguous(), fgrads.to(grad_dtype).contiguous()
        if quantized:
            quantized_rowwise_adagrad_fused(table.values, table.scales, acc, fids, fgrads, lr,
                                            eps, **buffer)
            return table, acc
        return rowwise_adagrad(table, acc, fids, fgrads, lr, eps, **buffer)
    return upd_sorted


def _check_train_config(model_cfg: ModelConfig, train_cfg: TrainConfig) -> None:
    if train_cfg.block_sorted_kernel not in ("off", "float32", "bfloat16"):
        raise ValueError(f"block_sorted_kernel must be off|float32|bfloat16, got "
                         f"{train_cfg.block_sorted_kernel!r}")
    if train_cfg.scatter_buffer_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"scatter_buffer_dtype must be float32|bfloat16, got "
                         f"{train_cfg.scatter_buffer_dtype!r}")
    if train_cfg.device_sorted_gather:
        raise NotImplementedError(
            "device_sorted_gather is not ported to the PyTorch package yet (ROADMAP)")
    _check_table_dtypes(model_cfg)
    sorted_table = validate_sorted_feature(model_cfg, train_cfg)
    if train_cfg.block_sorted_kernel != "off" and sorted_table is not None:
        if model_cfg.table_dtype_of(sorted_table) not in ("float32", "int8"):
            raise ValueError(
                f"block_sorted_kernel supports float32 and int8 tables; "
                f"table {sorted_table!r} is {model_cfg.table_dtype_of(sorted_table)}")


def make_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                    dense_opt: opt_lib.DenseOptimizer, sparse_update: Callable | None = None):
    """The single-device train step `step(state, batch) -> (state, out)`,
    out = {"loss", "logits"} as device tensors (read them when needed: a
    `.item()` waits for the card). `sparse_update`, when given, replaces the
    update of every float table (`pick_table_update_fn`); it may update in
    place or return new tensors (while a CUDA graph is being captured, what
    it returns is copied back into the state's own tensors, whose addresses
    the graph replays)."""
    _check_train_config(model_cfg, train_cfg)
    loss_fn = losses_lib.loss_fn_from_config(train_cfg, model_cfg)
    cand_feature = model_cfg.candidate_tower.features[0]
    sorted_table = validate_sorted_feature(model_cfg, train_cfg)
    bs_kernel = train_cfg.block_sorted_kernel
    block_feature = (train_cfg.sorted_feature
                     if bs_kernel != "off" and train_cfg.block_sorted_gather else None)
    updates: dict[str, Callable] = {}  # per table, picked at its first batch

    def step(state: TrainState, batch: Batch):
        model = state.model
        with torch.no_grad():  # stage A
            pooled = pooled_embeddings(
                model.tables, batch, model_cfg, block_sorted_feature=block_feature,
                block_sorted_dtype=bs_kernel if bs_kernel != "off" else "float32")
            # Streaming logQ: counts first, then logQ from the new counts, so a batch
            # sees its own occurrences. Every duplicate counts (index_add_). The counts
            # are integers held in f32: on the card the atomic adds of 1.0 are exact
            # below 2^24, so the result does not depend on their order.
            log_q = None
            if state.item_counts is not None:
                cand_ids = batch.features[cand_feature].ids[:, 0].long()
                state.item_counts.index_add_(
                    0, cand_ids, torch.ones(cand_ids.shape, dtype=torch.float32,
                                            device=cand_ids.device))
                log_q = losses_lib.item_log_q_from_counts(state.item_counts, cand_ids)
        pooled = {k: v.detach().requires_grad_(True) for k, v in pooled.items()}

        state.dense_opt_state.zero_grad(set_to_none=True)  # stage B
        q, c = towers_forward(model, pooled, batch.dense)
        loss, logits = loss_fn(q, c, batch, log_q=log_q)
        loss.backward()

        dense_opt.step(state.dense_opt_state, state.step, lr=state.device_lr)  # stage C
        d_pooled = {k: v.grad if v.grad is not None else torch.zeros_like(v)
                    for k, v in pooled.items()}
        with torch.no_grad():
            for tname, (fids, fgrads) in _table_flat_grads(model_cfg, batch, d_pooled).items():
                table, acc = model.tables[tname], state.adagrad_acc[tname]
                if tname not in updates:
                    updates[tname] = pick_table_update_fn(
                        model_cfg, train_cfg, sorted_table, tname, fids.shape[0],
                        isinstance(table, QuantizedTable), sparse_update)
                new_table, new_acc = updates[tname](table, acc, fids, fgrads,
                                                    train_cfg.sparse_learning_rate,
                                                    train_cfg.adagrad_eps)
                # an update that returned new tensors: installed, or under a graph
                # capture copied back, since a replay updates the captured addresses
                capturing = acc.is_cuda and torch.cuda.is_current_stream_capturing()
                if new_table is not table:
                    if capturing:
                        table.copy_(new_table)
                    else:
                        model.tables[tname] = new_table
                if new_acc is not acc:
                    if capturing:
                        acc.copy_(new_acc)
                    else:
                        state.adagrad_acc[tname] = new_acc
        state.step += 1
        return state, {"loss": loss.detach(), "logits": logits.detach()}

    return step


def stack_batches(batches: list) -> Any:
    """Stack K host batches into one macro-batch (a leading axis K on every
    array leaf, numpy as the reference's; a leaf that is None in every batch
    stays None)."""
    first = batches[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: stack_batches([b[k] for b in batches]) for k in first}
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: stack_batches([getattr(b, f.name) for b in batches])
            for f in dataclasses.fields(first)})
    return np.stack([np.asarray(b) for b in batches])


WARMUP_STEPS = 2  # eager steps on a copy of the state before a capture


def _state_tensors(state: TrainState) -> list[torch.Tensor]:
    """Every tensor a train step reads or writes in place: what a captured
    graph holds the addresses of."""
    out = [p for t in state.model.tables.values()
           for p in ((t.values, t.scales) if isinstance(t, QuantizedTable) else (t,))]
    out += state.adagrad_acc.values()
    for group in state.dense_opt_state.param_groups:
        if torch.is_tensor(group["lr"]):
            out.append(group["lr"])
        for p in group["params"]:
            out.append(p)
            out += [v for v in state.dense_opt_state.state[p].values() if torch.is_tensor(v)]
    if state.item_counts is not None:
        out.append(state.item_counts)
    return out


def _addresses(tensors: list[torch.Tensor]) -> tuple:
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


class _CapturedMacro:
    """K train steps captured into one CUDA graph, with the static buffers
    the graph reads (the payload, the K learning rates) and writes (the K
    losses)."""

    def __init__(self, step_fn: Callable, state: TrainState, stacked: Any):
        k = _leaves(stacked)[0].shape[0]
        device = state.device
        # Warm up on a copy: the first steps build and load the kernels and create
        # the libraries' handles and workspaces, none of which may happen inside a
        # capture, and they train the state they run on.
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            warm = state.copy()
            for i in range(WARMUP_STEPS):
                step_fn(warm, map_leaves(stacked, lambda t: t[i % k]))
            del warm
        torch.cuda.current_stream(device).wait_stream(side)

        self.payload = map_leaves(stacked, torch.clone)
        self.lr = torch.zeros(k, dtype=torch.float32, device=device)
        self.losses = torch.zeros(k, dtype=torch.float32, device=device)
        self.overflow = None  # [K] the all-to-all exchange's counts, when the step reports them
        self.k = k
        self.graph = torch.cuda.CUDAGraph()
        step0, before = state.step, _addresses(_state_tensors(state))
        # thread_local: an input pipeline's threads may pin and copy the next
        # macro-batch while this thread captures
        try:
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                for i in range(k):
                    state.device_lr = self.lr[i]
                    out = step_fn(state, map_leaves(self.payload, lambda t: t[i]))[1]
                    self.losses[i].copy_(out["loss"].detach().float())
                    if "exchange_overflow" in out:
                        if self.overflow is None:
                            self.overflow = torch.zeros(k, dtype=torch.int64, device=device)
                        self.overflow[i].copy_(out["exchange_overflow"])
        finally:  # a capture records and does not run: the state is where it was
            state.device_lr, state.step = None, step0
        if _addresses(_state_tensors(state)) != before:
            raise RuntimeError(
                "the train step replaced a tensor of the state while it was captured; a CUDA "
                "graph replays the addresses it saw, so the step must update the state in place")

    def replay(self, state: TrainState, stacked: Any) -> dict[str, torch.Tensor]:
        for dst, src in zip(_leaves(self.payload), _leaves(stacked)):
            dst.copy_(src, non_blocking=True)
        schedule = state.dense_opt_state.lr_schedule
        rates = [schedule(state.step + i) for i in range(self.k)]
        self.lr.copy_(torch.tensor(rates, dtype=torch.float32))
        self.graph.replay()
        state.step += self.k
        out = {"loss": self.losses.clone()}  # the next replay overwrites the buffers
        if self.overflow is not None:
            out["exchange_overflow"] = self.overflow.sum()
        return out


def _leaves(batch: Any) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    map_leaves(batch, lambda t: out.append(t) or t)
    return out


class MultiStep:
    """`multi(state, stacked) -> (state, {"loss": [K], ...})`: K train steps over a
    macro-batch whose every leaf has a leading axis K (`stack_batches`).

    On CPU tensors it is a plain loop over the K slices, bitwise equal to K
    sequential steps. On CUDA tensors the K steps are captured once into a
    `torch.cuda.CUDAGraph` and replayed: one graph per state (keyed by the
    addresses, shapes and dtypes of its tensors: a second state, or a state
    one of whose tensors was replaced, is captured anew and never replayed
    into another's addresses) and per shape and dtype of the payload. Each
    macro-batch is copied into the graph's static payload buffer, and the K
    learning rates are computed on the host from the schedule the state's
    optimizer was built with (updates `state.step` to `state.step + K - 1`)
    and copied into the buffer each captured step reads its rate from. The first call with a new key runs
    `WARMUP_STEPS` eager steps on a copy of the state (they would otherwise
    train it), captures, and replays.

    `captures` and `replays` count what their names say; kernel wrappers
    count launches where Python calls them, so a replay counts none. Where
    the step reports `exchange_overflow` (the all-to-all exchange), the
    macro-step reports the sum of its K steps' counts, on the device."""

    def __init__(self, step_fn: Callable):
        self.step_fn = step_fn
        self.captures = 0
        self.replays = 0
        self._captured: dict[tuple, _CapturedMacro] = {}

    def __call__(self, state: TrainState, stacked: Any):
        leaves = _leaves(stacked)
        if not leaves[0].is_cuda:
            losses, overflow = [], None
            for i in range(leaves[0].shape[0]):
                state, out = self.step_fn(state, map_leaves(stacked, lambda t: t[i]))
                losses.append(out["loss"].detach())
                if "exchange_overflow" in out:
                    ovf = out["exchange_overflow"]
                    overflow = ovf if overflow is None else overflow + ovf
            out = {"loss": torch.stack(losses)}
            if overflow is not None:
                out["exchange_overflow"] = overflow
            return state, out
        key = (_addresses(_state_tensors(state)),
               tuple((tuple(t.shape), t.dtype) for t in leaves))
        macro = self._captured.get(key)
        if macro is None:
            macro = self._captured[key] = _CapturedMacro(self.step_fn, state, stacked)
            self.captures += 1
        out = macro.replay(state, stacked)
        self.replays += 1
        return state, out


def make_multi_step(step_fn: Callable) -> MultiStep:
    """Train on a K-batch macro-batch in one call (`MultiStep`): `multi(state,
    stacked) -> (state, {"loss": [K]})`. `step_fn(state, batch)` is a train
    step over one slice of the macro-batch, e.g. `lambda s, pb: core(s,
    unpack_batch(pb, model_cfg))` with `core = make_train_step(...)`."""
    return MultiStep(step_fn)


@dataclasses.dataclass
class EvalState:
    """Running eval metrics: the binned AUROC and the mean BCE loss, and
    the distinct ids the all-to-all exchange dropped past its capacity in
    the eval forwards (a device tensor; None on the dense exchange and one
    device), which `train.loop.evaluate` raises on when nonzero."""

    auroc: AUROCState
    loss: MeanState
    exchange_overflow: torch.Tensor | None = None


def eval_state_init(bins: int = 8192, device: torch.device | str | None = None) -> EvalState:
    return EvalState(auroc=auroc_init(bins, device), loss=mean_init(device))


def make_eval_step(model_cfg: ModelConfig, train_cfg: TrainConfig):
    """`step(state, eval_state, batch) -> eval_state`: BCE and AUROC, whatever
    the training loss (`model_cfg` and `train_cfg` are the reference's
    signature; the model's own config drives the forward)."""
    del model_cfg, train_cfg
    loss_fn = losses_lib.make_loss_fn("bce")

    @torch.no_grad()
    def step(state: TrainState, eval_state: EvalState, batch: Batch) -> EvalState:
        q, c = forward(state.model, batch)
        loss, logits = loss_fn(q, c, batch)
        w = batch.weights
        if w is None:
            n = float(batch.labels.shape[0])
        else:
            # zero-weight rows are padding: average the loss over real rows
            n = w.sum()
            loss = losses_lib.bce_with_logits(logits, batch.labels, w)
        return EvalState(auroc=auroc_update(eval_state.auroc, logits, batch.labels, w),
                         loss=mean_update(eval_state.loss, loss, n))

    return step
