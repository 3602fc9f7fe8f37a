"""Optimizers: row-wise Adagrad for the embedding tables, Adam for the towers.

Port of `two_tower_recommender_model_tpu/train/optimizer.py`. Row-wise
Adagrad (fbgemm's semantics): per row

    acc_row += mean(g_row ** 2);  row -= lr * g_row / (sqrt(acc_row) + eps)

where g_row sums the gradients of every occurrence of the row in the batch.

The update the train step runs is the CUDA kernel of `ops/adagrad_kernel.py`
(kernel #4; for an int8 `QuantizedTable` kernel #6 of
`ops/quantized_kernel.py`), in place: straight on the host-sorted table's
ids, and through `device_sorted_fused_adagrad` (a stable device sort first)
on every other table. `sparse_rowwise_adagrad`, `dense_rowwise_adagrad` and
`masked_rowwise_adagrad_epilogue` are plain functional versions of the same
update (they return new tensors), kept as the kernel's oracles.

Two more routes compute the same update for a float table and are what
`make_train_step(..., sparse_update=...)` is given to run them:
`block_sorted_rowwise_adagrad` (the dense aggregate kernel #3, then the
masked epilogue) and `pallas_sparse_rowwise_adagrad` (the sorted-segment
aggregation, then the row-subtract kernel #7). They keep the names of their
counterparts in the JAX package's `ops/block_sorted.py` and
`ops/pallas_update.py`. `sparse_rowwise_adagrad_columns` updates a column
slice of a column-sharded table (kernel #3, then the epilogue).

`dense_optimizer` is the towers' Adam / AdamW recipe with the JAX package's
learning-rate schedules (constant, linear, cosine, with warmup). Over CUDA
parameters the optimizer is built capturable (its step counts and its
learning rate are device tensors), for eager steps as for the steps a
multi-step captures into a CUDA graph, so the two agree bit for bit on the
card; over CPU parameters it is the plain optimizer with a Python-number
rate. The capturable path computes Adam's bias corrections with f32 tensor
arithmetic and holds the rate in f32, the plain one with Python doubles:
the two agree to a few f32 ulps of each update (the rate times a ratio of
order 1), not bit for bit.

Over f32 parameters the recipe builds `torch.optim.Adam` / `AdamW`. Over
parameters of another dtype (`param_dtype="bfloat16"`) it builds
`OptaxAdam`, which rounds where optax rounds: every operation in the
parameters' dtype, each Python constant rounded to it first (through f32, as
JAX converts a Python number), the bias corrections `1 - b**count` in f32
and then rounded. torch's Adam computes in f32 and rounds once, so on bf16
weights it lands one ulp away from optax at a share of the elements.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable

import torch
import torch.distributed as dist

from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import (
    block_sorted_aggregate,
    rowwise_adagrad,
    run_sums,
)
from two_tower_recommender_model_tpu_torch.ops.quantized import QuantizedTable
from two_tower_recommender_model_tpu_torch.ops.quantized_kernel import (
    quantized_rowwise_adagrad_fused,
)
from two_tower_recommender_model_tpu_torch.ops.row_subtract import row_subtract


def row_grad_flatten(
    ids: torch.Tensor,  # [B, L]
    mask: torch.Tensor,  # [B, L]
    row_grads: torch.Tensor,  # [B, L, D]
    num_rows: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Flatten per-slot grads to ([M] ids, [M, D] grads); dead slots get the
    sentinel id `num_rows`, which every update drops."""
    flat_ids = torch.where(mask.reshape(-1) > 0, ids.reshape(-1), num_rows).to(torch.int32)
    return flat_ids, row_grads.reshape(-1, row_grads.shape[-1])


def aggregate_grads_by_row(
    flat_ids: torch.Tensor,  # [M] (sentinel >= n for dead slots)
    flat_grads: torch.Tensor,  # [M, D]
    n: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort the ids and sum duplicate occurrences. Returns (g_seg [M, D] f32,
    rep [M] row id per segment, valid [M], safe [M] in-range index); segments
    past the last are empty (rep is the int32 minimum there)."""
    m = flat_ids.shape[0]
    order = torch.argsort(flat_ids, stable=True)
    sids = flat_ids[order]
    sg = flat_grads[order].to(torch.float32)
    starts = torch.ones(m, dtype=torch.bool, device=flat_ids.device)
    starts[1:] = sids[1:] != sids[:-1]
    seg = torch.cumsum(starts, 0) - 1
    g_seg = torch.zeros_like(sg).index_add_(0, seg, sg)
    rep = torch.full((m,), torch.iinfo(torch.int32).min, dtype=torch.int32,
                     device=flat_ids.device).scatter_reduce_(0, seg, sids, "amax")
    valid = (rep >= 0) & (rep < n)
    return g_seg, rep, valid, torch.where(valid, rep, 0)


def sparse_rowwise_adagrad(table: torch.Tensor, acc: torch.Tensor, flat_ids: torch.Tensor,
                           flat_grads: torch.Tensor, lr: float,
                           eps: float = 1e-10) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted-segment row-wise Adagrad: gather, update and scatter only the
    touched rows. Returns new tensors."""
    n = table.shape[0]
    g_seg, rep, valid, safe = aggregate_grads_by_row(flat_ids, flat_grads, n)
    rows = table[safe].to(torch.float32)
    new_acc_rows = acc[safe].to(torch.float32) + torch.mean(g_seg * g_seg, dim=1)
    denom = torch.sqrt(new_acc_rows) + eps
    new_rows = rows - lr * g_seg / denom[:, None]
    new_table, new_acc = table.clone(), acc.clone()
    new_table[rep[valid].long()] = new_rows[valid].to(table.dtype)
    new_acc[rep[valid].long()] = new_acc_rows[valid].to(acc.dtype)
    return new_table, new_acc


def masked_rowwise_adagrad_epilogue(table: torch.Tensor, acc: torch.Tensor, g: torch.Tensor,
                                    touched: torch.Tensor, lr: float,
                                    eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise Adagrad over a dense aggregated gradient `g` [N, D], applied
    only to `touched` rows. Returns new tensors."""
    g2 = torch.mean(g * g, dim=1)
    acc32 = acc.to(torch.float32)
    new_acc = torch.where(touched, acc32 + g2, acc32)
    denom = torch.sqrt(new_acc) + eps
    new_table = torch.where(touched[:, None], table.to(torch.float32) - lr * g / denom[:, None],
                            table)
    return new_table.to(table.dtype), new_acc.to(acc.dtype)


def dense_buffer(n: int, flat_ids: torch.Tensor, flat_grads: torch.Tensor,
                 buffer_dtype: torch.dtype | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The transient-dense updates' `[n, D]` f32 gradient buffer and its
    `[n]` mask of named rows: the grads summed by id in f32, or with
    `buffer_dtype=torch.bfloat16` in the reference's bf16 buffer (each id's
    grads in position order, rounded to bf16 after every add), widened."""
    g = torch.zeros((n, flat_grads.shape[1]), dtype=torch.float32, device=flat_grads.device)
    rows, sums = run_sums(flat_ids, flat_grads, n, buffer_dtype)
    g[rows] = sums
    touched = torch.zeros(n, dtype=torch.bool, device=flat_grads.device)
    touched[rows] = True
    return g, touched


def dense_rowwise_adagrad(table: torch.Tensor, acc: torch.Tensor, flat_ids: torch.Tensor,
                          flat_grads: torch.Tensor, lr: float, eps: float = 1e-10, *,
                          ids_sorted: bool = False, buffer_dtype: torch.dtype | None = None,
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Transient-dense row-wise Adagrad: sum the grads into a table-shaped
    buffer (f32, or bf16 under `buffer_dtype=torch.bfloat16`:
    `dense_buffer`), then the masked epilogue. `ids_sorted` is the
    reference's hint that the ids are non-decreasing; the sums here do not
    depend on it. Returns new tensors."""
    del ids_sorted
    g, touched = dense_buffer(table.shape[0], flat_ids, flat_grads, buffer_dtype)
    return masked_rowwise_adagrad_epilogue(table, acc, g, touched, lr, eps)


@torch.no_grad()
def column_grad_sums(n: int, flat_ids: torch.Tensor,
                     flat_grads_cols: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A column slice's `[n, D_local]` f32 gradient sums and the `[n]` mask
    of the rows the ids name (sentinels outside [0, n) name none): kernel #3
    after a stable device sort, with its permutation."""
    sids, perm = torch.sort(flat_ids.to(torch.int32), stable=True)
    g = block_sorted_aggregate(n, sids.contiguous(), flat_grads_cols.contiguous(),
                               perm=perm.to(torch.int32))
    live = (flat_ids >= 0) & (flat_ids < n)
    touched = torch.zeros(n + 1, dtype=torch.bool, device=g.device).index_fill_(
        0, torch.where(live, flat_ids, n).long(), True)[:n]
    return g, touched


@torch.no_grad()
def column_adagrad_epilogue(table_cols: torch.Tensor, acc: torch.Tensor, g: torch.Tensor,
                            touched: torch.Tensor, g2: torch.Tensor, lr: float, eps: float,
                            full_dim: int):
    """Row-wise Adagrad on the touched rows of a column slice, in place: `g2`
    `[n]` is the rows' squared gradients summed over every column shard,
    divided here by the FULL dim. Returns (table_cols, acc)."""
    acc32 = acc.to(torch.float32)
    new_acc = torch.where(touched, acc32 + g2 / full_dim, acc32)
    denom = torch.sqrt(new_acc) + eps
    new_table = torch.where(touched[:, None],
                            table_cols.to(torch.float32) - lr * g / denom[:, None], table_cols)
    table_cols.copy_(new_table)
    acc.copy_(new_acc)
    return table_cols, acc


def sparse_rowwise_adagrad_columns(table_cols: torch.Tensor, acc: torch.Tensor,
                                   flat_ids: torch.Tensor, flat_grads_cols: torch.Tensor,
                                   lr: float, eps: float, full_dim: int, psum_group=None):
    """Row-wise Adagrad on a column slice `[N, D_local]` of a table whose
    rows' accumulator `acc` `[N]` is kept whole on every column shard: each
    row's gradients summed over the local columns (`column_grad_sums`,
    kernel #3), their squares summed and all-reduced over `psum_group` (None
    on one device), then the update of the local columns
    (`column_adagrad_epilogue`), in place. Every shard computes the same
    accumulator, so the copies stay equal. Returns (table_cols, acc)."""
    g, touched = column_grad_sums(table_cols.shape[0], flat_ids, flat_grads_cols)
    g2 = torch.sum(g * g, dim=1)
    if psum_group is not None:
        dist.all_reduce(g2, group=psum_group)
    return column_adagrad_epilogue(table_cols, acc, g, touched, g2, lr, eps, full_dim)


def grad_wire_dtype(matmul_dtype: str) -> torch.dtype:
    """The dtype the `[M, D]` gradients reach a kernel in: under
    `matmul_dtype="bfloat16"` they are rounded to bf16 first, as the
    reference casts them; the kernels sum in f32 either way."""
    return torch.bfloat16 if matmul_dtype == "bfloat16" else torch.float32


def device_sorted_fused_adagrad(table: torch.Tensor | QuantizedTable, acc: torch.Tensor,
                                flat_ids: torch.Tensor, flat_grads: torch.Tensor, lr: float,
                                eps: float = 1e-10, *, matmul_dtype: str = "float32"):
    """The front-end for ids in any order: a stable device sort of the ids,
    then kernel #4 (#6 for an int8 `QuantizedTable`) on the sorted ids with
    the sort's permutation, so the kernel reads `grads[perm[j]]` and no
    permuted [M, D] copy is made. In place; returns (table, acc)."""
    sids, perm = torch.sort(flat_ids, stable=True)
    sids, perm = sids.contiguous(), perm.to(torch.int32)
    grads = flat_grads.to(grad_wire_dtype(matmul_dtype)).contiguous()
    if isinstance(table, QuantizedTable):
        quantized_rowwise_adagrad_fused(table.values, table.scales, acc, sids, grads, lr, eps,
                                        perm=perm)
        return table, acc
    return rowwise_adagrad(table, acc, sids, grads, lr, eps, perm=perm)


def block_sorted_rowwise_adagrad(table: torch.Tensor, acc: torch.Tensor, flat_ids: torch.Tensor,
                                 flat_grads: torch.Tensor, lr: float, eps: float = 1e-10, *,
                                 matmul_dtype: str = "float32"):
    """Row-wise Adagrad by the dense aggregate: kernel #3 sums the gradients
    into an [N, D] f32 buffer, then the masked epilogue updates the rows whose
    sum is not all zero (a named row with an exactly-zero sum updates to the
    same values either way). `flat_ids` must be NON-DECREASING, sentinels
    last (the kernel gives each run of equal ids to one warp); an async device
    assert holds them to it. Returns new tensors."""
    torch._assert_async(torch.all(flat_ids[1:] >= flat_ids[:-1]),
                        "block_sorted_rowwise_adagrad: flat ids are not sorted")
    g = block_sorted_aggregate(table.shape[0], flat_ids.to(torch.int32).contiguous(),
                               flat_grads.to(grad_wire_dtype(matmul_dtype)).contiguous())
    touched = (g != 0).any(dim=1)
    return masked_rowwise_adagrad_epilogue(table, acc, g, touched, lr, eps)


@torch.no_grad()
def pallas_sparse_rowwise_adagrad(table: torch.Tensor, acc: torch.Tensor, flat_ids: torch.Tensor,
                                  flat_grads: torch.Tensor, lr: float, eps: float = 1e-10):
    """Row-wise Adagrad by the sorted-segment aggregation (ids in any order),
    the accumulator math in PyTorch, and the row apply in kernel #7:
    `table[rep] -= lr / (sqrt(acc) + eps) * g`, one distinct id per segment
    (the kernel's contract), empty segments carrying the sentinel N. In
    place; returns (table, acc)."""
    n = table.shape[0]
    g_seg, rep, valid, safe = aggregate_grads_by_row(flat_ids, flat_grads, n)
    new_acc_rows = acc[safe] + torch.mean(g_seg * g_seg, dim=1)
    scale = lr / (torch.sqrt(new_acc_rows) + eps)
    acc[rep[valid].long()] = new_acc_rows[valid]
    rep_ids = torch.where(valid, rep, n).to(torch.int32)
    row_subtract(table, rep_ids, (scale[:, None] * g_seg).contiguous())
    return table, acc


# --- the towers' optimizer -----------------------------------------------------------


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over `steps`, then held."""
    return lambda t: (init - end) * (1.0 - min(max(t, 0), steps) / steps) + end


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule: half a cosine from init to init * alpha."""
    def lr(t: int) -> float:
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(t, steps) / steps))
        return init * ((1.0 - alpha) * cosine + alpha)
    return lr


class OptaxAdam(torch.optim.Optimizer):
    """Adam, or AdamW with `weight_decay`, op for op as optax 0.2.6's
    `scale_by_adam` -> (`add_decayed_weights`) -> `scale_by_learning_rate`
    -> `apply_updates`, each operation rounded to the parameter's dtype:

        mu = (1-b1)·g + b1·mu;  nu = (1-b2)·(g·g) + b2·nu
        u  = (mu / c1) / (sqrt(nu / c2) + eps)     c = round(1 - b**count in f32)
        u  = u + wd·p  (AdamW);  p = p + (-lr)·u

    The learning rate is held in f32 (a Python double or a 0-dim f32 device
    tensor, as `torch.optim.Adam` holds it) and rounded to the dtype at each
    step, as optax rounds its f32 schedule value and its Python constant
    alike. The state keys are torch Adam's (`step`, `exp_avg`,
    `exp_avg_sq`), the moments in the parameter's dtype as optax's. In
    place; `capturable` keeps the step counts on the parameters' device."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 capturable=False):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      capturable=capturable))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("OptaxAdam takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            for dtype in dict.fromkeys(p.dtype for p in params):
                self._update([p for p in params if p.dtype == dtype], group, dtype)

    def _update(self, params: list[torch.Tensor], group: dict, dtype: torch.dtype) -> None:
        def rounded(x: float) -> float:  # a Python constant as JAX converts it: via f32
            return torch.tensor(x, dtype=torch.float32).to(dtype).item()

        b1, b2 = group["betas"]
        grads = [p.grad for p in params]
        states = [self.state[p] for p in params]
        mus = [s["exp_avg"] for s in states]
        nus = [s["exp_avg_sq"] for s in states]
        torch._foreach_add_([s["step"] for s in states], 1)
        step = states[0]["step"]
        # mu = (1-b1)·g + b1·mu; nu = (1-b2)·g² + b2·nu: three roundings each
        torch._foreach_mul_(mus, rounded(b1))
        torch._foreach_add_(mus, torch._foreach_mul(grads, rounded(1 - b1)))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, rounded(1 - b2))
        torch._foreach_mul_(nus, rounded(b2))
        torch._foreach_add_(nus, g2)
        # the bias corrections: b**count in f32 (f32 base), 1 - it, then rounded
        c1, c2 = ((1 - torch.pow(torch.full_like(step, b), step)).to(dtype) for b in (b1, b2))
        m_hat = torch._foreach_div(mus, c1)
        denom = torch._foreach_div(nus, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, rounded(group["eps"]))
        updates = torch._foreach_div(m_hat, denom)
        if group["weight_decay"]:
            torch._foreach_add_(updates,
                                torch._foreach_mul(params, rounded(group["weight_decay"])))
        lr = group["lr"]
        rate = -(lr.to(dtype) if torch.is_tensor(lr) else
                 torch.tensor(lr, dtype=torch.float32).to(dtype))
        torch._foreach_mul_(updates, rate)
        torch._foreach_add_(params, updates)


def init_adam_state(opt: torch.optim.Optimizer) -> None:
    """Create Adam's per-parameter state (zero moments, step 0) now instead
    of at the first `step()`, as `torch.optim.Adam` itself creates it: a CUDA
    graph bakes the state's addresses in, so they must exist before the
    capture."""
    for group in opt.param_groups:
        for p in group["params"]:
            if opt.state[p]:
                continue
            opt.state[p] = {
                # the count lives beside the parameter when the step may be captured
                "step": torch.zeros((), dtype=torch.float32,
                                    device=p.device if group["capturable"] else "cpu"),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
            }


@dataclasses.dataclass(frozen=True)
class DenseOptimizer:
    """A recipe for the towers' optimizer, not yet bound to parameters:
    `build(params)` makes the torch optimizer (which remembers the schedule
    as `opt.lr_schedule`), `step(opt, t)` sets the learning rate of update t
    (counted from 0) and applies the update."""

    schedule: Callable[[int], float]
    weight_decay: float = 0.0

    def build(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        """Adam (AdamW with `weight_decay`) over `params`, its state created
        at once: torch's over f32 parameters, `OptaxAdam` over any other
        dtype. Over CUDA parameters it is capturable and its rate is a 0-dim
        device tensor."""
        params = list(params)
        cuda = bool(params) and params[0].is_cuda
        lr = self.schedule(0)
        if cuda:
            lr = torch.tensor(lr, dtype=torch.float32, device=params[0].device)
        # optax's defaults: b1 0.9, b2 0.999, eps 1e-8; AdamW decays the
        # weights decoupled from the Adam direction, as optax.adamw does
        if any(p.dtype != torch.float32 for p in params):
            opt = OptaxAdam(params, lr=lr, weight_decay=self.weight_decay, capturable=cuda)
        elif self.weight_decay:
            opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=self.weight_decay, capturable=cuda)
        else:
            opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=cuda)
        # a capturable optimizer stepping outside a capture is meant here: no warning
        opt._warned_capturable_if_run_uncaptured = True
        opt.lr_schedule = self.schedule  # a captured multi-step fills its rate buffer from it
        init_adam_state(opt)
        return opt

    def step(self, opt: torch.optim.Optimizer, t: int, lr: torch.Tensor | None = None) -> None:
        """Apply update t. `lr`, when given, is a 0-dim device tensor that
        holds this update's rate: a step captured into a CUDA graph reads it
        from a buffer the host fills from the schedule before each replay,
        since a Python number would be baked into the graph."""
        for group in opt.param_groups:
            if torch.is_tensor(group["lr"]):
                if lr is None:
                    group["lr"].fill_(self.schedule(t))
                else:
                    group["lr"].copy_(lr)
            elif lr is not None:
                raise ValueError("a device learning rate needs a capturable optimizer "
                                 "(CUDA parameters)")
            else:
                group["lr"] = self.schedule(t)
        opt.step()


def clone_dense_optimizer(opt: torch.optim.Optimizer,
                          params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """An optimizer of `opt`'s kind and hyperparameters over `params` (the
    same parameters in the same order, on any device: theirs decides whether
    it is capturable), with a copy of `opt`'s state."""
    decay = (opt.param_groups[0]["weight_decay"]
             if type(opt) in (torch.optim.AdamW, OptaxAdam) else 0.0)
    new = DenseOptimizer(opt.lr_schedule, decay).build(params)
    olds = [p for g in opt.param_groups for p in g["params"]]
    news = [p for g in new.param_groups for p in g["params"]]
    for p_old, p_new in zip(olds, news, strict=True):
        for key, value in opt.state.get(p_old, {}).items():
            new.state[p_new][key].copy_(value)
    return new


def dense_optimizer(learning_rate: float, schedule: str = "constant",
                    total_steps: int | None = None, warmup_steps: int = 0,
                    end_factor: float = 0.0, weight_decay: float = 0.0) -> DenseOptimizer:
    """Adam for the dense towers, or AdamW with `weight_decay`, under a
    learning-rate schedule:

    - "constant": plain Adam;
    - "linear": linear decay from lr to lr * end_factor over total_steps;
    - "cosine": cosine decay to lr * end_factor over total_steps;

    each after `warmup_steps` of a linear ramp from 0."""
    if schedule == "constant":
        lr = lambda t: learning_rate  # noqa: E731
    elif schedule == "linear":
        if total_steps is None:
            raise ValueError("linear schedule requires total_steps")
        lr = _linear(learning_rate, learning_rate * end_factor, total_steps - warmup_steps)
    elif schedule == "cosine":
        if total_steps is None:
            raise ValueError("cosine schedule requires total_steps")
        lr = _cosine(learning_rate, total_steps - warmup_steps, end_factor)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if warmup_steps:
        warm, main = _linear(0.0, learning_rate, warmup_steps), lr
        lr = lambda t: warm(t) if t < warmup_steps else main(t - warmup_steps)  # noqa: E731
    return DenseOptimizer(lr, weight_decay)
