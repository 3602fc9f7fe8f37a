"""Pooled embedding lookup and its sparse backward.

Port of `two_tower_recommender_model_tpu/ops/embedding_ops.py`. The lookup
always goes through the pooled-gather wrapper (`ops/embedding_kernel.py`):
on a CUDA tensor that launches the CUDA kernel, on a CPU tensor it takes the
kernel's plain version. Mean pooling pre-scales the slot weights by the
live-slot count, as the reference's kernel route does, and the kernel emits
`compute_dtype` directly; under a compute dtype narrower than a float
table's, the rows are rounded first and a mean divides after, as the
reference's pool rounds. An int8 `QuantizedTable` (`ops/quantized.py`)
takes the same two functions through the int8 pooled-gather kernel
(`ops/quantized_kernel.py`, Pallas kernel #5).

`block_sorted_lookup` is the port of the sorted feature's gather call site
(`ops/block_sorted.py:block_sorted_lookup`, Pallas kernel #2): `table[sids]`
with zero rows for sentinel ids >= N. On Hopper the pooled-gather kernel at
one slot computes exactly that, so #2's call site goes through it, and an
int8 table's (`block_sorted_lookup_quantized`, #5) through the int8 kernel.
`device_sorted_lookup` is the reference's front-end for ids the host did not
sort (`TrainConfig.device_sorted_gather`): a device sort, that one launch on
the sorted ids, and the inverse permute. `block_sorted_shapes_ok` is the
reference's gate of the block kernels, which decides what takes that route.

The backward is not taken through autograd: `row_grads_from_pooled` turns
the gradient of the pooled outputs into per-slot row gradients, which the
row-wise Adagrad update (`train/optimizer.py`) applies to the table.
"""

from __future__ import annotations

import torch

from two_tower_recommender_model_tpu_torch.ops.embedding_kernel import pooled_gather
from two_tower_recommender_model_tpu_torch.ops.quantized import QuantizedTable
from two_tower_recommender_model_tpu_torch.ops.quantized_kernel import quantized_pooled_gather


def _gather(table, ids: torch.Tensor, w: torch.Tensor,
            out_dtype: torch.dtype | None) -> torch.Tensor:
    """One launch of the table's pooled-gather kernel: the int8 one for a
    `QuantizedTable` (f32 out when `out_dtype` is None), else the f32/bf16
    one (the table's dtype out when None)."""
    ids, w = ids.to(torch.int32).contiguous(), w.to(torch.float32).contiguous()
    if isinstance(table, QuantizedTable):
        return quantized_pooled_gather(table.values, table.scales, ids, w,
                                       out_dtype or torch.float32)
    return pooled_gather(table, ids, w, out_dtype=out_dtype)


def pooled_lookup(
    table: torch.Tensor | QuantizedTable,  # [N, D]
    ids: torch.Tensor,  # [B, L] int32, already hashed into [0, N)
    mask: torch.Tensor,  # [B, L] float
    pooling: str = "sum",
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:  # [B, D]
    """Gather + masked pool. `mean` divides by the live-slot count (0-length
    bags pool to zero, matching dropped falsy ids). The result is in
    `compute_dtype`, or in the table's dtype when it is None (f32 for an int8
    table).

    A `compute_dtype` narrower than a float table's rounds where the
    reference's pool rounds (`ops/embedding_ops.py:67-75`): each row to the
    compute dtype, the bag's rows summed in f32 in slot order and rounded
    once (kernel #1 with `round_rows`, the mask as the weights), and a mean
    then divides that sum by the count in the compute dtype, a rounding more.
    A bag of one live slot gives the bits of the weighted route either way.
    An int8 table keeps the weighted route, as the reference pools it in f32
    and casts once (`:49-57`)."""
    if pooling not in ("sum", "mean"):
        raise ValueError(f"unknown pooling {pooling!r}")
    w = mask.to(torch.float32)
    if (compute_dtype is not None and not isinstance(table, QuantizedTable)
            and torch.finfo(compute_dtype).bits < torch.finfo(table.dtype).bits):
        out = pooled_gather(table, ids.to(torch.int32).contiguous(), w.contiguous(),
                            out_dtype=compute_dtype, round_rows=True)
        if pooling == "mean" and ids.shape[1] > 1:  # one slot: a count of 0 or 1
            out = out / torch.clamp(w.sum(dim=1, keepdim=True), min=1.0).to(compute_dtype)
        return out
    if pooling == "mean":
        counts = w.sum(dim=1, keepdim=True)
        w = w / torch.clamp(counts, min=1.0)
    return _gather(table, ids, w, compute_dtype)


def block_sorted_lookup(table: torch.Tensor | QuantizedTable, sids: torch.Tensor,
                        w: torch.Tensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """`w[j] * table[sids[j]]` `[M, D]` in `out_dtype` (the table's dtype when
    None, f32 for an int8 table), with zero rows for sentinel ids >= N or
    weights 0 (the slot mask). One launch of the table's pooled-gather kernel
    at one slot. The ids need not be sorted here (the TPU kernel needed them
    sorted to stream the table in blocks); the train step passes the
    host-sorted feature's."""
    return _gather(table, sids.reshape(-1, 1), w.reshape(-1, 1), out_dtype)


def block_sorted_shapes_ok(d: int, m: int, c: int = 512) -> bool:
    """The reference's gate of its block-sorted kernels (`ops/block_sorted.py:
    block_sorted_shapes_ok`): `[M]` ids of rows of width D fit their tiling,
    D a multiple of 128 and M a multiple of the chunk min(c, M), itself a
    multiple of 128. The port's kernels need none of it; the train step keeps
    it so that the same features take the device-sorted route as in the
    reference, whose rounding differs from the plain gather's."""
    c = min(c, m)
    return d % 128 == 0 and c % 128 == 0 and m % c == 0


def device_sorted_lookup(table: torch.Tensor | QuantizedTable, flat_ids: torch.Tensor, *,
                         matmul_dtype: str = "float32",
                         out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """`table[flat_ids]` `[M, D]` in batch order for ids in any order, with
    zero rows for sentinel ids >= N: a stable device sort of the ids with
    their positions, one launch of the table's gather kernel at one slot on
    the sorted ids (#1, or #5 for an int8 `QuantizedTable`) and the inverse
    permute. `matmul_dtype="bfloat16"` rounds a float table's rows to bf16,
    as the reference's one-hot bf16 gather does; an int8 table's rows are
    dequantized in f32 whatever it says, as the reference's. The result is
    in `out_dtype` (f32 when None, as the reference's)."""
    if matmul_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"matmul_dtype must be float32|bfloat16, got {matmul_dtype!r}")
    quantized = isinstance(table, QuantizedTable)
    out_dtype = out_dtype or torch.float32
    rows_dtype = torch.bfloat16 if matmul_dtype == "bfloat16" and not quantized else out_dtype
    sids, perm = torch.sort(flat_ids.to(torch.int32), stable=True)
    ones = torch.ones(sids.shape, dtype=torch.float32, device=sids.device)
    rows = block_sorted_lookup(table, sids, ones, out_dtype=rows_dtype).to(out_dtype)
    return torch.empty_like(rows).index_copy_(0, perm, rows)


def row_grads_from_pooled(
    pooled_grad: torch.Tensor,  # [B, D]
    mask: torch.Tensor,  # [B, L]
    pooling: str = "sum",
) -> torch.Tensor:  # [B, L, D]
    """Distribute the pooled-output gradient back to each live bag slot:

        d pooled[b] / d row[b, l] = mask[b, l]        (sum pooling)
                                  = mask[b, l] / n_b  (mean pooling)

    Single-slot fast path: with L == 1 the mask multiply would only zero
    DEAD slots, and every consumer drops dead slots by the sentinel id
    (`row_grad_flatten` maps mask == 0 to id N, and the row-wise Adagrad
    update never reads a sentinel's gradient), so the grad is passed through
    as a view. Dead-slot values are then garbage but unused, by contract."""
    if mask.shape[1] == 1 and pooling in ("sum", "mean"):
        return pooled_grad[:, None, :]
    g = pooled_grad[:, None, :] * mask[..., None].to(pooled_grad.dtype)
    if pooling == "mean":
        counts = mask.sum(dim=1)[:, None, None].to(g.dtype)
        g = g / torch.clamp(counts, min=1.0)
    elif pooling != "sum":
        raise ValueError(f"unknown pooling {pooling!r}")
    return g
