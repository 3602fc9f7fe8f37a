"""Int8 embedding tables: a quarter of the bytes per row.

Port of `two_tower_recommender_model_tpu/ops/quantized.py`. Embedding tables
are bound by memory; storing rows as int8 with a per-row scale quarters the
table's footprint and its gather traffic. The scheme, to the rounding point:

    scale = max|row|
    q     = clip(round(row / (scale if scale > 0 else 1) * 127), -127, 127)
    row  ~= float(q) * (scale / 127)

with round-half-to-even, the division before the multiply in both
directions. An all-zero row has scale 0 and dequantizes to exact zeros.

- lookup: `quantized_pooled_lookup`, through the int8 pooled-gather kernel
  (`ops/quantized_kernel.py`);
- training update: the fused int8 row-wise Adagrad kernel of the same module
  (dequantize the touched rows, Adagrad in f32 with f32 accumulators,
  requantize with a fresh absmax). `quantized_rowwise_adagrad` and
  `quantized_dense_rowwise_adagrad` here are plain functional versions (they
  return new tensors), kept as that kernel's oracles.

`ModelConfig.table_dtype="int8"` (or a table's own `dtype="int8"`) switches
the whole stack over: such a table lives in `TwoTower.tables` as a
`QuantizedTable`. The export dequantizes to f32.

**Not ported: packed int32-word storage and the bitcast gather and scatter
helpers** of the JAX package (`pack_int8_values`, `qt_gather_rows_scales`,
`gather_int8_rows_scales`, `scatter_int8_rows`, `PACKED_STORAGE_MIN_ROWS`).
They work around the TPU compiler's emulation of int8 row gathers and
scatters through 32-bit table-sized temporaries. A CUDA kernel addresses
bytes, so the port stores int8 natively at every table size and reads and
writes rows in its own kernels.
"""

from __future__ import annotations

import torch
from torch import nn

from two_tower_recommender_model_tpu_torch.ops.quantized_kernel import (
    dequantize_rows,
    quantize_rows,
    quantized_pooled_gather,
)


class QuantizedTable(nn.Module):
    """int8 rows plus per-row scales: `values` `[N, D]` int8 and `scales`
    `[N]` f32 (the row's absmax), as buffers, so a table travels with its
    model through `state_dict()`, `.to(device)` and `copy.deepcopy`.
    `shape` and `dtype` report the logical `[N, D]` int8 table."""

    def __init__(self, values: torch.Tensor, scales: torch.Tensor):
        super().__init__()
        if values.dim() != 2 or values.dtype != torch.int8:
            raise ValueError(f"values must be [N, D] int8, got {tuple(values.shape)} "
                             f"{values.dtype}")
        if scales.shape != (values.shape[0],) or scales.dtype != torch.float32:
            raise ValueError(f"scales must be [N] float32, got {tuple(scales.shape)} "
                             f"{scales.dtype}")
        self.register_buffer("values", values)
        self.register_buffer("scales", scales)

    @property
    def shape(self) -> torch.Size:
        return self.values.shape

    @property
    def dtype(self) -> torch.dtype:
        return torch.int8  # the logical storage dtype

    @property
    def device(self) -> torch.device:
        return self.values.device


def quantize_table(table: torch.Tensor, row_chunk: int = 1 << 21) -> QuantizedTable:
    """Quantize an `[N, D]` table row by row, in chunks of `row_chunk` rows
    past that size: a one-shot pass makes f32 temporaries the size of the
    table. The result is the same either way (the scheme is per row)."""
    n = table.shape[0]
    if n <= row_chunk:
        return QuantizedTable(*quantize_rows(table.to(torch.float32)))
    parts = [quantize_rows(table[start:start + row_chunk].to(torch.float32))
             for start in range(0, n, row_chunk)]
    return QuantizedTable(torch.cat([q for q, _ in parts]), torch.cat([s for _, s in parts]))


def init_quantized_table(generator: torch.Generator, num_embeddings: int, dim: int,
                         row_chunk: int = 1 << 21) -> QuantizedTable:
    """Direct int8 init for tables too large to draw in f32 first: per chunk,
    draw the EmbeddingBag-style U(-sqrt(1/N), sqrt(1/N)) rows in f32 from
    `generator` (on its device) and quantize them into the table in place, so
    only one f32 chunk is ever live."""
    bound = (1.0 / num_embeddings) ** 0.5
    device = generator.device
    values = torch.empty((num_embeddings, dim), dtype=torch.int8, device=device)
    scales = torch.empty(num_embeddings, dtype=torch.float32, device=device)
    for start in range(0, num_embeddings, row_chunk):
        rows = min(row_chunk, num_embeddings - start)
        chunk = torch.empty((rows, dim), dtype=torch.float32, device=device)
        chunk.uniform_(-bound, bound, generator=generator)
        values[start:start + rows], scales[start:start + rows] = quantize_rows(chunk)
    return QuantizedTable(values, scales)


def dequantize_table(qt: QuantizedTable) -> torch.Tensor:
    return dequantize_rows(qt.values, qt.scales)


def quantized_pooled_lookup(qt: QuantizedTable, ids: torch.Tensor,
                            w: torch.Tensor) -> torch.Tensor:
    """`[B, D]` f32: the weighted sum of the bag's dequantized rows (w = 0 is
    a dead slot). One launch of the int8 pooled-gather kernel on a CUDA
    table."""
    return quantized_pooled_gather(qt.values, qt.scales, ids.to(torch.int32).contiguous(),
                                   w.to(torch.float32).contiguous(), torch.float32)


@torch.no_grad()
def quantized_rowwise_adagrad(qt: QuantizedTable, acc: torch.Tensor, flat_ids: torch.Tensor,
                              flat_grads: torch.Tensor, lr: float,
                              eps: float = 1e-10) -> tuple[QuantizedTable, torch.Tensor]:
    """Row-wise Adagrad on int8 storage, plain PyTorch: dequantize the named
    rows, update in f32, requantize every named row (also one whose summed
    gradient is zero, where the fused kernel writes nothing). The same
    sorted-segment aggregation as the f32 oracle. Returns new tensors."""
    from two_tower_recommender_model_tpu_torch.train.optimizer import aggregate_grads_by_row

    n = qt.shape[0]
    g_seg, rep, valid, safe = aggregate_grads_by_row(flat_ids, flat_grads, n)
    rows = dequantize_rows(qt.values[safe], qt.scales[safe])
    new_acc_rows = acc[safe] + torch.mean(g_seg * g_seg, dim=1)
    new_rows = rows - lr * g_seg / (torch.sqrt(new_acc_rows) + eps)[:, None]
    new_q, new_scales = quantize_rows(new_rows)
    idx = rep[valid].long()
    values, scales, new_acc = qt.values.clone(), qt.scales.clone(), acc.clone()
    values[idx], scales[idx], new_acc[idx] = new_q[valid], new_scales[valid], new_acc_rows[valid]
    return QuantizedTable(values, scales), new_acc


@torch.no_grad()
def quantized_dense_rowwise_adagrad(qt: QuantizedTable, acc: torch.Tensor,
                                    flat_ids: torch.Tensor, flat_grads: torch.Tensor, lr: float,
                                    eps: float = 1e-10, *, ids_sorted: bool = False,
                                    buffer_dtype: torch.dtype | None = None,
                                    ) -> tuple[QuantizedTable, torch.Tensor]:
    """The transient-dense variant, plain PyTorch: sum the batch's gradients
    into an `[N, D]` buffer (f32, or the reference's bf16 buffer under
    `buffer_dtype=torch.bfloat16`: `train.optimizer.dense_buffer`), then
    dequantize, update and requantize under a mask of the named rows. Rows no
    id names keep their exact bytes. `ids_sorted` is the reference's hint;
    the sums do not depend on it. Returns new tensors."""
    from two_tower_recommender_model_tpu_torch.train.optimizer import dense_buffer

    del ids_sorted
    g, touched = dense_buffer(qt.shape[0], flat_ids, flat_grads, buffer_dtype)
    new_acc = torch.where(touched, acc + torch.mean(g * g, dim=1), acc)
    new_rows = dequantize_table(qt) - lr * g / (torch.sqrt(new_acc) + eps)[:, None]
    q, scales = quantize_rows(new_rows)
    return (QuantizedTable(torch.where(touched[:, None], q, qt.values),
                           torch.where(touched, scales, qt.scales)), new_acc)


def pick_quantized_update(num_rows: int, batch_slots: int):
    """The JAX package's size policy between the two plain updates: the
    transient-dense one when the batch names a sizable share of the table."""
    return (quantized_dense_rowwise_adagrad if num_rows <= 8 * batch_slots
            else quantized_rowwise_adagrad)
