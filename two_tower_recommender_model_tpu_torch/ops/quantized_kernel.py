"""The int8 tables' two kernels: their wrappers and their plain versions.

An int8 table is `values` `[N, D]` int8 plus `scales` `[N]` f32, the row's
absmax (`ops/quantized.py`): `row = float(values) * (scale / 127)`.

**The pooled gather** (`quantized_pooled_gather`, `csrc/quantized_gather.cu`),
port of the Pallas TPU kernel `ops/block_sorted.py:
block_sorted_lookup_quantized` (`_gather_kernel_quantized`):

    out[b, :] = sum_l w[b, l] * (float(values[ids[b, l]]) * (scales[ids[b, l]] / 127))

accumulated in f32, f32 or bf16 out. A slot whose id lies outside `[0, N)` or
whose weight is 0 contributes nothing. At one slot and weight 1 it is the
Pallas function (dequantized rows, zero rows for sentinels), for ids in any
order; at L slots it is `ops/quantized.py:quantized_pooled_lookup`. It
launches with the plan of `ops/gather_plan.py` (its 16-byte path or its
narrow one, bags a warp, block and grid).

**The fused row-wise Adagrad** (`quantized_rowwise_adagrad_fused`,
`csrc/quantized_adagrad.cu`), port of `ops/block_sorted.py:
block_sorted_rowwise_adagrad_fused_quantized`
(`_fused_update_kernel_quantized`): for each distinct live id whose summed
gradient is not zero in every column, dequantize the row, apply row-wise
Adagrad in f32, requantize with a fresh absmax; in place on `values`,
`scales` and `acc`. Every other row keeps its exact bytes, scale and
accumulator (requantizing is not idempotent). The ids MUST be non-decreasing
on CUDA tensors; `perm` makes the kernel read `grads[perm[j]]`. With
`buffer_dtype=torch.bfloat16` (the reference's `scatter_buffer_dtype=
"bfloat16"` on the sorted table, `quantized_dense_rowwise_adagrad`'s bf16
buffer) each run is summed in position order with a rounding to bf16 after
every add, and every named row is updated, also one whose sum is zero.

Each wrapper launches its hand-written kernel on CUDA tensors at any D
(a narrow D or alignment takes the kernel's scalar path: the gather's one
int8 a lane, the Adagrad's general walk), takes its plain version
(`*_reference`) only for tensors that lie on the CPU, and counts its kernel
launches in `.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from two_tower_recommender_model_tpu_torch.ops import _build
from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import (
    buffer_code,
    run_sums,
    span_scratch,
)
from two_tower_recommender_model_tpu_torch.ops.gather_plan import GatherKernel, GatherPlan

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_table(values: torch.Tensor, scales: torch.Tensor) -> None:
    if values.dim() != 2 or values.dtype != torch.int8:
        raise ValueError(f"values must be [N, D] int8, got {tuple(values.shape)} {values.dtype}")
    if scales.shape != (values.shape[0],) or scales.dtype != torch.float32:
        raise ValueError(f"scales must be [N] float32, got {tuple(scales.shape)} {scales.dtype}")


def _require(tensors: list[tuple[str, torch.Tensor]]) -> None:
    """One device, all contiguous."""
    if len({t.device for _, t in tensors}) != 1:
        raise ValueError(f"{', '.join(n for n, _ in tensors)} must share a device")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def dequantize_rows(values: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """`float(values) * (scales / 127)`: the division first, then one multiply.
    The divisor is a tensor on the scales' device: PyTorch divides a CUDA
    tensor by a Python number as a multiplication by its reciprocal, which
    rounds differently from the true division of the kernels, the CPU and the
    reference."""
    return values.to(torch.float32) * (scales / scales.new_full((), 127.0))[..., None]


def quantize_rows(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, f32 absmax scales) of f32 rows `[R, D]`:
    `clip(round(row / (scale > 0 ? scale : 1) * 127), -127, 127)`, the
    division before the multiply, round-half-to-even."""
    scales = rows.abs().amax(dim=1) if rows.shape[1] else rows.new_zeros(rows.shape[0])
    denom = torch.where(scales > 0, scales, 1.0)
    q = torch.clamp(torch.round(rows / denom[:, None] * 127.0), -127, 127).to(torch.int8)
    return q, scales


# --- the pooled gather ---------------------------------------------------------------


def quantized_pooled_gather_reference(values: torch.Tensor, scales: torch.Tensor,
                                      ids: torch.Tensor, w: torch.Tensor,
                                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain PyTorch version of the gather kernel: the same contract, f32
    sum over the bag axis, dead slots (id outside [0, N) or w == 0) masked."""
    n = values.shape[0]
    live = (ids >= 0) & (ids < n) & (w != 0)
    safe = torch.where(live, ids, 0).long()
    rows = dequantize_rows(values[safe], scales[safe])  # [B, L, D]
    contrib = torch.where(live[..., None], rows * w[..., None], 0.0)
    return contrib.sum(dim=1).to(out_dtype)


class QuantizedPooledGather(GatherKernel):
    """The int8 pooled-gather wrapper: checks its inputs, allocates the
    output and launches the CUDA kernel on the current stream (no sync).
    `launches` counts kernel launches and nothing else."""

    def __init__(self):
        super().__init__("quantized_pooled_gather", "ttrm_quantized_gather", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int64],
            source="quantized_gather.cu")

    @staticmethod
    def _check(values: torch.Tensor, scales: torch.Tensor, ids: torch.Tensor,
               w: torch.Tensor, out_dtype: torch.dtype) -> None:
        _check_table(values, scales)
        if ids.dim() != 2 or w.shape != ids.shape:
            raise ValueError(
                f"ids and w must both be [B, L], got {tuple(ids.shape)} and {tuple(w.shape)}")
        if ids.dtype != torch.int32 or w.dtype != torch.float32:
            raise TypeError(f"ids must be int32 and w float32, got {ids.dtype} and {w.dtype}")
        if out_dtype not in _DTYPE_CODES:
            raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
        _require([("values", values), ("scales", scales), ("ids", ids), ("w", w)])

    def __call__(self, values: torch.Tensor, scales: torch.Tensor, ids: torch.Tensor,
                 w: torch.Tensor, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
        self._check(values, scales, ids, w, out_dtype)
        if values.device.type == "cpu":
            return quantized_pooled_gather_reference(values, scales, ids, w, out_dtype)
        if values.device.type != "cuda":
            raise ValueError(f"quantized_pooled_gather runs on cpu or cuda tensors, got "
                             f"{values.device}")
        out = torch.empty((ids.shape[0], values.shape[1]), dtype=out_dtype, device=values.device)
        if out.numel():
            self._launch(out, values, scales, ids, w)
        return out

    def plan(self, values: torch.Tensor, ids: torch.Tensor, out: torch.Tensor) -> GatherPlan:
        """The launch plan for these tensors on their card."""
        return self.plan_for(values.device, (out.dtype,), *ids.shape, values.shape[1], 1,
                             (values.data_ptr() | out.data_ptr()) % 16 == 0)

    def _launch(self, out: torch.Tensor, values: torch.Tensor, scales: torch.Tensor,
                ids: torch.Tensor, w: torch.Tensor) -> None:
        """Launch into `out` ([B, D], contiguous, beside the table; it may
        start off a 16-byte boundary, which the plan sends down the narrow
        path)."""
        v, o, dev = values.data_ptr(), out.data_ptr(), values.device
        (n, d), (b, bag_l) = values.shape, ids.shape
        plan = self.plan_for(dev, (out.dtype,), b, bag_l, d, 1, (v | o) % 16 == 0)
        self.launch(dev, v, scales.data_ptr(), ids.data_ptr(), w.data_ptr(), o,
                    _DTYPE_CODES[out.dtype], n, d, b, bag_l, plan.walk, plan.bags_per_warp,
                    plan.warps_per_block, plan.blocks)


quantized_pooled_gather = QuantizedPooledGather()


# --- the fused row-wise Adagrad ------------------------------------------------------


@torch.no_grad()
def quantized_rowwise_adagrad_fused_reference(
        values: torch.Tensor, scales: torch.Tensor, acc: torch.Tensor, ids: torch.Tensor,
        grads: torch.Tensor, lr: float, eps: float = 1e-10, perm: torch.Tensor | None = None,
        buffer_dtype: torch.dtype | None = None):
    """The plain PyTorch version of the Adagrad kernel: the same contract, in
    place, for ids in any order (duplicates summed by `index_add_` in f32). A
    row whose summed gradient is zero in every column is not written, except
    under the bf16 buffer, which sums as the reference's and writes every
    named row."""
    g = grads if perm is None else grads[perm.long()]
    rows, g_sum = run_sums(ids, g, values.shape[0], buffer_dtype)
    named = buffer_dtype == torch.bfloat16
    return apply_rowwise_update(values, scales, acc, rows, g_sum, lr, eps, named)


@torch.no_grad()
def apply_rowwise_update(values: torch.Tensor, scales: torch.Tensor, acc: torch.Tensor,
                         rows: torch.Tensor, g_sum: torch.Tensor, lr: float, eps: float,
                         named: bool = False):
    """The update of distinct `rows` from their summed f32 gradients `g_sum`
    `[R, D]`, in place: a row whose sum is zero in every column is not
    written, unless `named`."""
    if not named:
        touched = (g_sum != 0).any(dim=1)
        rows, g_sum = rows[touched], g_sum[touched]
    new_acc = acc[rows] + (g_sum * g_sum).mean(dim=1)
    denom = torch.sqrt(new_acc) + eps
    new_rows = dequantize_rows(values[rows], scales[rows]) - lr * g_sum / denom[:, None]
    values[rows], scales[rows] = quantize_rows(new_rows)
    acc[rows] = new_acc
    return values, scales, acc


class QuantizedRowwiseAdagrad(_build.KernelLibrary):
    """The int8 row-wise Adagrad wrapper: checks its inputs, allocates the
    kernel's scratch (the pieces of runs longer than a warp's window, on the
    current stream, so a CUDA graph captures it) and launches the CUDA
    kernel's two passes on the current stream (no sync). `launches` counts
    calls that launch them and nothing else."""

    def __init__(self):
        super().__init__("quantized_rowwise_adagrad", "ttrm_quantized_adagrad", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
            ctypes.c_int], source="quantized_adagrad.cu")

    def __call__(self, values: torch.Tensor, scales: torch.Tensor, acc: torch.Tensor,
                 ids: torch.Tensor, grads: torch.Tensor, lr: float, eps: float = 1e-10,
                 perm: torch.Tensor | None = None, buffer_dtype: torch.dtype | None = None):
        """Update `values`, `scales` and `acc` in place; returns them.
        `buffer_dtype=torch.bfloat16` sums each run in the reference's bf16
        buffer and writes every named row."""
        _check_table(values, scales)
        n, d = values.shape
        if acc.shape != (n,) or acc.dtype != torch.float32:
            raise ValueError(f"acc must be [N] float32, got {tuple(acc.shape)} {acc.dtype}")
        if ids.dim() != 1 or ids.dtype != torch.int32:
            raise ValueError(f"ids must be [M] int32, got {tuple(ids.shape)} {ids.dtype}")
        m = ids.shape[0]
        if grads.dtype not in _DTYPE_CODES:
            raise TypeError(f"grads dtype must be float32 or bfloat16, got {grads.dtype}")
        if grads.dim() != 2 or grads.shape[1] != d or (perm is None and grads.shape[0] != m):
            raise ValueError(f"grads must be [M, D] = {(m, d)} ([*, D] under a permutation), "
                             f"got {tuple(grads.shape)}")
        tensors = [("values", values), ("scales", scales), ("acc", acc), ("ids", ids),
                   ("grads", grads)]
        if perm is not None:
            if perm.shape != (m,) or perm.dtype != torch.int32:
                raise ValueError(f"perm must be [M] int32, got {tuple(perm.shape)} {perm.dtype}")
            tensors.append(("perm", perm))
        _require(tensors)
        buf = buffer_code(buffer_dtype)
        if values.device.type == "cpu":
            return quantized_rowwise_adagrad_fused_reference(values, scales, acc, ids, grads, lr,
                                                             eps, perm, buffer_dtype)
        if values.device.type != "cuda":
            raise ValueError(f"quantized_rowwise_adagrad_fused runs on cpu or cuda tensors, got "
                             f"{values.device}")
        if values.numel() and m:
            part, part_id = span_scratch(m, d, values.device)
            self.launch(values.device, values.data_ptr(), scales.data_ptr(), acc.data_ptr(),
                        ids.data_ptr(), grads.data_ptr(), _DTYPE_CODES[grads.dtype],
                        None if perm is None else perm.data_ptr(), part.data_ptr(),
                        part_id.data_ptr(), part.shape[0], n, d, m, lr, eps, buf)
        return values, scales, acc


quantized_rowwise_adagrad_fused = QuantizedRowwiseAdagrad()
