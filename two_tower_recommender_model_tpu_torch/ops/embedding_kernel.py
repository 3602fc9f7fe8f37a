"""Pooled embedding gather: the CUDA kernel's wrapper and its plain version.

Port of the Pallas TPU kernel `ops/pallas_embedding.py:pallas_pooled_lookup`
(`_pooled_kernel`):

    out[b, :] = sum_l w[b, l] * table[ids[b, l], :]

accumulated in float32. A slot whose id lies outside `[0, N)` or whose weight
is 0 contributes nothing (the sentinel contract of `ops/block_sorted.py`), so
with one slot and weight 1 this is also `block_sorted_lookup`: `table[ids]`
with zero rows for sentinel ids.

`pooled_gather` launches the hand-written kernel of `csrc/pooled_gather.cu`
on a CUDA tensor, and takes `pooled_gather_reference` only for a tensor that
lies on the CPU. It counts its kernel launches in `pooled_gather.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from two_tower_recommender_model_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(table: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
           out_dtype: torch.dtype) -> None:
    if table.dim() != 2:
        raise ValueError(f"table must be [N, D], got shape {tuple(table.shape)}")
    if ids.dim() != 2 or w.shape != ids.shape:
        raise ValueError(
            f"ids and w must both be [B, L], got {tuple(ids.shape)} and {tuple(w.shape)}")
    if table.dtype not in _DTYPE_CODES:
        raise TypeError(f"table dtype must be float32 or bfloat16, got {table.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if not (table.device == ids.device == w.device):
        raise ValueError(
            f"table, ids and w must share a device, got {table.device}, {ids.device}, {w.device}")
    for name, t in (("table", table), ("ids", ids), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def pooled_gather_reference(table: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
                            out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: same contract, f32 sum over
    the bag axis, dead slots (id outside [0, N) or w == 0) masked out."""
    n = table.shape[0]
    live = (ids >= 0) & (ids < n) & (w != 0)
    rows = table[torch.where(live, ids, 0).long()].float()  # [B, L, D]
    contrib = torch.where(live[..., None], rows * w[..., None], 0.0)
    return contrib.sum(dim=1).to(out_dtype or table.dtype)


class PooledGather(_build.KernelLibrary):
    """The pooled-gather wrapper: checks its inputs, allocates the output,
    and launches the CUDA kernel on the current stream (no sync).

    The library builds at the first launch (`load`). `launches` counts kernel
    launches and nothing else: a CPU call takes `pooled_gather_reference`
    and does not count."""

    def __init__(self):
        super().__init__("pooled_gather", "ttrm_pooled_gather", [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64])

    def __call__(self, table: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
        out_dtype = out_dtype or table.dtype
        _check(table, ids, w, out_dtype)
        if table.device.type == "cpu":
            return pooled_gather_reference(table, ids, w, out_dtype)
        if table.device.type != "cuda":
            raise ValueError(f"pooled_gather runs on cpu or cuda tensors, got {table.device}")
        b, bag_l = ids.shape
        n, d = table.shape
        out = torch.empty((b, d), dtype=out_dtype, device=table.device)
        if out.numel() == 0:
            return out
        self.launch(table.device, table.data_ptr(), _DTYPE_CODES[table.dtype], ids.data_ptr(),
                    w.data_ptr(), out.data_ptr(), _DTYPE_CODES[out_dtype], n, d, b, bag_l)
        return out


pooled_gather = PooledGather()
