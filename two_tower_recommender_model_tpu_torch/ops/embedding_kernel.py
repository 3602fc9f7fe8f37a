"""Pooled embedding gather: the CUDA kernel's wrapper and its plain version.

Port of the Pallas TPU kernel `ops/pallas_embedding.py:pallas_pooled_lookup`
(`_pooled_kernel`):

    out[b, :] = sum_l w[b, l] * table[ids[b, l], :]

accumulated in float32. A slot whose id lies outside `[0, N)` or whose weight
is 0 contributes nothing (the sentinel contract of `ops/block_sorted.py`), so
with one slot and weight 1 this is also `block_sorted_lookup`: `table[ids]`
with zero rows for sentinel ids.

`round_rows=True` rounds each row to the output dtype before it is weighted
and added (f32 rows into a bf16 output; no other pair changes): with the
slot mask as the weights, the bag's bf16 rows summed in f32 in slot order and
rounded once, which is how the reference pools a bag under bf16 compute
(`ops/embedding_ops.py:67-75`).

`pooled_gather` launches the hand-written kernel of `csrc/pooled_gather.cu`
on a CUDA tensor, with the launch plan of `ops/gather_plan.py` (its 16-byte
path or its narrow one, bags a warp, block and grid), and takes
`pooled_gather_reference` only for a tensor that lies on the CPU. It counts
its kernel launches in `pooled_gather.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from two_tower_recommender_model_tpu_torch.ops.gather_plan import DTYPE_CODES as _DTYPE_CODES
from two_tower_recommender_model_tpu_torch.ops.gather_plan import GatherKernel, GatherPlan


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
                            out_dtype: torch.dtype | None = None,
                            round_rows: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the kernel: same contract, f32 sum over
    the bag axis, dead slots (id outside [0, N) or w == 0) masked out. With
    `round_rows` each row is rounded to the output dtype first and the slots
    are added in slot order from 0, the kernel's order (bit for bit the
    kernel's fma where the weights are 0 or 1, as the lookup passes them)."""
    out_dtype = out_dtype or table.dtype
    n = table.shape[0]
    live = (ids >= 0) & (ids < n) & (w != 0)
    rows = table[torch.where(live, ids, 0).long()].float()  # [B, L, D]
    if round_rows:
        rows = rows.to(out_dtype).float()
    contrib = torch.where(live[..., None], rows * w[..., None], 0.0)
    if not round_rows:
        return contrib.sum(dim=1).to(out_dtype)
    acc = torch.zeros((ids.shape[0], table.shape[1]), dtype=torch.float32, device=table.device)
    for slot in range(ids.shape[1]):
        acc = acc + contrib[:, slot]
    return acc.to(out_dtype)


class PooledGather(GatherKernel):
    """The pooled-gather wrapper: checks its inputs, allocates the output,
    and launches the CUDA kernel on the current stream (no sync).

    The library builds at the first launch (`load`). `launches` counts kernel
    launches and nothing else: a CPU call takes `pooled_gather_reference`
    and does not count."""

    def __init__(self):
        super().__init__("pooled_gather", "ttrm_pooled_gather", [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int64])

    def __call__(self, table: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
                 out_dtype: torch.dtype | None = None, round_rows: bool = False) -> torch.Tensor:
        out_dtype = out_dtype or table.dtype
        _check(table, ids, w, out_dtype)
        if table.device.type == "cpu":
            return pooled_gather_reference(table, ids, w, out_dtype, round_rows)
        if table.device.type != "cuda":
            raise ValueError(f"pooled_gather runs on cpu or cuda tensors, got {table.device}")
        out = torch.empty((ids.shape[0], table.shape[1]), dtype=out_dtype, device=table.device)
        if out.numel():
            self._launch(out, table, ids, w, round_rows)
        return out

    @staticmethod
    def _mode(table: torch.Tensor, out: torch.Tensor, round_rows: bool) -> tuple:
        """The entry point's (table, output, round_rows) codes: the flag is
        set only where it rounds (f32 rows into bf16), so another pair keeps
        its one kernel and plan."""
        rounds = round_rows and table.dtype == torch.float32 and out.dtype == torch.bfloat16
        return table.dtype, out.dtype, int(rounds)

    def blocks_per_sm(self, device: torch.device, table_dtype: torch.dtype,
                      out_dtype: torch.dtype, round_rows: bool = False) -> dict:
        rounds = round_rows and (table_dtype, out_dtype) == (torch.float32, torch.bfloat16)
        return super().blocks_per_sm(device, table_dtype, out_dtype, int(rounds))

    def plan(self, table: torch.Tensor, ids: torch.Tensor, out: torch.Tensor,
             round_rows: bool = False) -> GatherPlan:
        """The launch plan for these tensors on their card."""
        return self.plan_for(table.device, self._mode(table, out, round_rows), *ids.shape,
                             table.shape[1], table.element_size(),
                             (table.data_ptr() | out.data_ptr()) % 16 == 0)

    def _launch(self, out: torch.Tensor, table: torch.Tensor, ids: torch.Tensor,
                w: torch.Tensor, round_rows: bool = False) -> None:
        """Launch into `out` ([B, D], contiguous, beside the table; it may
        start off a 16-byte boundary, which the plan sends down the narrow
        path)."""
        t, o, dev = table.data_ptr(), out.data_ptr(), table.device
        (n, d), (b, bag_l) = table.shape, ids.shape
        mode = self._mode(table, out, round_rows)
        plan = self.plan_for(dev, mode, b, bag_l, d, table.element_size(), (t | o) % 16 == 0)
        self.launch(dev, t, _DTYPE_CODES[table.dtype], ids.data_ptr(), w.data_ptr(), o,
                    _DTYPE_CODES[out.dtype], mode[2], n, d, b, bag_l, plan.walk,
                    plan.bags_per_warp, plan.warps_per_block, plan.blocks)


pooled_gather = PooledGather()
