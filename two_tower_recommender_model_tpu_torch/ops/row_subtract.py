"""In-place row subtract: the CUDA kernel's wrapper and its plain version.

Port of the Pallas TPU kernel `ops/pallas_update.py:pallas_row_subtract`
(`_apply_kernel`), the row apply of the sparse row-wise Adagrad:

    table[ids[j], :] -= updates[j, :]      for every j with 0 <= ids[j] < N

in place. Ids outside `[0, N)` are sentinels: skipped, neither read nor
written.

**The live ids must be distinct.** The kernel gives each position its own
warp and uses no atomics, so two positions naming one row would race (the
TPU kernel, being sequential, tolerated duplicates). The one caller,
`train/optimizer.py:pallas_sparse_rowwise_adagrad`, passes one id per segment
of equal ids, distinct by construction; with distinct ids the result is
deterministic and is one f32 subtraction per element.

`row_subtract` launches the hand-written kernel of `csrc/row_subtract.cu` on
CUDA tensors at any D (16-byte accesses where D % 4 == 0 and the pointers
allow them, else one element a lane) and takes `row_subtract_reference` only
for tensors that lie on the CPU. It counts its kernel launches in
`row_subtract.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from two_tower_recommender_model_tpu_torch.ops import _build


@torch.no_grad()
def row_subtract_reference(table: torch.Tensor, ids: torch.Tensor,
                           updates: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the same contract (distinct
    live ids), in place."""
    live = (ids >= 0) & (ids < table.shape[0])
    rows = ids[live].long()
    table[rows] = table[rows] - updates[live]
    return table


class RowSubtract(_build.KernelLibrary):
    """The row-subtract wrapper: checks its inputs and launches the CUDA
    kernel on the current stream (no sync, nothing allocated). `launches`
    counts kernel launches and nothing else."""

    def __init__(self):
        super().__init__("row_subtract", "ttrm_row_subtract", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64])

    def __call__(self, table: torch.Tensor, ids: torch.Tensor,
                 updates: torch.Tensor) -> torch.Tensor:
        """Update `table` in place; returns it. The live ids must be distinct."""
        if table.dim() != 2 or table.dtype != torch.float32:
            raise ValueError(f"table must be [N, D] float32, got {tuple(table.shape)} "
                             f"{table.dtype}")
        n, d = table.shape
        if ids.dim() != 1 or ids.dtype != torch.int32:
            raise ValueError(f"ids must be [M] int32, got {tuple(ids.shape)} {ids.dtype}")
        if updates.shape != (ids.shape[0], d) or updates.dtype != torch.float32:
            raise ValueError(f"updates must be [M, D] = {(ids.shape[0], d)} float32, got "
                             f"{tuple(updates.shape)} {updates.dtype}")
        if not (table.device == ids.device == updates.device):
            raise ValueError("table, ids and updates must share a device")
        for name, t in (("table", table), ("ids", ids), ("updates", updates)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if table.device.type == "cpu":
            return row_subtract_reference(table, ids, updates)
        if table.device.type != "cuda":
            raise ValueError(f"row_subtract runs on cpu or cuda tensors, got {table.device}")
        if table.numel() and ids.numel():
            self.launch(table.device, table.data_ptr(), ids.data_ptr(), updates.data_ptr(), n, d,
                        ids.shape[0])
        return table


row_subtract = RowSubtract()
