"""Fused row-wise Adagrad and the dense aggregate: the CUDA kernels' wrappers
and their plain versions.

Port of the Pallas TPU kernel
`ops/block_sorted.py:block_sorted_rowwise_adagrad_fused`
(`_fused_update_kernel`). For each distinct live id r (ids >= N are
sentinels: never read, never written):

    g_r       = sum over j with ids[j] == r of grads[j]     (f32)
    acc[r]   += mean(g_r ** 2)
    table[r] -= lr * g_r / (sqrt(acc[r]) + eps)

in place on `table` and `acc`. The table may be f32 or bf16: a bf16 row is
widened, updated with the same f32 math and rounded to nearest even once, as
the reference's plain updates do (`new_rows.astype(table.dtype)`), and the
accumulator stays f32. The gradients may be f32 or bf16 (bf16 is
widened and summed in f32). `perm`, when given, makes the kernel read
`grads[perm[j]]` for the j-th id, so the device-sort front-end needs no
permuted copy of the gradients.

`rowwise_adagrad` launches the hand-written kernel of
`csrc/rowwise_adagrad.cu` on CUDA tensors, whose ids MUST be non-decreasing
(the kernel gives each run of equal ids to one warp; unsorted ids would race),
and takes `rowwise_adagrad_reference` only for tensors that lie on the CPU. It
counts its kernel launches in `rowwise_adagrad.launches`.

`block_sorted_aggregate` is the port of the Pallas TPU kernel
`ops/block_sorted.py:block_sorted_aggregate` (`_aggregate_kernel`): the dense
`[N, D]` f32 sum of `grads[j]` over `ids[j] == r`, exact zeros for rows no
live id names. Its kernel lives in the same source and shares the run
detection and the sum with the Adagrad kernel (`csrc/sorted_runs.cuh`); the
same rules hold (sorted ids on CUDA tensors, the plain version only on the
CPU, launches counted in `block_sorted_aggregate.launches`).
"""

from __future__ import annotations

import ctypes

import torch

from two_tower_recommender_model_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 512  # the kernel keeps a row's gradient in registers, 4 columns x 4 chunks a lane


def _check(table, acc, ids, grads, perm) -> None:
    if table.dim() != 2 or table.dtype not in _DTYPE_CODES:
        raise ValueError(f"table must be [N, D] float32 or bfloat16, got {tuple(table.shape)} "
                         f"{table.dtype}")
    n, d = table.shape
    if acc.shape != (n,) or acc.dtype != torch.float32:
        raise ValueError(f"acc must be [N] float32, got {tuple(acc.shape)} {acc.dtype}")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f"ids must be [M] int32, got {tuple(ids.shape)} {ids.dtype}")
    m = ids.shape[0]
    if grads.dtype not in _DTYPE_CODES:
        raise TypeError(f"grads dtype must be float32 or bfloat16, got {grads.dtype}")
    if perm is None and grads.shape != (m, d):
        raise ValueError(f"grads must be [M, D] = {(m, d)}, got {tuple(grads.shape)}")
    if perm is not None:
        if perm.shape != (m,) or perm.dtype != torch.int32:
            raise ValueError(f"perm must be [M] int32, got {tuple(perm.shape)} {perm.dtype}")
        if grads.dim() != 2 or grads.shape[1] != d:
            raise ValueError(f"grads must be [*, D={d}], got {tuple(grads.shape)}")
    tensors = [("table", table), ("acc", acc), ("ids", ids), ("grads", grads)]
    if perm is not None:
        tensors.append(("perm", perm))
    if len({t.device for _, t in tensors}) != 1:
        raise ValueError("table, acc, ids, grads and perm must share a device")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@torch.no_grad()
def rowwise_adagrad_reference(table: torch.Tensor, acc: torch.Tensor, ids: torch.Tensor,
                              grads: torch.Tensor, lr: float, eps: float = 1e-10,
                              perm: torch.Tensor | None = None):
    """The plain PyTorch version of the kernel: the same contract, in place,
    for ids in any order (duplicates summed by `index_add_` in f32); a bf16
    table's rows are widened, updated in f32 and rounded once."""
    n = table.shape[0]
    g = (grads if perm is None else grads[perm.long()]).to(torch.float32)
    live = (ids >= 0) & (ids < n)
    rows, inv = torch.unique(ids[live].long(), return_inverse=True)
    g_sum = torch.zeros((rows.shape[0], table.shape[1]), dtype=torch.float32,
                        device=table.device).index_add_(0, inv, g[live])
    new_acc = acc[rows] + (g_sum * g_sum).mean(dim=1)
    denom = torch.sqrt(new_acc) + eps
    table[rows] = (table[rows].float() - lr * g_sum / denom[:, None]).to(table.dtype)
    acc[rows] = new_acc
    return table, acc


class RowwiseAdagrad(_build.KernelLibrary):
    """The row-wise Adagrad wrapper: checks its inputs and launches the CUDA
    kernel on the current stream (no sync, nothing allocated).

    The library builds at the first launch (`load`). `launches` counts kernel
    launches and nothing else: a CPU call takes `rowwise_adagrad_reference`
    and does not count."""

    def __init__(self):
        super().__init__("rowwise_adagrad", "ttrm_rowwise_adagrad", [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float])

    def __call__(self, table: torch.Tensor, acc: torch.Tensor, ids: torch.Tensor,
                 grads: torch.Tensor, lr: float, eps: float = 1e-10,
                 perm: torch.Tensor | None = None):
        """Update `table` and `acc` in place; returns them."""
        _check(table, acc, ids, grads, perm)
        if table.device.type == "cpu":
            return rowwise_adagrad_reference(table, acc, ids, grads, lr, eps, perm)
        if table.device.type != "cuda":
            raise ValueError(f"rowwise_adagrad runs on cpu or cuda tensors, got {table.device}")
        n, d = table.shape
        if d % 4 or d > MAX_DIM:
            raise ValueError(f"the CUDA kernel needs D % 4 == 0 and D <= {MAX_DIM}, got D={d}")
        table_align = 16 if table.dtype == torch.float32 else 8
        grad_align = 16 if grads.dtype == torch.float32 else 8
        if table.data_ptr() % table_align or grads.data_ptr() % grad_align:
            raise ValueError(f"the CUDA kernel needs a {table_align}-byte aligned table and "
                             f"{grad_align}-byte aligned grads")
        self.launch(table.device, table.data_ptr(), _DTYPE_CODES[table.dtype], acc.data_ptr(),
                    ids.data_ptr(), grads.data_ptr(), _DTYPE_CODES[grads.dtype],
                    None if perm is None else perm.data_ptr(), n, d, ids.shape[0], lr, eps)
        return table, acc


rowwise_adagrad = RowwiseAdagrad()


def block_sorted_aggregate_reference(table_rows: int, sids: torch.Tensor,
                                     grads: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the aggregate kernel: `[table_rows, D]`
    f32, ids in any order, ids outside `[0, table_rows)` dropped."""
    live = (sids >= 0) & (sids < table_rows)
    return torch.zeros((table_rows, grads.shape[1]), dtype=torch.float32,
                       device=grads.device).index_add_(0, sids[live].long(),
                                                       grads[live].to(torch.float32))


class BlockSortedAggregate(_build.KernelLibrary):
    """The dense-aggregate wrapper: checks its inputs, allocates the zeroed
    `[N, D]` f32 output and launches the CUDA kernel on the current stream (no
    sync). `launches` counts kernel launches and nothing else."""

    def __init__(self):
        super().__init__("block_sorted_aggregate", "ttrm_sorted_aggregate", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64], source="rowwise_adagrad.cu")

    def __call__(self, table_rows: int, sids: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
        """`[table_rows, D]` f32: each run of equal ids summed into its row.
        `sids` `[M]` int32 must be non-decreasing on CUDA tensors (sentinels
        >= `table_rows` last); `grads` `[M, D]` f32 or bf16."""
        if sids.dim() != 1 or sids.dtype != torch.int32:
            raise ValueError(f"sids must be [M] int32, got {tuple(sids.shape)} {sids.dtype}")
        if grads.dtype not in _DTYPE_CODES:
            raise TypeError(f"grads dtype must be float32 or bfloat16, got {grads.dtype}")
        if grads.dim() != 2 or grads.shape[0] != sids.shape[0]:
            raise ValueError(f"grads must be [M={sids.shape[0]}, D], got {tuple(grads.shape)}")
        if grads.device != sids.device:
            raise ValueError("sids and grads must share a device")
        if not (sids.is_contiguous() and grads.is_contiguous()):
            raise ValueError("sids and grads must be contiguous")
        if grads.device.type == "cpu":
            return block_sorted_aggregate_reference(table_rows, sids, grads)
        if grads.device.type != "cuda":
            raise ValueError(f"block_sorted_aggregate runs on cpu or cuda tensors, got "
                             f"{grads.device}")
        d = grads.shape[1]
        if d % 4 or d > MAX_DIM:
            raise ValueError(f"the CUDA kernel needs D % 4 == 0 and D <= {MAX_DIM}, got D={d}")
        grad_align = 16 if grads.dtype == torch.float32 else 8
        if grads.data_ptr() % grad_align:
            raise ValueError(f"the CUDA kernel needs {grad_align}-byte aligned grads")
        out = torch.zeros((table_rows, d), dtype=torch.float32, device=grads.device)
        if out.numel() and sids.numel():
            self.launch(grads.device, out.data_ptr(), sids.data_ptr(), grads.data_ptr(),
                        _DTYPE_CODES[grads.dtype], table_rows, d, sids.shape[0])
        return out


block_sorted_aggregate = BlockSortedAggregate()
