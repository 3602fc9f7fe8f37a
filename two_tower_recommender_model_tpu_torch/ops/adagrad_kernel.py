"""Fused row-wise Adagrad: the CUDA kernel's wrapper and its plain version.

Port of the Pallas TPU kernel
`ops/block_sorted.py:block_sorted_rowwise_adagrad_fused`
(`_fused_update_kernel`). For each distinct live id r (ids >= N are
sentinels: never read, never written):

    g_r       = sum over j with ids[j] == r of grads[j]     (f32)
    acc[r]   += mean(g_r ** 2)
    table[r] -= lr * g_r / (sqrt(acc[r]) + eps)

in place on `table` and `acc`. The gradients may be f32 or bf16 (bf16 is
widened and summed in f32). `perm`, when given, makes the kernel read
`grads[perm[j]]` for the j-th id, so the device-sort front-end needs no
permuted copy of the gradients.

`rowwise_adagrad` launches the hand-written kernel of
`csrc/rowwise_adagrad.cu` on CUDA tensors, whose ids MUST be non-decreasing
(the kernel gives each run of equal ids to one warp; unsorted ids would race),
and takes `rowwise_adagrad_reference` only for tensors that lie on the CPU. It
counts its kernel launches in `rowwise_adagrad.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from two_tower_recommender_model_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 512  # the kernel keeps a row's gradient in registers, 4 columns x 4 chunks a lane


def _check(table, acc, ids, grads, perm) -> None:
    if table.dim() != 2 or table.dtype != torch.float32:
        raise ValueError(f"table must be [N, D] float32, got {tuple(table.shape)} {table.dtype}")
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
    for ids in any order (duplicates summed by `index_add_` in f32)."""
    n = table.shape[0]
    g = (grads if perm is None else grads[perm.long()]).to(torch.float32)
    live = (ids >= 0) & (ids < n)
    rows, inv = torch.unique(ids[live].long(), return_inverse=True)
    g_sum = torch.zeros((rows.shape[0], table.shape[1]), dtype=torch.float32,
                        device=table.device).index_add_(0, inv, g[live])
    new_acc = acc[rows] + (g_sum * g_sum).mean(dim=1)
    denom = torch.sqrt(new_acc) + eps
    table[rows] = table[rows] - lr * g_sum / denom[:, None]
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
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.c_float])

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
        grad_align = 16 if grads.dtype == torch.float32 else 8
        if table.data_ptr() % 16 or grads.data_ptr() % grad_align:
            raise ValueError("the CUDA kernel needs a 16-byte aligned table and "
                             f"{grad_align}-byte aligned grads")
        self.launch(table.device, table.data_ptr(), acc.data_ptr(), ids.data_ptr(),
                    grads.data_ptr(), _DTYPE_CODES[grads.dtype],
                    None if perm is None else perm.data_ptr(), n, d, ids.shape[0], lr, eps)
        return table, acc


rowwise_adagrad = RowwiseAdagrad()
