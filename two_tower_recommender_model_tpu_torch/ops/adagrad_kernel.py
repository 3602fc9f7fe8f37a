"""Fused row-wise Adagrad and the dense aggregate: the CUDA kernels' wrappers
and their plain versions.

Port of the Pallas TPU kernel
`ops/block_sorted.py:block_sorted_rowwise_adagrad_fused`
(`_fused_update_kernel`). For each distinct live id r (ids >= N are
sentinels: never read, never written):

    g_r       = sum over j with ids[j] == r of grads[j]     (f32)
    acc[r]   += mean(g_r ** 2)
    table[r] -= lr * g_r / (sqrt(acc[r]) + eps)

in place on `table` and `acc`. With `buffer_dtype=torch.bfloat16` (the
reference's `scatter_buffer_dtype="bfloat16"` on the host-sorted table) g_r
is instead the reference's bf16 aggregation buffer: each run of equal ids
summed in position order, rounded to bf16 after every add
(`acc = bf16(f32(acc) + f32(bf16(g_j)))`, from 0; `bf16_buffer_sums`), and
that sum widened to f32 for the update. The table may be f32 or bf16: a bf16 row is
widened, updated with the same f32 math and rounded to nearest even once, as
the reference's plain updates do (`new_rows.astype(table.dtype)`), and the
accumulator stays f32. The gradients may be f32 or bf16 (bf16 is
widened and summed in f32). `perm`, when given, makes the kernel read
`grads[perm[j]]` for the j-th id, so the device-sort front-end needs no
permuted copy of the gradients.

`rowwise_adagrad` launches the hand-written kernel of
`csrc/rowwise_adagrad.cu` on CUDA tensors, whose ids MUST be non-decreasing
(the kernel gives each run of equal ids one owner; unsorted ids would race),
and takes `rowwise_adagrad_reference` only for tensors that lie on the CPU. It
counts its kernel launches in `rowwise_adagrad.launches`.

`block_sorted_aggregate` is the port of the Pallas TPU kernel
`ops/block_sorted.py:block_sorted_aggregate` (`_aggregate_kernel`): the dense
`[N, D]` f32 sum of `grads[j]` over `ids[j] == r`, exact zeros for rows no
live id names; with `perm` the j-th id's row is `grads[perm[j]]` (the
ranker's table gradient passes its stable device sort's permutation). With
`buffer_dtype=torch.bfloat16` it is the bf16 table's gradient of plain
autodiff (the reference's bf16 scatter-add, the ranker's bf16 tables): a
`[N, D]` bf16 output, each id's rows summed in the bf16 buffer's order. Its
kernel lives in the same source; the same rules hold (sorted ids on CUDA
tensors, the plain version only on the CPU, launches counted in
`block_sorted_aggregate.launches`).

Both kernels (and the int8 one of `quantized_kernel.py`) walk the sorted ids
in spans of `SPAN` positions (`csrc/sorted_runs.cuh`): a run longer than a
warp's window is summed in pieces by many warps and finished by a second
pass, which needs the scratch of `span_scratch`. A wrapper call launches both
passes and counts one launch. Every D >= 1 runs on the card: the kernels
take D % 4 == 0 up to 512 with the pointers aligned for four-element
accesses on the half-warp walk, which holds a run's row in registers, and
every other D or alignment on the general walk, which sums a run a column
slice at a time into a scratch row a warp.
"""

from __future__ import annotations

import ctypes

import torch

from two_tower_recommender_model_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # also the buffer codes
SPAN = 32  # sorted positions per warp of the span walk (`kSpan` in csrc/sorted_runs.cuh)


def span_split(n_spans: int) -> int:
    """Warps a span in pass 1 (`make_walk` in csrc/sorted_runs.cuh)."""
    split = 1
    while split < 16 and n_spans * split < 2048:
        split *= 2
    return split


def span_scratch(m: int, d: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The span walk's scratch for M sorted ids of D columns: `[rows, D]` f32
    and `[2 * spans]` int32 ids, two rows a span (a long run's first piece,
    a later one) and, for the general walk, one row a warp of its pass 1
    (where a run is summed; spans x `span_split` rows, at most 16 a span: a
    few MB, so it is there whichever walk the kernel takes for D and the
    pointers). Allocated on the current stream, so a CUDA graph captures
    it; the kernels write every row they read."""
    spans = -(-m // SPAN)
    return (torch.empty((2 * spans + spans * span_split(spans), d), dtype=torch.float32,
                        device=device),
            torch.empty(2 * spans, dtype=torch.int32, device=device))


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


def buffer_code(buffer_dtype: torch.dtype | None) -> int:
    """The kernels' code of an aggregation buffer dtype: None and f32 sum in
    f32, bf16 is the reference's bf16 buffer."""
    if buffer_dtype is None:
        return _DTYPE_CODES[torch.float32]
    if buffer_dtype not in _DTYPE_CODES:
        raise ValueError(f"buffer_dtype must be None, float32 or bfloat16, got {buffer_dtype}")
    return _DTYPE_CODES[buffer_dtype]


@torch.no_grad()
def bf16_buffer_sums(ids: torch.Tensor, grads: torch.Tensor,
                     n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's bf16 aggregation buffer, `zeros((n, D), bf16).at[ids]
    .add(grads.astype(bf16))`, which XLA sums in position order with a
    rounding after every add: for each distinct live id (in [0, n)), in
    ascending order, `acc = bf16(f32(acc) + f32(bf16(g_j)))` from 0 over its
    positions j. Returns (rows [R] int64, sums [R, D] f32).

    The loop runs over the rank of a position within its id's positions, not
    over positions: step k adds every id's k-th gradient at once (the rows of
    a step are distinct), so it takes as many steps as the longest run."""
    live = (ids >= 0) & (ids < n)
    idx = ids[live].long()
    g = grads[live].to(torch.bfloat16)
    rows, inv = torch.unique(idx, return_inverse=True)
    order = torch.argsort(inv, stable=True)
    counts = torch.bincount(inv, minlength=rows.shape[0])
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(inv)
    rank[order] = torch.arange(inv.shape[0], device=ids.device) - starts[inv[order]]
    by_rank = torch.argsort(rank, stable=True)
    buf = torch.zeros((rows.shape[0], grads.shape[1]), dtype=torch.bfloat16, device=ids.device)
    off = 0
    for c in torch.bincount(rank).tolist():
        sel = by_rank[off:off + c]
        off += c
        r = inv[sel]
        buf[r] = (buf[r].float() + g[sel].float()).bfloat16()
    return rows, buf.float()


@torch.no_grad()
def run_sums(ids: torch.Tensor, grads: torch.Tensor, n: int,
             buffer_dtype: torch.dtype | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows [R] int64, their summed gradients [R, D] f32) for the distinct
    live ids, ascending: an f32 `index_add_` (duplicates in position order),
    or with `buffer_dtype=torch.bfloat16` the bf16 buffer's sums."""
    if buffer_code(buffer_dtype) == _DTYPE_CODES[torch.bfloat16]:
        return bf16_buffer_sums(ids, grads, n)
    live = (ids >= 0) & (ids < n)
    rows, inv = torch.unique(ids[live].long(), return_inverse=True)
    return rows, torch.zeros((rows.shape[0], grads.shape[1]), dtype=torch.float32,
                             device=grads.device).index_add_(0, inv,
                                                             grads[live].to(torch.float32))


@torch.no_grad()
def rowwise_adagrad_reference(table: torch.Tensor, acc: torch.Tensor, ids: torch.Tensor,
                              grads: torch.Tensor, lr: float, eps: float = 1e-10,
                              perm: torch.Tensor | None = None,
                              buffer_dtype: torch.dtype | None = None):
    """The plain PyTorch version of the kernel: the same contract, in place,
    for ids in any order (duplicates summed by `index_add_` in f32, or in the
    bf16 buffer); a bf16 table's rows are widened, updated in f32 and
    rounded once."""
    g = grads if perm is None else grads[perm.long()]
    rows, g_sum = run_sums(ids, g, table.shape[0], buffer_dtype)
    new_acc = acc[rows] + (g_sum * g_sum).mean(dim=1)
    denom = torch.sqrt(new_acc) + eps
    table[rows] = (table[rows].float() - lr * g_sum / denom[:, None]).to(table.dtype)
    acc[rows] = new_acc
    return table, acc


class RowwiseAdagrad(_build.KernelLibrary):
    """The row-wise Adagrad wrapper: checks its inputs, allocates the span
    walk's scratch and launches the CUDA kernel's two passes on the current
    stream (no sync).

    The library builds at the first launch (`load`). `launches` counts calls
    that launch the kernel and nothing else: a CPU call takes
    `rowwise_adagrad_reference` and does not count."""

    def __init__(self):
        super().__init__("rowwise_adagrad", "ttrm_rowwise_adagrad", [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
            ctypes.c_int])

    def __call__(self, table: torch.Tensor, acc: torch.Tensor, ids: torch.Tensor,
                 grads: torch.Tensor, lr: float, eps: float = 1e-10,
                 perm: torch.Tensor | None = None, buffer_dtype: torch.dtype | None = None):
        """Update `table` and `acc` in place; returns them. `buffer_dtype=
        torch.bfloat16` sums each run in the reference's bf16 buffer."""
        _check(table, acc, ids, grads, perm)
        buf = buffer_code(buffer_dtype)
        if table.device.type == "cpu":
            return rowwise_adagrad_reference(table, acc, ids, grads, lr, eps, perm, buffer_dtype)
        if table.device.type != "cuda":
            raise ValueError(f"rowwise_adagrad runs on cpu or cuda tensors, got {table.device}")
        n, d = table.shape
        m = ids.shape[0]
        if n and m:
            part, part_id = span_scratch(m, d, table.device)
            self.launch(table.device, table.data_ptr(), _DTYPE_CODES[table.dtype],
                        acc.data_ptr(), ids.data_ptr(), grads.data_ptr(),
                        _DTYPE_CODES[grads.dtype], None if perm is None else perm.data_ptr(),
                        part.data_ptr(), part_id.data_ptr(), part.shape[0], n, d, m, lr, eps,
                        buf)
        return table, acc


rowwise_adagrad = RowwiseAdagrad()


def block_sorted_aggregate_reference(table_rows: int, sids: torch.Tensor, grads: torch.Tensor,
                                     perm: torch.Tensor | None = None,
                                     buffer_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The plain PyTorch version of the aggregate kernel: `[table_rows, D]`
    f32, ids in any order, ids outside `[0, table_rows)` dropped; the j-th
    id's row is `grads[perm[j]]` when `perm` is given. With `buffer_dtype=
    torch.bfloat16` the output is bf16: each id's rows summed in position
    order from bf16 zero, rounded to bf16 after every add
    (`bf16_buffer_sums`)."""
    if perm is not None:
        grads = grads[perm.long()]
    if buffer_code(buffer_dtype) == _DTYPE_CODES[torch.bfloat16]:
        rows, sums = bf16_buffer_sums(sids, grads, table_rows)
        out = torch.zeros((table_rows, grads.shape[1]), dtype=torch.bfloat16,
                          device=grads.device)
        out[rows] = sums.to(torch.bfloat16)
        return out
    live = (sids >= 0) & (sids < table_rows)
    return torch.zeros((table_rows, grads.shape[1]), dtype=torch.float32,
                       device=grads.device).index_add_(0, sids[live].long(),
                                                       grads[live].to(torch.float32))


class BlockSortedAggregate(_build.KernelLibrary):
    """The dense-aggregate wrapper: checks its inputs, allocates the zeroed
    `[N, D]` output (f32, or bf16 in the bf16 buffer's mode) and the span
    walk's scratch and launches the CUDA kernel's two passes on the current
    stream (no sync). `launches` counts calls that launch the kernel and
    nothing else; `bf16_launches` those of them in the bf16 mode."""

    def __init__(self):
        super().__init__("block_sorted_aggregate", "ttrm_sorted_aggregate", [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64], source="rowwise_adagrad.cu")
        self.bf16_launches = 0

    def __call__(self, table_rows: int, sids: torch.Tensor, grads: torch.Tensor,
                 perm: torch.Tensor | None = None,
                 buffer_dtype: torch.dtype | None = None) -> torch.Tensor:
        """`[table_rows, D]` f32: each run of equal ids summed into its row;
        with `buffer_dtype=torch.bfloat16` `[table_rows, D]` bf16, each run
        summed in position order with a rounding to bf16 after every add (the
        reference's bf16 scatter-add). `sids` `[M]` int32 must be
        non-decreasing on CUDA tensors (sentinels >= `table_rows` last);
        `grads` `[M, D]` f32 or bf16, or `[*, D]` read as `grads[perm[j]]`
        under `perm` `[M]` int32."""
        if sids.dim() != 1 or sids.dtype != torch.int32:
            raise ValueError(f"sids must be [M] int32, got {tuple(sids.shape)} {sids.dtype}")
        m = sids.shape[0]
        if grads.dtype not in _DTYPE_CODES:
            raise TypeError(f"grads dtype must be float32 or bfloat16, got {grads.dtype}")
        if grads.dim() != 2 or (perm is None and grads.shape[0] != m):
            raise ValueError(f"grads must be [M={m}, D] ([*, D] under a permutation), got "
                             f"{tuple(grads.shape)}")
        buf = buffer_code(buffer_dtype)
        tensors = [sids, grads]
        if perm is not None:
            if perm.shape != (m,) or perm.dtype != torch.int32:
                raise ValueError(f"perm must be [M] int32, got {tuple(perm.shape)} {perm.dtype}")
            tensors.append(perm)
        if len({t.device for t in tensors}) != 1:
            raise ValueError("sids, grads and perm must share a device")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("sids, grads and perm must be contiguous")
        if grads.device.type == "cpu":
            return block_sorted_aggregate_reference(table_rows, sids, grads, perm, buffer_dtype)
        if grads.device.type != "cuda":
            raise ValueError(f"block_sorted_aggregate runs on cpu or cuda tensors, got "
                             f"{grads.device}")
        d = grads.shape[1]
        out_dtype = torch.bfloat16 if buf == _DTYPE_CODES[torch.bfloat16] else torch.float32
        out = torch.zeros((table_rows, d), dtype=out_dtype, device=grads.device)
        if out.numel() and m:
            part, part_id = span_scratch(m, d, grads.device)
            self.launch(grads.device, out.data_ptr(), buf, sids.data_ptr(), grads.data_ptr(),
                        _DTYPE_CODES[grads.dtype], None if perm is None else perm.data_ptr(),
                        part.data_ptr(), part_id.data_ptr(), part.shape[0], table_rows, d, m)
            if out_dtype == torch.bfloat16:
                self.bf16_launches += 1
        return out


block_sorted_aggregate = BlockSortedAggregate()
