"""Fused in-batch sampled softmax: the CUDA kernels' wrappers, their plain
versions and the loss built on them.

Port of `two_tower_recommender_model_tpu/ops/softmax_kernel.py`. The score
matrix of a batch against itself,

    s_ij = (q_i . c_j) / T - log_q_j,   -1e9 on padded columns (j >= n_valid)
                                        and on accidental hits (same item id
                                        as row i's positive, off its column),

has B^2 entries (4.3e9 at B = 65,536), so it is never written to device
memory: kernel #9 streams it through an online logsumexp, kernels #10 and #11
recompute it for dq and dc. The positive score s_i,pos is a row-wise dot in
plain PyTorch outside the kernels (`lse_and_pos`), and autograd gives its
gradient. The kernels are rectangular: q is [BQ, D], c is [BK, D], BQ <= BK,
and q row i has the global row index `row_offset + i` (the column of its
positive), so one stripe of a data-parallel split runs the same kernels.

Rounding points, the reference's: q and c are rounded to bf16 once; every
product of a score is bf16 x bf16 summed in f32; times 1/T, minus the merged
adjustment (logQ plus 1e9 on padded columns), then the duplicate mask; in the
backward p = exp(s - lse) * g is rounded to bf16 before the second product,
which sums in f32 and is multiplied by 1/T once.

`softmax_lse_fwd`, `softmax_lse_dq` and `softmax_lse_dc` launch the
hand-written kernels of `csrc/softmax_lse.cu` on CUDA tensors and take
`lse_forward_reference` / `lse_backward_reference` only for tensors that lie
on the CPU; each counts its kernel launches in `.launches`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from two_tower_recommender_model_tpu_torch.ops import _build

NEG = -1e9
MAX_DIM = 128  # the kernels hold a [rows, D] f32 accumulator in registers
_PLAIN_BLOCK = 1 << 24  # most score elements the plain versions hold at once


def softmax_kernel_shapes_ok(bk: int, d: int, bq: int | None = None) -> bool:
    """Shapes the fused kernels take: the reference's rule for the batch dims
    (128-divisible, q rows may be a stripe of the columns), and an embedding
    dim of at most 128 where the reference allows 2,048: the CUDA kernels
    keep a thread's share of a [rows, D] accumulator in registers. D itself
    need not be aligned: the wrappers zero-pad it to 64 or 128."""
    if bq is None:
        bq = bk
    return (bk % 128 == 0 and bk >= 256 and bq % 128 == 0 and bq >= 128
            and bk % bq == 0 and 0 < d <= MAX_DIM)


def _scores(qf: torch.Tensor, cf: torch.Tensor, adj, row_ids, col_ids, rows: torch.Tensor,
            cols: torch.Tensor, inv_t: float) -> torch.Tensor:
    """The adjusted scores of a block of q rows against every column."""
    s = (qf @ cf.T) * inv_t
    if adj is not None:
        s = s - adj[None, :]
    if row_ids is not None:
        dup = row_ids[:, None] == col_ids[None, :]
        s = s.masked_fill(dup & (rows[:, None] != cols[None, :]), NEG)
    return s


def _row_blocks(bq: int, bk: int):
    r = max(1, _PLAIN_BLOCK // bk)
    return [(lo, min(lo + r, bq)) for lo in range(0, bq, r)]


@torch.no_grad()
def lse_forward_reference(q16: torch.Tensor, c16: torch.Tensor, adj: torch.Tensor | None,
                          row_ids: torch.Tensor | None, col_ids: torch.Tensor | None,
                          row_offset: int, inv_t: float) -> torch.Tensor:
    """The plain PyTorch version of kernel #9: lse [BQ] f32. Row blocks of at
    most 2^24 scores, f32 products of the bf16 values (each exact in f32, so
    only the order of the sums differs from the kernel), the running max
    started at -1e9 as the kernel's is."""
    qf, cf = q16.float(), c16.float()
    bq, bk = qf.shape[0], cf.shape[0]
    cols = torch.arange(bk, device=qf.device)
    out = torch.empty(bq, dtype=torch.float32, device=qf.device)
    for lo, hi in _row_blocks(bq, bk):
        s = _scores(qf[lo:hi], cf, adj, None if row_ids is None else row_ids[lo:hi], col_ids,
                    cols[lo:hi] + row_offset, cols, inv_t)
        m = s.max(dim=1).values.clamp_min(NEG)
        out[lo:hi] = m + torch.log(torch.exp(s - m[:, None]).sum(dim=1))
    return out


@torch.no_grad()
def lse_backward_reference(q16: torch.Tensor, c16: torch.Tensor, adj: torch.Tensor | None,
                           row_ids: torch.Tensor | None, col_ids: torch.Tensor | None,
                           row_offset: int, inv_t: float, lse: torch.Tensor, g: torch.Tensor,
                           need_dq: bool = True, need_dc: bool = True):
    """The plain PyTorch version of kernels #10 and #11: (dq [BQ, D],
    dc [BK, D]) in f32, None for the one not asked for. The scores are
    recomputed per row block, p is rounded to bf16 before the second product."""
    qf, cf = q16.float(), c16.float()
    bq, bk = qf.shape[0], cf.shape[0]
    cols = torch.arange(bk, device=qf.device)
    dq = torch.empty_like(qf) if need_dq else None
    dc = torch.zeros_like(cf) if need_dc else None
    for lo, hi in _row_blocks(bq, bk):
        s = _scores(qf[lo:hi], cf, adj, None if row_ids is None else row_ids[lo:hi], col_ids,
                    cols[lo:hi] + row_offset, cols, inv_t)
        p = (torch.exp(s - lse[lo:hi, None]) * g[lo:hi, None]).to(torch.bfloat16).float()
        if need_dq:
            dq[lo:hi] = (p @ cf) * inv_t
        if need_dc:
            dc += p.T @ qf[lo:hi]
    if need_dc:
        dc *= inv_t
    return dq, dc


def _check(q16, c16, adj, row_ids, col_ids, row_offset, lse=None, g=None) -> None:
    if q16.dim() != 2 or c16.dim() != 2 or q16.shape[1] != c16.shape[1]:
        raise ValueError(f"q and c must be [BQ, D] and [BK, D], got {tuple(q16.shape)}, "
                         f"{tuple(c16.shape)}")
    (bq, d), bk = q16.shape, c16.shape[0]
    if q16.dtype != torch.bfloat16 or c16.dtype != torch.bfloat16:
        raise TypeError(f"q and c must be bfloat16 (rounded once by the caller), got "
                        f"{q16.dtype}, {c16.dtype}")
    if (row_ids is None) != (col_ids is None):
        raise ValueError("row_ids and col_ids must both be set or both None")
    if not 0 <= row_offset <= bk - bq:
        raise ValueError(f"row_offset {row_offset} puts the {bq} q rows outside the {bk} columns")
    f32, i32 = torch.float32, torch.int32
    for name, t, n, dtype in (("adj", adj, bk, f32), ("row_ids", row_ids, bq, i32),
                              ("col_ids", col_ids, bk, i32), ("lse", lse, bq, f32),
                              ("g", g, bq, f32)):
        if t is None:
            continue
        if t.shape != (n,) or t.dtype != dtype or t.device != q16.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{n}] {dtype} tensor on {q16.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if c16.device != q16.device or not (q16.is_contiguous() and c16.is_contiguous()):
        raise ValueError("q and c must be contiguous and share a device")
    if q16.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the softmax kernels run on cpu or cuda tensors, got {q16.device}")
    if q16.device.type == "cuda" and not softmax_kernel_shapes_ok(bk, d, bq):
        raise ValueError(f"the CUDA softmax kernels do not take BQ={bq}, BK={bk}, D={d} "
                         "(see softmax_kernel_shapes_ok)")


def _pad_dim(x16: torch.Tensor) -> torch.Tensor:
    """Zero-pad D to the kernels' 64 or 128: zero columns add zero to every
    dot product. The flagship's D = 64 passes through."""
    d = x16.shape[1]
    dp = 64 if d <= 64 else 128
    return x16 if d == dp else F.pad(x16, (0, dp - d))


def _tile_own(n_own: int, device: torch.device) -> int:
    """Rows of the own operand per block: 128, or 64 while 128 would leave
    SMs without a block."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 128 if n_own // 128 >= sms else 64


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
_TAIL = [_I64, _I64, _I64, _I64, ctypes.c_float, _I64]  # bq, bk, dp, row_offset, 1/T, tile_own


class LseForward(_build.KernelLibrary):
    """Kernel #9's wrapper: lse [BQ] f32 of the adjusted scores. Checks its
    inputs, allocates the output and launches on the current stream (no
    sync). `launches` counts kernel launches and nothing else: a CPU call
    takes `lse_forward_reference` and does not count."""

    def __init__(self):
        super().__init__("softmax_lse_fwd", "ttrm_softmax_lse_fwd", [_PTR] * 6 + _TAIL,
                         source="softmax_lse.cu")

    def __call__(self, q16, c16, adj, row_ids, col_ids, row_offset: int, inv_t: float):
        _check(q16, c16, adj, row_ids, col_ids, row_offset)
        if q16.device.type == "cpu":
            return lse_forward_reference(q16, c16, adj, row_ids, col_ids, row_offset, inv_t)
        qp, cp = _pad_dim(q16), _pad_dim(c16)
        bq, bk = qp.shape[0], cp.shape[0]
        lse = torch.empty(bq, dtype=torch.float32, device=qp.device)
        self.launch(qp.device, qp.data_ptr(), cp.data_ptr(), _ptr(adj), _ptr(row_ids),
                    _ptr(col_ids), lse.data_ptr(), bq, bk, qp.shape[1], row_offset, inv_t,
                    _tile_own(bq, qp.device))
        return lse


class LseBackward(_build.KernelLibrary):
    """The wrapper of kernel #10 (`which="dq"`: [BQ, D] f32) or #11 ("dc":
    [BK, D] f32). A CPU call takes `lse_backward_reference` and does not
    count."""

    def __init__(self, which: str):
        super().__init__(f"softmax_lse_{which}", f"ttrm_softmax_lse_{which}", [_PTR] * 8 + _TAIL,
                         source="softmax_lse.cu")
        self.which = which

    def __call__(self, q16, c16, adj, row_ids, col_ids, row_offset: int, inv_t: float,
                 lse: torch.Tensor, g: torch.Tensor):
        _check(q16, c16, adj, row_ids, col_ids, row_offset, lse, g)
        dq = self.which == "dq"
        if q16.device.type == "cpu":
            return lse_backward_reference(q16, c16, adj, row_ids, col_ids, row_offset, inv_t,
                                          lse, g, need_dq=dq, need_dc=not dq)[0 if dq else 1]
        d = q16.shape[1]
        qp, cp = _pad_dim(q16), _pad_dim(c16)
        bq, bk = qp.shape[0], cp.shape[0]
        n_own = bq if dq else bk
        out = torch.empty((n_own, qp.shape[1]), dtype=torch.float32, device=qp.device)
        self.launch(qp.device, qp.data_ptr(), cp.data_ptr(), _ptr(adj), _ptr(row_ids),
                    _ptr(col_ids), lse.data_ptr(), g.data_ptr(), out.data_ptr(), bq, bk,
                    qp.shape[1], row_offset, inv_t, _tile_own(n_own, qp.device))
        return out if d == out.shape[1] else out[:, :d]


softmax_lse_fwd = LseForward()
softmax_lse_dq = LseBackward("dq")
softmax_lse_dc = LseBackward("dc")


def _merged_adj(log_q: torch.Tensor | None, n_valid: int | None, bk: int,
                device: torch.device) -> torch.Tensor | None:
    """logQ plus 1e9 on padded columns, so the kernels apply one subtract;
    None when there is neither."""
    if log_q is None and n_valid is None:
        return None
    adj = (torch.zeros(bk, dtype=torch.float32, device=device) if log_q is None
           else log_q.detach().to(torch.float32))
    if n_valid is not None:
        adj = adj + torch.where(torch.arange(bk, device=device) >= n_valid, -NEG, 0.0)
    return adj.contiguous()


class _LseFused(torch.autograd.Function):
    """lse [BQ] of the adjusted score matrix, differentiable in q and c: the
    forward is kernel #9, the backward kernels #10 and #11."""

    @staticmethod
    def forward(ctx, q, c, row_ids, col_ids, log_q, row_offset, temperature, n_valid):
        q16 = q.detach().to(torch.bfloat16).contiguous()  # rounded once, here
        c16 = c.detach().to(torch.bfloat16).contiguous()
        adj = _merged_adj(log_q, n_valid, c.shape[0], c.device)
        if row_ids is not None:
            row_ids = row_ids.to(torch.int32).contiguous()
            col_ids = col_ids.to(torch.int32).contiguous()
        inv_t = 1.0 / temperature
        lse = softmax_lse_fwd(q16, c16, adj, row_ids, col_ids, row_offset, inv_t)
        ctx.save_for_backward(q16, c16, adj, row_ids, col_ids, lse)
        ctx.row_offset, ctx.inv_t, ctx.dtypes = row_offset, inv_t, (q.dtype, c.dtype)
        return lse

    @staticmethod
    def backward(ctx, g_lse):
        q16, c16, adj, row_ids, col_ids, lse = ctx.saved_tensors
        g = g_lse.to(torch.float32).contiguous()
        args = (q16, c16, adj, row_ids, col_ids, ctx.row_offset, ctx.inv_t, lse, g)
        if q16.device.type == "cpu":  # one pass over the scores for both
            dq, dc = lse_backward_reference(*args)
        else:
            dq, dc = softmax_lse_dq(*args), softmax_lse_dc(*args)
        return (dq.to(ctx.dtypes[0]), dc.to(ctx.dtypes[1]), None, None, None, None, None, None)


def lse_and_pos(q: torch.Tensor, c: torch.Tensor, row_ids: torch.Tensor | None,
                col_ids: torch.Tensor | None, log_q: torch.Tensor | None, row_offset: int,
                temperature: float, n_valid: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (logsumexp_j s_ij, s_i,pos). The lse goes through the fused
    kernels; the positive score q_i . c_pos(i) / T - logQ_pos(i) is plain
    PyTorch in f32, and autograd gives its exact gradient. The q rows are
    contiguous ascending (`row_offset + arange`), so c_pos is a slice."""
    bq = q.shape[0]
    lse = _LseFused.apply(q, c, row_ids, col_ids, log_q, row_offset, temperature, n_valid)
    pos = torch.sum(q * c[row_offset:row_offset + bq], dim=1) * (1.0 / temperature)
    if log_q is not None:
        pos = pos - log_q[row_offset:row_offset + bq]
    if n_valid is not None:
        # a padded row's own column is pad-masked in the score matrix
        rows = torch.arange(bq, device=q.device) + row_offset
        pos = torch.where(rows >= n_valid, NEG, pos)
    return lse, pos


def sampled_softmax_fused_parts(
    query_emb: torch.Tensor,  # [BQ, D]
    cand_emb: torch.Tensor,  # [BK, D]: all in-batch candidates
    labels: torch.Tensor,  # [BQ]
    row_item_ids: torch.Tensor | None = None,  # [BQ]
    col_item_ids: torch.Tensor | None = None,  # [BK]; defaults to row_item_ids
    log_q: torch.Tensor | None = None,  # [BK]
    temperature: float = 1.0,
    n_valid: int | None = None,
    row_offset: int = 0,  # global index of q row 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused loss's numerator and denominator: (sum over label == 1 rows
    of lse_i - s_i,pos, the count of those rows). A data-parallel caller sums
    both over its stripes and divides once."""
    if col_item_ids is None:
        col_item_ids = row_item_ids
    if (row_item_ids is None) != (col_item_ids is None):
        raise ValueError("row_item_ids and col_item_ids must both be set or both None")
    lse, pos = lse_and_pos(query_emb.float(), cand_emb.float(), row_item_ids, col_item_ids,
                           None if log_q is None else log_q.float(), row_offset, temperature,
                           n_valid)
    w = labels.float()
    if n_valid is not None:
        # padded entries may sit among the q rows too (the square case)
        rows = torch.arange(query_emb.shape[0], device=w.device) + row_offset
        w = w * (rows < n_valid)
    return ((lse - pos) * w).sum(), w.sum()


def sampled_softmax_fused(query_emb: torch.Tensor, cand_emb: torch.Tensor, labels: torch.Tensor,
                          item_ids: torch.Tensor | None = None,
                          log_q: torch.Tensor | None = None, temperature: float = 1.0,
                          n_valid: int | None = None) -> torch.Tensor:
    """Mean over label == 1 rows of lse_i - s_ii, the scores fused: the
    drop-in for `models.losses._chunked_sampled_softmax`."""
    num, den = sampled_softmax_fused_parts(query_emb, cand_emb, labels, item_ids, None, log_q,
                                           temperature, n_valid, 0)
    return num / torch.clamp(den, min=1.0)
