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
product of a score is bf16 x bf16 summed in f32 (above D = 128 the plain
versions sum in f64 and round once, see `_dots`); times 1/T, minus the merged
adjustment (logQ plus 1e9 on padded columns), then the duplicate mask; in the
backward p = exp(s - lse) * g is rounded to bf16 before the second product,
which sums in f32 and is multiplied by 1/T once.

`softmax_lse_fwd`, `softmax_lse_dq` and `softmax_lse_dc` launch the
hand-written kernels of `csrc/softmax_lse.cu` on CUDA tensors and take
`lse_forward_reference` / `lse_backward_reference` only for tensors that lie
on the CPU; each counts its kernel launches in `.launches`. #9 cuts the
columns in `fwd_chunks` chunks, whose (m, l) go through a workspace to a
merge launch (one launch in the count). At a padded D of 64 or 128, #10 and
#11 cut their streamed rows in `bwd_chunks` chunks, a block each, whose sums
go through a workspace to a merge launch (one launch in the count). Above a padded D of 128 a backward is computed per panel of q
rows (`wide_backward`): the
p kernel (`softmax_lse_p`) writes the panel's bf16 p into a workspace, and
#10's and #11's products (`LseBackward.product`, counted in
`softmax_lse_dq` / `softmax_lse_dc`) read it. `softmax_lse_grads` returns
both gradients from one p; the fused loss's backward takes it on the card.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from two_tower_recommender_model_tpu_torch.ops import _build

NEG = -1e9
# The reference's cap on D. Above 128 the kernels run on one TMA + wgmma ring:
# #10 / #11 a p kernel and two products (`csrc/softmax_lse.cu`, "wide D"). #9
# runs over column chunks with a merge at every D
MAX_DIM = 2048
FWD_CHUNKS = 32  # #9's most column chunks at a wide D (`fwd_chunks`)
# #9 at D <= 128: the most column chunks and the fewest columns a chunk where several
FWD_NARROW_CHUNKS, FWD_CHUNK_COLS = 8, 1024
# #10 and #11 at D <= 128: the most chunks of the streamed range (a block each
# an own tile, `bwd_chunks`) and the fewest streamed rows a chunk where several
BWD_CHUNKS, BWD_CHUNK_ROWS = 4, 2048
_PLAIN_BLOCK = 1 << 24  # most score elements the plain versions hold at once
# The wide backward's workspace: the bf16 p of a panel of q rows against every
# column, at most this many bytes (and at least 128 rows)
PANEL_BYTES = 256 << 20


def softmax_kernel_shapes_ok(bk: int, d: int, bq: int | None = None) -> bool:
    """Shapes the fused kernels take, the reference's rule: 128-divisible
    batch dims (q rows may be a stripe of the columns) and an embedding dim
    of at most 2,048. D itself need not be aligned: the wrappers zero-pad it
    to 64, 128 or a multiple of 128."""
    if bq is None:
        bq = bk
    return (bk % 128 == 0 and bk >= 256 and bq % 128 == 0 and bq >= 128
            and bk % bq == 0 and 0 < d <= MAX_DIM)


def _dots(qf: torch.Tensor, cf: torch.Tensor) -> torch.Tensor:
    """The raw f32 scores of bf16-valued rows. Above D = 128 each is summed in
    f64 and rounded once, as the wide kernels' tie recompute takes it: an f32
    GEMM's order over thousands of products is the library's choice and
    changes with the shapes, by tens of ulps (one of a p near a bf16 tie is
    enough to round it the other way)."""
    if qf.shape[1] > 128:
        return (qf.double() @ cf.double().T).float()
    return qf @ cf.T


def _scores(qf: torch.Tensor, cf: torch.Tensor, adj, row_ids, col_ids, rows: torch.Tensor,
            cols: torch.Tensor, inv_t: float) -> torch.Tensor:
    """The adjusted scores of a block of q rows against every column."""
    s = _dots(qf, cf) * inv_t
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


def p_panel_reference(q16: torch.Tensor, c16: torch.Tensor, adj: torch.Tensor | None,
                      row_ids: torch.Tensor | None, col_ids: torch.Tensor | None,
                      row_offset: int, inv_t: float, lse: torch.Tensor, g: torch.Tensor,
                      lo: int, hi: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of the p kernel: p of q rows [lo, hi) against every
    column, [hi - lo, BK] bf16, from `_scores` as `lse_backward_reference`
    takes it (row blocks of at most 2^24 scores), into `out` when given."""
    qf, cf = q16.float(), c16.float()
    bk = cf.shape[0]
    cols = torch.arange(bk, device=qf.device)
    if out is None:
        out = torch.empty((hi - lo, bk), dtype=torch.bfloat16, device=qf.device)
    for a, b in _row_blocks(hi - lo, bk):
        r0, r1 = lo + a, lo + b
        s = _scores(qf[r0:r1], cf, adj, None if row_ids is None else row_ids[r0:r1], col_ids,
                    cols[r0:r1] + row_offset, cols, inv_t)
        out[a:b] = torch.exp(s - lse[r0:r1, None]) * g[r0:r1, None]
    return out


def dq_product_reference(p: torch.Tensor, c16: torch.Tensor, inv_t: float,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of #10's product at a wide D: (p @ c) / T in f32, p
    the bf16 panel, into `out` when given."""
    res = (p.float() @ c16.float()) * inv_t
    return res if out is None else out.copy_(res)


def dc_product_reference(p: torch.Tensor, q16_rows: torch.Tensor, dc: torch.Tensor,
                         inv_t: float, first: bool, last: bool) -> torch.Tensor:
    """The plain version of #11's product at a wide D, in place on `dc`: the
    panel's p.T @ q added to dc (its first panel starts it), times 1/T after
    the last panel, as `lse_backward_reference` sums its row blocks."""
    part = p.float().T @ q16_rows.float()
    if first:
        dc.copy_(part)
    else:
        dc += part
    if last:
        dc *= inv_t
    return dc


def panel_rows(bq: int, bk: int) -> int:
    """Rows of a panel of the wide backward: PANEL_BYTES of bf16 p against BK
    columns, a multiple of 128, at least 128 and at most BQ."""
    return min(bq, max(128, PANEL_BYTES // (2 * bk) // 128 * 128))


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
    if q16.device.type == "cuda" and any(t is not None and t.data_ptr() % 16
                                         for t in (q16, c16, adj, row_ids, col_ids, lse, g)):
        raise ValueError("the CUDA softmax kernels load their operands 16 bytes at a time: "
                         "every tensor must start on a 16-byte boundary")


def _padded_dim(d: int) -> int:
    """The depth the kernels see: 64, 128, or D rounded up to a multiple of 128."""
    return 64 if d <= 64 else -(-d // 128) * 128


def _pad_dim(x16: torch.Tensor) -> torch.Tensor:
    """Zero-pad D to the kernels' depth: zero columns add zero to every dot
    product. The flagship's D = 64 passes through."""
    d = x16.shape[1]
    dp = _padded_dim(d)
    return x16 if d == dp else F.pad(x16, (0, dp - d))


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
_TAIL = [_I64, _I64, _I64, _I64, ctypes.c_float]  # bq, bk, dp, row_offset, 1/T


def fwd_chunks(bk: int, d: int) -> int:
    """The column chunks of #9, each of whole 128-column tiles: at a padded
    D of 64 or 128 BK / FWD_CHUNK_COLS from 1 to FWD_NARROW_CHUNKS (a block
    keeps its 128 q rows across a chunk's tiles, so chunks are long: 8 of
    8 tiles at 8,192), wider up to FWD_CHUNKS chunks. A function of BK and D
    alone, so a stripe's rows meet the same chunks (and get the same lse
    bits) as the square's, and enough chunks that a stripe of a few row
    tiles still fills the card."""
    if _padded_dim(d) <= 128:
        return min(FWD_NARROW_CHUNKS, max(1, bk // FWD_CHUNK_COLS))
    return min(bk // 128, FWD_CHUNKS)


def fwd_workspace_shape(bq: int, bk: int, d: int) -> tuple[int, int, int]:
    """The shape of #9's workspace, each chunk's (m, l) of each q row:
    `[fwd_chunks(BK, D), BQ, 2]` f32."""
    return fwd_chunks(bk, d), bq, 2


def bwd_chunks(n_str: int) -> int:
    """The chunks of the streamed range of #10 or #11 at D <= 128 (BK rows
    for dq, BQ for dc): N / BWD_CHUNK_ROWS, from 1 to BWD_CHUNKS, each of
    whole 128-row tiles. A function of the length alone, so a stripe's dq
    rows meet the same chunks (and get the same bits) as the square's. An
    own tile's chunks are blocks of their own, so the grid fills the card on
    a stripe; their sums meet in a workspace and a merge launch adds them in
    chunk order. The kernel (`bwd_chunks` in `csrc/softmax_lse.cu`) takes
    the same rule."""
    return min(BWD_CHUNKS, max(1, n_str // BWD_CHUNK_ROWS))


def bwd_chunk_tiles(n_str: int) -> list[tuple[int, int]]:
    """The 128-row tiles [first, end) of each of `bwd_chunks(n_str)` chunks,
    in chunk order: chunk k starts at tile k * n_tiles // n_chunks."""
    n_tiles, n = n_str // 128, bwd_chunks(n_str)
    return [(k * n_tiles // n, (k + 1) * n_tiles // n) for k in range(n)]


class LseForward(_build.KernelLibrary):
    """Kernel #9's wrapper: lse [BQ] f32 of the adjusted scores. Checks its
    inputs, allocates the output and the chunks' (m, l) workspace
    (`fwd_workspace_shape`) and launches on the current stream (no sync).
    `launches` counts kernel launches and nothing else (the chunks' launch
    and their merge count one): a CPU call takes `lse_forward_reference`
    and does not count."""

    def __init__(self):
        super().__init__("softmax_lse_fwd", "ttrm_softmax_lse_fwd", [_PTR] * 7 + [_I64] + _TAIL,
                         source="softmax_lse.cu")

    def __call__(self, q16, c16, adj, row_ids, col_ids, row_offset: int, inv_t: float):
        _check(q16, c16, adj, row_ids, col_ids, row_offset)
        if q16.device.type == "cpu":
            return lse_forward_reference(q16, c16, adj, row_ids, col_ids, row_offset, inv_t)
        qp, cp = _pad_dim(q16), _pad_dim(c16)
        (bq, dp), bk = qp.shape, cp.shape[0]
        lse = torch.empty(bq, dtype=torch.float32, device=qp.device)
        part = torch.empty(fwd_workspace_shape(bq, bk, dp), dtype=torch.float32, device=qp.device)
        self.launch(qp.device, qp.data_ptr(), cp.data_ptr(), _ptr(adj), _ptr(row_ids),
                    _ptr(col_ids), lse.data_ptr(), part.data_ptr(), part.shape[0], bq, bk, dp,
                    row_offset, inv_t)
        return lse


class LseP(_build.KernelLibrary):
    """The p kernel's wrapper, part of #10 and #11 at a wide D: p of q rows
    [lo, hi) against every column, [hi - lo, BK] bf16, into `out` (a
    contiguous workspace) or a new tensor. lo and hi are multiples of 128
    (hi may be BQ). A CPU call takes `p_panel_reference` and does not
    count."""

    def __init__(self):
        super().__init__("softmax_lse_p", "ttrm_softmax_lse_p",
                         [_PTR] * 8 + [_I64] * 6 + [ctypes.c_float], source="softmax_lse.cu")

    def __call__(self, q16, c16, adj, row_ids, col_ids, row_offset: int, inv_t: float,
                 lse: torch.Tensor, g: torch.Tensor, lo: int, hi: int,
                 out: torch.Tensor | None = None) -> torch.Tensor:
        _check(q16, c16, adj, row_ids, col_ids, row_offset, lse, g)
        (bq, d), bk = q16.shape, c16.shape[0]
        if not (0 <= lo < hi <= bq and lo % 128 == 0 and (hi % 128 == 0 or hi == bq)):
            raise ValueError(f"the p kernel takes q rows [lo, hi) on 128-row boundaries, got "
                             f"[{lo}, {hi}) of {bq}")
        if out is not None and (out.shape != (hi - lo, bk) or out.dtype != torch.bfloat16
                                or out.device != q16.device or not out.is_contiguous()):
            raise ValueError(f"out must be a contiguous [{hi - lo}, {bk}] bfloat16 tensor on "
                             f"{q16.device}")
        if q16.device.type == "cpu":
            return p_panel_reference(q16, c16, adj, row_ids, col_ids, row_offset, inv_t, lse, g,
                                     lo, hi, out)
        if _padded_dim(d) <= 128:
            raise ValueError(f"the p kernel runs at a padded D above 128, got D={d}: kernels "
                             "#10 and #11 take the whole backward there")
        qp, cp = _pad_dim(q16), _pad_dim(c16)
        if out is None:
            out = torch.empty((hi - lo, bk), dtype=torch.bfloat16, device=qp.device)
        if out.data_ptr() % 16:
            raise ValueError("the p kernel's workspace must start on a 16-byte boundary")
        self.launch(qp.device, qp.data_ptr(), cp.data_ptr(), _ptr(adj), _ptr(row_ids),
                    _ptr(col_ids), lse.data_ptr(), g.data_ptr(), out.data_ptr(), bq, bk,
                    qp.shape[1], row_offset, lo, hi - lo, inv_t)
        return out


class LseBackward(_build.KernelLibrary):
    """The wrapper of kernel #10 (`which="dq"`: [BQ, D] f32) or #11 ("dc":
    [BK, D] f32). At a padded D of 64 or 128 it allocates the chunks' sums
    (`[bwd_chunks(n), rows, D]` f32, n the streamed length: BK for dq, BQ for
    dc) where there are several; the kernel and its merge count one launch.
    At a padded D above 128 it is `wide_backward`: the p kernel
    and this kernel's product (`product`, counted here), a panel at a time. A
    CPU call takes `lse_backward_reference` and does not count."""

    def __init__(self, which: str):
        tail = [_I64] * 3 + [ctypes.c_float] + ([_I64] * 2 if which == "dc" else [])
        super().__init__(f"softmax_lse_{which}", f"ttrm_softmax_lse_{which}", [_PTR] * 9 + _TAIL,
                         source="softmax_lse.cu",
                         extra={f"ttrm_softmax_lse_{which}_product": [_PTR] * 3 + tail,
                                "ttrm_softmax_lse_bwd_plan": [_I64] * 3 + [_PTR]})
        self.which = which

    def plan(self, device: torch.device, n_str: int, dp: int) -> dict[str, int]:
        """The kernel's launch plan at D <= 128 (padded depth `dp` of 64 or
        128) over a streamed range of `n_str` rows, as the card reports it:
        its chunks (a block each an own tile; a merge launch where there are
        several), the blocks an SM holds at once, a block's shared memory.
        Launches nothing, counts nothing."""
        out = (ctypes.c_int64 * 3)()
        lib = self.load().lib
        with torch.cuda.device(device):
            err = lib.ttrm_softmax_lse_bwd_plan(n_str, dp, int(self.which == "dq"),
                                                ctypes.addressof(out), None)
        if err != 0:
            raise RuntimeError(f"{self.name} plan failed: {lib.ttrm_error_string(err).decode()} "
                               f"({err})")
        return {"chunks": out[0], "blocks_per_sm": out[1], "smem_bytes": out[2]}

    def product(self, p: torch.Tensor, other: torch.Tensor, out: torch.Tensor, inv_t: float,
                first: bool = True, last: bool = True) -> torch.Tensor:
        """This kernel's product at a wide D, on one panel's p ([rows, BK]
        bf16): dq (`out` [rows, DP] f32) = (p @ c) / T with `other` = c [BK,
        DP]; dc (`out` [BK, DP] f32) = (first ? 0 : dc) + p.T @ q_rows, times
        1/T if `last`, with `other` = the panel's q rows [rows, DP]. DP is
        the padded depth. A CPU call takes the plain version."""
        dq = self.which == "dq"
        rows, bk = p.shape
        dp = other.shape[1]
        want = {"p": (p, (rows, bk), torch.bfloat16),
                "other": (other, (bk if dq else rows, dp), torch.bfloat16),
                "out": (out, (rows if dq else bk, dp), torch.float32)}
        for name, (t, shape, dtype) in want.items():
            if t.shape != shape or t.dtype != dtype or t.device != p.device or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous {list(shape)} {dtype} tensor on "
                                 f"{p.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
        if p.device.type == "cpu":
            return (dq_product_reference(p, other, inv_t, out) if dq else
                    dc_product_reference(p, other, out, inv_t, first, last))
        if rows % 128 or bk % 128 or dp % 128 or not 128 < dp <= MAX_DIM:
            raise ValueError(f"the {self.which} product takes 128-row panels and a padded D of "
                             f"256 to {MAX_DIM}, got p {tuple(p.shape)}, D {dp}")
        if any(t.data_ptr() % 16 for t in (p, other, out)):
            raise ValueError("the products load their operands 16 bytes at a time: every tensor "
                             "must start on a 16-byte boundary")
        args = (p.data_ptr(), other.data_ptr(), out.data_ptr(), rows, bk, dp, inv_t)
        self.launch(p.device, *args, *(() if dq else (int(first), int(last))),
                    entry=f"ttrm_softmax_lse_{self.which}_product")
        return out

    def __call__(self, q16, c16, adj, row_ids, col_ids, row_offset: int, inv_t: float,
                 lse: torch.Tensor, g: torch.Tensor):
        _check(q16, c16, adj, row_ids, col_ids, row_offset, lse, g)
        dq = self.which == "dq"
        if q16.device.type == "cpu":
            return lse_backward_reference(q16, c16, adj, row_ids, col_ids, row_offset, inv_t,
                                          lse, g, need_dq=dq, need_dc=not dq)[0 if dq else 1]
        if _padded_dim(q16.shape[1]) > 128:
            return wide_backward(q16, c16, adj, row_ids, col_ids, row_offset, inv_t, lse, g,
                                 need_dq=dq, need_dc=not dq)[0 if dq else 1]
        d = q16.shape[1]
        qp, cp = _pad_dim(q16), _pad_dim(c16)
        (bq, dp), bk = qp.shape, cp.shape[0]
        n_own, n_str = (bq, bk) if dq else (bk, bq)
        out = torch.empty((n_own, dp), dtype=torch.float32, device=qp.device)
        chunks = bwd_chunks(n_str)  # their sums go through a workspace to a merge launch
        part = (torch.empty((chunks, n_own, dp), dtype=torch.float32, device=qp.device)
                if chunks > 1 else None)
        self.launch(qp.device, qp.data_ptr(), cp.data_ptr(), _ptr(adj), _ptr(row_ids),
                    _ptr(col_ids), lse.data_ptr(), g.data_ptr(), out.data_ptr(), _ptr(part), bq,
                    bk, dp, row_offset, inv_t)
        return out if d == dp else out[:, :d]


softmax_lse_fwd = LseForward()
softmax_lse_p = LseP()
softmax_lse_dq = LseBackward("dq")
softmax_lse_dc = LseBackward("dc")


def wide_backward(q16, c16, adj, row_ids, col_ids, row_offset: int, inv_t: float,
                  lse: torch.Tensor, g: torch.Tensor, need_dq: bool = True,
                  need_dc: bool = True):
    """(dq [BQ, D], dc [BK, D]) f32 at any D, None for the one not asked for,
    a panel of `panel_rows` q rows at a time: the panel's p once into a bf16
    workspace (`softmax_lse_p`), then dq's rows (#10's product) and dc's
    running sum over the panels (#11's, times 1/T after the last). The
    kernels' path at a padded D above 128; on CPU tensors every step takes
    its plain version."""
    _check(q16, c16, adj, row_ids, col_ids, row_offset, lse, g)
    d = q16.shape[1]
    qp, cp = _pad_dim(q16), _pad_dim(c16)
    (bq, dp), bk = qp.shape, cp.shape[0]
    rows = panel_rows(bq, bk)
    work = torch.empty((rows, bk), dtype=torch.bfloat16, device=qp.device)
    dq = torch.empty((bq, dp), dtype=torch.float32, device=qp.device) if need_dq else None
    dc = torch.empty((bk, dp), dtype=torch.float32, device=qp.device) if need_dc else None
    for lo in range(0, bq, rows):
        hi = min(lo + rows, bq)
        p = softmax_lse_p(qp, cp, adj, row_ids, col_ids, row_offset, inv_t, lse, g, lo, hi,
                          out=work[:hi - lo])
        if need_dq:
            softmax_lse_dq.product(p, cp, dq[lo:hi], inv_t)
        if need_dc:
            softmax_lse_dc.product(p, qp[lo:hi], dc, inv_t, first=lo == 0, last=hi == bq)
    if d != dp:
        dq = None if dq is None else dq[:, :d]
        dc = None if dc is None else dc[:, :d]
    return dq, dc


def softmax_lse_grads(q16, c16, adj, row_ids, col_ids, row_offset: int, inv_t: float,
                      lse: torch.Tensor, g: torch.Tensor):
    """Both gradients of the lse, (dq [BQ, D], dc [BK, D]) f32, from one p:
    at a padded D above 128 `wide_backward` (p once a panel, then both
    products; on the CPU its plain steps); at D <= 128 kernels #10 and #11
    as `softmax_lse_dq` and `softmax_lse_dc` launch them (on the CPU
    `lse_backward_reference`, one pass for both)."""
    _check(q16, c16, adj, row_ids, col_ids, row_offset, lse, g)
    args = (q16, c16, adj, row_ids, col_ids, row_offset, inv_t, lse, g)
    if _padded_dim(q16.shape[1]) > 128:
        return wide_backward(*args)
    if q16.device.type == "cpu":
        return lse_backward_reference(*args)
    return softmax_lse_dq(*args), softmax_lse_dc(*args)


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
    forward is kernel #9, the backward kernels #10 and #11 (at a wide D the p
    kernel and their products, through `softmax_lse_grads`)."""

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
        else:  # at a wide D one p for both
            dq, dc = softmax_lse_grads(*args)
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
