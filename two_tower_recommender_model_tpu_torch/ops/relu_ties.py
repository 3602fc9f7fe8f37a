"""Bias and ReLU after a tower layer's bf16 GEMM, with the ReLU decisions at
bf16 rounding ties taken in k order: the CUDA kernel's wrapper and its
plain version.

    r   = y[i, c]                                  (the GEMM's bf16 sum)
    tie = a bf16 neighbour of r decides the ReLU other than r does
    r'  = tie ? bf16(sum_k a[i, k] * w[k, c], f32 in k order) : r
    out = relu(bf16(r' + b[c]))

The fused tower's forward (`models/mlp.py:_mlp2_fwd_impl`) runs each layer
as one bf16 GEMM, which sums in its own order; where a sum lies at a bf16
rounding midpoint against -b, another order decides that ReLU the other way.
The tower backward (kernel #8), the plain version and the host decide such
sums in k order, so the forward does too (`csrc/relu_ties.cu` has the
design).

`relu_ties` launches the hand-written kernel of `csrc/relu_ties.cu` on CUDA
tensors and takes `relu_ties_reference` only for tensors that lie on the
CPU. It counts its kernel launches in `relu_ties.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from two_tower_recommender_model_tpu_torch.ops import _build


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The uint16 bit patterns of a bf16 tensor, in int32."""
    return t.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF


def tie_mask(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, N] bool: where a bf16 neighbour of y (in value order) decides
    `bf16(v + b) > 0` other than y does: the sums another summation order
    could flip. The decision is v > -b, so these are t = -b and the value
    next above it, a zero standing for both zeros; the kernel takes the same
    test on the bits."""
    u, t = _bits(y), _bits(b) ^ 0x8000
    above = torch.where((t & 0x7FFF) == 0, 0x0001, torch.where((t & 0x8000) != 0, t - 1, t + 1))
    zero_tie = ((t & 0x7FFF) == 0) | ((above & 0x7FFF) == 0)
    return (u == t) | (u == above) | (((u & 0x7FFF) == 0) & zero_tie)


def ordered_sums(a: torch.Tensor, w: torch.Tensor, rows: torch.Tensor,
                 cols: torch.Tensor) -> torch.Tensor:
    """f32 sums a[rows[j]] . w[:, cols[j]] in k order, one rounding an add
    (products of bf16 values are exact in f32, so this is an fmaf chain)."""
    prod = a[rows].float() * w[:, cols].T.float()
    s = torch.zeros(prod.shape[0], dtype=torch.float32, device=a.device)
    for k in range(prod.shape[1]):
        s = s + prod[:, k]
    return s


@torch.no_grad()
def relu_ties_reference(y: torch.Tensor, b: torch.Tensor, a: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the kernel's tie test, recompute, rounding
    points and ReLU (positive zero below), on any device."""
    r = y.float()
    rows, cols = tie_mask(y, b).nonzero(as_tuple=True)
    r[rows, cols] = ordered_sums(a, w, rows, cols).to(torch.bfloat16).float()
    pre = (r + b.float()).to(torch.bfloat16)
    return torch.where(pre > 0, pre, torch.zeros_like(pre))


class ReluTies(_build.KernelLibrary):
    """The wrapper: checks its inputs, allocates the output and the tie flags
    (a byte a thread of the first pass) and launches the CUDA kernel's two
    passes on the current stream (no sync), one launch in `launches`, which
    counts kernel launches and nothing else: a CPU call takes
    `relu_ties_reference` and does not count."""

    def __init__(self):
        super().__init__("relu_ties", "ttrm_relu_ties", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])

    def __call__(self, y: torch.Tensor, b: torch.Tensor, a: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
        """`relu(bf16(y' + b))` [B, N] bf16, for y = bf16(a @ w) the layer's
        GEMM output [B, N], its input a [B, K], its weights w [K, N] (any
        strides: the kernel reads w's columns, which are the rows of an
        `nn.Linear` weight) and bias b [N], all bf16."""
        if y.dim() != 2 or a.dim() != 2 or w.dim() != 2 or b.dim() != 1:
            raise ValueError("y, a, w must be 2-d and b 1-d")
        (rows, n), k = y.shape, a.shape[1]
        if a.shape[0] != rows or w.shape != (k, n) or b.shape != (n,):
            raise ValueError(f"shapes: y {tuple(y.shape)}, a {tuple(a.shape)}, w "
                             f"{tuple(w.shape)}, b {tuple(b.shape)} do not make y = a @ w + b")
        if any(t.dtype != torch.bfloat16 for t in (y, b, a, w)):
            raise TypeError("y, b, a and w must be bfloat16")
        if len({t.device for t in (y, b, a, w)}) != 1:
            raise ValueError("y, b, a and w must share a device")
        if y.device.type == "cpu":
            return relu_ties_reference(y, b, a, w)
        if y.device.type != "cuda":
            raise ValueError(f"relu_ties runs on cpu or cuda tensors, got {y.device}")
        y, a, b = y.contiguous(), a.contiguous(), b.contiguous()
        wt = w.T.contiguous()  # [N, K]: a column of w is a contiguous row
        out = torch.empty_like(y)
        vec8 = n % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (y, b, out))
        if y.numel():
            groups = -(-y.numel() // (8 if vec8 else 1))
            flags = torch.empty(-(-groups // 4) * 4, dtype=torch.uint8, device=y.device)
            self.launch(y.device, y.data_ptr(), b.data_ptr(), a.data_ptr(), wt.data_ptr(),
                        out.data_ptr(), rows, n, k, int(vec8), flags.data_ptr())
        return out


relu_ties = ReluTies()
