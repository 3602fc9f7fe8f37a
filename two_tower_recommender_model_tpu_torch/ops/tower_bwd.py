"""Fused two-layer tower backward: the CUDA kernel's wrapper and its plain
version.

Port of the Pallas TPU kernel `ops/tower_bwd.py:tower_backward_fused`
(`_bwd_kernel`): the whole backward of the flagship tower
`relu(relu(x @ W1 + b1) @ W2 + b2)` ([128] -> [128] -> [H2 <= 128], final
ReLU on) in one kernel, with the forward's first layer recomputed from x and
the final-ReLU mask taken from the saved output. Every product takes bf16
operands and sums in f32, as the reference's `_mm` does; db1 and db2 sum the
unrounded f32 gradients. Returns (dx in x's dtype, dW1, db1, dW2, db2 in f32).

`tower_backward` launches the hand-written kernel of `csrc/tower_bwd.cu` on
CUDA tensors (two row warpgroups a block: x by TMA into a ring of tiles, dq
and out prefetched into L2 by bulk copies; the five products on wgmma; the
weight gradients in registers across a block's tiles, of two gradient
warpgroups at bf16 io and H2 <= 64, else of the row warpgroups; dx out by
TMA stores; layer 1's ReLU ties settled by the forward's rule,
`csrc/relu_ties.cuh`) and takes `tower_backward_reference` only for tensors
that lie on the CPU. The weights reach the kernel as they lie (bf16 or f32,
any strides). It counts its kernel launches in `tower_backward.launches`.
`fits` is the reference's shape gate, unchanged, so both packages route the
same shapes through the fused backward.
"""

from __future__ import annotations

import ctypes

import torch

from two_tower_recommender_model_tpu_torch.ops import _build

MIN_TILE = 512  # the reference's batch granule (its smallest TPU tile)
_LANE = 128
# the batch multiple the CUDA kernel takes: its tiles are 64 rows, and at f32
# io the last may be 32 (the TMA fills the rest with zeros)
_TILE_ROWS = {torch.bfloat16: 64, torch.float32: 32}
_KERNEL_TILE = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the stages a split launch runs the kernel up to (`TowerBackward.split`), in its order
SPLIT_STAGES = ("loads", "row products", "epilogues", "gradient products", "stores")


def fits(d_in: int, h1: int, h2: int, batch: int) -> bool:
    return d_in == _LANE and h1 == _LANE and 0 < h2 <= _LANE and batch % MIN_TILE == 0


def _bf(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and widen back: the value a bf16 product operand has."""
    return t.to(torch.bfloat16).to(torch.float32)


@torch.no_grad()
def tower_backward_reference(x: torch.Tensor, dq: torch.Tensor, out: torch.Tensor,
                             w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor):
    """The plain PyTorch version: the reference kernel's rounding points,
    with f32 products of bf16 values (each product is exact in f32, so only
    the summation order can differ from the kernel)."""
    d2 = torch.where(out.float() > 0, dq.float(), 0.0)
    pre1 = (_bf(x) @ _bf(w1)).to(torch.bfloat16) + b1.to(torch.bfloat16)  # bf16 add
    pre1 = pre1.float()
    h1 = torch.relu(pre1)
    d1 = torch.where(pre1 > 0, _bf(d2) @ _bf(w2).T, 0.0)
    dx = (_bf(d1) @ _bf(w1).T).to(x.dtype)
    return dx, _bf(x).T @ _bf(d1), d1.sum(0), h1.T @ _bf(d2), d2.sum(0)


def _check(x, dq, out, w1, b1, w2) -> None:
    if x.dim() != 2 or x.shape[1] != _LANE:
        raise ValueError(f"x must be [B, 128], got {tuple(x.shape)}")
    b = x.shape[0]
    if w1.shape != (_LANE, _LANE) or b1.shape != (_LANE,):
        raise ValueError(f"w1 must be [128, 128] and b1 [128], got {tuple(w1.shape)}, "
                         f"{tuple(b1.shape)}")
    if w2.dim() != 2 or w2.shape[0] != _LANE or not 0 < w2.shape[1] <= _LANE:
        raise ValueError(f"w2 must be [128, H2] with H2 <= 128, got {tuple(w2.shape)}")
    h2 = w2.shape[1]
    if dq.shape != (b, h2) or out.shape != (b, h2):
        raise ValueError(f"dq and out must be [B, H2] = {(b, h2)}, got {tuple(dq.shape)}, "
                         f"{tuple(out.shape)}")
    if x.dtype not in _DTYPE_CODES or not (x.dtype == dq.dtype == out.dtype):
        raise TypeError(f"x, dq and out must share a dtype, float32 or bfloat16; got "
                        f"{x.dtype}, {dq.dtype}, {out.dtype}")
    if len({t.device for t in (x, dq, out, w1, b1, w2)}) != 1:
        raise ValueError("x, dq, out, w1, b1 and w2 must share a device")
    for name, t in (("x", x), ("dq", dq), ("out", out)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,      # x, dq, out, io
         ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,      # w1, strides, b1
         ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,         # w2, strides, w
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,                    # dx, partials, grads
         ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]                       # B, H2, blocks


class TowerBackward(_build.KernelLibrary):
    """The tower-backward wrapper: checks its inputs, allocates the outputs
    and the per-block partial sums, and launches the CUDA kernel on the
    current stream (no sync).

    The library builds at the first launch (`load`). `launches` counts kernel
    launches and nothing else: a CPU call takes `tower_backward_reference`
    and does not count."""

    def __init__(self):
        super().__init__("tower_bwd", "ttrm_tower_bwd", _ARGS,
                         extra={"ttrm_tower_bwd_split": [*_ARGS, ctypes.c_int64]})

    def __call__(self, x: torch.Tensor, dq: torch.Tensor, out: torch.Tensor, w1: torch.Tensor,
                 b1: torch.Tensor, w2: torch.Tensor):
        """(dx [B, 128] in x's dtype, dW1 [128, 128], db1 [128], dW2 [128, H2],
        db2 [H2]), the weight gradients in f32."""
        _check(x, dq, out, w1, b1, w2)
        if x.device.type == "cpu":
            return tower_backward_reference(x, dq, out, w1, b1, w2)
        if x.device.type != "cuda":
            raise ValueError(f"tower_backward runs on cpu or cuda tensors, got {x.device}")
        return self._launch(x, dq, out, w1, b1, w2)

    def split(self, stage: str, x: torch.Tensor, dq: torch.Tensor, out: torch.Tensor,
              w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor):
        """One launch of the kernel run up to `stage` of `SPLIT_STAGES` (the
        loads alone; and the row products; and their epilogues and ties; and
        the gradient products; "stores" is the whole kernel), at bf16 io and
        H2 = 64 on CUDA tensors: for timing a tile's parts. Before "stores"
        the outputs are not the function's."""
        if stage not in SPLIT_STAGES:
            raise ValueError(f"stage must be one of {SPLIT_STAGES}, got {stage!r}")
        _check(x, dq, out, w1, b1, w2)
        if x.device.type != "cuda" or x.dtype != torch.bfloat16 or w2.shape[1] != 64:
            raise ValueError("a split launch runs the CUDA kernel at bf16 io and H2 = 64 on "
                             "CUDA tensors")
        return self._launch(x, dq, out, w1, b1, w2,
                            split=(SPLIT_STAGES.index(stage) + 1) % len(SPLIT_STAGES))

    def _launch(self, x, dq, out, w1, b1, w2, split: int | None = None):
        b, h2 = x.shape[0], w2.shape[1]
        tile = _TILE_ROWS[x.dtype]
        if b % tile:
            raise ValueError(f"the CUDA kernel needs B % {tile} == 0 for {x.dtype} io, got B={b}")
        # the kernel's TMA and bulk copies read 16-byte aligned rows: an offset view is copied
        # to a fresh buffer
        x, dq, out = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, dq, out))
        # the weights as they lie (the kernel rounds them to bf16 as it loads them), in
        # one dtype of the two it reads
        if not (w1.dtype == b1.dtype == w2.dtype and w1.dtype in _DTYPE_CODES):
            w1, b1, w2 = (t.to(torch.float32) for t in (w1, b1, w2))
        b1 = b1.contiguous()
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        n_blocks = min(-(-b // _KERNEL_TILE), sms)  # persistent: one block an SM
        n_out = _LANE * _LANE + _LANE + _LANE * h2 + h2
        dx = torch.empty_like(x)
        partials = torch.empty((n_blocks, n_out), dtype=torch.float32, device=x.device)
        grads = torch.empty(n_out, dtype=torch.float32, device=x.device)
        args = (x.data_ptr(), dq.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype],
                w1.data_ptr(), *w1.stride(), b1.data_ptr(), w2.data_ptr(), *w2.stride(),
                _DTYPE_CODES[w1.dtype], dx.data_ptr(), partials.data_ptr(), grads.data_ptr(),
                b, h2, n_blocks)
        if split is None:
            self.launch(x.device, *args)
        else:
            self.launch(x.device, *args, split, entry="ttrm_tower_bwd_split")
        o = _LANE * _LANE
        return (dx, grads[:o].view(_LANE, _LANE), grads[o:o + _LANE],
                grads[o + _LANE:o + _LANE + _LANE * h2].view(_LANE, h2),
                grads[o + _LANE + _LANE * h2:])


tower_backward = TowerBackward()
