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
CUDA tensors and takes `tower_backward_reference` only for tensors that lie
on the CPU. It counts its kernel launches in `tower_backward.launches`.
`fits` is the reference's shape gate, unchanged, so both packages route the
same shapes through the fused backward.
"""

from __future__ import annotations

import ctypes

import torch

from two_tower_recommender_model_tpu_torch.ops import _build

MIN_TILE = 512  # the reference's batch granule (its smallest TPU tile)
_LANE = 128
_TILE_ROWS = 32  # rows per tile of the CUDA kernel
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


class TowerBackward(_build.KernelLibrary):
    """The tower-backward wrapper: checks its inputs, allocates the outputs
    and the per-block partial sums, and launches the CUDA kernel on the
    current stream (no sync).

    The library builds at the first launch (`load`). `launches` counts kernel
    launches and nothing else: a CPU call takes `tower_backward_reference`
    and does not count."""

    def __init__(self):
        super().__init__("tower_bwd", "ttrm_tower_bwd", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64])

    def __call__(self, x: torch.Tensor, dq: torch.Tensor, out: torch.Tensor, w1: torch.Tensor,
                 b1: torch.Tensor, w2: torch.Tensor):
        """(dx [B, 128] in x's dtype, dW1 [128, 128], db1 [128], dW2 [128, H2],
        db2 [H2]), the weight gradients in f32."""
        _check(x, dq, out, w1, b1, w2)
        if x.device.type == "cpu":
            return tower_backward_reference(x, dq, out, w1, b1, w2)
        if x.device.type != "cuda":
            raise ValueError(f"tower_backward runs on cpu or cuda tensors, got {x.device}")
        b, h2 = x.shape[0], w2.shape[1]
        if b % _TILE_ROWS:
            raise ValueError(f"the CUDA kernel needs B % {_TILE_ROWS} == 0, got B={b}")
        w1f, b1f, w2f = (t.to(torch.float32).contiguous() for t in (w1, b1, w2))
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        n_blocks = min(b // _TILE_ROWS, sms)  # one 193 KB shared-memory block per SM
        n_out = _LANE * _LANE + _LANE + _LANE * h2 + h2
        dx = torch.empty_like(x)
        partials = torch.empty((n_blocks, n_out), dtype=torch.float32, device=x.device)
        grads = torch.empty(n_out, dtype=torch.float32, device=x.device)
        self.launch(x.device, x.data_ptr(), dq.data_ptr(), out.data_ptr(),
                    _DTYPE_CODES[x.dtype], w1f.data_ptr(), b1f.data_ptr(), w2f.data_ptr(),
                    dx.data_ptr(), partials.data_ptr(), grads.data_ptr(), b, h2, n_blocks)
        o = _LANE * _LANE
        return (dx, grads[:o].view(_LANE, _LANE), grads[o:o + _LANE],
                grads[o + _LANE:o + _LANE + _LANE * h2].view(_LANE, h2),
                grads[o + _LANE + _LANE * h2:])


tower_backward = TowerBackward()
