"""The fused two-layer tower forward under bf16 compute: the CUDA kernel's
wrapper and its plain version.

    out = relu(relu(x @ w1 + b1) @ w2 + b2)

for x [B, 128], w1 [128, 128], b1 [128], w2 [128, H2], b2 [H2], all bf16,
the weights in the reference's [in, out] layout, on the shapes that the
fused tower backward takes (`ops.tower_bwd.fits`: 0 < H2 <= 128, B % 512 ==
0). Each product sums in f32 and rounds once to bf16 (`_mm`); each layer's
bias and ReLU are relu_ties's (`ops/relu_ties.py`): a sum at a bf16 rounding
tie against -b is summed again in k order, so the forward makes the ReLU
decisions that the tower backward (#8), the plain version and the host make.

`tower_forward` launches the hand-written kernel of `csrc/tower_fwd.cu` (both
layers in one kernel, h1 kept in shared memory; x by TMA into a ring that a
producer warp keeps full, each tile's ties pooled and summed again by one
warp, the output out by TMA stores) on CUDA tensors and takes
`tower_forward_reference` only for tensors that lie on the CPU. It
counts its kernel launches in `tower_forward.launches`. No TPU kernel is
replaced: the reference's `_mlp2_fwd_impl` (`models/mlp.py:89` of the JAX
package) is two dots that XLA fuses with their bias and ReLU.
"""

from __future__ import annotations

import ctypes

import torch

from two_tower_recommender_model_tpu_torch.ops import _build
from two_tower_recommender_model_tpu_torch.ops.relu_ties import relu_ties_reference
from two_tower_recommender_model_tpu_torch.ops.tower_bwd import fits

# the stages a split launch runs the kernel up to (`TowerForward.split`), in its order
SPLIT_STAGES = ("loads", "products", "epilogue", "ties", "stores")


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`a @ w` in a's dtype, summed in f32 and rounded once (the reference's
    `preferred_element_type=f32` then cast). On CUDA bf16 operands this is one
    bf16 GEMM: cuBLAS sums in f32, and the package turns off its bf16
    reduction of split-K partials at import. Elsewhere the operands are
    widened to f32 (products of bf16 values are exact in f32, so the two
    routes differ only in the order of the sum)."""
    if a.is_cuda and a.dtype == w.dtype == torch.bfloat16:
        return torch.matmul(a, w)
    return torch.matmul(a.float(), w.float()).to(a.dtype)


@torch.no_grad()
def tower_forward_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                            w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, on any device: each layer's product by
    `_mm`, then relu_ties's tie test, k-order recompute, bias and ReLU."""
    h1 = relu_ties_reference(_mm(x, w1), b1, x, w1)
    return relu_ties_reference(_mm(h1, w2), b2, h1, w2)


_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]


class TowerForward(_build.KernelLibrary):
    """The wrapper: checks its inputs, allocates the output and launches the
    CUDA kernel on the current stream (no sync), one launch in `launches`,
    which counts kernel launches and nothing else: a CPU call takes
    `tower_forward_reference` and does not count."""

    def __init__(self):
        super().__init__("tower_fwd", "ttrm_tower_fwd", _ARGS,
                         extra={"ttrm_tower_fwd_split": [*_ARGS, ctypes.c_int64]})

    def __call__(self, x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor) -> torch.Tensor:
        """`relu(relu(x @ w1 + b1) @ w2 + b2)` [B, H2] bf16. The weights may
        have any strides (an `nn.Linear` weight's `.T` is read as it lies);
        x is made contiguous and must then lie on a 16-byte boundary."""
        x, b1, b2 = self._check(x, w1, b1, w2, b2)
        if x.device.type == "cpu":
            return tower_forward_reference(x, w1, b1, w2, b2)
        return self._launch(x, w1, b1, w2, b2)

    def split(self, stage: str, x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
        """One launch of the kernel run up to `stage` of `SPLIT_STAGES` (the
        x loads alone; and the products; and the epilogues, ties taken as
        none; and the tie rounds; "stores" is the whole kernel), at H2 = 64
        on CUDA tensors: for timing a tile's parts. Before "stores" the
        output is not the function's."""
        if stage not in SPLIT_STAGES:
            raise ValueError(f"stage must be one of {SPLIT_STAGES}, got {stage!r}")
        x, b1, b2 = self._check(x, w1, b1, w2, b2)
        if x.device.type != "cuda" or w2.shape[1] != 64:
            raise ValueError("a split launch runs the CUDA kernel at H2 = 64 on CUDA tensors")
        return self._launch(x, w1, b1, w2, b2, split=(SPLIT_STAGES.index(stage) + 1) % 5)

    @staticmethod
    def _check(x, w1, b1, w2, b2) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Refuses what the kernel and its plain version do not take; x, b1
        and b2 as they are passed on."""
        if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2 or b1.dim() != 1 or b2.dim() != 1:
            raise ValueError("x, w1, w2 must be 2-d and b1, b2 1-d")
        (batch, d_in), h1, h2 = x.shape, w1.shape[1], w2.shape[1]
        if w1.shape[0] != d_in or b1.shape != (h1,) or w2.shape[0] != h1 or b2.shape != (h2,):
            raise ValueError(f"shapes: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, b1 "
                             f"{tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)} "
                             "do not chain")
        if not fits(d_in, h1, h2, batch):
            raise ValueError(f"the fused tower takes d_in = h1 = 128, 0 < h2 <= 128 and B % 512 "
                             f"== 0; got d_in={d_in}, h1={h1}, h2={h2}, B={batch}")
        if any(t.dtype != torch.bfloat16 for t in (x, w1, b1, w2, b2)):
            raise TypeError("x, w1, b1, w2 and b2 must be bfloat16")
        if len({t.device for t in (x, w1, b1, w2, b2)}) != 1:
            raise ValueError("x, w1, b1, w2 and b2 must share a device")
        if x.device.type == "cpu":
            return x, b1, b2
        if x.device.type != "cuda":
            raise ValueError(f"tower_forward runs on cpu or cuda tensors, got {x.device}")
        x, b1, b2 = x.contiguous(), b1.contiguous(), b2.contiguous()
        if x.data_ptr() % 16:
            raise ValueError("x must lie on a 16-byte boundary (the kernel's TMA reads it)")
        return x, b1, b2

    def _launch(self, x, w1, b1, w2, b2, split: int | None = None) -> torch.Tensor:
        (batch, _), h2 = x.shape, w2.shape[1]
        out = torch.empty((batch, h2), dtype=torch.bfloat16, device=x.device)
        if batch:  # the kernel's grid: from B and the SM count
            sms = torch.cuda.get_device_properties(x.device).multi_processor_count
            args = (x.data_ptr(), w1.data_ptr(), *w1.stride(), b1.data_ptr(), w2.data_ptr(),
                    *w2.stride(), b2.data_ptr(), out.data_ptr(), batch, h2, sms)
            if split is None:
                self.launch(x.device, *args)
            else:
                self.launch(x.device, *args, split, entry="ttrm_tower_fwd_split")
        return out


tower_forward = TowerForward()
