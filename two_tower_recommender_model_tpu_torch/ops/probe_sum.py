"""Per-row-block sums: the gather probe's consumer kernels, their wrappers
and their plain versions.

Port of the Pallas TPU kernels `pallas_sum` and `pallas_sum2` of the
reference's `tools/probe_consumer.py`. Their grid has `M // 512` steps; each
step reads one `[512, D]` block (cast to f32) and writes its sum to the same
`(1, 1)` output block, so every step overwrites the one before and the value
returned is the sum of the LAST full block, not of the whole array; rows
from `M // 512 * 512` on are never read. The kernel's use is as a consumer:
it forces every block of a gathered operand to be read by a hand-written
kernel.

On Hopper the blocks run in parallel, so every step's write gets its own
slot:

    probe_block_sums(x)[i]     = sum(x[512 i : 512 (i + 1)])
    probe_block_sums2(a, b)[i] = sum(a[512 i : ...]) + sum(b[512 i : ...])

f32 `[M // 512]`, from f32 or bf16 operands, summed in f32.
`probe_sum(x)` / `probe_sum2(a, b)` return element `[-1]` as a 0-dim tensor:
what `pallas_sum` / `pallas_sum2` return.

The wrappers launch the hand-written kernels of `csrc/probe_sum.cu` on CUDA
tensors and take the `*_reference` versions only for tensors that lie on the
CPU. They count their kernel launches in `.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from two_tower_recommender_model_tpu_torch.ops import _build

BLOCK_ROWS = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(*operands: torch.Tensor) -> None:
    first = operands[0]
    for x in operands:
        if x.dim() != 2:
            raise ValueError(f"operand must be [M, D], got shape {tuple(x.shape)}")
        if x.dtype not in _DTYPE_CODES:
            raise TypeError(f"operand dtype must be float32 or bfloat16, got {x.dtype}")
        if x.shape != first.shape or x.dtype != first.dtype or x.device != first.device:
            raise ValueError("the two operands must share shape, dtype and device")
        if not x.is_contiguous():
            raise ValueError("operand must be contiguous")
    if first.shape[0] < BLOCK_ROWS:
        raise ValueError(f"M must be at least {BLOCK_ROWS} (no full row block to sum), got "
                         f"M={first.shape[0]}")
    if first.shape[1] == 0:
        raise ValueError("D must be positive")


def probe_block_sums_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the kernel: f32 `[M // 512]`."""
    g = x.shape[0] // BLOCK_ROWS
    return x[:g * BLOCK_ROWS].float().reshape(g, -1).sum(1)


def probe_block_sums2_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the two-operand kernel."""
    return probe_block_sums_reference(a) + probe_block_sums_reference(b)


class _ProbeSums(_build.KernelLibrary):
    """A block-sums wrapper: checks its operands, allocates the `[M // 512]`
    f32 output and launches its kernel on the current stream (no sync).
    `launches` counts kernel launches and nothing else: a CPU call takes the
    plain version and does not count."""

    def __init__(self, name: str, entry: str, operands: int, reference):
        super().__init__(name, entry, [
            *[ctypes.c_void_p] * operands, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64], source="probe_sum.cu")
        self._operands = operands
        self._reference = reference

    def __call__(self, *operands: torch.Tensor) -> torch.Tensor:
        if len(operands) != self._operands:
            raise TypeError(f"{self.name} takes {self._operands} operand(s), got {len(operands)}")
        _check(*operands)
        x = operands[0]
        if x.device.type == "cpu":
            return self._reference(*operands)
        if x.device.type != "cuda":
            raise ValueError(f"{self.name} runs on cpu or cuda tensors, got {x.device}")
        if any(t.data_ptr() % 16 for t in operands):
            raise ValueError("the CUDA kernel needs 16-byte aligned operands")
        m, d = x.shape
        out = torch.empty(m // BLOCK_ROWS, dtype=torch.float32, device=x.device)
        self.launch(x.device, *[t.data_ptr() for t in operands], _DTYPE_CODES[x.dtype],
                    out.data_ptr(), m, d)
        return out


probe_block_sums = _ProbeSums("probe_block_sums", "ttrm_probe_block_sums", 1,
                              probe_block_sums_reference)
probe_block_sums2 = _ProbeSums("probe_block_sums2", "ttrm_probe_block_sums2", 2,
                               probe_block_sums2_reference)


def probe_sum(x: torch.Tensor) -> torch.Tensor:
    """What `pallas_sum(x)` returns: the last full row block's sum, 0-dim f32."""
    return probe_block_sums(x)[-1]


def probe_sum2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """What `pallas_sum2(a, b)` returns: the last full row block's two sums
    added, 0-dim f32."""
    return probe_block_sums2(a, b)[-1]
