"""Pooled embedding lookup.

Port of `two_tower_recommender_model_tpu/ops/embedding_ops.py:pooled_lookup`.
The lookup always goes through the pooled-gather wrapper
(`ops/embedding_kernel.py`): on a CUDA tensor that launches the CUDA kernel,
on a CPU tensor it takes the kernel's plain version. Mean pooling pre-scales
the slot weights by the live-slot count, as the reference's kernel route
does, and the kernel emits `compute_dtype` directly.

`row_grads_from_pooled` (the sparse backward) is not ported yet: it belongs
to the training step.
"""

from __future__ import annotations

import torch

from two_tower_recommender_model_tpu_torch.ops.embedding_kernel import pooled_gather


def pooled_lookup(
    table: torch.Tensor,  # [N, D]
    ids: torch.Tensor,  # [B, L] int32, already hashed into [0, N)
    mask: torch.Tensor,  # [B, L] float
    pooling: str = "sum",
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:  # [B, D]
    """Gather + masked pool. `mean` divides by the live-slot count (0-length
    bags pool to zero, matching dropped falsy ids). The result is in
    `compute_dtype`, or in the table's dtype when it is None."""
    w = mask.to(torch.float32)
    if pooling == "mean":
        counts = w.sum(dim=1, keepdim=True)
        w = w / torch.clamp(counts, min=1.0)
    elif pooling != "sum":
        raise ValueError(f"unknown pooling {pooling!r}")
    return pooled_gather(table, ids.to(torch.int32).contiguous(), w.contiguous(),
                         out_dtype=compute_dtype)
