"""two_tower_recommender_model_tpu_torch — the PyTorch/CUDA port of the
two-tower framework, for NVIDIA Hopper (H100).

The JAX package `two_tower_recommender_model_tpu` stays the reference: every
module here mirrors its counterpart's path and public names, and the tests
(`tests/test_torch_*.py`) run both on the same numpy inputs. This package
imports `torch` and numpy, never `jax`, `flax` or `optax`, and nothing of the
JAX package.

What it covers today is the serving slice:

- `config`                 — the model dataclasses, equal field for field to
                             the JAX package's, so its exports load here.
- `data.featurizer`        — host hashing (`id % N`, dropped id 0) into `[B, L]`
                             id/mask tensors on the device.
- `ops.embedding_kernel`   — the hand-written CUDA pooled-gather kernel
                             (`csrc/pooled_gather.cu`), its ctypes binding and
                             its plain PyTorch version.
- `ops.embedding_ops`      — `pooled_lookup` (sum / mean pooling) over it.
- `ops.topk`               — exact corpus-chunked top-k, ties to the lower index.
- `models`                 — MLP towers and the `TwoTower` module.
- `evaluation.retrieval`   — full-corpus tower embedding export.
- `serving`                — `Scorer`, `RetrievalService`, HTTP `ModelServer`.
- `utils.checkpoint`       — `load_model` of the JAX package's portable export.

Numerics: float32 matmuls run in full float32. Importing this package sets
`torch.backends.cuda.matmul.allow_tf32 = False` and
`torch.backends.cudnn.allow_tf32 = False`, so no product silently drops to
TF32 (the reference tests run JAX at "highest" matmul precision).

Importing builds nothing: the CUDA kernel compiles with `nvcc` at its first
launch on a CUDA tensor (`ops/_build.py`).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
