"""two_tower_recommender_model_tpu_torch — the PyTorch/CUDA port of the
two-tower framework, for NVIDIA Hopper (H100).

The JAX package `two_tower_recommender_model_tpu` stays the reference: every
module here mirrors its counterpart's path and public names, and the tests
(`tests/test_torch_*.py`) run both on the same numpy inputs. This package
imports `torch` and numpy, never `jax`, `flax` or `optax`, and nothing of the
JAX package.

What it covers today: serving, training (BCE and the in-batch sampled
softmax; eager steps and K steps as one CUDA graph), int8 and bf16 table
storage, the gather probe, the Instacart pipeline from CSVs to recall@100
(host side on numpy and the standard library: no pandas), and the workflow
around it: checkpoints and resume, crash restarts, the model registry,
batch scoring, profiling and the per-user table:

- `config`                 — the model dataclasses and `TrainConfig`, equal
                             field for field to the JAX package's.
- `data.featurizer`        — host hashing (`id % N`, dropped id 0) into `[B, L]`
                             id/mask tensors on the device.
- `data.device_featurizer` — packed input: raw ids (+ the label bit) packed on
                             the host, hashed and masked on the device.
- `data.synthetic`         — the synthetic clickstream generator.
- `data.replica`           — the schema-faithful Instacart CSVs.
- `data.ingest`            — CSV tables with their schemas, the order_detail join.
- `data.feature_engineering` — positives, sampled negatives, the per-user
                             split, id indexing.
- `data.shards`            — TTRS shard files and datasets.
- `data.loader`            — `StreamLoader`: seeded, resumable, multi-host
                             batches over shards.
- `data.prepacked`         — datasets stored in the packed device layout.
- `ops.embedding_kernel`   — the CUDA pooled-gather kernel
                             (`csrc/pooled_gather.cu`), its ctypes binding and
                             its plain PyTorch version.
- `ops.embedding_ops`      — `pooled_lookup`, the sorted feature's lookup, and
                             `row_grads_from_pooled`.
- `ops.adagrad_kernel`     — the CUDA fused row-wise Adagrad kernel and the
                             dense aggregate kernel (`csrc/rowwise_adagrad.cu`)
                             and their plain versions.
- `ops.quantized`          — int8 tables: `QuantizedTable`, the quantization
                             scheme, the plain int8 updates.
- `ops.quantized_kernel`   — the CUDA int8 pooled-gather kernel
                             (`csrc/quantized_gather.cu`) and the fused int8
                             row-wise Adagrad kernel
                             (`csrc/quantized_adagrad.cu`), their plain versions.
- `ops.row_subtract`       — the CUDA in-place row-subtract kernel
                             (`csrc/row_subtract.cu`) and its plain version.
- `ops.tower_bwd`          — the CUDA fused two-layer tower backward
                             (`csrc/tower_bwd.cu`) and its plain version.
- `ops.softmax_kernel`     — the CUDA fused in-batch sampled-softmax kernels
                             (`csrc/softmax_lse.cu`: the online logsumexp and
                             its dq and dc) and their plain versions.
- `ops.probe_sum`          — the CUDA per-row-block sum kernels
                             (`csrc/probe_sum.cu`), the gather probe's
                             consumers, and their plain versions.
- `ops.topk`               — exact corpus-chunked top-k, ties to the lower index.
- `models`                 — MLP towers (with the fused-backward route), the
                             `TwoTower` module, losses and streaming metrics.
- `train`                  — optimizers, the train and eval steps, the
                             multi-step (K steps in one call: on the card one
                             CUDA graph), the input pipeline, the train/val/test
                             loop, the packed macro-step epoch, and
                             `resilient_fit` (restarts on transient errors).
- `tools.probe_consumer`   — the gather probe (`python -m ...tools.probe_consumer`).
- `evaluation.retrieval`   — full-corpus tower embedding export, the retriever
                             metrics, a split's held-out positives, the
                             per-epoch retrieval eval and the per-user table
                             (a pandas DataFrame; pandas loads only there).
- `device`                 — `default_device()`: the card, or an error that
                             says to pass `device="cpu"`.
- `serving`                — `Scorer`, `RetrievalService`, HTTP `ModelServer`,
                             `load_scorer_from_registry`, `batch.batch_predict`.
- `utils.checkpoint`       — `Checkpointer` (whole training states, atomic
                             steps, in-place restore) and the portable export:
                             `export_model`, `load_model`.
- `utils.registry`         — `ModelRegistry`: numbered versions, stages.
- `utils.profiling`        — `profile_trace`, `StepTimer`, `device_memory_stats`.
- `utils.tracking`         — `ExperimentLogger`: params, metrics, artifacts a run.
- `cli`                    — the pipeline's entry points (`python -m
                             ...cli.instacart_pipeline`, `fetch_instacart`,
                             `prepare_instacart`, `train`, `evaluate_retrieval`).
- `tools.pipeline_host_timing` — the host stages' seconds and peak memory.
- `tools.full_scale_quality` — the full-scale quality runs (BCE, sampled
                             softmax) through the entry points.

Numerics: float32 matmuls run in full float32. Importing this package sets
`torch.backends.cuda.matmul.allow_tf32 = False` and
`torch.backends.cudnn.allow_tf32 = False`, so no product silently drops to
TF32 (the reference tests run JAX at "highest" matmul precision), and
`torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False`,
so a bf16 GEMM (the fused tower's forward under bf16 compute) sums in f32 to
the end and rounds once, as the reference's f32-accumulated bf16 dot does:
cuBLAS would otherwise be free to add split-K partials in bf16.

Entry points that take a `device` run on the card when given none, and raise
without a card; they land on the CPU only when the caller passes
`device="cpu"` (or a CPU generator, or CPU tensors).

Importing builds nothing: each CUDA kernel compiles with `nvcc` at its first
launch on a CUDA tensor (`ops/_build.py`).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"
from two_tower_recommender_model_tpu_torch.device import default_device  # noqa: F401
