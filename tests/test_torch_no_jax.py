"""The PyTorch port imports no JAX and nothing of the JAX package, and
importing it builds nothing."""

import os
import subprocess
import sys

_PROBE = r"""
import ctypes, importlib, pkgutil, subprocess, sys
import numpy, torch  # their own imports load libraries; the port's must not

def refuse(*args, **kwargs):
    raise AssertionError("importing the port must not build or load a kernel library")

subprocess.run = subprocess.Popen = ctypes.CDLL = refuse

import two_tower_recommender_model_tpu_torch as pkg

names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "optax", "two_tower_recommender_model_tpu"))
assert not leaked, leaked
from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import (
    block_sorted_aggregate, rowwise_adagrad)
from two_tower_recommender_model_tpu_torch.ops.embedding_kernel import pooled_gather
from two_tower_recommender_model_tpu_torch.ops.quantized_kernel import (
    quantized_pooled_gather, quantized_rowwise_adagrad_fused)
from two_tower_recommender_model_tpu_torch.ops.row_subtract import row_subtract
from two_tower_recommender_model_tpu_torch.ops.softmax_kernel import (
    softmax_lse_dc, softmax_lse_dq, softmax_lse_fwd)
from two_tower_recommender_model_tpu_torch.ops.tower_bwd import tower_backward
for wrapper in (pooled_gather, rowwise_adagrad, tower_backward, softmax_lse_fwd, softmax_lse_dq,
                softmax_lse_dc, quantized_pooled_gather, quantized_rowwise_adagrad_fused,
                block_sorted_aggregate, row_subtract):
    assert wrapper._built is None and wrapper.launches == 0
for name in ("train.step", "train.loop", "train.pipeline", "train.optimizer",
             "data.device_featurizer", "data.synthetic", "models.losses", "models.metrics",
             "utils.checkpoint", "ops.softmax_kernel", "evaluation.retrieval", "device",
             "ops.quantized", "ops.quantized_kernel", "ops.row_subtract"):
    assert pkg.__name__ + "." + name in names, name
print(len(names))
"""


def test_port_imports_no_jax_and_builds_nothing():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 33  # every module was imported


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_imports_no_jax():
    """`chip_smoke.py` imports torch, numpy, the standard library and the
    port, never JAX or the JAX package."""
    import ast

    with open(os.path.join(_ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "two_tower_recommender_model_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "optax", "two_tower_recommender_model_tpu"}


def test_chip_smoke_fails_without_a_card():
    """Without a CUDA device the script exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        import pytest

        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(_ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, cwd=_ROOT, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
