"""The PyTorch port imports no JAX, nothing of the JAX package and neither
pandas nor pyarrow, and importing it builds nothing. The card's machine has
pandas and pyarrow, but the port's data path runs on numpy and the standard
library by choice; the one function that returns a pandas DataFrame
(`evaluation.retrieval.per_user_retrieval_table`, as the reference's does)
imports pandas when it is called."""

import os
import subprocess
import sys

import pytest

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
    "jax", "jaxlib", "flax", "optax", "two_tower_recommender_model_tpu", "pandas", "pyarrow"))
assert not leaked, leaked
from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import (
    block_sorted_aggregate, rowwise_adagrad)
from two_tower_recommender_model_tpu_torch.ops.embedding_kernel import pooled_gather
from two_tower_recommender_model_tpu_torch.ops.quantized_kernel import (
    quantized_pooled_gather, quantized_rowwise_adagrad_fused)
from two_tower_recommender_model_tpu_torch.ops.probe_sum import (
    probe_block_sums, probe_block_sums2)
from two_tower_recommender_model_tpu_torch.ops.row_subtract import row_subtract
from two_tower_recommender_model_tpu_torch.ops.softmax_kernel import (
    softmax_lse_dc, softmax_lse_dq, softmax_lse_fwd)
from two_tower_recommender_model_tpu_torch.ops.tower_bwd import tower_backward
from two_tower_recommender_model_tpu_torch.ops.relu_ties import relu_ties
from two_tower_recommender_model_tpu_torch.ops.tower_fwd import tower_forward
for wrapper in (pooled_gather, rowwise_adagrad, tower_backward, softmax_lse_fwd, softmax_lse_dq,
                softmax_lse_dc, quantized_pooled_gather, quantized_rowwise_adagrad_fused,
                block_sorted_aggregate, row_subtract, relu_ties, tower_forward):
    assert wrapper._built is None and wrapper.launches == 0
for name in ("train.step", "train.loop", "train.pipeline", "train.optimizer",
             "data.device_featurizer", "data.synthetic", "models.losses", "models.metrics",
             "utils.checkpoint", "ops.softmax_kernel", "evaluation.retrieval", "device",
             "ops.quantized", "ops.quantized_kernel", "ops.row_subtract", "ops.probe_sum",
             "tools", "tools.probe_consumer", "data.shards", "data.loader", "data.prepacked",
             "data.ingest", "data.feature_engineering", "data.replica", "utils.tracking", "cli",
             "cli.fetch_instacart", "cli.prepare_instacart", "cli.train",
             "cli.evaluate_retrieval", "cli.instacart_pipeline", "train.resilient",
             "utils.registry", "utils.profiling", "serving.batch", "data.compact",
             "data.wirecache", "data.device_pool", "ops.relu_ties", "ops.tower_fwd",
             "models.concat_mlp", "tuning", "tuning.sweep", "tuning.adaptive",
             "tuning.multi_seed", "data.parquet", "data.text_features", "examples",
             "examples.end_to_end_instacart_style", "examples.full_scale_synthetic",
             "examples.sweep_example", "examples.text_side_features",
             "examples.tune_retrieval_smoke", "examples.workshop_ratings_style",
             "parallel", "parallel.mesh", "parallel.launch", "parallel.planner",
             "parallel.sharded", "native", "native.build", "native.ttrs", "buildroot"):
    assert pkg.__name__ + "." + name in names, name
print(len(names))
"""


def test_port_imports_no_jax_and_builds_nothing():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 60  # every module was imported


_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _import_roots(path: str) -> set[str]:
    import ast

    with open(os.path.join(_ROOT, path)) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


_JAX_ROOTS = {"jax", "jaxlib", "flax", "optax", "two_tower_recommender_model_tpu"}
_NOT_IMPORTED = _JAX_ROOTS | {"pandas", "pyarrow"}


def test_chip_smoke_imports_no_jax():
    """`chip_smoke.py` imports torch, numpy, the standard library and the
    port, never JAX, the JAX package, pandas or pyarrow."""
    roots = _import_roots("chip_smoke.py")
    assert "two_tower_recommender_model_tpu_torch" in roots
    assert not roots & _NOT_IMPORTED


# the card tests run on the card's machine, which has no JAX
_CARD_TESTS = ["tests/test_torch_embedding_cuda.py", "tests/test_torch_train_cuda.py",
               "tests/test_torch_softmax_cuda.py", "tests/test_torch_quantized_cuda.py",
               "tests/test_torch_device_default.py", "tests/test_torch_probe_cuda.py",
               "tests/test_torch_graph_cuda.py", "tests/test_torch_checkpoint_cuda.py",
               "tests/test_torch_compact_cuda.py", "tests/test_torch_tower_fwd_cuda.py",
               "tests/test_torch_scatter_buffer_cuda.py", "tests/test_torch_ranker_cuda.py",
               "tests/test_torch_shard_local_cuda.py", "tests/test_torch_any_width_cuda.py",
               "tests/test_torch_bf16_params_cuda.py", "tests/test_torch_tower_bwd_cuda.py",
               "tests/test_torch_fresh_thread_cuda.py"]


def test_every_card_test_file_is_listed():
    import glob

    found = {os.path.relpath(f, _ROOT) for f in glob.glob(os.path.join(_ROOT, "tests", "*_cuda.py"))}
    assert found <= set(_CARD_TESTS), found - set(_CARD_TESTS)


def test_the_parallel_tests_ranks_import_no_jax():
    """The gloo ranks of the parallel tests run the port alone."""
    roots = _import_roots("tests/torch_parallel_ranks.py")
    assert "two_tower_recommender_model_tpu_torch" in roots
    assert not roots & _NOT_IMPORTED


# the parallel tests whose port side runs on gloo ranks: a pool of
# `torch_parallel_ranks` (JAX-free, above) or `cli.train` under torchrun
_RANK_TESTS = ["tests/test_torch_parallel_step.py", "tests/test_torch_parallel_eval.py",
               "tests/test_torch_parallel_cli.py", "tests/test_torch_parallel_alltoall.py",
               "tests/test_torch_parallel_column.py", "tests/test_torch_parallel_int8.py",
               "tests/test_torch_parallel_topk.py", "tests/test_torch_parallel_softmax.py",
               "tests/test_torch_parallel_compact.py", "tests/test_torch_parallel_multihost.py"]


def test_every_parallel_test_file_is_listed():
    import glob

    found = {os.path.relpath(f, _ROOT)
             for f in glob.glob(os.path.join(_ROOT, "tests", "test_torch_parallel_*.py"))}
    assert found - set(_RANK_TESTS) == {"tests/test_torch_parallel_planner.py"}


@pytest.mark.parametrize("path", _RANK_TESTS)
def test_parallel_tests_run_the_port_on_jax_free_ranks(path):
    """Each file starts its ranks through `torch_parallel_ranks.RankPool` or
    torchrun, so what runs on a rank imports no JAX, whatever the test's
    own process does."""
    with open(os.path.join(_ROOT, path)) as f:
        src = f.read()
    assert "ranks.RankPool(" in src or "torch.distributed.run" in src
    assert "import torch_parallel_ranks as ranks" in src or "cli.train" in src


@pytest.mark.parametrize("path", _CARD_TESTS)
def test_card_tests_import_no_jax(path):
    roots = _import_roots(path)
    assert "two_tower_recommender_model_tpu_torch" in roots
    assert not roots & _JAX_ROOTS


def test_chip_smoke_fails_without_a_card():
    """Without a CUDA device the script exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, os.path.join(_ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, cwd=_ROOT, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
