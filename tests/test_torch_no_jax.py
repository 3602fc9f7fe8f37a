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
from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import rowwise_adagrad
from two_tower_recommender_model_tpu_torch.ops.embedding_kernel import pooled_gather
from two_tower_recommender_model_tpu_torch.ops.softmax_kernel import (
    softmax_lse_dc, softmax_lse_dq, softmax_lse_fwd)
from two_tower_recommender_model_tpu_torch.ops.tower_bwd import tower_backward
for wrapper in (pooled_gather, rowwise_adagrad, tower_backward, softmax_lse_fwd, softmax_lse_dq,
                softmax_lse_dc):
    assert wrapper._built is None and wrapper.launches == 0
for name in ("train.step", "train.loop", "train.pipeline", "train.optimizer",
             "data.device_featurizer", "data.synthetic", "models.losses", "models.metrics",
             "utils.checkpoint", "ops.softmax_kernel", "evaluation.retrieval", "device"):
    assert pkg.__name__ + "." + name in names, name
print(len(names))
"""


def test_port_imports_no_jax_and_builds_nothing():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 30  # every module was imported
