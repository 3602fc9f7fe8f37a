"""The port's pooled gather against the JAX package's kernels and lookup.

On the CPU the wrapper takes its plain version; the Pallas kernels run in
interpret mode. The CUDA kernel itself is compared with its plain version in
`test_torch_embedding_cuda.py`, which needs a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu.ops import embedding_ops as jax_embedding_ops
from two_tower_recommender_model_tpu.ops.block_sorted import block_sorted_lookup
from two_tower_recommender_model_tpu.ops.pallas_embedding import pallas_pooled_lookup
from two_tower_recommender_model_tpu_torch.ops.embedding_kernel import (
    pooled_gather,
    pooled_gather_reference,
)
from two_tower_recommender_model_tpu_torch.ops.embedding_ops import pooled_lookup

GATHERS = {"reference": pooled_gather_reference, "wrapper": pooled_gather}


def _bags(rng, n, d, b, bag_l):
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(0, n, (b, bag_l)).astype(np.int32)
    w = (rng.random((b, bag_l)) * (rng.random((b, bag_l)) > 0.3)).astype(np.float32)
    return table, ids, w


@pytest.mark.parametrize("gather", sorted(GATHERS))
@pytest.mark.parametrize("bag_l", [1, 3])
def test_matches_pallas_pooled_lookup(gather, bag_l):
    table, ids, w = _bags(np.random.default_rng(bag_l), 300, 128, 64, bag_l)
    want = np.asarray(pallas_pooled_lookup(jnp.asarray(table), jnp.asarray(ids),
                                           jnp.asarray(w), tile_b=16, interpret=True))
    got = GATHERS[gather](torch.from_numpy(table), torch.from_numpy(ids),
                          torch.from_numpy(w)).numpy()
    if bag_l == 1:  # one product per row: exact
        np.testing.assert_array_equal(got, want)
    else:  # summation order differs
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_matches_block_sorted_lookup(out_dtype):
    """Sorted ids with sentinels (>= N): exact rows and exact zero rows, as
    `block_sorted_lookup` documents (each row is 1.0 x the table row)."""
    rng = np.random.default_rng(11)
    n, d, m = 300, 128, 256
    table = rng.normal(size=(n, d)).astype(np.float32)
    sids = np.sort(np.concatenate([rng.integers(0, n, m - 40),
                                   n + rng.integers(0, 50, 40)])).astype(np.int32)
    jax_out_dtype = jnp.bfloat16 if out_dtype == "bfloat16" else None
    want = np.asarray(block_sorted_lookup(
        jnp.asarray(table), jnp.asarray(sids), interpret=True,
        matmul_dtype=out_dtype, out_dtype=jax_out_dtype).astype(jnp.float32))
    got = pooled_gather(torch.from_numpy(table), torch.from_numpy(sids[:, None]),
                        torch.ones((m, 1)), out_dtype=getattr(torch, out_dtype))
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert not got[torch.from_numpy(sids >= n)].any()


# f32: the same products summed in another order; bf16 compute: the port
# rounds each row, sums in slot order and rounds once (then a mean's division),
# where the reference rounds: bit for bit (`test_torch_pool_rounding.py`)
_TOL = {("float32", 1): (0, 0), ("float32", 3): (1e-6, 1e-6),
        ("bfloat16", 1): (0, 0), ("bfloat16", 3): (0, 0)}


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pooling", ["sum", "mean"])
@pytest.mark.parametrize("bag_l", [1, 3])
def test_matches_embedding_ops_pooled_lookup(compute_dtype, pooling, bag_l):
    rng = np.random.default_rng(5)
    table = rng.uniform(-1, 1, (300, 32)).astype(np.float32)
    ids = rng.integers(0, 300, (48, bag_l)).astype(np.int32)
    mask = (rng.random((48, bag_l)) > 0.3).astype(np.float32)
    ids = np.where(mask > 0, ids, 0).astype(np.int32)
    # the reference route for a table already in the compute dtype passes None
    cdt = None if compute_dtype == "float32" else compute_dtype
    want = np.asarray(jax_embedding_ops.pooled_lookup(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(mask), pooling,
        None if cdt is None else jnp.dtype(cdt)).astype(jnp.float32))
    got = pooled_lookup(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(mask),
                        pooling, None if cdt is None else getattr(torch, cdt))
    assert got.dtype == getattr(torch, compute_dtype)
    rtol, atol = _TOL[(compute_dtype, bag_l)]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=atol)


def test_unknown_pooling_raises():
    with pytest.raises(ValueError, match="pooling"):
        pooled_lookup(torch.zeros(4, 8), torch.zeros(2, 1, dtype=torch.int32),
                      torch.ones(2, 1), "max")


@pytest.mark.parametrize("bad", ["ids_int64", "w_f16", "table_int", "shape", "strided", "3d"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    table = torch.zeros(10, 8)
    ids = torch.zeros(4, 2, dtype=torch.int32)
    w = torch.ones(4, 2)
    if bad == "ids_int64":
        ids = ids.long()
    elif bad == "w_f16":
        w = w.half()
    elif bad == "table_int":
        table = table.int()
    elif bad == "shape":
        w = torch.ones(4, 3)
    elif bad == "strided":
        table = torch.zeros(8, 10).T
    elif bad == "3d":
        table = torch.zeros(10, 8, 1)
    with pytest.raises((TypeError, ValueError)):
        pooled_gather(table, ids, w)


def test_cpu_call_takes_plain_version_and_builds_nothing():
    before = pooled_gather.launches
    out = pooled_gather(torch.ones(5, 4), torch.tensor([[1, 9, -1]], dtype=torch.int32),
                        torch.tensor([[2.0, 1.0, 1.0]]))
    np.testing.assert_array_equal(out.numpy(), [[2.0] * 4])  # ids 9 and -1 are dead
    assert pooled_gather.launches == before
    assert pooled_gather._built is None
