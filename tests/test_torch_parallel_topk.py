"""The port's sharded top-k (`parallel.sharded.make_sharded_topk`) and
`RetrievalService(mesh=)` on gloo ranks, against the JAX package's
`make_sharded_topk` and one-device `RetrievalService`, and the port's
one-device `chunked_topk` and service, on the same inputs
(`tests/test_sharded.py:157`, `:176`, `:192`; `tests/test_serving.py:67`):
the dense match, k above a shard's rows, a corpus that is not a multiple of
the ranks (its pad rows masked before each shard's selection), and tied
scores across shards, which go to the lower global row as on one device.

Tolerances: the rows equal; the scores within rtol 1e-5 / atol 1e-6 of the
JAX package's and of numpy's f64 product (the reference's bars), and
within rtol 1e-6 of the port's one-device top-k (the same f32 products;
only the chunks' boundaries differ). The tie case draws small integers, so
every score is exact and equal scores are equal bit for bit.

Four ranks (spawned processes, one gloo group) serve every case."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import P as _P
from jax.sharding import NamedSharding

import torch_parallel_ranks as ranks
from two_tower_recommender_model_tpu import config as cfg_lib
from two_tower_recommender_model_tpu.models.two_tower import init_params
from two_tower_recommender_model_tpu.parallel import make_mesh
from two_tower_recommender_model_tpu.parallel.sharded import make_sharded_topk
from two_tower_recommender_model_tpu.serving import RetrievalService as JaxRetrievalService
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.models.two_tower import params_from_numpy
from two_tower_recommender_model_tpu_torch.ops.topk import chunked_topk
from two_tower_recommender_model_tpu_torch.serving.retrieval_service import RetrievalService


@pytest.fixture(scope="module")
def pool():
    p = ranks.RankPool(4)
    yield p
    p.close()


def _jax_topk(mesh_shape, corpus, queries, k, chunk):
    mesh = make_mesh(*mesh_shape)
    sharded = jax.device_put(jnp.asarray(corpus), NamedSharding(mesh, _P(("data", "model"), None)))\
        if corpus.shape[0] % mesh.devices.size == 0 else jnp.asarray(corpus)
    vals, idx = make_sharded_topk(mesh, k=k, corpus_chunk=chunk)(jnp.asarray(queries), sharded)
    return np.asarray(vals), np.asarray(idx)


def _check(pool, corpus, queries, k, chunk, mesh_shape, jax_mesh):
    got = pool.run("topk_ranks", corpus=corpus, queries=queries, k=k, chunk=chunk,
                   mesh_shape=mesh_shape)
    scores = queries.astype(np.float64) @ corpus.astype(np.float64).T
    want_idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    want_vals = np.take_along_axis(scores, want_idx, 1)
    jvals, jidx = _jax_topk(jax_mesh, corpus, queries, k, chunk)
    one_vals, one_idx = chunked_topk(torch.from_numpy(queries), torch.from_numpy(corpus), k=k,
                                     corpus_chunk=chunk)
    for vals, idx in got:  # every rank holds the answer
        np.testing.assert_array_equal(idx, want_idx)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(idx, one_idx.numpy())
        np.testing.assert_allclose(vals, want_vals, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(vals, jvals, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(vals, one_vals.numpy(), rtol=1e-6)
        assert idx.max() < corpus.shape[0]
    return got


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 1)])
def test_sharded_topk_matches_dense(pool, mesh_shape):
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(512, 16)).astype(np.float32)
    queries = rng.normal(size=(10, 16)).astype(np.float32)
    _check(pool, corpus, queries, 12, 32, mesh_shape, (4, 2))


def test_sharded_topk_k_exceeds_shard(pool):
    """k = 16 over four shards of 8 rows: every shard's missing candidates
    score -inf, and the merge still returns the global top 16."""
    rng = np.random.default_rng(1)
    corpus = rng.normal(size=(32, 8)).astype(np.float32)
    queries = rng.normal(size=(3, 8)).astype(np.float32)
    _check(pool, corpus, queries, 16, 8, (4, 1), (8, 1))


def test_sharded_topk_non_multiple_corpus(pool):
    """119 rows over four ranks (30 a shard, one pad row): every true score
    negative, so a zero pad row would win if it reached a shard's
    selection."""
    rng = np.random.default_rng(2)
    corpus = (-np.abs(rng.normal(size=(119, 8))) - 0.1).astype(np.float32)
    queries = (np.abs(rng.normal(size=(5, 8))) + 0.1).astype(np.float32)
    _check(pool, corpus, queries, 12, 16, (4, 1), (4, 2))


def test_sharded_topk_ties_go_to_the_lower_row(pool):
    """Rows repeated across shards (row i of shard 0 again in shards 1-3,
    and twice within a shard), small integers so the equal scores are equal
    bit for bit: the ranks' candidates merge in shard order by a stable
    sort, so ties go to the lower global row, as on one device."""
    rng = np.random.default_rng(3)
    base = rng.integers(-3, 4, size=(16, 8)).astype(np.float32)
    base[5] = base[2]
    corpus = np.concatenate([base, base[::-1], base, base[::2], base[1::2]])
    queries = rng.integers(-2, 3, size=(6, 8)).astype(np.float32)
    got = _check(pool, corpus, queries, 20, 8, (4, 1), (4, 1))
    scores = queries @ corpus.T
    vals, idx = got[0]
    assert any(len(set(row)) < len(row) for row in vals.tolist())  # ties were there
    for q in range(queries.shape[0]):
        for j in range(1, 20):
            if vals[q, j] == vals[q, j - 1]:
                assert idx[q, j] > idx[q, j - 1]
        assert np.array_equal(vals[q], scores[q, idx[q]])


def test_retrieval_service_sharded_mesh_matches_single_device(pool):
    """`RetrievalService(mesh=)`: the corpus row-sharded over the ranks
    (51 items -> 50 rows past the sentinel, not a multiple of 4) == the JAX
    package's one-device service and the port's, before and after a
    `refresh`."""
    mcfg = cfg_lib.two_tower_model_config(num_users=80, num_items=51, embedding_dim=16,
                                          layer_sizes=(16, 8))
    params = jax.tree.map(np.asarray, init_params(jax.random.key(3), mcfg))
    params2 = jax.tree.map(np.asarray, init_params(jax.random.key(4), mcfg))
    users = np.array([1, 5, 17, 42])
    jax_single = JaxRetrievalService(mcfg, params)
    pcfg = port_config.model_config_from_dict(dataclasses.asdict(mcfg))
    port_single = RetrievalService(params_from_numpy(params, pcfg, "cpu"))
    wants = [jax_single.retrieve(users, k=k) for k in (7, 50)]
    mine = [port_single.retrieve(users, k=k) for k in (7, 50)]
    jax_single.refresh(params2)
    port_single.refresh(params_from_numpy(params2, pcfg, "cpu"))
    wants.append(jax_single.retrieve(users, k=5))
    mine.append(port_single.retrieve(users, k=5))
    got = pool.run("retrieval_ranks", cfg=dataclasses.asdict(mcfg), params=params, users=users,
                   ks=[7, 50], mesh_shape=(4, 1), params2=params2, k2=5)
    for per_rank in got:
        for (items, scores), (w_items, w_scores), (m_items, m_scores) in zip(per_rank, wants,
                                                                             mine):
            np.testing.assert_array_equal(items, w_items)
            np.testing.assert_array_equal(items, m_items)
            np.testing.assert_allclose(scores, w_scores, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(scores, m_scores, rtol=1e-6)
