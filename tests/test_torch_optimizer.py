"""The port's row-wise Adagrad (kernel #4's plain version and wrapper, the
oracles, the device-sort front-end) and the towers' optimizer against the
JAX package's, on the same numpy inputs. JAX's Pallas kernel runs in
interpret mode, as the JAX package's own tests run it.

Tolerance: the reference's own for this kernel, f32 summation order
(rtol 1e-5, atol 1e-6); rows no live id names must keep their exact bits."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from two_tower_recommender_model_tpu.ops.block_sorted import block_sorted_rowwise_adagrad_fused
from two_tower_recommender_model_tpu.train import optimizer as jax_opt
from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import (
    rowwise_adagrad,
    rowwise_adagrad_reference,
)
from two_tower_recommender_model_tpu_torch.train import optimizer as port_opt

N, D, M, LR, EPS = 1000, 128, 1024, 0.05, 1e-10
F32 = dict(rtol=1e-5, atol=1e-6)


def _case(seed, sort=True, bf16=False):
    """Ids with duplicates and sentinels (>= N), grads, table, accumulator."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N // 4, M)  # a quarter of the rows: many duplicates
    ids[rng.random(M) < 0.1] = N + rng.integers(0, 5)  # dead slots
    ids[:7] = 3  # one long run
    if sort:
        ids = np.sort(ids)
    grads = rng.normal(size=(M, D)).astype(np.float32)
    if bf16:  # values a bf16 gradient can hold
        grads = np.asarray(jnp.asarray(grads).astype(jnp.bfloat16).astype(jnp.float32))
    table = rng.normal(size=(N, D)).astype(np.float32)
    acc = np.abs(rng.normal(size=N)).astype(np.float32)
    return ids.astype(np.int32), grads, table, acc


def _port_update(fn, ids, grads, table, acc, grad_dtype=torch.float32, **kw):
    t, a = torch.from_numpy(table.copy()), torch.from_numpy(acc.copy())
    fn(t, a, torch.from_numpy(ids.copy()), torch.from_numpy(grads.copy()).to(grad_dtype), LR,
       EPS, **kw)
    return t.numpy(), a.numpy()


def _untouched_bitwise(ids, table, acc, got_t, got_a):
    live = np.zeros(N, bool)
    live[ids[ids < N]] = True
    assert live.any() and not live.all()
    np.testing.assert_array_equal(got_t[~live].view(np.int32), table[~live].view(np.int32))
    np.testing.assert_array_equal(got_a[~live].view(np.int32), acc[~live].view(np.int32))


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_plain_version_matches_pallas_kernel(grad_dtype):
    ids, grads, table, acc = _case(1, bf16=grad_dtype == "bfloat16")
    want_t, want_a = block_sorted_rowwise_adagrad_fused(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(ids), jnp.asarray(grads), LR, EPS,
        matmul_dtype=grad_dtype, interpret=True)
    got_t, got_a = _port_update(rowwise_adagrad_reference, ids, grads, table, acc,
                                getattr(torch, grad_dtype))
    np.testing.assert_allclose(got_t, np.asarray(want_t), **F32)
    np.testing.assert_allclose(got_a, np.asarray(want_a), **F32)
    _untouched_bitwise(ids, table, acc, got_t, got_a)
    _untouched_bitwise(ids, table, acc, np.asarray(want_t), np.asarray(want_a))


@pytest.mark.parametrize("sort", [True, False])
def test_plain_version_matches_sparse_rowwise_adagrad(sort):
    ids, grads, table, acc = _case(2, sort=sort)
    want_t, want_a = jax_opt.sparse_rowwise_adagrad(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(ids), jnp.asarray(grads), LR, EPS)
    got_t, got_a = _port_update(rowwise_adagrad_reference, ids, grads, table, acc)
    np.testing.assert_allclose(got_t, np.asarray(want_t), **F32)
    np.testing.assert_allclose(got_a, np.asarray(want_a), **F32)
    _untouched_bitwise(ids, table, acc, got_t, got_a)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    ids, grads, table, acc = _case(3)
    before = rowwise_adagrad.launches
    got = _port_update(rowwise_adagrad, ids, grads, table, acc)
    want = _port_update(rowwise_adagrad_reference, ids, grads, table, acc)
    assert rowwise_adagrad.launches == before and rowwise_adagrad._built is None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_permutation_reads_grads_in_place():
    """grads[perm[j]] for the j-th sorted id equals updating with the
    permuted copy."""
    ids, grads, table, acc = _case(4, sort=False)
    order = np.argsort(ids, kind="stable").astype(np.int32)
    want = _port_update(rowwise_adagrad_reference, ids[order], grads[order], table, acc)
    got = _port_update(rowwise_adagrad, ids[order], grads, table, acc,
                       perm=torch.from_numpy(order))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bad", ["table_f64", "acc_shape", "ids_int64", "grads_f16",
                                 "grads_shape", "perm_int64", "strided"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    t, a = torch.zeros(N, D), torch.zeros(N)
    ids, g, perm = torch.zeros(M, dtype=torch.int32), torch.zeros(M, D), None
    if bad == "table_f64":
        t = t.double()
    elif bad == "acc_shape":
        a = torch.zeros(N + 1)
    elif bad == "ids_int64":
        ids = ids.long()
    elif bad == "grads_f16":
        g = g.half()
    elif bad == "grads_shape":
        g = torch.zeros(M, D + 1)
    elif bad == "perm_int64":
        perm = torch.zeros(M, dtype=torch.int64)
    elif bad == "strided":
        g = torch.zeros(D, M).T
    with pytest.raises((ValueError, TypeError)):
        rowwise_adagrad(t, a, ids, g, LR, EPS, perm=perm)


@pytest.mark.parametrize("name", ["sparse_rowwise_adagrad", "dense_rowwise_adagrad"])
def test_oracles_match_jax(name):
    ids, grads, table, acc = _case(5, sort=False)
    want_t, want_a = getattr(jax_opt, name)(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(ids), jnp.asarray(grads), LR, EPS)
    got_t, got_a = getattr(port_opt, name)(
        torch.from_numpy(table), torch.from_numpy(acc), torch.from_numpy(ids),
        torch.from_numpy(grads), LR, EPS)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **F32)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **F32)
    _untouched_bitwise(ids, table, acc, got_t.numpy(), got_a.numpy())


def test_aggregate_grads_by_row_matches_jax():
    ids, grads, _, _ = _case(6, sort=False)
    want = jax_opt.aggregate_grads_by_row(jnp.asarray(ids), jnp.asarray(grads), N)
    got = port_opt.aggregate_grads_by_row(torch.from_numpy(ids), torch.from_numpy(grads), N)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **F32)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_masked_epilogue_matches_jax():
    rng = np.random.default_rng(7)
    table = rng.normal(size=(N, D)).astype(np.float32)
    acc = np.abs(rng.normal(size=N)).astype(np.float32)
    g = rng.normal(size=(N, D)).astype(np.float32)
    touched = rng.random(N) < 0.3
    want = jax_opt.masked_rowwise_adagrad_epilogue(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(g), jnp.asarray(touched), LR, EPS)
    got = port_opt.masked_rowwise_adagrad_epilogue(
        torch.from_numpy(table), torch.from_numpy(acc), torch.from_numpy(g),
        torch.from_numpy(touched), LR, EPS)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_device_sorted_front_end_matches_jax(matmul_dtype):
    ids, grads, table, acc = _case(8, sort=False)
    want_t, want_a = jax_opt.device_sorted_fused_adagrad(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(ids), jnp.asarray(grads), LR, EPS,
        matmul_dtype=matmul_dtype)
    got_t, got_a = _port_update(port_opt.device_sorted_fused_adagrad, ids, grads, table, acc,
                                matmul_dtype=matmul_dtype)
    np.testing.assert_allclose(got_t, np.asarray(want_t), **F32)
    np.testing.assert_allclose(got_a, np.asarray(want_a), **F32)
    _untouched_bitwise(ids, table, acc, got_t, got_a)


def test_row_grad_flatten_matches_jax():
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 50, (64, 3)).astype(np.int32)
    mask = (rng.random((64, 3)) > 0.3).astype(np.float32)
    rg = rng.normal(size=(64, 3, 8)).astype(np.float32)
    want = jax_opt.row_grad_flatten(jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(rg), 50)
    got = port_opt.row_grad_flatten(torch.from_numpy(ids), torch.from_numpy(mask),
                                    torch.from_numpy(rg), 50)
    assert got[0].dtype == torch.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


SCHEDULES = [
    dict(schedule="constant"),
    dict(schedule="constant", warmup_steps=3),
    dict(schedule="linear", total_steps=10, end_factor=0.1),
    dict(schedule="linear", total_steps=10, warmup_steps=2),
    dict(schedule="cosine", total_steps=10, end_factor=0.05),
    dict(schedule="cosine", total_steps=10, warmup_steps=4),
]


@pytest.mark.parametrize("kwargs", SCHEDULES)
def test_dense_optimizer_schedules_match_optax(kwargs):
    """The learning rate of update t, read from optax: after t updates with a
    zero gradient (moments stay zero, the count advances), a unit gradient
    gives the update -lr(t) * m_hat / (sqrt(v_hat) + eps) with
    m_hat = 0.1 / (1 - 0.9^(t+1)) and v_hat = 0.001 / (1 - 0.999^(t+1))."""
    port = port_opt.dense_optimizer(0.01, **kwargs)
    tx = jax_opt.dense_optimizer(0.01, **kwargs)
    params = jnp.zeros(())
    for t in range(14):
        state = tx.init(params)
        for _ in range(t):
            _, state = tx.update(jnp.zeros(()), state, params)
        upd, _ = tx.update(jnp.ones(()), state, params)
        m_hat = 0.1 / (1 - 0.9 ** (t + 1))
        v_hat = 0.001 / (1 - 0.999 ** (t + 1))
        want = -float(upd) / (m_hat / (np.sqrt(v_hat) + 1e-8))
        # optax evaluates the schedule and the Adam step in f32, a dozen
        # roundings of ~6e-8 each; the port's schedule is exact Python math
        np.testing.assert_allclose(port.schedule(t), want, rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_steps_match_optax(weight_decay):
    rng = np.random.default_rng(10)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(4)]
    tx = jax_opt.dense_optimizer(0.01, "cosine", total_steps=4, weight_decay=weight_decay)
    params, state = jnp.asarray(p0), None
    state = tx.init(params)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, upd)
    recipe = port_opt.dense_optimizer(0.01, "cosine", total_steps=4, weight_decay=weight_decay)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = recipe.build([p])
    for t, g in enumerate(grads):
        p.grad = torch.from_numpy(g)
        recipe.step(opt, t)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=1e-5, atol=1e-7)
