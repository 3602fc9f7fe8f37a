"""The plain versions of the int8 slice's four kernels (what their wrappers
run on CPU tensors) against the JAX package's Pallas kernels in interpret
mode, at the JAX tests' own shapes and id cases (`tests/test_block_sorted.py`):
the int8 gather (#5), the fused int8 row-wise Adagrad (#6), the dense
aggregate (#3), the row subtract (#7), and the two update routes built on #3
and #7."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu.ops import block_sorted as jbs
from two_tower_recommender_model_tpu.ops import pallas_update as jpu
from two_tower_recommender_model_tpu.ops.quantized import quantize_table as jax_quantize_table
from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import block_sorted_aggregate
from two_tower_recommender_model_tpu_torch.ops.embedding_ops import block_sorted_lookup
from two_tower_recommender_model_tpu_torch.ops.quantized import QuantizedTable
from two_tower_recommender_model_tpu_torch.ops import quantized_kernel as kq
from two_tower_recommender_model_tpu_torch.ops.quantized_kernel import (
    quantized_pooled_gather,
    quantized_rowwise_adagrad_fused,
)
from two_tower_recommender_model_tpu_torch.ops.row_subtract import row_subtract
from two_tower_recommender_model_tpu_torch.train import optimizer as port_opt
from torch_sorted_runs import span_order_sums

R, C, D = 16, 128, 128  # the JAX tests' block rows, chunk and width
M = 3 * C
CASES = ["uniform", "sentinels", "empty_blocks", "one_hot_row", "all_sentinel"]
SIZES = [220, 16 * 11]  # ragged, and an exact multiple of R


def _case(kind: str, rng, n: int, m: int) -> np.ndarray:
    """Sorted ids, as `tests/test_block_sorted.py:_case` makes them."""
    if kind == "uniform":
        ids = rng.integers(0, n, size=m)
    elif kind == "sentinels":
        ids = np.concatenate([rng.integers(0, n, size=m // 2), np.full(m - m // 2, n)])
    elif kind == "empty_blocks":
        ids = np.concatenate([rng.integers(0, R, size=m // 2),
                              rng.integers(n - 3, n, size=m - m // 2)])
    elif kind == "one_hot_row":
        ids = np.full(m, 7)
    else:
        ids = np.full(m, n)
    return np.sort(ids).astype(np.int32)


def _setup(kind, n, salt):
    rng = np.random.default_rng(zlib.crc32(kind.encode()) % 2**31 + salt)
    sids = _case(kind, rng, n, M)
    qt = jax_quantize_table(jnp.asarray(rng.normal(size=(n, D)).astype(np.float32)))
    return rng, sids, np.asarray(qt.values), np.asarray(qt.scales)


def _t(a):
    return torch.from_numpy(np.array(a))


# --- #5 ---------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("n", SIZES)
def test_quantized_gather_matches_pallas(kind, n):
    """rtol 5e-7 (the JAX test's own bound against numpy: XLA multiplies the
    scale by 1/127 where the port divides), sentinel rows exact zeros; and
    equal to numpy's `values * (scales / 127)` bit for bit."""
    _, sids, values, scales = _setup(kind, n, 5)
    want = np.asarray(jbs.block_sorted_lookup_quantized(
        jnp.asarray(values), jnp.asarray(scales), jnp.asarray(sids), r=R, c=C, interpret=True))
    ones = torch.ones((M, 1))
    got = quantized_pooled_gather(_t(values), _t(scales), _t(sids)[:, None], ones).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=0.0)
    np.testing.assert_array_equal(got[sids >= n], 0.0)
    safe = np.minimum(sids, n - 1)
    exact = np.where((sids < n)[:, None],
                     values[safe].astype(np.float32) * (scales[safe] / np.float32(127))[:, None],
                     np.float32(0))
    np.testing.assert_array_equal(got, exact)
    # the call site the train step uses, with the slot mask as the weight
    mask = (np.arange(M) % 5 != 0).astype(np.float32)
    rows = block_sorted_lookup(QuantizedTable(_t(values), _t(scales)), _t(sids), _t(mask),
                               torch.bfloat16)
    assert rows.dtype == torch.bfloat16
    assert torch.equal(rows, (_t(exact) * _t(mask)[:, None]).to(torch.bfloat16))


# --- #6 ---------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_quantized_adagrad_matches_pallas(kind, n, matmul_dtype):
    """Accumulators and scales within rtol 1e-5 / atol 1e-6, int8 values
    within one step (the order of the sum can move a value across a rounding
    boundary), rows no id names byte-exact: the JAX test's own bounds. Under
    "bfloat16" both sides round the gradients to bf16 first."""
    rng, sids, values, scales = _setup(kind, n, 6)
    grads = rng.normal(size=(M, D)).astype(np.float32)
    acc = np.abs(rng.normal(size=n)).astype(np.float32)
    want_v, want_s, want_a = jbs.block_sorted_rowwise_adagrad_fused_quantized(
        jnp.asarray(values), jnp.asarray(scales), jnp.asarray(acc), jnp.asarray(sids),
        jnp.asarray(grads), lr=0.05, eps=1e-10, r=R, c=C, matmul_dtype=matmul_dtype,
        interpret=True)
    v, s, a = _t(values), _t(scales), _t(acc)
    g = _t(grads).to(port_opt.grad_wire_dtype(matmul_dtype))
    out = quantized_rowwise_adagrad_fused(v, s, a, _t(sids), g, 0.05, 1e-10)
    assert out[0] is v and out[1] is s and out[2] is a  # in place
    np.testing.assert_allclose(a.numpy(), np.asarray(want_a), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-6)
    steps = np.abs(v.numpy().astype(np.int32) - np.asarray(want_v, np.int32))
    assert steps.max() <= 1, f"int8 values differ by more than one step ({steps.max()})"
    touched = np.zeros(n, bool)
    touched[sids[sids < n]] = True
    np.testing.assert_array_equal(v.numpy()[~touched], values[~touched])
    np.testing.assert_array_equal(s.numpy()[~touched], scales[~touched])
    np.testing.assert_array_equal(a.numpy()[~touched], acc[~touched])
    assert touched.any() == (not np.array_equal(v.numpy(), values))


def test_zero_gradient_run_keeps_its_bytes():
    """A run whose gradients sum to exactly zero in every column writes
    nothing, in the Pallas kernel and in the port (requantizing such a row
    would move its bytes: it is not idempotent)."""
    rng, sids, values, scales = _setup("uniform", 220, 7)
    grads = rng.normal(size=(M, D)).astype(np.float32)
    acc = np.abs(rng.normal(size=220)).astype(np.float32)
    row = int(sids[M // 2])
    pos = np.flatnonzero(sids == row)
    grads[pos] = 0.0
    if len(pos) > 1:  # gradients that cancel exactly
        grads[pos[0]], grads[pos[1]] = 1.5, -1.5
    want_v, want_s, want_a = jbs.block_sorted_rowwise_adagrad_fused_quantized(
        jnp.asarray(values), jnp.asarray(scales), jnp.asarray(acc), jnp.asarray(sids),
        jnp.asarray(grads), lr=0.05, eps=1e-10, r=R, c=C, interpret=True)
    v, s, a = _t(values), _t(scales), _t(acc)
    quantized_rowwise_adagrad_fused(v, s, a, _t(sids), _t(grads), 0.05, 1e-10)
    for got, want, start in ((v, want_v, values), (s, want_s, scales), (a, want_a, acc)):
        assert got.numpy()[row].tobytes() == start[row].tobytes()
        assert np.asarray(want)[row].tobytes() == start[row].tobytes()
    assert not np.array_equal(v.numpy(), values)  # the other rows did move


@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
def test_quantized_adagrad_through_a_permutation(grad_dtype):
    """`perm` makes the update read `grads[perm[j]]`: the device-sort
    front-end's call equals the call on gradients permuted beforehand, bit
    for bit, and `device_sorted_fused_adagrad` on a `QuantizedTable` is that
    call."""
    rng = np.random.default_rng(12)
    n, m, d = 90, 256, 32
    ids = np.where(rng.random(m) < 0.1, n, rng.integers(0, n, m)).astype(np.int32)
    qt = jax_quantize_table(jnp.asarray(rng.normal(size=(n, d)).astype(np.float32)))
    acc = np.abs(rng.normal(size=n)).astype(np.float32)
    grads = _t(rng.normal(size=(m, d)).astype(np.float32)).to(grad_dtype)
    order = np.argsort(ids, kind="stable")
    a = (_t(qt.values), _t(qt.scales), _t(acc))
    b = (_t(qt.values), _t(qt.scales), _t(acc))
    quantized_rowwise_adagrad_fused(*a, _t(ids[order]), grads, 0.1, 1e-10,
                                    perm=_t(order.astype(np.int32)))
    quantized_rowwise_adagrad_fused(*b, _t(ids[order]), grads[_t(order)].contiguous(), 0.1, 1e-10)
    table, acc_c = QuantizedTable(_t(qt.values), _t(qt.scales)), _t(acc)
    out = port_opt.device_sorted_fused_adagrad(
        table, acc_c, _t(ids), grads.float(), 0.1, 1e-10,
        matmul_dtype="bfloat16" if grad_dtype == torch.bfloat16 else "float32")
    assert out[0] is table and out[1] is acc_c
    for x, y, z in zip(a, b, (table.values, table.scales, acc_c)):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert table.values.dtype == torch.int8


@pytest.mark.parametrize("with_perm", [False, True])
def test_hot_id_in_segment_order_matches_pallas(with_perm):
    """One id holds 1,103 of 2,048 positions (a run of 34 pieces), among
    short runs and sentinels. Summed in kernel #6's segment order, then
    updated as the plain version updates, it holds the Pallas kernel at the
    file's bounds (accumulators and scales rtol 1e-5 / atol 1e-6, int8 values
    within one step, rows no id names byte-exact); the port's wrapper (the
    plain version on the CPU) too. With `perm` the ids arrive unsorted and
    the sums read the gradients through the sort's permutation."""
    rng = np.random.default_rng(21)
    n, m = 220, 2048
    ids = np.concatenate([np.full(1100, 37), rng.integers(0, n, m - 1100 - 90), np.full(90, n)])
    rng.shuffle(ids)
    grads = rng.normal(size=(m, D)).astype(np.float32)
    qt = jax_quantize_table(jnp.asarray(rng.normal(size=(n, D)).astype(np.float32)))
    values, scales = np.asarray(qt.values), np.asarray(qt.scales)
    acc = np.abs(rng.normal(size=n)).astype(np.float32)
    order = np.argsort(ids, kind="stable")
    sids = ids[order].astype(np.int32)
    if not with_perm:  # the gradients arrive in sorted order
        grads, ids = grads[order], sids
    g_sorted = grads[order] if with_perm else grads
    want_v, want_s, want_a = jbs.block_sorted_rowwise_adagrad_fused_quantized(
        jnp.asarray(values), jnp.asarray(scales), jnp.asarray(acc), jnp.asarray(sids),
        jnp.asarray(g_sorted), lr=0.05, eps=1e-10, r=R, c=512, interpret=True)
    rows, sums = span_order_sums(sids, _t(g_sorted), n)
    assert (np.bincount(sids[sids < n]) > 32 * 33).sum() == 1  # the hot id spans 34 pieces
    v, s, a = _t(values), _t(scales), _t(acc)
    kq.apply_rowwise_update(v, s, a, rows, sums, 0.05, 1e-10)
    wv, ws, wa = _t(values), _t(scales), _t(acc)
    quantized_rowwise_adagrad_fused(wv, ws, wa, _t(sids), _t(grads), 0.05, 1e-10,
                                    perm=_t(order.astype(np.int32)) if with_perm else None)
    touched = np.zeros(n, bool)
    touched[sids[sids < n]] = True
    for got_v, got_s, got_a in ((v, s, a), (wv, ws, wa)):
        np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-5, atol=1e-6)
        steps = np.abs(got_v.numpy().astype(np.int32) - np.asarray(want_v, np.int32))
        assert steps.max() <= 1, f"int8 values differ by more than one step ({steps.max()})"
        np.testing.assert_array_equal(got_v.numpy()[~touched], values[~touched])
        np.testing.assert_array_equal(got_s.numpy()[~touched], scales[~touched])
        np.testing.assert_array_equal(got_a.numpy()[~touched], acc[~touched])


# --- #3 ---------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_aggregate_matches_pallas(kind, n, matmul_dtype):
    """rtol 1e-5 / atol 1e-5 (f32 summation order; the Pallas kernel sums
    through bf16x3 one-hot matmuls), rows without ids exact zeros."""
    rng = np.random.default_rng(zlib.crc32(kind.encode()) % 2**31 + 3)
    sids = _case(kind, rng, n, M)
    grads = rng.normal(size=(M, D)).astype(np.float32)
    want = np.asarray(jbs.block_sorted_aggregate(n, jnp.asarray(sids), jnp.asarray(grads), r=R,
                                                 c=C, matmul_dtype=matmul_dtype, interpret=True))
    got = block_sorted_aggregate(n, _t(sids),
                                 _t(grads).to(port_opt.grad_wire_dtype(matmul_dtype))).numpy()
    assert got.shape == (n, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    named = np.zeros(n, bool)
    named[sids[sids < n]] = True
    np.testing.assert_array_equal(got[~named], 0.0)


@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("n", SIZES)
def test_block_sorted_rowwise_adagrad_matches_jax(kind, n):
    """The route built on #3 (aggregate, then the masked epilogue) against
    the JAX package's: rtol 1e-5 / atol 1e-6 (f32 summation order),
    untouched rows bitwise; new tensors, the inputs unchanged."""
    rng = np.random.default_rng(zlib.crc32(kind.encode()) % 2**31 + 1)
    sids = _case(kind, rng, n, M)
    grads = rng.normal(size=(M, D)).astype(np.float32)
    table = rng.normal(size=(n, D)).astype(np.float32)
    acc = np.abs(rng.normal(size=n)).astype(np.float32)
    want_t, want_a = jbs.block_sorted_rowwise_adagrad(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(sids), jnp.asarray(grads), lr=0.05,
        eps=1e-10, r=R, c=C, interpret=True)
    t, a = _t(table), _t(acc)
    got_t, got_a = port_opt.block_sorted_rowwise_adagrad(t, a, _t(sids), _t(grads), 0.05, 1e-10)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-5, atol=1e-6)
    named = np.zeros(n, bool)
    named[sids[sids < n]] = True
    np.testing.assert_array_equal(got_t.numpy()[~named], table[~named])
    np.testing.assert_array_equal(t.numpy(), table)


def test_block_sorted_rowwise_adagrad_refuses_unsorted_ids():
    ids = _t(np.array([5, 3, 9, 1], np.int32))
    with pytest.raises(RuntimeError, match="not sorted"):
        port_opt.block_sorted_rowwise_adagrad(torch.zeros((10, 8)), torch.zeros(10), ids,
                                              torch.ones((4, 8)), 0.1)


# --- #7 ---------------------------------------------------------------------------------


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("m", [200, 256, 1])
def test_row_subtract_matches_pallas(d, m):
    """Distinct live ids in any order with sentinels among them (the
    kernel's contract): one f32 subtraction an element in both, so equal bit
    for bit; in place."""
    rng = np.random.default_rng(d + m)
    n = 300
    ids = rng.permutation(n)[:m].astype(np.int32)
    ids[::7] = n  # sentinels: skipped
    table = rng.normal(size=(n, d)).astype(np.float32)
    upd = rng.normal(size=(m, d)).astype(np.float32)
    want = np.asarray(jpu.pallas_row_subtract(jnp.asarray(table), jnp.asarray(ids),
                                              jnp.asarray(upd), interpret=True))
    t = _t(table)
    assert row_subtract(t, _t(ids), _t(upd)) is t
    np.testing.assert_array_equal(t.numpy(), want)
    live = ids[ids < n]
    assert np.array_equal(t.numpy()[live], table[live] - upd[ids < n])
    rest = np.ones(n, bool)
    rest[live] = False
    np.testing.assert_array_equal(t.numpy()[rest], table[rest])


@pytest.mark.parametrize("kind", ["mixed", "all-sentinels", "one-id"])
def test_pallas_sparse_rowwise_adagrad_matches_jax(kind):
    """The route built on #7 against the JAX package's, on unsorted ids with
    duplicates and sentinels: rtol 1e-5 / atol 1e-6 (f32 summation order of
    the segment sums), untouched rows bitwise; in place."""
    rng = np.random.default_rng(len(kind))
    n, m, d = 200, 256, 128
    ids = {"mixed": np.where(rng.random(m) < 0.15, n, rng.integers(0, n // 2, m)),
           "all-sentinels": np.full(m, n), "one-id": np.full(m, 11)}[kind].astype(np.int32)
    table = rng.normal(size=(n, d)).astype(np.float32)
    acc = np.abs(rng.normal(size=n)).astype(np.float32)
    grads = rng.normal(size=(m, d)).astype(np.float32)
    want_t, want_a = jpu.pallas_sparse_rowwise_adagrad(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(ids), jnp.asarray(grads), 0.05,
        interpret=True)
    t, a = _t(table), _t(acc)
    got_t, got_a = port_opt.pallas_sparse_rowwise_adagrad(t, a, _t(ids), _t(grads), 0.05)
    assert got_t is t and got_a is a
    np.testing.assert_allclose(t.numpy(), np.asarray(want_t), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a.numpy(), np.asarray(want_a), rtol=1e-5, atol=1e-6)
    named = np.zeros(n, bool)
    named[ids[ids < n]] = True
    np.testing.assert_array_equal(t.numpy()[~named], table[~named])
    np.testing.assert_array_equal(a.numpy()[~named], acc[~named])
    # and against the port's own oracle
    exp_t, exp_a = port_opt.sparse_rowwise_adagrad(_t(table), _t(acc), _t(ids), _t(grads), 0.05)
    torch.testing.assert_close(t, exp_t, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(a, exp_a, rtol=1e-6, atol=1e-7)


# --- what a wrapper refuses ----------------------------------------------------------------


def test_wrappers_check_their_inputs():
    """Wrong dtypes and shapes raise on any device; on a CPU tensor any D
    runs (the plain version), the D % 4 rule is the CUDA kernels'."""
    v, s = torch.zeros((10, 6), dtype=torch.int8), torch.zeros(10)
    ids1, ids2 = torch.zeros(4, dtype=torch.int32), torch.zeros((4, 1), dtype=torch.int32)
    w = torch.ones((4, 1))
    assert quantized_pooled_gather(v, s, ids2, w).shape == (4, 6)
    with pytest.raises(ValueError, match="int8"):
        quantized_pooled_gather(v.float(), s, ids2, w)
    with pytest.raises(TypeError, match="int32"):
        quantized_pooled_gather(v, s, ids2.long(), w)
    with pytest.raises(TypeError, match="out_dtype"):
        quantized_pooled_gather(v, s, ids2, w, torch.float16)
    with pytest.raises(ValueError, match="acc"):
        quantized_rowwise_adagrad_fused(v, s, torch.zeros(9), ids1, torch.zeros((4, 6)), 0.1)
    with pytest.raises(ValueError, match="grads"):
        quantized_rowwise_adagrad_fused(v, s, torch.zeros(10), ids1, torch.zeros((3, 6)), 0.1)
    with pytest.raises(ValueError, match="sids"):
        block_sorted_aggregate(10, ids2, torch.zeros((4, 6)))
    with pytest.raises(ValueError, match="updates"):
        row_subtract(torch.zeros((10, 6)), ids1, torch.zeros((4, 5)))
    for wrapper in (quantized_pooled_gather, quantized_rowwise_adagrad_fused,
                    block_sorted_aggregate, row_subtract):
        assert wrapper.launches == 0  # a CPU call launches nothing
