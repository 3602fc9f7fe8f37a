"""The sharded step's shard-local work on the card against the same
functions on the CPU, where each kernel's wrapper takes its plain version:
the all-to-all exchange's routing, pre-aggregation (#3), the owner's rows
(#1 at one slot) and update (#4 after the device sort), the column slice's
update (#3 and the epilogue), and the int8 shards' partial pools (#5) and
updates (#6, after the device sort, and on the host-sorted shard's local ids
as they are, with and without the bf16 buffer); the data-parallel softmax's
four stripes through #9, #10 and #11 at their row offsets; the sharded
top-k's merge of four shards by hand. This file imports no JAX,
so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_shard_local_cuda.py

Without a CUDA device the tests skip (the kernels have no CPU mode)."""

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu_torch.ops import softmax_kernel as sk
from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import (
    block_sorted_aggregate,
    rowwise_adagrad,
)
from two_tower_recommender_model_tpu_torch.ops.quantized import QuantizedTable
from two_tower_recommender_model_tpu_torch.ops.quantized_kernel import (
    dequantize_rows,
    quantize_rows,
    quantized_pooled_gather,
    quantized_rowwise_adagrad_fused,
)
from two_tower_recommender_model_tpu_torch.ops.topk import chunked_topk
from two_tower_recommender_model_tpu_torch.parallel import sharded
from two_tower_recommender_model_tpu_torch.train import optimizer as opt_lib

WORLD, ROWS, D, M = 4, 1000, 128, 8192
LR, EPS = 0.05, 1e-10


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ids(rng, hot: bool) -> np.ndarray:
    ids = rng.integers(0, WORLD * ROWS, M)
    if hot:
        ids[rng.random(M) < 0.4] = 1234
    return ids.astype(np.int32)


def _both(dev, *arrays):
    """The arrays as CPU tensors and as tensors on `dev`, each its own copy
    (the updates run in place)."""
    return [tuple(torch.from_numpy(np.array(a)).to(d) for a in arrays) for d in ("cpu", dev)]


@pytest.mark.cuda
@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("factor", [0.05, 1.25])
def test_a2a_route_and_send_grads_match_cpu(dev, hot, factor):
    """`a2a_route` bit for bit the CPU's (slots, ok, the overflow), and the
    pre-aggregated send buffer (#3 on the stably sorted slots) against the
    CPU's `index_add_`: each element within 1e-5 x the sum of the magnitudes
    added into it, #3's bar on a long run (`test_torch_quantized_cuda.py`:
    the kernel sums a run past a warp's window in pieces)."""
    rng = np.random.default_rng(int(hot))
    ids = _ids(rng, hot)
    w = (rng.random(M) > 0.1).astype(np.float32)
    g = rng.normal(size=(M, D)).astype(np.float32)
    cap = sharded.a2a_cap(M, WORLD, factor, ROWS)
    out = []
    for t_ids, t_w, t_g in _both(dev, ids, w, g):
        resp = sharded.a2a_responsible(t_ids, ROWS, WORLD, 1, 0)
        slot, ok, overflow = sharded.a2a_route(t_ids, t_w, ROWS, WORLD, cap, resp)
        before = block_sorted_aggregate.launches
        send = sharded.a2a_send_grads(slot, ok, t_g, WORLD * cap)
        if t_g.is_cuda:
            torch.cuda.synchronize()
            assert block_sorted_aggregate.launches == before + 1
        magnitude = sharded.a2a_send_grads(slot.cpu(), ok.cpu(), t_g.cpu().abs(), WORLD * cap)
        out.append([x.cpu() for x in (slot, ok, overflow, send)] + [magnitude])
    (s0, k0, o0, g0, mag), (s1, k1, o1, g1, _) = out
    assert torch.equal(s0, s1) and torch.equal(k0, k1) and int(o0) == int(o1)
    assert (int(o0) > 0) == (factor == 0.05)
    assert ((g1 - g0).abs() <= 1e-5 * mag).all(), ((g1 - g0).abs() / mag).max()


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [torch.float32, torch.bfloat16])
def test_a2a_owner_rows_and_update_match_cpu(dev, wire):
    """The owner's rows of the received ids (#1 at one slot, empty slots as
    the sentinel: zero rows) bit for bit the CPU's; its update (#4 after the
    device sort, the out-of-shard ids as the sentinel) within rtol 1e-5 of
    the plain version, untouched rows bit for bit."""
    rng = np.random.default_rng(5)
    shard = rng.normal(size=(ROWS, D)).astype(np.float32)
    acc = np.abs(rng.normal(size=ROWS)).astype(np.float32)
    recv = rng.integers(0, WORLD * ROWS, 4096).astype(np.int32)
    recv[rng.random(4096) < 0.2] = WORLD * ROWS  # empty slots
    g = rng.normal(size=(4096, D)).astype(np.float32)
    out = []
    for t_shard, t_acc, t_recv, t_g in _both(dev, shard, acc, recv, g):
        rows = sharded.a2a_owner_rows(t_shard, t_recv, 2, wire)
        local = sharded.shard_local_ids(t_recv, 2, ROWS)
        before = rowwise_adagrad.launches
        opt_lib.device_sorted_fused_adagrad(t_shard, t_acc, local, t_g, LR, EPS)
        if t_g.is_cuda:
            torch.cuda.synchronize()
            assert rowwise_adagrad.launches == before + 1
        out.append([x.cpu() for x in (rows, t_shard, t_acc)])
    (r0, t0, a0), (r1, t1, a1) = out
    assert torch.equal(r0, r1)
    mine = (recv >= 2 * ROWS) & (recv < 3 * ROWS)
    assert not r1[torch.from_numpy(~mine)].any()
    torch.testing.assert_close(t1, t0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a1, a0, rtol=1e-5, atol=1e-6)
    named = np.zeros(ROWS, bool)
    named[recv[mine] - 2 * ROWS] = True
    assert torch.equal(t1[torch.from_numpy(~named)], torch.from_numpy(shard[~named]))


@pytest.mark.cuda
def test_column_update_matches_cpu(dev):
    """A column slice's update (#3 after the device sort, then the epilogue,
    no group: one device) within rtol 1e-5 of the CPU's, untouched rows bit
    for bit."""
    rng = np.random.default_rng(9)
    cols = rng.normal(size=(ROWS, 32)).astype(np.float32)
    acc = np.abs(rng.normal(size=ROWS)).astype(np.float32)
    ids = rng.integers(0, ROWS + 1, M).astype(np.int32)  # ROWS: a dead slot
    ids[:2000] = 17  # a hot row: the span walk's second pass
    g = rng.normal(size=(M, 32)).astype(np.float32)
    out = []
    for t_cols, t_acc, t_ids, t_g in _both(dev, cols, acc, ids, g):
        opt_lib.sparse_rowwise_adagrad_columns(t_cols, t_acc, t_ids, t_g, LR, EPS, 128)
        out.append((t_cols.cpu(), t_acc.cpu()))
    (c0, a0), (c1, a1) = out
    torch.testing.assert_close(c1, c0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a1, a0, rtol=1e-5, atol=1e-6)
    untouched = torch.from_numpy(~np.isin(np.arange(ROWS), ids))
    assert torch.equal(c1[untouched], torch.from_numpy(cols)[untouched])


def _int8_shard(rng, rows=ROWS):
    values, scales = quantize_rows(torch.from_numpy(rng.normal(size=(rows, D)).astype(np.float32)))
    return values.numpy(), scales.numpy()


def _int8_close(got, want, values0):
    """`test_torch_quantized_cuda.py`'s bar for #6 against its plain
    version: scales and accumulators within rtol 1e-5, values within one
    step, untouched rows bit for bit."""
    (v1, s1, a1), (v0, s0, a0) = got, want
    torch.testing.assert_close(a1, a0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(s1, s0, rtol=1e-5, atol=1e-6)
    assert (v1.int() - v0.int()).abs().max().item() <= 1
    moved = (v0 != torch.from_numpy(values0)).any(dim=1)
    assert torch.equal(v1[~moved & (a1 == a0)], v0[~moved & (a1 == a0)])


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [1, 3])
def test_int8_partial_pool_matches_cpu(dev, slots):
    """Each of WORLD int8 shards' partial pool (#5, the slots outside the
    shard at weight 0) against the CPU's: one slot bit for bit, three
    within 1e-5 x max; the partials sum to the whole table's pool."""
    rng = np.random.default_rng(slots)
    values, scales = _int8_shard(rng, WORLD * ROWS)
    ids = rng.integers(0, WORLD * ROWS, (M, slots)).astype(np.int32)
    w = (rng.random((M, slots)) > 0.2).astype(np.float32)
    sums = []
    for t_v, t_s, t_ids, t_w in _both(dev, values, scales, ids, w):
        total = 0
        for r in range(WORLD):
            shard = QuantizedTable(t_v[r * ROWS:(r + 1) * ROWS].contiguous(),
                                   t_s[r * ROWS:(r + 1) * ROWS].contiguous())
            before = quantized_pooled_gather.launches
            total = total + sharded.partial_pool(shard, t_ids, t_w, r)
            if t_v.is_cuda:
                torch.cuda.synchronize()
                assert quantized_pooled_gather.launches == before + 1
        sums.append(total.cpu())
    if slots == 1:
        assert torch.equal(sums[1], sums[0])
    else:
        torch.testing.assert_close(sums[1], sums[0], rtol=0,
                                   atol=1e-5 * sums[0].abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["device-sort", "sorted", "sorted-bf16-buffer"])
def test_int8_shard_updates_match_cpu(dev, route):
    """An int8 shard's update (#6) against its plain version: through the
    device sort on `shard_local_ids`, or on the host-sorted shard's local ids
    as they are (negative below the shard, past its rows above it), with and
    without the bf16 buffer, which writes no row for those sentinels."""
    rng = np.random.default_rng(len(route))
    values, scales = _int8_shard(rng)
    acc = np.abs(rng.normal(size=ROWS)).astype(np.float32)
    keys = rng.integers(0, WORLD * ROWS, M).astype(np.int32)
    if route != "device-sort":
        keys = np.sort(keys)
    g = (rng.normal(size=(M, D)) * 0.1).astype(np.float32)
    buffer = torch.bfloat16 if route == "sorted-bf16-buffer" else None
    out = []
    for t_v, t_s, t_a, t_keys, t_g in _both(dev, values, scales, acc, keys, g):
        shard = QuantizedTable(t_v, t_s)
        if route == "device-sort":
            local = sharded.shard_local_ids(t_keys, 1, ROWS)
            opt_lib.device_sorted_fused_adagrad(shard, t_a, local, t_g, LR, EPS)
        else:
            local = (t_keys - ROWS).to(torch.int32)
            quantized_rowwise_adagrad_fused(t_v, t_s, t_a, local, t_g, LR, EPS,
                                            buffer_dtype=buffer)
        out.append((t_v.cpu(), t_s.cpu(), t_a.cpu()))
    _int8_close(out[1], out[0], values)
    outside = ~np.isin(np.arange(ROWS), keys - ROWS)
    for got in out:
        assert torch.equal(got[0][torch.from_numpy(outside)], torch.from_numpy(values[outside]))
    torch.testing.assert_close(dequantize_rows(*out[1][:2]), dequantize_rows(*out[0][:2]),
                               rtol=0, atol=1.01 * float(out[0][1].max()) / 127)


def _within(got, want, rel, what):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), f"{what}: {err}"


@pytest.mark.cuda
def test_softmax_stripes_match_plain_and_the_whole_batch(dev):
    """Four data-parallel stripes of a [2,048, 2,048] batch, [512, 2,048]
    each at row offsets 0, 512, 1,024 and 1,536, through #9, #10 and #11
    against their plain versions at `[kernel]`'s bars (lse rtol 2e-5, dq
    and dc within 1e-3 x max); the stripes' lse are the whole batch's rows,
    their dc summed is the whole batch's dc (1e-3 x max), and their (num,
    den) summed is the whole batch's (rtol 1e-5)."""
    rng = np.random.default_rng(11)
    bk, bq, d, inv_t = 2048, 512, 64, 1.25
    q16 = torch.from_numpy(rng.normal(size=(bk, d)).astype(np.float32)).to(dev, torch.bfloat16)
    c16 = torch.from_numpy(rng.normal(size=(bk, d)).astype(np.float32)).to(dev, torch.bfloat16)
    ids = torch.from_numpy(rng.integers(1, 300, bk).astype(np.int32)).to(dev)
    adj = torch.from_numpy(rng.normal(size=bk).astype(np.float32)).to(dev)
    labels = torch.from_numpy((rng.random(bk) < 0.7).astype(np.float32)).to(dev)
    g = labels / labels.sum()
    whole = (q16, c16, adj, ids, ids, 0, inv_t)
    lse_all = sk.lse_forward_reference(*whole)
    dc_all = sk.lse_backward_reference(*whole, lse_all, g)[1]
    dc_sum = torch.zeros_like(dc_all)
    for off in range(0, bk, bq):
        args = (q16[off:off + bq].contiguous(), c16, adj, ids[off:off + bq].contiguous(), ids,
                off, inv_t)
        before = [k.launches for k in (sk.softmax_lse_fwd, sk.softmax_lse_dq, sk.softmax_lse_dc)]
        lse = sk.softmax_lse_fwd(*args)
        want = sk.lse_forward_reference(*args)
        torch.testing.assert_close(lse, want, rtol=2e-5, atol=1e-5)
        torch.testing.assert_close(lse, lse_all[off:off + bq], rtol=2e-5, atol=1e-5)
        dq = sk.softmax_lse_dq(*args, want, g[off:off + bq].contiguous())
        dc = sk.softmax_lse_dc(*args, want, g[off:off + bq].contiguous())
        want_dq, want_dc = sk.lse_backward_reference(*args, want, g[off:off + bq].contiguous())
        assert [k.launches for k in (sk.softmax_lse_fwd, sk.softmax_lse_dq, sk.softmax_lse_dc)] \
            == [n + 1 for n in before]
        _within(dq, want_dq, 1e-3, f"dq at {off}")
        _within(dc, want_dc, 1e-3, f"dc at {off}")
        dc_sum += dc
    _within(dc_sum, dc_all, 1e-3, "the stripes' dc summed")
    num = den = 0.0
    for off in range(0, bk, bq):
        n, m = sk.sampled_softmax_fused_parts(
            q16[off:off + bq].float(), c16.float(), labels[off:off + bq], ids[off:off + bq],
            ids, adj, 1 / inv_t, row_offset=off)
        num, den = num + n.item(), den + m.item()
    n, m = sk.sampled_softmax_fused_parts(q16.float(), c16.float(), labels, ids, ids, adj,
                                          1 / inv_t)
    np.testing.assert_allclose([num, den], [n.item(), m.item()], rtol=1e-5)


@pytest.mark.cuda
def test_sharded_topk_merge_matches_one_device(dev):
    """Four shards of a 10,001-row corpus (the last padded by three rows,
    masked by `valid`), each shard's candidates (`topk_shard_candidates`)
    merged by hand (`topk_merge`): the one-device `chunked_topk`'s rows and
    scores, the scores within rtol 1e-6 (the same products, other chunks)."""
    rng = np.random.default_rng(12)
    corpus = torch.from_numpy(rng.normal(size=(10001, 64)).astype(np.float32)).to(dev)
    queries = torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32)).to(dev)
    want_vals, want_idx = chunked_topk(queries, corpus, k=100)
    rows = -(-corpus.shape[0] // WORLD)
    padded = torch.zeros((WORLD * rows, 64), device=dev)
    padded[:corpus.shape[0]] = corpus
    parts = [sharded.topk_shard_candidates(queries, padded[r * rows:(r + 1) * rows], 100, 4096,
                                           r, corpus.shape[0]) for r in range(WORLD)]
    vals, idx = sharded.topk_merge(torch.stack([p[0] for p in parts]),
                                   torch.stack([p[1] for p in parts]), 100)
    assert torch.equal(idx, want_idx)
    torch.testing.assert_close(vals, want_vals, rtol=1e-6, atol=0)
