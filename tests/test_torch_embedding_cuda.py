"""The CUDA pooled-gather kernel (#1) against its plain PyTorch version, on
the card: its wide and narrow paths, the launch plan's batch edges, dead
slots, pointers off a 16-byte boundary and repeat launches. This file
imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_embedding_cuda.py

Without a CUDA device the tests skip (the kernel has no CPU mode)."""

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu_torch.ops.embedding_kernel import (
    pooled_gather,
    pooled_gather_reference,
)
from two_tower_recommender_model_tpu_torch.ops.gather_plan import Walk
from torch_gather_cases import DEAD_AT, SLOTS, bags, edge_batches, off_boundary, within


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernel against its plain version on the card: both table and
    output dtypes, bag lengths, sentinels, and widths and an alignment that
    take the scalar path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    for d in (128, 36, 130):  # 130 is not a multiple of 4: scalar path
        for table_dtype in (torch.float32, torch.bfloat16):
            for out_dtype in (torch.float32, torch.bfloat16):
                for bag_l in (1, 3):
                    table = torch.from_numpy(rng.normal(size=(500, d)).astype(np.float32))
                    table = table.to(dev, table_dtype)
                    ids = rng.integers(-5, 520, (300, bag_l)).astype(np.int32)  # with sentinels
                    w = (rng.random((300, bag_l)) * (rng.random((300, bag_l)) > 0.2))
                    ids_t = torch.from_numpy(ids).to(dev)
                    w_t = torch.from_numpy(w.astype(np.float32)).to(dev)
                    before = pooled_gather.launches
                    got = pooled_gather(table, ids_t, w_t, out_dtype)
                    want = pooled_gather_reference(table, ids_t, w_t, out_dtype)
                    torch.cuda.synchronize()
                    assert pooled_gather.launches == before + 1
                    if bag_l == 1:
                        assert torch.equal(got, want)
                    else:
                        tol = 1e-5 if out_dtype == torch.float32 else 1e-2
                        torch.testing.assert_close(got.float(), want.float(),
                                                   rtol=tol, atol=tol)
    # a table 4 bytes off 16-byte alignment takes the scalar path
    storage = torch.empty(500 * 128 + 1, device=dev)
    table = storage[1:].view(500, 128)
    table.copy_(torch.from_numpy(rng.normal(size=(500, 128)).astype(np.float32)))
    ids_t = torch.from_numpy(rng.integers(0, 500, (300, 1)).astype(np.int32)).to(dev)
    w_t = torch.ones((300, 1), device=dev)
    assert torch.equal(pooled_gather(table, ids_t, w_t), pooled_gather_reference(table, ids_t, w_t))


# --- the launch plan's edges (kernel #1's wide and narrow paths) -------------------------

TABLE_DTYPES = [torch.float32, torch.bfloat16]
OUT_DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _table(rng, n, d, dtype, dev):
    return torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev, dtype)


def _run(table, ids, w, out_dtype, out=None):
    """The kernel (into `out` when given: the wrapper's launch helper, as
    its call does into a fresh tensor) and the plain version; one launch."""
    before = pooled_gather.launches
    if out is None:
        got = pooled_gather(table, ids, w, out_dtype)
    else:
        pooled_gather._launch(out, table, ids, w)
        got = out
    want = pooled_gather_reference(table, ids, w, out_dtype)
    torch.cuda.synchronize()
    assert pooled_gather.launches == before + 1
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 36, 130])
@pytest.mark.parametrize("table_dtype", TABLE_DTYPES)
def test_plan_edges_match_plain(dev, d, table_dtype):
    """One slot at batch sizes 1, 31, 32, 33 and the plan's edges +-1 (the
    bags of a warp and of a block, where the one-item walk gives way to
    runs, where runs reach 32 bags): bit for bit the plain version's, f32
    and bf16 out, on the wide path (D = 128; D = 36 in f32) or the narrow
    one (D = 130; D = 36 in bf16, not 16-byte rows)."""
    rng = np.random.default_rng(d)
    n = 500
    table = _table(rng, n, d, table_dtype, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    wide = d * table.element_size() % 16 == 0
    for out_dtype in OUT_DTYPES:
        blocks = pooled_gather.blocks_per_sm(dev, table_dtype, out_dtype)
        for b in edge_batches(1, d, table.element_size(), sms, blocks):
            ids, w = bags(rng, n, b, 1, "first")
            ids_t, w_t = torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev)
            got, want = _run(table, ids_t, w_t, out_dtype)
            assert (pooled_gather.plan(table, ids_t, got).walk != Walk.NARROW) == wide
            within(got, want, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("bag_l", SLOTS)
@pytest.mark.parametrize("dead_at", DEAD_AT)
def test_dead_slots_match_plain(dev, bag_l, dead_at):
    """L = 1, 3, 7 and 40 with dead slots (the sentinel N, a negative id, a
    zero weight) in the first, middle or last slot, at D = 128, 36 and 130,
    both table and output dtypes: one slot bit for bit, more within 1e-5 x
    max (2^-8 x max in bf16 out); dead slots alone give exact zeros."""
    rng = np.random.default_rng(bag_l)
    n = 500
    for d in (128, 36, 130):
        for table_dtype in TABLE_DTYPES:
            table = _table(rng, n, d, table_dtype, dev)
            for b in (33, 1000):
                ids, w = bags(rng, n, b, bag_l, dead_at)
                ids_t, w_t = torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev)
                for out_dtype in OUT_DTYPES:
                    got, want = _run(table, ids_t, w_t, out_dtype)
                    within(got, want, bag_l)
                    dead = ((ids_t < 0) | (ids_t >= n) | (w_t == 0)).all(dim=1)
                    if bag_l == 1:
                        assert dead.any() and torch.count_nonzero(got[dead]).item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("bag_l", [1, 3])
@pytest.mark.parametrize("which", ["table", "out"])
def test_off_boundary_pointers_take_the_narrow_path(dev, bag_l, which):
    """A table, or an output, 4 bytes off a 16-byte boundary: the plan takes
    the narrow path, and the result is the plain version's (bit for bit at
    one slot)."""
    rng = np.random.default_rng(7)
    n, d = 500, 128
    for table_dtype in TABLE_DTYPES:
        table = _table(rng, n, d, table_dtype, dev)
        if which == "table":
            table = off_boundary(table)
        for b in (1, 33, 700):
            ids, w = bags(rng, n, b, bag_l, "middle")
            ids_t, w_t = torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev)
            for out_dtype in OUT_DTYPES:
                out = torch.empty((b, d), dtype=out_dtype, device=dev)
                if which == "out":
                    out = off_boundary(out)
                assert pooled_gather.plan(table, ids_t, out).walk == Walk.NARROW
                got, want = _run(table, ids_t, w_t, out_dtype, out)
                assert got.data_ptr() == out.data_ptr()
                within(got, want, bag_l)


@pytest.mark.cuda
@pytest.mark.parametrize("bag_l", [1, 3, 40])
def test_two_launches_agree(dev, bag_l):
    """Two launches on the same inputs give the same bits (fixed slot
    order, no atomics), on the narrow path and every walk of the wide one
    (40,000 bags of one slot: runs of several bags)."""
    rng = np.random.default_rng(bag_l + 11)
    n = 500
    for d, table_dtype, b in ((128, torch.float32, 40_000), (128, torch.bfloat16, 5000),
                              (36, torch.float32, 999), (130, torch.float32, 999)):
        table = _table(rng, n, d, table_dtype, dev)
        ids, w = bags(rng, n, b, bag_l, "last")
        ids_t, w_t = torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev)
        for out_dtype in OUT_DTYPES:
            first = pooled_gather(table, ids_t, w_t, out_dtype)
            second = pooled_gather(table, ids_t, w_t, out_dtype)
            torch.cuda.synchronize()
            view = torch.int32 if out_dtype == torch.float32 else torch.int16
            assert torch.equal(first.view(view), second.view(view))


@pytest.mark.cuda
@pytest.mark.parametrize("bag_l", [1, 4, 16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_round_rows_mode_matches_plain(bag_l, out_dtype):
    """`round_rows` (the lookup's mode under bf16 compute on an f32 table):
    each row rounded to the output dtype, the bag summed in slot order,
    rounded once. With the slot mask as the weights, bit for bit the plain
    version, on the wide path (D = 128) and the narrow one (D = 130), with
    dead slots; at one slot bit for bit the mode off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(bag_l)
    dev = torch.device("cuda")
    for d in (128, 130):
        table = torch.from_numpy((rng.normal(size=(700, d)) * 3).astype(np.float32)).to(dev)
        for b in (1, 33, 4096):
            ids = rng.integers(-3, 705, (b, bag_l)).astype(np.int32)
            w = (rng.random((b, bag_l)) > 0.3).astype(np.float32)
            ids_t, w_t = torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev)
            before = pooled_gather.launches
            got = pooled_gather(table, ids_t, w_t, out_dtype, round_rows=True)
            torch.cuda.synchronize()
            assert pooled_gather.launches == before + 1
            want = pooled_gather_reference(table, ids_t, w_t, out_dtype, round_rows=True)
            assert torch.equal(got, want), (d, b, (got.float() - want.float()).abs().max())
            if bag_l == 1:
                assert torch.equal(got, pooled_gather(table, ids_t, w_t, out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16-mode", "int8"])
def test_device_sorted_lookup_matches_the_plain_gather(dev, kind):
    """`device_sorted_lookup` (a device sort, one launch of #1 or #5 at one
    slot, the inverse permute) against the plain gather of the same ids in
    batch order: unsorted ids with repeats and sentinels, rows bit for bit
    the plain version's (`table[ids]`; rounded to bf16 under the bf16 mode;
    an int8 table's rows dequantized in f32), in f32 and bf16 out."""
    from two_tower_recommender_model_tpu_torch.ops.embedding_ops import device_sorted_lookup
    from two_tower_recommender_model_tpu_torch.ops.quantized import (
        dequantize_table,
        quantize_table,
    )
    from two_tower_recommender_model_tpu_torch.ops.quantized_kernel import (
        quantized_pooled_gather,
    )

    rng = np.random.default_rng(5)
    n, m = 5000, 4096
    table = _table(rng, n, 128, torch.float32, dev)
    if kind == "int8":
        table = quantize_table(table)
    ids = torch.from_numpy(rng.integers(0, n + 50, m).astype(np.int32)).to(dev)  # sentinels
    rows = dequantize_table(table) if kind == "int8" else table
    plain = torch.where((ids < n)[:, None], rows[ids.clamp(max=n - 1).long()], 0.0)
    mode = "bfloat16" if kind == "bfloat16-mode" else "float32"
    if mode == "bfloat16":
        plain = plain.bfloat16().float()
    counter = quantized_pooled_gather if kind == "int8" else pooled_gather
    for out_dtype in (torch.float32, torch.bfloat16):
        before = counter.launches
        got = device_sorted_lookup(table, ids, matmul_dtype=mode, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert got.dtype == out_dtype and got.shape == (m, 128)
        assert torch.equal(got, plain.to(out_dtype))
