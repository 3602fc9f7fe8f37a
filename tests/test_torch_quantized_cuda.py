"""The int8 slice's CUDA kernels against their plain PyTorch versions, on the
card: the int8 pooled gather (kernel #5: its 16-byte and narrow paths, the
launch plan's batch edges, dead slots, pointers off a 16-byte boundary, D
% 4 != 0 and D > 512),
the fused int8 row-wise Adagrad (#6), the dense aggregate (#3) and the row
subtract (#7), at odd shapes. This
file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_quantized_cuda.py

Without a CUDA device the tests skip (the kernels have no CPU mode)."""

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import (
    block_sorted_aggregate,
    block_sorted_aggregate_reference,
)
from two_tower_recommender_model_tpu_torch.ops.gather_plan import Walk
from two_tower_recommender_model_tpu_torch.ops.quantized_kernel import (
    dequantize_rows,
    quantize_rows,
    quantized_pooled_gather,
    quantized_pooled_gather_reference,
    quantized_rowwise_adagrad_fused,
    quantized_rowwise_adagrad_fused_reference,
)
from two_tower_recommender_model_tpu_torch.ops.row_subtract import (
    row_subtract,
    row_subtract_reference,
)
from torch_gather_cases import DEAD_AT, SLOTS, bags, edge_batches, off_boundary, within
from torch_sorted_runs import RUN_CASES, run_case_ids

DIMS = [8, 32, 128, 512]
# ids of M positions into N rows: name -> (n, m, maker(rng, n, m))
ID_CASES = {
    "mixed": (500, 1237, lambda rng, n, m: np.where(rng.random(m) < 0.1, n + 3,
                                                    rng.integers(0, n // 3, m))),
    "all-sentinels": (500, 333, lambda rng, n, m: np.full(m, n)),
    "one-id-repeated": (500, 777, lambda rng, n, m: np.full(m, 41)),
    "empty": (500, 0, lambda rng, n, m: np.zeros(0, np.int64)),
    # one run of 3,000 positions (about 94 of the Adagrad kernel's 32-position
    # segments) among short runs and sentinels
    "hot-id": (500, 4096, lambda rng, n, m: np.concatenate(
        [np.full(3000, 77), rng.integers(0, n, m - 3100), np.full(100, n)])),
    # runs at the edges of the span walk (tests/torch_sorted_runs.py), among runs of 3
    **{name: (run_case_ids(name)[0], 4096, lambda rng, n, m, name=name: run_case_ids(name)[1])
       for name in RUN_CASES},
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _table(rng, n, d, dev):
    rows = rng.normal(size=(n, d)).astype(np.float32)
    rows[5] = 0.0  # an all-zero row: scale 0
    values, scales = quantize_rows(torch.from_numpy(rows))
    return values.to(dev), scales.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slots", [1, 3])
def test_quantized_gather_matches_plain(dev, d, out_dtype, slots):
    """One slot: equal bit for bit (one product per element, the same
    roundings). Three weighted slots: rtol 1e-5 of the largest value (f32
    summation order), one bf16 ulp more for bf16 out. Dead slots (sentinel
    ids, negative ids, weight 0) give exact zeros."""
    rng = np.random.default_rng(d + slots)
    n, b = 700, 1237
    values, scales = _table(rng, n, d, dev)
    ids = rng.integers(0, n, (b, slots))
    ids[::7, 0] = n + 2
    ids[3::11, 0] = -1
    w = rng.random((b, slots)).astype(np.float32) if slots > 1 else np.ones((b, 1), np.float32)
    w[5::13, 0] = 0.0
    ids_t = torch.from_numpy(ids.astype(np.int32)).to(dev)
    w_t = torch.from_numpy(w).to(dev)
    before = quantized_pooled_gather.launches
    got = quantized_pooled_gather(values, scales, ids_t, w_t, out_dtype)
    want = quantized_pooled_gather_reference(values, scales, ids_t, w_t, out_dtype)
    torch.cuda.synchronize()
    assert quantized_pooled_gather.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (b, d)
    if slots == 1:
        assert torch.equal(got, want)
        dead = (ids_t[:, 0] >= n) | (ids_t[:, 0] < 0) | (w_t[:, 0] == 0)
        assert dead.any() and torch.count_nonzero(got[dead]).item() == 0
    else:
        tol = (1e-5 if out_dtype == torch.float32 else 2.0 ** -8) * want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.cuda
def test_quantized_gather_empty_batch_and_bad_dim(dev):
    """An empty batch launches nothing; D % 4 != 0 (6: one int8 a lane) and
    D > 512 (516: the narrow path, D % 16 != 0) launch the kernel and give
    the plain version's bits."""
    rng = np.random.default_rng(0)
    values, scales = _table(rng, 50, 8, dev)
    before = quantized_pooled_gather.launches
    out = quantized_pooled_gather(values, scales, torch.zeros((0, 1), dtype=torch.int32, device=dev),
                                  torch.zeros((0, 1), device=dev))
    assert out.shape == (0, 8) and quantized_pooled_gather.launches == before
    for d in (6, 516):  # every D the reference trains runs on the card, never a plain route
        values, scales = _table(rng, 50, d, dev)
        ids = torch.from_numpy(rng.integers(-1, 52, (40, 1)).astype(np.int32)).to(dev)
        w = torch.ones((40, 1), device=dev)
        got, want = _gather(values, scales, ids, w, torch.float32)
        assert got.shape == (40, d) and torch.equal(got, want)


def _gather(values, scales, ids, w, out_dtype, out=None):
    """Kernel #5 (into `out` when given: the wrapper's launch helper, as its
    call does into a fresh tensor) and its plain version; one launch."""
    before = quantized_pooled_gather.launches
    if out is None:
        got = quantized_pooled_gather(values, scales, ids, w, out_dtype)
    else:
        quantized_pooled_gather._launch(out, values, scales, ids, w)
        got = out
    want = quantized_pooled_gather_reference(values, scales, ids, w, out_dtype)
    torch.cuda.synchronize()
    assert quantized_pooled_gather.launches == before + 1
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("d", DIMS)
def test_quantized_gather_plan_edges(dev, d):
    """One slot at batch sizes 1, 31, 32, 33 and the plan's edges +-1 (the
    bags of a warp and of a block, where the one-item walk gives way to
    runs, where runs reach 32 bags): bit for bit the plain version's, f32
    and bf16 out; D = 8 takes the narrow path, the rest the 16-byte one."""
    rng = np.random.default_rng(d + 100)
    n = 700
    values, scales = _table(rng, n, d, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for out_dtype in (torch.float32, torch.bfloat16):
        blocks = quantized_pooled_gather.blocks_per_sm(dev, out_dtype)
        for b in edge_batches(1, d, 1, sms, blocks):
            ids, w = bags(rng, n, b, 1, "first")
            ids_t, w_t = torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev)
            got, want = _gather(values, scales, ids_t, w_t, out_dtype)
            wide = quantized_pooled_gather.plan(values, ids_t, got).walk != Walk.NARROW
            assert wide == (d % 16 == 0)
            within(got, want, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("bag_l", SLOTS)
@pytest.mark.parametrize("dead_at", DEAD_AT)
def test_quantized_gather_dead_slots(dev, bag_l, dead_at):
    """L = 1, 3, 7 and 40 with dead slots (the sentinel N, a negative id, a
    zero weight) in the first, middle or last slot, at every D of `DIMS`:
    one slot bit for bit, more within 1e-5 x max (2^-8 x max in bf16 out);
    dead slots alone give exact zeros."""
    rng = np.random.default_rng(bag_l + 200)
    n = 700
    for d in DIMS:
        values, scales = _table(rng, n, d, dev)
        for b in (33, 1000):
            ids, w = bags(rng, n, b, bag_l, dead_at)
            ids_t, w_t = torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev)
            for out_dtype in (torch.float32, torch.bfloat16):
                got, want = _gather(values, scales, ids_t, w_t, out_dtype)
                within(got, want, bag_l)
                dead = ((ids_t < 0) | (ids_t >= n) | (w_t == 0)).all(dim=1)
                if bag_l == 1:
                    assert dead.any() and torch.count_nonzero(got[dead]).item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("bag_l", [1, 3])
@pytest.mark.parametrize("which", ["values", "out"])
def test_quantized_gather_off_boundary_pointers(dev, bag_l, which):
    """Values, or an output, 4 bytes off a 16-byte boundary: the plan takes
    the narrow path, and the result is the plain version's (bit for bit at
    one slot)."""
    rng = np.random.default_rng(300 + bag_l)
    n, d = 700, 128
    values, scales = _table(rng, n, d, dev)
    if which == "values":
        values = off_boundary(values)
    for b in (1, 33, 700):
        ids, w = bags(rng, n, b, bag_l, "middle")
        ids_t, w_t = torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev)
        for out_dtype in (torch.float32, torch.bfloat16):
            out = torch.empty((b, d), dtype=out_dtype, device=dev)
            if which == "out":
                out = off_boundary(out)
            assert quantized_pooled_gather.plan(values, ids_t, out).walk == Walk.NARROW
            got, want = _gather(values, scales, ids_t, w_t, out_dtype, out)
            assert got.data_ptr() == out.data_ptr()
            within(got, want, bag_l)


@pytest.mark.cuda
@pytest.mark.parametrize("bag_l", [1, 3, 40])
def test_quantized_gather_two_launches_agree(dev, bag_l):
    """Two launches on the same inputs give the same bits, on the narrow
    path and every walk of the wide one (140,000 bags of one slot: runs of
    several bags)."""
    rng = np.random.default_rng(400 + bag_l)
    n = 700
    for d, b in ((128, 140_000), (512, 999), (8, 999)):
        values, scales = _table(rng, n, d, dev)
        ids, w = bags(rng, n, b, bag_l, "last")
        ids_t, w_t = torch.from_numpy(ids).to(dev), torch.from_numpy(w).to(dev)
        for out_dtype in (torch.float32, torch.bfloat16):
            first = quantized_pooled_gather(values, scales, ids_t, w_t, out_dtype)
            second = quantized_pooled_gather(values, scales, ids_t, w_t, out_dtype)
            torch.cuda.synchronize()
            view = torch.int32 if out_dtype == torch.float32 else torch.int16
            assert torch.equal(first.view(view), second.view(view))


def _sorted_ids(rng, case, dev, with_perm=False):
    n, m, make = ID_CASES[case]
    ids = make(rng, n, m)
    perm = None
    if with_perm:
        order = np.argsort(ids, kind="stable")
        ids, perm = ids[order], torch.from_numpy(order.astype(np.int32)).to(dev)
    else:
        ids = np.sort(ids)
    return n, m, torch.from_numpy(ids.astype(np.int32)).to(dev), perm


@pytest.mark.cuda
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(ID_CASES))
@pytest.mark.parametrize("with_perm", [False, True])
def test_quantized_adagrad_matches_plain(dev, d, grad_dtype, case, with_perm):
    """Rows no live id names, and a run whose gradients sum to exactly zero,
    keep values, scale and accumulator bit for bit; accumulators and scales
    within rtol 1e-5 (f32 summation order); int8 values within one step of
    the plain version's (the order of the sum may move a value across a
    rounding boundary)."""
    rng = np.random.default_rng(d)
    n, m, ids, perm = _sorted_ids(rng, case, dev, with_perm)
    values, scales = _table(rng, n, d, dev)
    acc = torch.from_numpy(np.abs(rng.normal(size=n)).astype(np.float32)).to(dev)
    g = rng.normal(size=(m, d)).astype(np.float32)
    zero_run = None
    if case == "mixed":  # one run whose gradients cancel exactly
        zero_run = int(ids[ids < n][-1].item())
        pos = np.flatnonzero(ids.cpu().numpy() == zero_run)
        src = pos if perm is None else perm.cpu().numpy()[pos]
        g[src] = 0.0
    grads = torch.from_numpy(g).to(dev, grad_dtype)
    v_k, s_k, a_k = values.clone(), scales.clone(), acc.clone()
    v_p, s_p, a_p = values.clone(), scales.clone(), acc.clone()
    before = quantized_rowwise_adagrad_fused.launches
    quantized_rowwise_adagrad_fused(v_k, s_k, a_k, ids, grads, 0.05, 1e-10, perm=perm)
    quantized_rowwise_adagrad_fused_reference(v_p, s_p, a_p, ids, grads, 0.05, 1e-10, perm=perm)
    torch.cuda.synchronize()
    assert quantized_rowwise_adagrad_fused.launches == before + (1 if m else 0)
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    keep[ids[ids < n].long()] = False
    if zero_run is not None:
        keep[zero_run] = True
    assert torch.equal(v_k[keep], values[keep])
    assert torch.equal(s_k[keep].view(torch.int32), scales[keep].view(torch.int32))
    assert torch.equal(a_k[keep].view(torch.int32), acc[keep].view(torch.int32))
    if case in ("mixed", "one-id-repeated"):
        assert not torch.equal(v_k, values)
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(s_k, s_p, rtol=1e-5, atol=1e-6)
    assert (v_k.int() - v_p.int()).abs().max().item() <= 1 if n else True
    torch.testing.assert_close(dequantize_rows(v_k, s_k), dequantize_rows(v_p, s_p), rtol=0,
                               atol=1.01 * (s_p.max().item() / 127))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [12, 128, 512])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["mixed", "hot-id"])
@pytest.mark.parametrize("with_perm", [False, True])
def test_quantized_adagrad_two_launches_agree(dev, d, grad_dtype, case, with_perm):
    """Two launches of kernel #6 from the same table, accumulators and
    gradients give the same bytes, scales and accumulators: every sum, the
    hot id's pieces included, has one fixed order. D = 12 takes the 8-byte
    bf16 loads (D % 8 != 0)."""
    rng = np.random.default_rng(d + 1)
    n, m, ids, perm = _sorted_ids(rng, case, dev, with_perm)
    values, scales = _table(rng, n, d, dev)
    acc = torch.from_numpy(np.abs(rng.normal(size=n)).astype(np.float32)).to(dev)
    grads = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev, grad_dtype)
    runs = []
    for _ in range(2):
        state = (values.clone(), scales.clone(), acc.clone())
        quantized_rowwise_adagrad_fused(*state, ids, grads, 0.05, 1e-10, perm=perm)
        runs.append(state)
    torch.cuda.synchronize()
    assert not torch.equal(runs[0][0], values)
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.int8 else a.view(torch.int32),
                           b.view(torch.uint8) if b.dtype == torch.int8 else b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(ID_CASES))
def test_aggregate_matches_plain(dev, d, grad_dtype, case):
    """Rows without ids exact zero, the rest within rtol 1e-5 (f32 summation
    order: `index_add_` sums with atomics)."""
    rng = np.random.default_rng(d)
    n, m, ids, _ = _sorted_ids(rng, case, dev)
    grads = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev, grad_dtype)
    before = block_sorted_aggregate.launches
    got = block_sorted_aggregate(n, ids, grads)
    want = block_sorted_aggregate_reference(n, ids, grads)
    torch.cuda.synchronize()
    assert block_sorted_aggregate.launches == before + (1 if m else 0)
    assert got.shape == (n, d) and got.dtype == torch.float32
    named = torch.zeros(n, dtype=torch.bool, device=dev)
    named[ids[ids < n].long()] = True
    assert torch.count_nonzero(got[~named]).item() == 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * max(want.abs().max().item(), 1))


@pytest.mark.cuda
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("case", ["distinct", "all-sentinels", "empty"])
def test_row_subtract_matches_plain(dev, d, case):
    """Distinct live ids (the kernel's contract) in any order, sentinels and
    negative ids among them: equal bit for bit, one subtraction an element."""
    rng = np.random.default_rng(d)
    n = 900
    if case == "distinct":
        ids = rng.permutation(n)[:517]
        ids[::9] = n + 1
        ids[4::31] = -5
    else:
        ids = np.full(0 if case == "empty" else 211, n)
    ids_t = torch.from_numpy(ids.astype(np.int32)).to(dev)
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    upd = torch.from_numpy(rng.normal(size=(len(ids), d)).astype(np.float32)).to(dev)
    t_k, t_p = table.clone(), table.clone()
    before = row_subtract.launches
    assert row_subtract(t_k, ids_t, upd) is t_k
    row_subtract_reference(t_p, ids_t, upd)
    torch.cuda.synchronize()
    assert row_subtract.launches == before + (1 if len(ids) else 0)
    assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    assert (case == "distinct") == (not torch.equal(t_k, table))


@pytest.mark.cuda
def test_bad_dims_are_refused_on_the_card(dev):
    """D % 4 != 0 (6) and D > 512 (516) run on CUDA tensors for each kernel
    (#3, #7, #6: the scalar path or the general walk) and match the plain
    versions: #3 within rtol 1e-5, #7 bit for bit, #6 within one int8 step
    (scales rtol 1e-5). Each launches once."""
    rng = np.random.default_rng(6)
    ids = torch.tensor([0, 0, 3, 7, 7, 7, 10], dtype=torch.int32, device=dev)  # 10: a sentinel
    for d in (6, 516):
        g = torch.from_numpy(rng.normal(size=(7, d)).astype(np.float32)).to(dev)
        before = (block_sorted_aggregate.launches, row_subtract.launches,
                  quantized_rowwise_adagrad_fused.launches)
        torch.testing.assert_close(block_sorted_aggregate(10, ids, g),
                                   block_sorted_aggregate_reference(10, ids, g),
                                   rtol=1e-5, atol=1e-5)
        table = torch.from_numpy(rng.normal(size=(10, d)).astype(np.float32)).to(dev)
        sub_ids = torch.tensor([1, 4, 9, 12], dtype=torch.int32, device=dev)
        t_k, t_p = table.clone(), table.clone()
        row_subtract(t_k, sub_ids, g[:4].contiguous())
        row_subtract_reference(t_p, sub_ids, g[:4].contiguous())
        assert torch.equal(t_k, t_p)
        values, scales = _table(rng, 10, d, dev)
        acc = torch.ones(10, device=dev)
        k = (values.clone(), scales.clone(), acc.clone())
        p = (values.clone(), scales.clone(), acc.clone())
        quantized_rowwise_adagrad_fused(*k, ids, g, 0.1)
        quantized_rowwise_adagrad_fused_reference(*p, ids, g, 0.1)
        torch.cuda.synchronize()
        assert (block_sorted_aggregate.launches, row_subtract.launches,
                quantized_rowwise_adagrad_fused.launches) == tuple(x + 1 for x in before)
        assert (k[0].int() - p[0].int()).abs().max().item() <= 1
        torch.testing.assert_close(k[1], p[1], rtol=1e-5, atol=1e-6)
