"""The table kernels at every width the JAX package trains, on the card: the
dense aggregate (#3), row-wise Adagrad (#4), the int8 pooled gather (#5),
the int8 row-wise Adagrad (#6) and the row subtract (#7) at D = 30, 514,
1,024 and 2,048 (past the half-warp walk's 512 columns, and at D % 4 != 0),
against their plain PyTorch versions, with the tolerances of the card tests
at D <= 512. #4 and #6 also in the bf16 buffer's mode and on ids drawn as
rank^-1 (hot runs of thousands of positions: the span walk's second pass),
two launches bit for bit; and a table or gradients off the alignment of
four-element accesses, which takes the scalar path. This file imports no
JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_any_width_cuda.py

Without a CUDA device the tests skip (the kernels have no CPU mode)."""

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import (
    block_sorted_aggregate,
    block_sorted_aggregate_reference,
    rowwise_adagrad,
    rowwise_adagrad_reference,
)
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

DIMS = [30, 514, 1024, 2048]
BF16 = torch.bfloat16
BUFFERS = {"f32-sum": None, "bf16-buffer": BF16}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ids(case: str, rng) -> tuple[int, np.ndarray, np.ndarray | None]:
    """(N, [M] ids in the kernels' order, the device sort's permutation or
    None): "mixed" sorted ids with sentinels and a run of 3,000; "rank-1"
    ids drawn as rank^-1 over 5,000 rows (a hot id of about 3,500 of 32,768
    positions), in the stable device sort's order with its permutation."""
    if case == "mixed":
        n, m = 2000, 8192
        ids = rng.integers(0, n // 3, m)
        ids[rng.random(m) < 0.1] = n + 3
        ids[:3000] = 7
        return n, np.sort(ids), None
    n, m = 5000, 32_768
    p = 1.0 / np.arange(1, n + 1)
    raw = rng.choice(n, m, p=p / p.sum())
    order = np.argsort(raw, kind="stable")
    return n, raw[order], order.astype(np.int32)


def _on(dev, ids, perm):
    return (torch.from_numpy(ids.astype(np.int32)).to(dev),
            None if perm is None else torch.from_numpy(perm).to(dev))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.float32: torch.int32, BF16: torch.int16}.get(t.dtype, t.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("table_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("grad_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("case", ["mixed", "rank-1"])
@pytest.mark.parametrize("buffer", list(BUFFERS))
def test_rowwise_adagrad_any_width(dev, d, table_dtype, grad_dtype, case, buffer):
    """Untouched rows and accumulators bit for bit; an f32 table's touched
    rows and every accumulator within rtol 1e-5 / atol 1e-6 of the plain
    version (the sum of g^2 runs in another order); a bf16 table's touched
    values within 2^-7 of the larger magnitude (atol 1e-6), fewer than 1%
    apart; two launches bit for bit."""
    rng = np.random.default_rng(d)
    n, ids, perm = _ids(case, rng)
    m = ids.shape[0]
    ids_t, perm_t = _on(dev, ids, perm)
    grads = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev, grad_dtype)
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev, table_dtype)
    acc = torch.from_numpy(np.abs(rng.normal(size=n)).astype(np.float32)).to(dev)
    buf = BUFFERS[buffer]
    runs = []
    before = rowwise_adagrad.launches
    for _ in range(2):
        state = (table.clone(), acc.clone())
        rowwise_adagrad(*state, ids_t, grads, 0.05, 1e-10, perm=perm_t, buffer_dtype=buf)
        runs.append(state)
    t_p, a_p = table.clone(), acc.clone()
    rowwise_adagrad_reference(t_p, a_p, ids_t, grads, 0.05, 1e-10, perm=perm_t, buffer_dtype=buf)
    torch.cuda.synchronize()
    assert rowwise_adagrad.launches == before + 2
    (t_k, a_k), (t_2, a_2) = runs
    assert torch.equal(_bits(t_k), _bits(t_2)) and torch.equal(_bits(a_k), _bits(a_2))
    live = torch.zeros(n, dtype=torch.bool, device=dev)
    live[ids_t[ids_t < n].long()] = True
    assert torch.equal(_bits(t_k[~live]), _bits(table[~live]))
    assert torch.equal(_bits(a_k[~live]), _bits(acc[~live]))
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=1e-6)
    if table_dtype == torch.float32:
        torch.testing.assert_close(t_k, t_p, rtol=1e-5, atol=1e-6)
    else:
        got, want = t_k[live].float(), t_p[live].float()
        assert not torch.equal(got, table[live].float())
        assert ((got - want).abs() <= 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) + 1e-6).all()
        assert (got != want).float().mean().item() < 0.01


def _int8_table(rng, n, d, dev):
    rows = rng.normal(size=(n, d)).astype(np.float32)
    rows[5] = 0.0  # an all-zero row: scale 0
    values, scales = quantize_rows(torch.from_numpy(rows))
    return values.to(dev), scales.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("grad_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("case", ["mixed", "rank-1"])
@pytest.mark.parametrize("buffer", list(BUFFERS))
def test_quantized_adagrad_any_width(dev, d, grad_dtype, case, buffer):
    """Rows no live id names keep values, scale and accumulator bit for bit
    (and, summing in f32, a run whose gradients cancel to exactly zero);
    scales and accumulators within rtol 1e-5 (atol 1e-6); int8 values within
    one step of the plain version's; two launches bit for bit."""
    rng = np.random.default_rng(d + 7)
    n, ids, perm = _ids(case, rng)
    m = ids.shape[0]
    g = rng.normal(size=(m, d)).astype(np.float32)
    zero_run = None
    if case == "mixed" and buffer == "f32-sum":  # one run whose gradients cancel exactly
        zero_run = int(ids[ids < n][-1])
        g[np.flatnonzero(ids == zero_run)] = 0.0
    ids_t, perm_t = _on(dev, ids, perm)
    grads = torch.from_numpy(g).to(dev, grad_dtype)
    values, scales = _int8_table(rng, n, d, dev)
    acc = torch.from_numpy(np.abs(rng.normal(size=n)).astype(np.float32)).to(dev)
    buf = BUFFERS[buffer]
    runs = []
    for _ in range(2):
        state = (values.clone(), scales.clone(), acc.clone())
        quantized_rowwise_adagrad_fused(*state, ids_t, grads, 0.05, 1e-10, perm=perm_t,
                                        buffer_dtype=buf)
        runs.append(state)
    p = (values.clone(), scales.clone(), acc.clone())
    quantized_rowwise_adagrad_fused_reference(*p, ids_t, grads, 0.05, 1e-10, perm=perm_t,
                                              buffer_dtype=buf)
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(_bits(a), _bits(b))
    v_k, s_k, a_k = runs[0]
    v_p, s_p, a_p = p
    keep = torch.ones(n, dtype=torch.bool, device=dev)
    keep[ids_t[ids_t < n].long()] = False
    if zero_run is not None:
        keep[zero_run] = True
    assert torch.equal(v_k[keep], values[keep])
    assert torch.equal(_bits(s_k[keep]), _bits(scales[keep]))
    assert torch.equal(_bits(a_k[keep]), _bits(acc[keep]))
    assert not torch.equal(v_k, values)
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(s_k, s_p, rtol=1e-5, atol=1e-6)
    assert (v_k.int() - v_p.int()).abs().max().item() <= 1
    torch.testing.assert_close(dequantize_rows(v_k, s_k), dequantize_rows(v_p, s_p), rtol=0,
                               atol=1.01 * (s_p.max().item() / 127))


@pytest.mark.cuda
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("grad_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("case", ["mixed", "rank-1"])
def test_aggregate_any_width(dev, d, grad_dtype, case):
    """Rows without ids exact zero, the rest within rtol 1e-5 (atol 1e-5 x
    max: `index_add_` sums with atomics); two launches bit for bit."""
    rng = np.random.default_rng(d + 11)
    n, ids, perm = _ids(case, rng)
    ids_t, perm_t = _on(dev, ids, perm)
    grads = torch.from_numpy(rng.normal(size=(ids.shape[0], d)).astype(np.float32)).to(
        dev, grad_dtype)
    before = block_sorted_aggregate.launches
    got = block_sorted_aggregate(n, ids_t, grads, perm_t)
    again = block_sorted_aggregate(n, ids_t, grads, perm_t)
    want = block_sorted_aggregate_reference(n, ids_t, grads, perm_t)
    torch.cuda.synchronize()
    assert block_sorted_aggregate.launches == before + 2
    assert torch.equal(_bits(got), _bits(again))
    named = torch.zeros(n, dtype=torch.bool, device=dev)
    named[ids_t[ids_t < n].long()] = True
    assert torch.count_nonzero(got[~named]).item() == 0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * max(want.abs().max().item(), 1))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [6, 30, 516, 1024, 2048])
@pytest.mark.parametrize("out_dtype", [torch.float32, BF16])
@pytest.mark.parametrize("slots", [1, 3])
def test_quantized_gather_any_width(dev, d, out_dtype, slots):
    """One slot: bit for bit the plain version (one product an element, the
    same roundings), dead slots exact zeros; three weighted slots within 1e-5
    x max (2^-8 x max into bf16)."""
    rng = np.random.default_rng(d + slots)
    n, b = 700, 1237
    values, scales = _int8_table(rng, n, d, dev)
    ids = rng.integers(0, n, (b, slots))
    ids[::7, 0] = n + 2
    ids[3::11, 0] = -1
    w = rng.random((b, slots)).astype(np.float32) if slots > 1 else np.ones((b, 1), np.float32)
    ids_t = torch.from_numpy(ids.astype(np.int32)).to(dev)
    w_t = torch.from_numpy(w).to(dev)
    before = quantized_pooled_gather.launches
    got = quantized_pooled_gather(values, scales, ids_t, w_t, out_dtype)
    want = quantized_pooled_gather_reference(values, scales, ids_t, w_t, out_dtype)
    torch.cuda.synchronize()
    assert quantized_pooled_gather.launches == before + 1
    assert got.shape == (b, d) and got.dtype == out_dtype
    if slots == 1:
        assert torch.equal(_bits(got), _bits(want))
        dead = (ids_t[:, 0] >= n) | (ids_t[:, 0] < 0)
        assert torch.count_nonzero(got[dead]).item() == 0
    else:
        tol = (1e-5 if out_dtype == torch.float32 else 2.0 ** -8) * want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [6] + DIMS)
def test_row_subtract_any_width(dev, d):
    """Distinct live ids among sentinels: bit for bit, one subtraction an
    element."""
    rng = np.random.default_rng(d)
    n = 900
    ids = rng.permutation(n)[:517]
    ids[::9] = n + 1
    ids[4::31] = -5
    ids_t = torch.from_numpy(ids.astype(np.int32)).to(dev)
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    upd = torch.from_numpy(rng.normal(size=(len(ids), d)).astype(np.float32)).to(dev)
    t_k, t_p = table.clone(), table.clone()
    before = row_subtract.launches
    row_subtract(t_k, ids_t, upd)
    row_subtract_reference(t_p, ids_t, upd)
    torch.cuda.synchronize()
    assert row_subtract.launches == before + 1
    assert torch.equal(_bits(t_k), _bits(t_p)) and not torch.equal(t_k, table)


def _off(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` one element past the start of its storage: off the
    16-byte (f32), 8-byte (bf16) or 4-byte (int8) boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 512])
@pytest.mark.parametrize("which", ["table", "grads"])
def test_off_boundary_pointers_take_the_scalar_walk(dev, d, which):
    """A table (int8 values) or gradients one element off their alignment,
    at a D the half-warp walk takes: #4, #6 and #7 run (the general walk's
    scalar path; #7's element path) and match their plain versions at the
    tolerances above."""
    rng = np.random.default_rng(d + 3)
    n, ids, perm = _ids("mixed", rng)
    m = ids.shape[0]
    ids_t, _ = _on(dev, ids, perm)
    grads = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev)
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    values, scales = _int8_table(rng, n, d, dev)
    acc = torch.from_numpy(np.abs(rng.normal(size=n)).astype(np.float32)).to(dev)
    if which == "grads":
        grads = _off(grads)
    t_k = _off(table) if which == "table" else table.clone()
    v_k = _off(values) if which == "table" else values.clone()
    a_k, t_p, a_p = acc.clone(), table.clone(), acc.clone()
    rowwise_adagrad(t_k, a_k, ids_t, grads, 0.05, 1e-10)
    rowwise_adagrad_reference(t_p, a_p, ids_t, grads, 0.05, 1e-10)
    q_k = (v_k, scales.clone(), acc.clone())
    q_p = (values.clone(), scales.clone(), acc.clone())
    quantized_rowwise_adagrad_fused(*q_k, ids_t, grads, 0.05, 1e-10)
    quantized_rowwise_adagrad_fused_reference(*q_p, ids_t, grads, 0.05, 1e-10)
    sub_ids = torch.from_numpy(rng.permutation(n)[:300].astype(np.int32)).to(dev)
    upd = grads[:300].contiguous() if which == "table" else _off(grads[:300].contiguous())
    s_k = _off(table) if which == "table" else table.clone()
    s_p = table.clone()
    row_subtract(s_k, sub_ids, upd)
    row_subtract_reference(s_p, sub_ids, upd)
    torch.cuda.synchronize()
    torch.testing.assert_close(t_k, t_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=1e-6)
    assert (q_k[0].int() - q_p[0].int()).abs().max().item() <= 1
    torch.testing.assert_close(q_k[1], q_p[1], rtol=1e-5, atol=1e-6)
    assert torch.equal(_bits(s_k), _bits(s_p))
