"""The fused sampled-softmax CUDA kernels (#9 forward, #10 dq, #11 dc) against
their plain PyTorch versions, on the card. This file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_softmax_cuda.py

Without a CUDA device the tests skip (the kernels have no CPU mode).

Tolerances: lse within rtol 2e-5 / atol 1e-5 (f32 sums in another order);
dq and dc within 2^-8 x the largest magnitude, cosine > 0.99999 (p is rounded
to bf16 per score: a p on a rounding boundary goes either way in two versions
that sum in different orders, and at these small batches a single p can
carry most of a row's gradient)."""

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu_torch.ops import softmax_kernel as sk


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(dev, bq, bk, d, seed, n_ids=60):
    rng = np.random.default_rng(seed)
    q16 = torch.from_numpy(rng.normal(size=(bq, d)).astype(np.float32)).to(dev, torch.bfloat16)
    c16 = torch.from_numpy(rng.normal(size=(bk, d)).astype(np.float32)).to(dev, torch.bfloat16)
    col_ids = torch.from_numpy(rng.integers(1, n_ids, bk).astype(np.int32)).to(dev)
    log_q = torch.from_numpy((rng.normal(size=bk) * 0.3).astype(np.float32)).to(dev)
    g = torch.from_numpy((rng.normal(size=bq) / bq).astype(np.float32)).to(dev)
    return q16, c16, col_ids, log_q, g


def _grad_close(got, want, label):
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= 2.0 ** -8 * scale, f"{label}: max abs diff {err} > 2^-8 x {scale}"
    cos = torch.nn.functional.cosine_similarity(got.flatten().double(), want.flatten().double(),
                                                dim=0).item()
    assert cos > 0.99999, f"{label}: cosine {cos}"


def _compare(args, g):
    counters = (sk.softmax_lse_fwd, sk.softmax_lse_dq, sk.softmax_lse_dc)
    before = [w.launches for w in counters]
    lse = sk.softmax_lse_fwd(*args)
    want_lse = sk.lse_forward_reference(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=1e-5)
    # both backwards from the plain lse, so only the backward itself is compared
    dq, dc = sk.softmax_lse_dq(*args, want_lse, g), sk.softmax_lse_dc(*args, want_lse, g)
    want_dq, want_dc = sk.lse_backward_reference(*args, want_lse, g)
    torch.cuda.synchronize()
    assert [w.launches for w in counters] == [b + 1 for b in before]
    assert dq.shape == want_dq.shape and dc.shape == want_dc.shape
    _grad_close(dq, want_dq, "dq")
    _grad_close(dc, want_dc, "dc")
    return lse


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("use_ids,use_logq,n_valid", [
    (False, False, None), (True, False, None), (False, True, None), (True, True, None),
    (False, False, 400), (True, True, 400)])
def test_kernels_match_plain_square(dev, d, use_ids, use_logq, n_valid):
    b = 512
    q16, c16, ids, log_q, g = _inputs(dev, b, b, d, seed=d)
    adj = sk._merged_adj(log_q if use_logq else None, n_valid, b, dev)
    ids = ids if use_ids else None
    _compare((q16, c16, adj, ids, ids, 0, 1.0 / 0.7), g)


@pytest.mark.cuda
@pytest.mark.parametrize("bq,bk,row_offset", [(128, 512, 256), (256, 1024, 768), (128, 256, 0),
                                              (128, 1280, 128)])
@pytest.mark.parametrize("d", [64, 128])
def test_kernels_match_plain_rectangular(dev, bq, bk, row_offset, d):
    """BQ < BK with a row offset: the stripe of a data-parallel split, and
    equal to the same rows of the square case."""
    q16, c16, ids, log_q, g = _inputs(dev, bk, bk, d, seed=bq + d)
    rows = slice(row_offset, row_offset + bq)
    lse = _compare((q16[rows].contiguous(), c16, log_q, ids[rows].contiguous(), ids, row_offset,
                    1.0), g[rows].contiguous())
    square = sk.softmax_lse_fwd(q16, c16, log_q, ids, ids, 0, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(lse.view(torch.int32), square[rows].view(torch.int32))


@pytest.mark.cuda
def test_both_tile_sizes_agree(dev):
    """The forward has one block shape (128 q rows, two consumer warpgroups
    over 128-column tiles), where it had blocks of 64 and of 128 rows: two
    launches on the same inputs agree bit for bit, and the backward kernels
    from that lse agree with the plain version."""
    b, d = 1024, 64
    q16, c16, ids, log_q, g = _inputs(dev, b, b, d, seed=1)
    args = (q16, c16, log_q, ids, ids, 0, 1.3)
    first, again = sk.softmax_lse_fwd(*args), sk.softmax_lse_fwd(*args)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    _compare(args, g)


@pytest.mark.cuda
@pytest.mark.parametrize("d,bq,row_offset", [(64, 8192, 0), (128, 8192, 0), (64, 128, 4096),
                                             (128, 1024, 7168), (64, 2048, 2048),
                                             (128, 2048, 6144), (16, 2048, 4096),
                                             (256, 8192, 0), (256, 1024, 3072),
                                             (2048, 1024, 7168)])
def test_forward_is_deterministic_at_the_production_batch(dev, d, bq, row_offset):
    """Kernel #9 at B = 8,192 columns with item ids (they repeat), logQ and
    192 padded columns: two launches on the same inputs agree bit for bit,
    the lse holds the plain version, and a stripe of BQ rows at a row offset
    is bit for bit those rows of the square case (the column chunks follow
    BK alone and merge in chunk order: at D <= 128 8 chunks of 8 tiles at
    8,192 columns, each walked by 128 q rows; at a wide D 32 chunks of 2
    tiles), also the [2,048 x 8,192] stripes of a four-way split."""
    bk = 8192
    q16, c16, ids, log_q, _ = _inputs(dev, bk, bk, d, seed=d + bq, n_ids=5000)
    adj = sk._merged_adj(log_q, bk - 192, bk, dev)
    rows = slice(row_offset, row_offset + bq)
    args = (q16[rows].contiguous(), c16, adj, ids[rows].contiguous(), ids, row_offset, 1 / 0.7)
    first, again = sk.softmax_lse_fwd(*args), sk.softmax_lse_fwd(*args)
    want = sk.lse_forward_reference(*args)
    square = sk.softmax_lse_fwd(q16, c16, adj, ids, ids, 0, 1 / 0.7)
    torch.cuda.synchronize()
    assert first.shape == (bq,)
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    torch.testing.assert_close(first, want, rtol=2e-5, atol=1e-5)
    assert torch.equal(first.view(torch.int32), square[rows].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("d,bq,row_offset", [(64, 8192, 0), (128, 8192, 0), (16, 8192, 0),
                                             (64, 128, 4096), (128, 128, 8064), (64, 2048, 2048),
                                             (128, 2048, 6144)])
def test_backward_is_deterministic_at_the_production_batch(dev, d, bq, row_offset):
    """Kernels #10 and #11 at B = 8,192 columns with item ids (they
    repeat), logQ and 192 padded columns: two launches on the same inputs
    agree bit for bit, both match the plain version, and a stripe of BQ =
    128 or 2,048 rows (a four-way data-parallel split) gives dq bit for bit
    equal to those rows of the square case (the streamed rows are cut in
    chunks by BK alone, and between the warpgroups by tile index). D = 16
    is zero-padded to 64 by the wrapper.

    q and c lie on a grid of 1/8 in [-2, 2], so every score is exact in any
    summation order and the kernel and the plain version round the same p:
    the comparison sees the kernel's indexing (fragments, masks, offsets)
    and not the ties of p, which the tests above and `chip_smoke.py` hold on
    normal draws. On normal draws at this size, D = 128 and T = 0.7 the
    scores have a standard deviation of about 16, a row's largest p carries
    most of it, and a p near a bf16 rounding tie rounds either way in two
    summation orders: one such p moved dq by 1.09 x (2^-8 x max) on an
    H100 (one bf16 ulp is 2^-8 to 2^-7 of a value)."""
    bk = 8192
    q16, c16, ids, log_q, g = _inputs(dev, bk, bk, d, seed=d + bq, n_ids=5000)
    q16, c16 = ((torch.round(x.float() * 4).clamp(-16, 16) / 8).to(torch.bfloat16)
                for x in (q16, c16))
    adj = sk._merged_adj(log_q, bk - 192, bk, dev)
    rows = slice(row_offset, row_offset + bq)
    args = (q16[rows].contiguous(), c16, adj, ids[rows].contiguous(), ids, row_offset, 1 / 0.7)
    lse = sk.lse_forward_reference(q16, c16, adj, ids, ids, 0, 1 / 0.7)
    lse_rows, g_rows = lse[rows].contiguous(), g[rows].contiguous()
    first = (sk.softmax_lse_dq(*args, lse_rows, g_rows), sk.softmax_lse_dc(*args, lse_rows, g_rows))
    again = (sk.softmax_lse_dq(*args, lse_rows, g_rows), sk.softmax_lse_dc(*args, lse_rows, g_rows))
    want = sk.lse_backward_reference(*args, lse_rows, g_rows)
    torch.cuda.synchronize()
    for a, b_, w, label in zip(first, again, want, ("dq", "dc")):
        assert a.shape == w.shape
        assert torch.equal(a.view(torch.int32), b_.view(torch.int32)), f"{label}: two launches"
        _grad_close(a, w, label)
    assert (first[1][bk - 192:] == 0).all()  # padded columns take no gradient
    if bq < bk:
        square = sk.softmax_lse_dq(q16, c16, adj, ids, ids, 0, 1 / 0.7, lse, g)
        torch.cuda.synchronize()
        assert torch.equal(first[0].view(torch.int32), square[rows].view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_a_stripes_dq_rows_are_the_square_rows_on_normal_draws(dev, d):
    """A [2,048 x 8,192] stripe (a four-way data-parallel split) at row
    offset 4,096 on normal draws with ids, logQ and padded columns: dq bit
    for bit those rows of the square case (its rows meet the same chunks,
    merged in the same order, and the same ties); dc of the stripe within
    the grad bars of the plain version."""
    bk, bq, off = 8192, 2048, 4096
    q16, c16, ids, log_q, g = _inputs(dev, bk, bk, d, seed=d + 11, n_ids=5000)
    adj = sk._merged_adj(log_q, bk - 192, bk, dev)
    lse = sk.lse_forward_reference(q16, c16, adj, ids, ids, 0, 1.0)
    rows = slice(off, off + bq)
    args = (q16[rows].contiguous(), c16, adj, ids[rows].contiguous(), ids, off, 1.0,
            lse[rows].contiguous(), g[rows].contiguous())
    square = sk.softmax_lse_dq(q16, c16, adj, ids, ids, 0, 1.0, lse, g)
    stripe, dc = sk.softmax_lse_dq(*args), sk.softmax_lse_dc(*args)
    torch.cuda.synchronize()
    assert torch.equal(stripe.view(torch.int32), square[rows].view(torch.int32))
    _grad_close(dc, sk.lse_backward_reference(*args, need_dq=False)[1], "dc")


@pytest.mark.cuda
@pytest.mark.parametrize("bk", [2048, 4096, 6144, 8192])
@pytest.mark.parametrize("d", [64, 128])
def test_backward_at_each_chunk_count_matches_plain(dev, bk, d):
    """#10 and #11 on a BQ = 128 stripe at row offset BK / 2 of BK columns,
    BK at each count of `bwd_chunks` (1, 2, 3, 4 chunks of the c tiles for
    dq, a block each, merged by a second launch; one chunk of q rows for
    dc), with ids, logQ and padded columns: each against its plain version,
    two launches bit for bit."""
    assert sk.bwd_chunks(bk) == bk // 2048
    bq, off = 128, bk // 2
    q16, c16, ids, log_q, g = _inputs(dev, bk, bk, d, seed=bk + d, n_ids=500)
    adj = sk._merged_adj(log_q, bk - 64, bk, dev)
    rows = slice(off, off + bq)
    args = (q16[rows].contiguous(), c16, adj, ids[rows].contiguous(), ids, off, 1.0)
    lse = sk.lse_forward_reference(*args)
    args = (*args, lse, g[rows].contiguous())
    got = (sk.softmax_lse_dq(*args), sk.softmax_lse_dc(*args))
    again = (sk.softmax_lse_dq(*args), sk.softmax_lse_dc(*args))
    want = sk.lse_backward_reference(*args)
    torch.cuda.synchronize()
    for a, b_, w, label in zip(got, again, want, ("dq", "dc")):
        assert a.shape == w.shape, label
        assert torch.equal(a.view(torch.int32), b_.view(torch.int32)), f"{label}: two launches"
        _grad_close(a, w, label)
    assert (got[1][bk - 64:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [192, 256, 1024, 2048])
@pytest.mark.parametrize("bq,row_offset,n_valid", [(512, 0, 400), (128, 256, None),
                                                   (256, 256, 448)])
def test_wide_dims_match_plain(dev, d, bq, row_offset, n_valid):
    """128 < D <= 2,048: the kernels' TMA + wgmma ring (#9 over column
    chunks and a merge; the p kernel and two products). The square with
    padded columns and stripes at a row offset, item ids and logQ: each
    kernel against its plain version, two launches bit for bit, dq and dc
    of the original width (192 is padded to 256), padded columns without
    gradient, and a stripe's lse equal to its rows of the square case."""
    bk = 512
    q16, c16, ids, log_q, g = _inputs(dev, bk, bk, d, seed=d + bq, n_ids=200)
    adj = sk._merged_adj(log_q, n_valid, bk, dev)
    rows = slice(row_offset, row_offset + bq)
    args = (q16[rows].contiguous(), c16, adj, ids[rows].contiguous(), ids, row_offset, 1 / 0.7)
    g = g[rows].contiguous()
    lse = _compare(args, g)
    want_lse = sk.lse_forward_reference(*args)
    again = (sk.softmax_lse_fwd(*args), sk.softmax_lse_dq(*args, want_lse, g),
             sk.softmax_lse_dc(*args, want_lse, g))
    first = (lse, sk.softmax_lse_dq(*args, want_lse, g), sk.softmax_lse_dc(*args, want_lse, g))
    square = sk.softmax_lse_fwd(q16, c16, adj, ids, ids, 0, 1 / 0.7)
    torch.cuda.synchronize()
    for a, b_ in zip(first, again):
        assert torch.equal(a.view(torch.int32), b_.view(torch.int32))
    assert first[1].shape == (bq, d) and first[2].shape == (bk, d)
    if n_valid is not None:
        assert (first[2][n_valid:] == 0).all()
    assert torch.equal(lse.view(torch.int32), square[rows].view(torch.int32))


@pytest.mark.cuda
def test_fully_masked_rows_stay_finite(dev):
    """Every id equal and the last 128 columns padded: rows at or past
    `n_valid` have no live column. The lse is finite (about -1e9) and the
    kernel agrees with the plain version; exp(-1e9 - lse) on the live rows'
    masked columns is exactly 0."""
    b, d = 512, 64
    q16, c16, _, _, g = _inputs(dev, b, b, d, seed=4)
    ids = torch.full((b,), 7, dtype=torch.int32, device=dev)
    adj = sk._merged_adj(None, b - 128, b, dev)
    lse = _compare((q16, c16, adj, ids, ids, 0, 1.0), g)
    assert torch.isfinite(lse).all() and (lse[b - 128:] < -9e8).all()
    assert (lse[:b - 128] > -1e3).all()  # a live row keeps its own positive column


@pytest.mark.cuda
def test_autograd_through_the_kernels(dev):
    """`sampled_softmax_fused` on the card against the same call on the CPU
    (plain versions): loss, dq and dc."""
    b, d = 512, 64
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).bfloat16().float()
    c = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).bfloat16().float()
    labels = torch.from_numpy(rng.integers(0, 2, b).astype(np.int32))
    ids = torch.from_numpy(rng.integers(1, 50, b).astype(np.int32))
    log_q = torch.from_numpy((rng.normal(size=b) * 0.2).astype(np.float32))
    res = {}
    for device in ("cpu", dev):
        qt = q.clone().to(device).requires_grad_(True)
        ct = c.clone().to(device).requires_grad_(True)
        loss = sk.sampled_softmax_fused(qt, ct, labels.to(device), ids.to(device),
                                        log_q.to(device), 0.9)
        loss.backward()
        res[str(device)] = (loss.item(), qt.grad.cpu(), ct.grad.cpu())
    (l0, dq0, dc0), (l1, dq1, dc1) = res["cpu"], res[str(dev)]
    np.testing.assert_allclose(l1, l0, rtol=2e-5)
    _grad_close(dq1, dq0, "dq")
    _grad_close(dc1, dc0, "dc")


@pytest.mark.cuda
def test_shapes_outside_the_gate_raise_on_the_card(dev):
    q16, c16, ids, log_q, _ = _inputs(dev, 384, 384, 64, seed=2)
    with pytest.raises(ValueError, match="softmax_kernel_shapes_ok"):
        sk.softmax_lse_fwd(q16[:200].contiguous(), c16, None, None, None, 0, 1.0)
    q16, c16, _, _, _ = _inputs(dev, 256, 256, 2049, seed=2)  # past the reference's cap
    with pytest.raises(ValueError, match="softmax_kernel_shapes_ok"):
        sk.softmax_lse_fwd(q16, c16, None, None, None, 0, 1.0)
    q16, c16, _, log_q, g = _inputs(dev, 256, 256, 64, seed=2)
    off = torch.zeros(257, dtype=torch.float32, device=dev)[1:]  # 4 bytes past a boundary
    with pytest.raises(ValueError, match="16-byte boundary"):
        sk.softmax_lse_dq(q16, c16, off, None, None, 0, 1.0, log_q, g)


def _one_ulp(got: torch.Tensor, want: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Where a panel of p (bf16) lies within one bf16 ulp of the plain one
    (the spacing of bf16 values at the larger magnitude, 2^-133 below the
    smallest normal, 2^-126), or within 2^-126 |g| of it: ex2.approx flushes
    an exp(s - lse) below 2^-126 to zero, where the plain version's expf
    keeps it, and such a p, times g, may still round to a bf16 subnormal."""
    a, b = got.float(), want.float()
    m = torch.maximum(torch.maximum(a.abs(), b.abs()), torch.tensor(2.0 ** -126, device=a.device))
    _, e = torch.frexp(m)  # m = f 2^e, 0.5 <= f < 1: bf16's spacing there is 2^(e - 8), exactly
    ulp = torch.maximum(torch.ldexp(torch.ones_like(m), e - 8), 2.0 ** -126 * g.abs()[:, None])
    return (a - b).abs() <= ulp


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 2048])
@pytest.mark.parametrize("bq,row_offset,n_valid", [(512, 0, 400), (256, 256, None)])
def test_p_kernel_matches_plain_p(dev, d, bq, row_offset, n_valid):
    """The p kernel of the wide backward against `p_panel_reference`: every p
    of weight (exp(s - lse) >= 2^-10) bit for bit, the rest within one bf16
    ulp (ex2.approx and the tensor cores' order move them by a few f32 ulps;
    `_one_ulp`, with the exp's flush to zero below 2^-126).
    The square with padded columns and a stripe at a row offset, whose panel
    rows are bit for bit those of the square; two launches bit for bit."""
    bk = 512
    q16, c16, ids, log_q, g = _inputs(dev, bk, bk, d, seed=d + bq + 1, n_ids=200)
    adj = sk._merged_adj(log_q, n_valid, bk, dev)
    lse = sk.lse_forward_reference(q16, c16, adj, ids, ids, 0, 1 / 0.7)
    rows = slice(row_offset, row_offset + bq)
    args = (q16[rows].contiguous(), c16, adj, ids[rows].contiguous(), ids, row_offset, 1 / 0.7,
            lse[rows].contiguous(), g[rows].contiguous())
    before = sk.softmax_lse_p.launches
    got, again = sk.softmax_lse_p(*args, 0, bq), sk.softmax_lse_p(*args, 0, bq)
    square = sk.softmax_lse_p(q16, c16, adj, ids, ids, 0, 1 / 0.7, lse, g, 0, bk)
    want = sk.p_panel_reference(*args, 0, bq)
    cols = torch.arange(bk, device=dev)
    s = sk._scores(args[0].float(), c16.float(), adj, args[3], ids, cols[rows], cols, 1 / 0.7)
    weighty = torch.exp(s - args[7][:, None]) >= 2.0 ** -10
    torch.cuda.synchronize()
    assert sk.softmax_lse_p.launches == before + 3
    assert got.shape == (bq, bk) and got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    assert torch.equal(got.view(torch.int16), square[rows].view(torch.int16))
    assert weighty.any()
    assert torch.equal(got[weighty].view(torch.int16), want[weighty].view(torch.int16))
    assert _one_ulp(got, want, args[8]).all()
    if n_valid is not None:
        assert (got[:, n_valid:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [256, 1024])
def test_panels_match_one_panel_and_plain(dev, d, monkeypatch):
    """A backward walked in four panels of 128 q rows (a small PANEL_BYTES)
    against the one-panel backward and the plain version: dq bit for bit
    (each row meets the same p and the same k order), dc within the grad
    bars (the panels' sums are added in f32 in panel order); a launch of the
    p kernel and of each product per panel."""
    b = 512
    q16, c16, ids, log_q, g = _inputs(dev, b, b, d, seed=d + 3, n_ids=200)
    adj = sk._merged_adj(log_q, 448, b, dev)
    args = (q16, c16, adj, ids, ids, 0, 1 / 0.7)
    lse = sk.lse_forward_reference(*args)
    one = sk.wide_backward(*args, lse, g)
    monkeypatch.setattr(sk, "PANEL_BYTES", 128 * 2 * b)
    assert sk.panel_rows(b, b) == 128
    wrappers = (sk.softmax_lse_p, sk.softmax_lse_dq, sk.softmax_lse_dc)
    before = [w.launches for w in wrappers]
    four = sk.wide_backward(*args, lse, g)
    want = sk.lse_backward_reference(*args, lse, g)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [n + 4 for n in before]
    assert torch.equal(four[0].view(torch.int32), one[0].view(torch.int32))
    _grad_close(four[1], one[1], "dc, four panels against one")
    for got, w, label in zip(four, want, ("dq", "dc")):
        assert got.shape == w.shape == (b, d)
        _grad_close(got, w, label)
    assert (four[1][448:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 256, 2048])
def test_both_gradients_entry_matches_the_single_wrappers(dev, d):
    """`softmax_lse_grads` (one p a panel for both products at a wide D; the
    narrow kernels #10 and #11 at D = 64) against `softmax_lse_dq` and
    `softmax_lse_dc` called one at a time: bit for bit, on a stripe with ids,
    logQ and padded columns. At a wide D it launches the p kernel once where
    the two single wrappers launch it twice."""
    bq, bk, off = 256, 512, 128
    q16, c16, ids, log_q, g = _inputs(dev, bk, bk, d, seed=d + 7, n_ids=200)
    adj = sk._merged_adj(log_q, 480, bk, dev)
    rows = slice(off, off + bq)
    args = (q16[rows].contiguous(), c16, adj, ids[rows].contiguous(), ids, off, 1 / 0.7)
    lse = sk.lse_forward_reference(*args)
    args = (*args, lse, g[rows].contiguous())
    p_before = sk.softmax_lse_p.launches
    both = sk.softmax_lse_grads(*args)
    p_both = sk.softmax_lse_p.launches - p_before
    single = (sk.softmax_lse_dq(*args), sk.softmax_lse_dc(*args))
    torch.cuda.synchronize()
    assert p_both == (1 if d > 128 else 0)
    assert sk.softmax_lse_p.launches - p_before == 3 * p_both
    for a, b_, label in zip(both, single, ("dq", "dc")):
        assert a.shape == b_.shape, label
        assert torch.equal(a.view(torch.int32), b_.view(torch.int32)), label
