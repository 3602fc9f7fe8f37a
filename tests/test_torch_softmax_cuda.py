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
    torch.testing.assert_close(lse, square[rows], rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_both_tile_sizes_agree(dev, monkeypatch):
    """Blocks of 64 own rows (small grids) and of 128 (grids that fill the
    card) compute the same function."""
    b, d = 1024, 64
    q16, c16, ids, log_q, g = _inputs(dev, b, b, d, seed=1)
    args = (q16, c16, log_q, ids, ids, 0, 1.3)
    out = {}
    for tile in (64, 128):
        monkeypatch.setattr(sk, "_tile_own", lambda n, device, t=tile: t)
        lse = sk.softmax_lse_fwd(*args)
        out[tile] = (lse, sk.softmax_lse_dq(*args, lse, g), sk.softmax_lse_dc(*args, lse, g))
    torch.cuda.synchronize()
    torch.testing.assert_close(out[64][0], out[128][0], rtol=1e-6, atol=1e-6)
    _grad_close(out[64][1], out[128][1], "dq")
    _grad_close(out[64][2], out[128][2], "dc")
    _compare(args, g)


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
    q16, c16, _, _, _ = _inputs(dev, 256, 256, 160, seed=2)
    with pytest.raises(ValueError, match="softmax_kernel_shapes_ok"):
        sk.softmax_lse_fwd(q16, c16, None, None, None, 0, 1.0)
