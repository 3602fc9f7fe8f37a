"""The training slice's CUDA kernels against their plain PyTorch versions,
on the card: row-wise Adagrad (kernel #4, f32 and bf16 tables) and the fused
tower backward (kernel #8). This file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_cuda.py

Without a CUDA device the tests skip (the kernels have no CPU mode)."""

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import (
    rowwise_adagrad,
    rowwise_adagrad_reference,
)
from two_tower_recommender_model_tpu_torch.ops.tower_bwd import (
    tower_backward,
    tower_backward_reference,
)
from torch_sorted_runs import RUN_CASES, run_case_ids


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 32, 256, 4])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_perm", [False, True])
def test_rowwise_adagrad_matches_plain(dev, d, grad_dtype, with_perm):
    """Touched rows and accumulators within rtol 1e-5 (f32 summation order),
    untouched rows bitwise; duplicates, a long run and sentinels."""
    rng = np.random.default_rng(d)
    n, m = 2000, 4096
    ids = rng.integers(0, n // 3, m)
    ids[rng.random(m) < 0.1] = n + 3
    ids[:100] = 7  # a long run
    grads = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev, grad_dtype)
    perm = None
    if with_perm:  # the device-sort front-end's call
        order = np.argsort(ids, kind="stable")
        ids, perm = ids[order], torch.from_numpy(order.astype(np.int32)).to(dev)
    else:
        ids = np.sort(ids)
    ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev)
    acc = torch.from_numpy(np.abs(rng.normal(size=n)).astype(np.float32)).to(dev)
    t_k, a_k, t_p, a_p = table.clone(), acc.clone(), table.clone(), acc.clone()
    before = rowwise_adagrad.launches
    rowwise_adagrad(t_k, a_k, ids, grads, 0.05, 1e-10, perm=perm)
    rowwise_adagrad_reference(t_p, a_p, ids, grads, 0.05, 1e-10, perm=perm)
    torch.cuda.synchronize()
    assert rowwise_adagrad.launches == before + 1
    live = torch.zeros(n, dtype=torch.bool, device=dev)
    live[ids[ids < n].long()] = True
    assert torch.equal(t_k[~live].view(torch.int32), table[~live].view(torch.int32))
    assert torch.equal(a_k[~live].view(torch.int32), acc[~live].view(torch.int32))
    torch.testing.assert_close(t_k, t_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 32, 512, 4])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_perm", [False, True])
def test_rowwise_adagrad_bf16_table_matches_plain(dev, d, grad_dtype, with_perm):
    """A bf16 table: untouched rows bitwise; touched rows equal to the plain
    version's or one bf16 ulp apart (the f32 sums run in different orders
    before the one rounding), fewer than 1% of their elements apart; the f32
    accumulators within rtol 1e-5."""
    rng = np.random.default_rng(d + 1)
    n, m = 2000, 4096
    ids = rng.integers(0, n // 3, m)
    ids[rng.random(m) < 0.1] = n + 3
    ids[:100] = 7  # a long run
    grads = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev, grad_dtype)
    perm = None
    if with_perm:
        order = np.argsort(ids, kind="stable")
        ids, perm = ids[order], torch.from_numpy(order.astype(np.int32)).to(dev)
    else:
        ids = np.sort(ids)
    ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev, torch.bfloat16)
    acc = torch.from_numpy(np.abs(rng.normal(size=n)).astype(np.float32)).to(dev)
    t_k, a_k, t_p, a_p = table.clone(), acc.clone(), table.clone(), acc.clone()
    before = rowwise_adagrad.launches
    rowwise_adagrad(t_k, a_k, ids, grads, 0.05, 1e-10, perm=perm)
    rowwise_adagrad_reference(t_p, a_p, ids, grads, 0.05, 1e-10, perm=perm)
    torch.cuda.synchronize()
    assert rowwise_adagrad.launches == before + 1 and t_k.dtype == torch.bfloat16
    live = torch.zeros(n, dtype=torch.bool, device=dev)
    live[ids[ids < n].long()] = True
    assert torch.equal(t_k[~live].view(torch.int16), table[~live].view(torch.int16))
    assert torch.equal(a_k[~live].view(torch.int32), acc[~live].view(torch.int32))
    got, want = t_k[live].float(), t_p[live].float()
    assert not torch.equal(got, table[live].float())
    # atol 1e-6 (the f32 table test's): where row and update cancel to nearly zero
    assert ((got - want).abs() <= 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) + 1e-6).all()
    assert (got != want).float().mean().item() < 0.01
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RUN_CASES))
@pytest.mark.parametrize("d", [128, 12])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_perm", [False, True])
def test_rowwise_adagrad_run_lengths(dev, case, d, table_dtype, grad_dtype, with_perm):
    """Runs at the edges of the kernel's span walk (1, 32, 33, 63, 64, 65 and
    3,000 positions, long runs that start mid-span, end at M or meet the
    sentinels) among runs of 3: untouched rows bitwise, the rest within the
    plain version's bounds (an f32 table rtol 1e-5 / atol 1e-6; a bf16
    table's touched rows changed, each value within 2^-7 of the larger
    magnitude of the two (at most two bf16 ulps; atol 1e-6), fewer than 1%
    of them apart; accumulators rtol 1e-5), and two launches bit for bit
    equal (every sum, the long runs' pieces too, has one order). D = 12
    takes the 8-byte bf16 loads."""
    n, ids = run_case_ids(case)
    m = ids.shape[0]
    rng = np.random.default_rng(m + d)
    grads = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev, grad_dtype)
    perm = None
    if with_perm:  # the device sort's order: the gradients arrive shuffled
        shuffle = rng.permutation(m)
        perm = torch.from_numpy(shuffle.astype(np.int32)).to(dev)
        grads = grads[torch.from_numpy(np.argsort(shuffle)).to(dev)].contiguous()
    ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dev, table_dtype)
    acc = torch.from_numpy(np.abs(rng.normal(size=n)).astype(np.float32)).to(dev)
    t_k, a_k, t_p, a_p = table.clone(), acc.clone(), table.clone(), acc.clone()
    t_2, a_2 = table.clone(), acc.clone()
    before = rowwise_adagrad.launches
    rowwise_adagrad(t_k, a_k, ids, grads, 0.05, 1e-10, perm=perm)
    rowwise_adagrad(t_2, a_2, ids, grads, 0.05, 1e-10, perm=perm)
    rowwise_adagrad_reference(t_p, a_p, ids, grads, 0.05, 1e-10, perm=perm)
    torch.cuda.synchronize()
    assert rowwise_adagrad.launches == before + 2
    bits = torch.int32 if table_dtype == torch.float32 else torch.int16
    assert torch.equal(t_k.view(bits), t_2.view(bits))
    assert torch.equal(a_k.view(torch.int32), a_2.view(torch.int32))
    live = torch.zeros(n, dtype=torch.bool, device=dev)
    live[ids[ids < n].long()] = True
    assert torch.equal(t_k[~live].view(bits), table[~live].view(bits))
    assert torch.equal(a_k[~live].view(torch.int32), acc[~live].view(torch.int32))
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=1e-6)
    if table_dtype == torch.float32:
        torch.testing.assert_close(t_k, t_p, rtol=1e-5, atol=1e-6)
    else:
        got, want = t_k[live].float(), t_p[live].float()
        assert not torch.equal(got, table[live].float())
        assert ((got - want).abs() <= 2.0 ** -7 * torch.maximum(got.abs(), want.abs())
                + 1e-6).all()
        assert (got != want).float().mean().item() < 0.01


TOWER_TILE = {torch.bfloat16: 64, torch.float32: 32}  # rows per tile of kernel #8


def _tower_inputs(dev, b, h2, io_dtype, seed):
    """x and W1 on coarse grids (x in steps of 1/8 up to 1, W1 in steps of
    2^-7 up to 1/8), so that every partial sum of x @ W1 is a multiple of
    2^-10 below 2^5: exact in f32 in any order, on the tensor cores as on
    the CUDA cores. Both versions then take the same layer-1 ReLU decisions.
    With normal draws, a pre-activation lands within an f32 rounding of a
    bf16 boundary against -b1 about once in 3e7 values; the two summation
    orders then decide that ReLU differently, which moves a whole row of dx
    by a tenth of its largest value. dq is drawn around 0.5: db2 is held to
    1e-5 x its largest value, and at H2 = 1 a zero-mean draw cancels the one
    column's sum of 262,144 values to ~1e-5 of their magnitudes' sum, below
    what two f32 summation orders agree on. The other operands are normal
    draws."""
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
    x = t(rng.integers(-8, 9, size=(b, 128)) / 8, io_dtype)
    dq = t(rng.normal(loc=0.5, size=(b, h2)), io_dtype)
    out = t(np.maximum(rng.normal(size=(b, h2)), 0), io_dtype)
    w1 = t(rng.integers(-16, 17, size=(128, 128)) / 128)
    b1 = t(rng.normal(size=128, scale=0.1))
    w2 = t(rng.normal(size=(128, h2), scale=0.1))
    return x, dq, out, w1, b1, w2


@pytest.mark.cuda
@pytest.mark.parametrize("h2", [1, 8, 40, 64, 100, 128])
@pytest.mark.parametrize("io_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch", ["512", "4096 + one tile", "262144"])
def test_tower_backward_matches_plain(dev, h2, io_dtype, batch):
    """dx, dW1 and dW2 within one bf16 ulp of their largest magnitude (a sum
    on a bf16 rounding boundary rounds either way), db within 1e-5 x max.
    H2 from 1 to 128 (zero-padded to 32, 64 or 128 inside the kernel); the
    batches leave the last wave of the persistent grid partly idle (512 rows
    are 8 or 16 tiles for 132 SMs; 4,096 + one tile is one tile more than a
    multiple of the tile)."""
    b = 4096 + TOWER_TILE[io_dtype] if batch == "4096 + one tile" else int(batch)
    x, dq, out, w1, b1, w2 = _tower_inputs(dev, b, h2, io_dtype, h2)
    before = tower_backward.launches
    got = tower_backward(x, dq, out, w1, b1, w2)
    want = tower_backward_reference(x, dq, out, w1, b1, w2)
    torch.cuda.synchronize()
    assert tower_backward.launches == before + 1
    assert got[0].dtype == io_dtype
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        scale = w.float().abs().max().item()
        tol = 2.0 ** -8 * scale if i in (0, 1, 3) else 1e-5 * scale
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("h2", [8, 64])
@pytest.mark.parametrize("io_dtype", [torch.bfloat16, torch.float32])
def test_tower_backward_takes_an_f32_gemms_relu_decisions(dev, h2, io_dtype):
    """Normal draws at B = 262,144: some pre-activations' f32 sums lie on a
    bf16 rounding midpoint against -b1 (seed 8, H2 = 8 has one), where the
    tensor cores' order of summation and an f32 GEMM's decide the ReLU
    differently. The kernel recomputes those in k order, so
    its dx, dW1 and dW2 match the plain version's (cuBLAS's f32 GEMM) within
    one bf16 ulp of their largest magnitude. (db is left to the tests above:
    a zero-mean dq cancels its column sums.)"""
    rng = np.random.default_rng(8)
    b = 262_144

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
    x = t(rng.normal(size=(b, 128)), io_dtype)
    dq = t(rng.normal(size=(b, h2)), io_dtype)
    out = t(np.maximum(rng.normal(size=(b, h2)), 0), io_dtype)
    w1, b1 = t(rng.normal(size=(128, 128), scale=0.1)), t(rng.normal(size=128, scale=0.1))
    w2 = t(rng.normal(size=(128, h2), scale=0.1))
    got = tower_backward(x, dq, out, w1, b1, w2)
    want = tower_backward_reference(x, dq, out, w1, b1, w2)
    torch.cuda.synchronize()
    for i in (0, 1, 3):  # dx, dW1, dW2
        scale = want[i].float().abs().max().item()
        torch.testing.assert_close(got[i].float(), want[i].float(), rtol=0, atol=2.0 ** -8 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("io_dtype", [torch.bfloat16, torch.float32])
def test_tower_backward_is_deterministic(dev, io_dtype):
    """Two launches on the same inputs agree bit for bit: each block sums its
    own tiles in a fixed order and a second pass adds the blocks in order,
    with no atomics (the CUDA graph's eager-against-replayed check relies on
    it)."""
    x, dq, out, w1, b1, w2 = _tower_inputs(dev, 262_144, 64, io_dtype, 5)
    first = [t.clone() for t in tower_backward(x, dq, out, w1, b1, w2)]
    second = tower_backward(x, dq, out, w1, b1, w2)
    torch.cuda.synchronize()
    view = torch.int16 if io_dtype == torch.bfloat16 else torch.int32
    assert torch.equal(first[0].view(view), second[0].view(view))
    for a, b in zip(first[1:], second[1:]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("io_dtype", [torch.bfloat16, torch.float32])
def test_tower_backward_refuses_a_batch_off_its_tile(dev, io_dtype):
    """A CUDA batch that is not a multiple of the kernel's tile raises
    `ValueError` before any launch; a multiple of the tile runs."""
    tile = TOWER_TILE[io_dtype]
    x, dq, out, w1, b1, w2 = _tower_inputs(dev, 4 * tile + tile // 2, 16, io_dtype, 6)
    before = tower_backward.launches
    with pytest.raises(ValueError, match="multiple|B %"):
        tower_backward(x, dq, out, w1, b1, w2)
    assert tower_backward.launches == before
    cut = 4 * tile
    tower_backward(x[:cut].contiguous(), dq[:cut].contiguous(), out[:cut].contiguous(), w1, b1, w2)
    torch.cuda.synchronize()
    assert tower_backward.launches == before + 1


def _within_one_bf16_ulp(got, want, a, w):
    """|got - want| within one bf16 ulp of the larger (2^-7 x max(|got|,
    |want|) admits exactly one ulp between bf16 values), plus 2^-20 x the sum
    of |terms| of the product: where the terms cancel to near zero, the f32
    sums of the two orders may straddle more than one ulp of the result."""
    floor = 2.0 ** -20 * torch.matmul(a.float().abs(), w.float().abs())
    diff = (got.float() - want.float()).abs()
    bound = 2.0 ** -7 * torch.maximum(got.float().abs(), want.float().abs()) + floor
    return bool((diff <= bound).all()), diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("h2", [64, 128, 40])
def test_bf16_tower_forward_gemms_match_the_widened_route(dev, h2):
    """Under bf16 compute the fused tower's forward runs on the card as two
    bf16 GEMMs (f32 sums, one rounding); the CPU's route widens the operands
    to f32 and rounds the product. Products of bf16 values are exact in f32,
    so only the order of the sums differs: each layer's product is within
    one bf16 ulp of the widened route's on the same inputs. The forward
    itself is the fused kernel's (`ops/tower_fwd.py`), whose tensor cores sum
    in a third order: within 2^-8 x max|plain| of its plain version, the two
    GEMMs with relu_ties's bias and ReLU."""
    from two_tower_recommender_model_tpu_torch.models.mlp import _mlp2_fwd_impl, _mm
    from two_tower_recommender_model_tpu_torch.ops.relu_ties import relu_ties_reference
    from two_tower_recommender_model_tpu_torch.ops.tower_fwd import tower_forward_reference

    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    rng = np.random.default_rng(h2)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16)
    x = t(rng.normal(size=(262_144, 128)))
    w1, b1 = t(rng.normal(size=(128, 128), scale=0.1)), t(rng.normal(size=128, scale=0.1))
    w2, b2 = t(rng.normal(size=(128, h2), scale=0.1)), t(rng.normal(size=h2, scale=0.1))
    h1 = relu_ties_reference(_mm(x, w1), b1, x, w1)
    for a, w in ((x, w1), (h1, w2)):
        got = _mm(a, w)
        want = torch.matmul(a.float(), w.float()).to(torch.bfloat16)
        assert got.dtype == torch.bfloat16
        ok, worst = _within_one_bf16_ulp(got, want, a, w)
        assert ok, worst
        assert (got != want).float().mean().item() < 0.01
    out = _mlp2_fwd_impl(w1, b1, w2, b2, x)
    want = tower_forward_reference(x, w1, b1, w2, b2)
    assert torch.equal(want, relu_ties_reference(_mm(h1, w2), b2, h1, w2))
    torch.testing.assert_close(out.float(), want.float(), rtol=0,
                               atol=2.0 ** -8 * want.float().abs().max().item())
