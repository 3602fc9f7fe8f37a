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
@pytest.mark.parametrize("h2", [64, 128, 40])
@pytest.mark.parametrize("io_dtype", [torch.bfloat16, torch.float32])
def test_tower_backward_matches_plain(dev, h2, io_dtype):
    """dx, dW1 and dW2 within one bf16 ulp of their largest magnitude (a sum
    on a bf16 rounding boundary rounds either way), db within 1e-5 x max."""
    rng = np.random.default_rng(h2)
    b = 4096

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
    x = t(rng.normal(size=(b, 128)), io_dtype)
    dq = t(rng.normal(size=(b, h2)), io_dtype)
    out = t(np.maximum(rng.normal(size=(b, h2)), 0), io_dtype)
    w1, b1 = t(rng.normal(size=(128, 128), scale=0.1)), t(rng.normal(size=128, scale=0.1))
    w2 = t(rng.normal(size=(128, h2), scale=0.1))
    before = tower_backward.launches
    got = tower_backward(x, dq, out, w1, b1, w2)
    want = tower_backward_reference(x, dq, out, w1, b1, w2)
    torch.cuda.synchronize()
    assert tower_backward.launches == before + 1
    assert got[0].dtype == io_dtype
    for i, (g, w) in enumerate(zip(got, want)):
        scale = w.float().abs().max().item()
        tol = 2.0 ** -8 * scale if i in (0, 1, 3) else 1e-5 * scale
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol)
