"""The fused tower's forward on the card: its kernel (`csrc/tower_fwd.cu`)
against its plain version and at bf16 rounding ties, and the two-GEMM
route's bias-and-ReLU kernel (`csrc/relu_ties.cu`) against its plain
version. This file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tower_fwd_cuda.py

Without a CUDA device the tests skip (the kernel has no CPU mode)."""

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu_torch.models.mlp import Mlp2Relu, _mlp2_fwd_impl
from two_tower_recommender_model_tpu_torch.ops.tower_fwd import (
    tower_forward,
    tower_forward_reference,
)
from torch_tie_cases import k_order_forward, tie_inputs


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(np.asarray(a, np.float32)).to(dev, torch.bfloat16) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_layer_one_makes_the_plain_versions_relu_decisions_at_ties(dev, seed):
    """Every layer-1 sum of these inputs lies within a few f32 ulps of a bf16
    rounding midpoint against -b1, so the order of its sum decides its ReLU.
    Through the forward with W2 = I and b2 = 0 (out = h1 exactly), the
    card's layer-1 decisions are the plain route's (every sum in k order, as
    the tower backward #8 and the host decide them), at B = 65,536."""
    x, w1, b1, _, _ = _on(dev, *tie_inputs(65_536, 128, seed))
    eye = torch.eye(128, dtype=torch.bfloat16, device=dev)
    h1 = _mlp2_fwd_impl(w1, b1, eye, torch.zeros(128, dtype=torch.bfloat16, device=dev), x)
    want, _ = k_order_forward(x, w1, b1, eye, torch.zeros(128, device=dev))
    flips = ((h1 > 0) != (want > 0)).sum().item()
    assert flips == 0, f"{flips} of {h1.numel()} ReLU decisions differ from the k-order route's"
    assert 0.4 < (want > 0).float().mean().item() < 0.6


@pytest.mark.cuda
@pytest.mark.parametrize("h2", [64, 128])
def test_tower_forward_and_backward_follow_the_plain_version_at_ties(dev, h2):
    """`Mlp2Relu` on the tie inputs: the final ReLU decisions (the mask the
    backward takes from the saved output) are the plain route's, and the
    backward's dx, dW1, dW2 stay within one bf16 ulp of the largest value of
    the backward under the plain route's two ReLU masks: a flipped decision
    would move whole rows of dx."""
    x, w1, b1, w2, b2 = _on(dev, *tie_inputs(65_536, h2, 7 + h2))
    h1_plain, out_plain = k_order_forward(x, w1, b1, w2, b2)
    params = [t.clone().requires_grad_() for t in (w1, b1, w2, b2, x)]
    out = Mlp2Relu.apply(*params)
    assert torch.equal(out > 0, out_plain > 0)
    dq = torch.from_numpy(np.random.default_rng(h2).normal(loc=0.5, size=(65_536, h2))
                          .astype(np.float32)).to(dev, torch.bfloat16)
    out.backward(dq)

    def bf(t):
        return t.to(torch.bfloat16).float()
    d2 = torch.where(out_plain > 0, dq.float(), 0.0)
    d1 = torch.where(h1_plain > 0, bf(d2) @ w2.float().T, 0.0)
    dx, dw1, dw2 = bf(d1) @ w1.float().T, x.float().T @ bf(d1), h1_plain.float().T @ bf(d2)
    for got, want in ((params[4].grad, dx), (params[0].grad, dw1), (params[2].grad, dw2)):
        scale = want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2.0 ** -8 * scale)


def _gemm_case(dev, b, k, n, seed, ties=False):
    """(y, bias, a, w): y = the bf16 GEMM of a and w on the card."""
    if ties:
        a, w, bias, _, _ = _on(dev, *tie_inputs(b, 8, seed))
        w, bias = w[:, :n], bias[:n]
    else:
        rng = np.random.default_rng(seed)
        a, w, bias = _on(dev, rng.normal(size=(b, k)), rng.normal(size=(k, n), scale=0.1),
                         rng.normal(size=n, scale=0.1))
    return torch.matmul(a, w), bias, a, w


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ties", [
    ((262_144, 128, 128), False), ((262_144, 128, 64), False), ((4096, 128, 40), False),
    ((4096, 64, 100), False), ((1000, 128, 1), False), ((8, 16, 24), False),
    ((16_384, 128, 128), True), ((4096, 128, 40), True), ((1000, 128, 1), True)])
def test_relu_ties_matches_plain(dev, shape, ties):
    """The kernel equals its plain version bit for bit (values; the sign of a
    zero is not compared): on normal draws, where a small share is
    recomputed, and on the tie inputs, where every value is; 8 values a
    thread (N % 8 == 0) and one (N = 100, 1); one launch a call, two
    launches alike."""
    from two_tower_recommender_model_tpu_torch.ops.relu_ties import (
        relu_ties,
        relu_ties_reference,
    )

    b, k, n = shape
    y, bias, a, w = _gemm_case(dev, b, k, n, sum(shape), ties)
    before = relu_ties.launches
    got = relu_ties(y, bias, a, w)
    again = relu_ties(y, bias, a, w.T.contiguous().T)
    torch.cuda.synchronize()
    assert relu_ties.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (b, n)
    assert torch.equal(got, relu_ties_reference(y, bias, a, w))
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))


@pytest.mark.cuda
def test_relu_ties_off_a_16_byte_boundary(dev):
    """A GEMM output 2 bytes off a 16-byte boundary takes the one-value path
    and gives the plain version's values."""
    from two_tower_recommender_model_tpu_torch.ops.relu_ties import (
        relu_ties,
        relu_ties_reference,
    )

    y, bias, a, w = _gemm_case(dev, 4097, 128, 64, 3)
    y_off = y.reshape(-1)[1:1 + 4096 * 64].view(4096, 64)
    assert y_off.data_ptr() % 16
    got = relu_ties(y_off, bias, a[:4096], w)
    assert torch.equal(got, relu_ties_reference(y_off, bias, a[:4096], w))


def _tower_case(dev, b, h2, seed, linear_layout=False):
    """(x, w1, b1, w2, b2) on the card at the towers' scales (x as the pooled
    embeddings' ~0.05, weights and biases as `init_mlp` draws them); with
    `linear_layout` the weights are `nn.Linear` weights' transposed views."""
    rng = np.random.default_rng(seed)
    lim = 1 / 128 ** 0.5
    x, w1, b1, w2, b2 = _on(dev, rng.normal(size=(b, 128), scale=0.05),
                            rng.uniform(-lim, lim, (128, 128)), rng.uniform(-lim, lim, 128),
                            rng.uniform(-lim, lim, (128, h2)), rng.uniform(-lim, lim, h2))
    if linear_layout:
        w1, w2 = w1.T.contiguous().T, w2.T.contiguous().T
    return x, w1, b1, w2, b2


@pytest.mark.cuda
@pytest.mark.parametrize("b,h2,linear_layout", [
    (262_144, 64, True), (262_144, 128, False), (512, 64, False), (512, 1, True),
    (4096, 40, False), (4096, 100, True)])
def test_tower_forward_matches_plain(dev, b, h2, linear_layout):
    """The fused kernel against `tower_forward_reference` (cuBLAS GEMMs and
    relu_ties's plain version) on the towers' draws: values within 2^-8 x
    max|plain| (the tensor cores sum in another order than cuBLAS, so a
    non-tie value may sit one bf16 ulp away, and an h1 value one ulp away
    carries into layer 2), most values bit for bit; one launch a call, two
    launches bit for bit; H2 of 1, 40 and 100 pad W2 in shared memory."""
    args = _tower_case(dev, b, h2, b + h2, linear_layout)
    before = tower_forward.launches
    got = tower_forward(*args).clone()
    again = tower_forward(*args)
    torch.cuda.synchronize()
    assert tower_forward.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (b, h2)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    want = tower_forward_reference(*args)
    scale = want.float().abs().max().item()
    assert scale > 0
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2.0 ** -8 * scale)
    assert (got == want).float().mean().item() > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("h2", [64, 128])
def test_tower_forward_decides_ties_in_k_order(dev, h2):
    """On the tie inputs (every layer-1 sum at a bf16 rounding tie against
    -b1) at 65,536 rows: the kernel's final ReLU decisions are the k-order
    route's, 0 flipped, and with W2 = I and b2 = 0 (out = h1) so are layer
    1's, which hold h1 to the k-order route's bit for bit (values)."""
    x, w1, b1, w2, b2 = _on(dev, *tie_inputs(65_536, h2, 11 + h2))
    _, want = k_order_forward(x, w1, b1, w2, b2)
    got = tower_forward(x, w1, b1, w2, b2)
    flips = ((got > 0) != (want > 0)).sum().item()
    assert flips == 0, f"{flips} of {got.numel()} ReLU decisions differ from the k-order route's"
    eye = torch.eye(128, dtype=torch.bfloat16, device=dev)
    zero = torch.zeros(128, dtype=torch.bfloat16, device=dev)
    h1_want, _ = k_order_forward(x, w1, b1, eye, zero)
    h1 = tower_forward(x, w1, b1, eye, zero)
    assert torch.equal(h1, h1_want)
    assert 0.4 < (h1 > 0).float().mean().item() < 0.6


@pytest.mark.cuda
@pytest.mark.parametrize("tie_cols", [1, 2])
def test_tower_forward_sums_sparse_ties_in_k_order(dev, tie_cols):
    """Layer-1 sums at ties in only `tie_cols` columns, the others drawn, at
    65,536 rows (a few ties a warp, as on the towers' draws, but every row
    has one): with W2 = I and b2 = 0 (out = h1) the tied columns of h1 are
    the k-order route's bit for bit (values), the rest within 2^-8 x
    max|h1| (the tensor cores sum the untied columns in their own order: a
    sum one bf16 ulp off near -b1 is not a tie, and its h1 is small); the
    tower's output lies within 2^-8 x max|plain| of the plain version's.
    (The final decisions are not compared with the k-order route's: an
    untied h1 value one ulp off moves layer 2's sums.)"""
    x, w1, b1, w2, b2 = _on(dev, *tie_inputs(65_536, 64, 30 + tie_cols, tie_cols))
    eye = torch.eye(128, dtype=torch.bfloat16, device=dev)
    zero = torch.zeros(128, dtype=torch.bfloat16, device=dev)
    h1_want, _ = k_order_forward(x, w1, b1, eye, zero)
    h1 = tower_forward(x, w1, b1, eye, zero)
    assert torch.equal(h1[:, :tie_cols], h1_want[:, :tie_cols])
    assert 0.4 < (h1[:, :tie_cols] > 0).float().mean().item() < 0.6
    torch.testing.assert_close(h1.float(), h1_want.float(), rtol=0,
                               atol=2.0 ** -8 * h1_want.float().abs().max().item())
    got = tower_forward(x, w1, b1, w2, b2)
    plain = tower_forward_reference(x, w1, b1, w2, b2)
    torch.testing.assert_close(got.float(), plain.float(), rtol=0,
                               atol=2.0 ** -8 * plain.float().abs().max().item())
