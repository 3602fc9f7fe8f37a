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


def _walkers(batch, h2, sms):
    """(blocks, consumer warpgroups a block) of tower_fwd's launch, as
    `csrc/tower_fwd.cu` sets them: tile t (64 rows) goes to block t %
    blocks, and there to consumer (t // blocks) % consumers, whose tiles
    follow one another in that order."""
    consumers = 4 if h2 <= 64 else 3  # the layouts' consumers: as many as shared memory holds
    return min(sms, -(-(batch // 64) // consumers)), consumers


def _tied_tiles(dev, n_tiles, h2, tiles, seed):
    """Inputs whose layer-1 sums sit at bf16 rounding ties in every column of
    the rows of `tiles` (the tie inputs' W1 and b1, x's leading 1, 1) and
    nowhere else (x's leading 2.5, 0 there: pre ~ 1.5 m, far from -b1), with
    W2 = I and b2 = 0, so that out = h1 and each zero of h1 ties in layer
    2: ties of both layers in those tiles only. Returns the inputs and the
    tied rows."""
    x, w1, b1, _, _ = tie_inputs(64 * n_tiles, 8, seed)
    tied = np.zeros(64 * n_tiles, dtype=bool)
    for t in tiles:
        tied[64 * t:64 * t + 64] = True
    x[~tied, 0], x[~tied, 1] = 2.5, 0.0
    x, w1, b1 = _on(dev, x, w1, b1)
    w2 = torch.eye(128, dtype=torch.bfloat16, device=dev)[:, :h2]
    return (x, w1, b1, w2, torch.zeros(h2, dtype=torch.bfloat16, device=dev)), tied


@pytest.mark.cuda
@pytest.mark.parametrize("h2", [64, 128])
@pytest.mark.parametrize("where", ["consecutive tiles of a walker", "last tiles of walkers"])
def test_ties_in_chosen_tiles_of_the_walk(dev, h2, where):
    """Ties of both layers only in chosen tiles of the kernel's walk, at 1,096
    tiles (not a multiple of the walkers, the consumers a block times 132):
    the first two tiles of one walker, whose layer-2 ties are settled under
    the next tile's product, or the last tile of every walker (its layer-2
    ties settled after the walk, before the last store) and the tile before
    it. With W2 = I and b2 = 0, out = h1: the tied rows bit for bit the
    k-order route's h1 (every value of theirs summed again), the others
    within 2^-8 x max|plain| of the plain version; the ReLU decisions the
    plain version's; two launches bit for bit."""
    n_tiles = 1096
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, consumers = _walkers(64 * n_tiles, h2, sms)
    walkers = blocks * consumers
    assert n_tiles % walkers
    if where == "consecutive tiles of a walker":
        tiles = [0, walkers]
    else:  # each walker's last tile and the one before it
        tiles = sorted({t for w in range(walkers) for t in (
            max(u for u in range(n_tiles) if u % walkers == w) - d * walkers for d in (0, 1))})
    args, tied = _tied_tiles(dev, n_tiles, h2, tiles, 40 + h2)
    got = tower_forward(*args).clone()
    again = tower_forward(*args)
    plain = tower_forward_reference(*args)
    h1_k, _ = k_order_forward(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    rows = torch.from_numpy(tied).to(dev)
    assert torch.equal(got[rows], h1_k[rows, :h2])
    assert torch.equal(got > 0, plain > 0)
    assert 0.3 < (got[rows] > 0).float().mean().item() < 0.7  # layer 2 ties at the zeros
    torch.testing.assert_close(got.float(), plain.float(), rtol=0,
                               atol=2.0 ** -8 * plain.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("h2", [37, 64, 128])
def test_batches_of_fewer_tiles_than_the_ring(dev, k, h2):
    """B = 64 k for k below and about the ring's depth of 4 tiles (the kernel
    takes any multiple of 64; the wrapper's granule of 512 is the tower
    backward's): one block a tile for each consumer at most, consumers with
    no tile at all, and the ring's first loads the whole walk. Called below
    the wrapper's check; values within 2^-8 x max|plain| of the plain
    version and the ties of the tie inputs' rows in k order."""
    rng = np.random.default_rng(k * h2)
    x, w1, b1, w2, b2 = _tower_case(dev, 64 * k, h2, 100 + k * h2, linear_layout=True)
    got = tower_forward._launch(x, w1, b1, w2, b2)
    want = tower_forward_reference(x, w1, b1, w2, b2)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2.0 ** -8 * want.float().abs().max().item())
    tx, tw1, tb1, _, _ = _on(dev, *tie_inputs(64 * k, h2, int(rng.integers(1 << 16))))
    eye = torch.eye(128, dtype=torch.bfloat16, device=dev)[:, :h2]
    zero = torch.zeros(h2, dtype=torch.bfloat16, device=dev)
    h1_k, _ = k_order_forward(tx, tw1, tb1, eye, zero)
    assert torch.equal(tower_forward._launch(tx, tw1, tb1, eye, zero), h1_k[:, :h2])


@pytest.mark.cuda
@pytest.mark.parametrize("h2", [1, 37, 64, 100, 128])
def test_widths_and_weight_layouts_agree(dev, h2):
    """Every width H2 the kernel takes (the no-branch instance at 64 and
    128, the padded one elsewhere; TMA box stores at 64 and 128, one bulk
    copy a tile elsewhere), at 70,144 rows: `nn.Linear` weights' transposed
    views give the bits of contiguous [in, out] weights, and both lie within
    2^-8 x max|plain| of the plain version."""
    x, w1, b1, w2, b2 = _tower_case(dev, 70_144, h2, 7 * h2)
    got = tower_forward(x, w1, b1, w2, b2)
    linear = tower_forward(x, w1.T.contiguous().T, b1, w2.T.contiguous().T, b2)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), linear.view(torch.int16))
    want = tower_forward_reference(x, w1, b1, w2, b2)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=2.0 ** -8 * want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("h2", [37, 64, 128])
def test_two_launches_and_a_captured_graph_agree(dev, h2):
    """The kernel allocates nothing and does not synchronize, so it is
    captured in a CUDA graph: the graph's replays, on the inputs as they lie
    and after new values are copied into them, give the bits of eager
    launches, which give each other's; one launch counted per eager call
    and none per replay."""
    args = _tower_case(dev, 65_536, h2, 9 + h2, linear_layout=True)
    first = tower_forward(*args).clone()
    second = tower_forward(*args).clone()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        tower_forward(*args)  # a warm-up launch on the capturing stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tower_forward(*args)
    before = tower_forward.launches
    graph.replay()
    torch.cuda.synchronize()
    assert tower_forward.launches == before
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
    assert torch.equal(out.view(torch.int16), first.view(torch.int16))
    fresh = _tower_case(dev, 65_536, h2, 10 + h2, linear_layout=True)
    for t, v in zip(args, fresh):
        t.copy_(v)
    graph.replay()
    want = tower_forward(*fresh)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))
