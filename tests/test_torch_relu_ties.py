"""`ops/relu_ties.py` on the CPU: the tie test marks exactly the bf16 values
whose neighbour decides the ReLU the other way, the plain version (the CUDA
kernel's oracle) makes the k-order decisions on inputs built to sit on bf16
rounding ties and keeps the GEMM's sums everywhere else, the wrapper takes
its plain version on CPU tensors, and a fused tower layer through it stays
with the JAX package's forward. (The kernel itself runs in
`tests/test_torch_tower_fwd_cuda.py` and `chip_smoke.py`.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu.models.mlp import _mlp2_fwd_impl as jax_mlp2_fwd
from two_tower_recommender_model_tpu_torch.models.mlp import _mlp2_fwd_impl, _mm
from two_tower_recommender_model_tpu_torch.ops.relu_ties import (
    relu_ties,
    relu_ties_reference,
    tie_mask,
)
from torch_tie_cases import k_order_forward, k_order_matmul, tie_inputs


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the same
    cores, where torch's thread pools would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _every_bf16() -> torch.Tensor:
    """Every finite bf16 value once (+0 and -0 both), in increasing order."""
    bits = torch.arange(1 << 16, dtype=torch.int32)
    vals = torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16).view(torch.bfloat16)
    vals = vals[torch.isfinite(vals.float())]
    return vals[torch.argsort(vals.float(), stable=True)]


def _neighbour_ties(vals: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Over `vals` (every finite bf16 value, in value order): where the value
    before or after in that order decides bf16(v + b) > 0 other than it,
    from the sorted list alone."""
    d = (vals.float() + bias.float()).to(torch.bfloat16) > 0
    want = (torch.cat([d[:1], d[:-1]]) != d) | (torch.cat([d[1:], d[-1:]]) != d)
    # -0 and +0 sit side by side: both are 0, whose neighbours are the smallest subnormals
    zi = torch.nonzero(vals.float() == 0).flatten()
    lo, hi = zi.min().item() - 1, zi.max().item() + 1
    want[zi] = (d[lo] != d[zi]) | (d[hi] != d[zi])
    return want


@pytest.mark.parametrize("b", [0.0, -0.0, 0.1, -1.5, 3.0e-3, 1.0e-30, -250.0, 1.0e-40, -3.0e-39,
                               6.5e4, -1.0e38])
def test_tie_mask_marks_the_values_a_neighbour_decides_otherwise(b):
    """Over every finite bf16 value r (in value order): marked exactly where
    the value before or after r in that order decides bf16(v + b) > 0 other
    than r, computed here from the sorted list, independently of the
    kernel's bit arithmetic. That is the values at the boundary -b."""
    vals = _every_bf16()
    bias = _bf([b])
    got = tie_mask(vals[None, :], bias.expand(vals.shape[0]))[0]
    assert torch.equal(got, _neighbour_ties(vals, bias))
    assert 1 <= int(got.sum()) <= 4


def test_tie_mask_over_random_biases():
    """The same over 200 biases drawn from every finite bf16 bit pattern."""
    vals = _every_bf16()
    rng = np.random.default_rng(5)
    biases = vals[torch.from_numpy(rng.integers(0, vals.shape[0], 200))]
    for bias in biases:
        got = tie_mask(vals[None, :], bias.reshape(1).expand(vals.shape[0]))[0]
        assert torch.equal(got, _neighbour_ties(vals, bias.reshape(1))), bias.item()


def test_plain_version_decides_ties_in_k_order():
    """On inputs whose every layer-1 sum sits on a bf16 rounding tie against
    -b1, every value is marked, and the layer's output is the k-order
    route's bit for bit, about half of it on."""
    x, w1, b1, _, _ = (_bf(a) for a in tie_inputs(512, 64, 0))
    y = k_order_matmul(x, w1).to(torch.bfloat16)
    assert bool(tie_mask(y, b1).all())
    want = torch.relu(y + b1)
    got = relu_ties_reference(y, b1, x, w1)
    assert torch.equal(got, want)
    assert 0.4 < (got > 0).float().mean().item() < 0.6
    # the GEMM's r rounded the other way on every value: the recompute restores k order
    flipped = torch.where(y.float() > -b1.float(), y.float() - 2.0 ** -7, y.float() + 2.0 ** -7)
    assert torch.equal(relu_ties_reference(flipped.to(torch.bfloat16), b1, x, w1), want)


def test_plain_version_keeps_the_gemm_sum_off_ties():
    """On normal draws a small share of values is marked (those at -b1 and
    the bf16 value above); every other value is `relu(y + b)` of the GEMM's
    own y, bit for bit, and a marked value is the k-order sum's."""
    rng = np.random.default_rng(1)
    x = _bf(rng.normal(size=(2048, 128)))
    w = _bf(rng.normal(size=(128, 128), scale=0.1))
    b = _bf(rng.normal(size=128, scale=0.1))
    y = (_mm(x, w).float() + 2.0 ** -9).to(torch.bfloat16)  # an "other order": off by a bit
    mask = tie_mask(y, b)
    assert 0 < mask.float().mean().item() < 1e-2
    got = relu_ties_reference(y, b, x, w)
    plain = torch.relu(y + b)
    assert torch.equal(got[~mask], plain[~mask])
    k = torch.relu(k_order_matmul(x, w).to(torch.bfloat16) + b)
    assert torch.equal(got[mask], k[mask])


def test_wrapper_on_cpu_takes_the_plain_version_and_checks_its_inputs():
    x, w1, b1, _, _ = (_bf(a) for a in tie_inputs(64, 8, 2))
    y = _mm(x, w1)
    before = relu_ties.launches
    assert torch.equal(relu_ties(y, b1, x, w1), relu_ties_reference(y, b1, x, w1))
    # w as a transposed view (an nn.Linear weight's .T) reads the same columns
    assert torch.equal(relu_ties(y, b1, x, w1.T.contiguous().T), relu_ties(y, b1, x, w1))
    assert relu_ties.launches == before  # a CPU call launches nothing
    with pytest.raises(TypeError, match="bfloat16"):
        relu_ties(y.float(), b1, x, w1)
    with pytest.raises(ValueError, match="shapes"):
        relu_ties(y, b1, x, w1[:, :8])
    with pytest.raises(ValueError, match="shapes"):
        relu_ties(y, b1[:8], x, w1)


def test_cpu_forward_keeps_the_widened_route():
    """On the CPU the fused tower's forward stays the widened route (f32
    GEMMs, bf16 add, ReLU), whatever its BLAS's order; `relu_ties` is the
    CUDA route's. The tie inputs' k-order forward is about half on."""
    x, w1, b1, w2, b2 = (_bf(a) for a in tie_inputs(512, 64, 3))
    before = relu_ties.launches
    out = _mlp2_fwd_impl(w1, b1, w2, b2, x)
    assert relu_ties.launches == before
    assert torch.equal(out, torch.relu(_mm(torch.relu(_mm(x, w1) + b1), w2) + b2))
    h1, _ = k_order_forward(x, w1, b1, w2, b2)
    assert 0.4 < (h1 > 0).float().mean().item() < 0.6


@pytest.mark.parametrize("h2", [64, 128])
def test_tower_forward_through_the_plain_version_matches_jax(h2):
    """The fused tower's bf16 forward with each layer's bias and ReLU through
    the plain version, against the JAX package's `_mlp2_fwd_impl` on the
    same numpy draws: within one bf16 ulp of the largest output (XLA's CPU
    dot sums in another order; a tie flipped there moves an output by about
    a bf16 ulp of b, not by a row)."""
    rng = np.random.default_rng(h2)
    draws = [rng.normal(size=(1024, 128)), rng.normal(size=(128, 128), scale=0.1),
             rng.normal(size=128, scale=0.1), rng.normal(size=(128, h2), scale=0.1),
             rng.normal(size=h2, scale=0.1)]
    x, w1, b1, w2, b2 = (_bf(a) for a in draws)
    h1 = relu_ties(_mm(x, w1), b1, x, w1)
    got = relu_ties(_mm(h1, w2), b2, h1, w2).float().numpy()
    jx, jw1, jb1, jw2, jb2 = (jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)
                              for a in draws)
    want = np.asarray(jax.jit(jax_mlp2_fwd)(jw1, jb1, jw2, jb2, jx).astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -7 * np.abs(want).max())
    assert ((got > 0) == (want > 0)).mean() > 0.999
