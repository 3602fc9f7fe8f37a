"""`ops/tower_fwd.py` on the CPU: the fused tower forward's plain version
(the CUDA kernel's oracle) against the JAX package's `_mlp2_fwd_impl`, its
ReLU decisions on inputs built to sit on bf16 rounding ties, the tie test in
the form the kernel takes it, and the wrapper's refusals. (The kernel itself
runs in `tests/test_torch_tower_fwd_cuda.py` and `chip_smoke.py`.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu.models.mlp import _mlp2_fwd_impl as jax_mlp2_fwd
from two_tower_recommender_model_tpu_torch.models.mlp import Mlp2Relu, _mlp2_fwd_impl
from two_tower_recommender_model_tpu_torch.ops.relu_ties import tie_mask
from two_tower_recommender_model_tpu_torch.ops.tower_fwd import (
    _mm,
    tower_forward,
    tower_forward_reference,
)
from torch_tie_cases import k_order_forward, tie_inputs


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


def _draws(b: int, h2: int, seed: int) -> list[np.ndarray]:
    """x, w1, b1, w2, b2 at the towers' scales (x as pooled embeddings, the
    weights and biases as `init_mlp` draws them)."""
    rng = np.random.default_rng(seed)
    lim = 1 / 128 ** 0.5
    return [rng.normal(size=(b, 128), scale=0.05), rng.uniform(-lim, lim, (128, 128)),
            rng.uniform(-lim, lim, 128), rng.uniform(-lim, lim, (128, h2)),
            rng.uniform(-lim, lim, h2)]


@pytest.mark.parametrize("h2", [1, 40, 64, 128])
@pytest.mark.parametrize("b", [512, 1024])
def test_plain_version_matches_jax(b, h2):
    """The plain version against the JAX package's `_mlp2_fwd_impl` (bf16,
    CPU) on the same numpy draws: within one bf16 ulp of the largest output,
    2^-7 x max|out| (XLA's CPU dot sums in another order, so a value may
    round to the other bf16 neighbour, in layer 1 too, whose difference
    layer 2 carries). A ReLU decision may differ from JAX's only at a value
    whose rounded sum `tie_mask` flags, in either layer: the JAX side
    decides those in its own order, the plain version in k order. Counted;
    no other decision may differ."""
    draws = _draws(b, h2, 100 * b + h2)
    x, w1, b1, w2, b2 = (_bf(a) for a in draws)
    got = tower_forward_reference(x, w1, b1, w2, b2)
    jx, jw1, jb1, jw2, jb2 = (jnp.asarray(np.asarray(a, np.float32), jnp.bfloat16)
                              for a in draws)
    want = np.asarray(jax.jit(jax_mlp2_fwd)(jw1, jb1, jw2, jb2, jx).astype(jnp.float32))
    g = got.float().numpy()
    np.testing.assert_allclose(g, want, rtol=0, atol=2.0 ** -7 * np.abs(want).max())
    y1 = _mm(x, w1)
    h1 = torch.relu(y1 + b1)
    flagged = tie_mask(_mm(h1, w2), b2).numpy() | tie_mask(y1, b1).numpy().any(1, keepdims=True)
    differ = (g > 0) != (want > 0)
    assert not (differ & ~flagged).any(), int((differ & ~flagged).sum())
    assert int(differ.sum()) <= int(flagged.sum())


@pytest.mark.parametrize("h2", [64, 128])
def test_plain_version_decides_ties_in_k_order(h2):
    """On the tie inputs (every layer-1 sum at a bf16 rounding tie against
    -b1): the final ReLU decisions are the k-order route's, and with W2 = I,
    b2 = 0 (out = h1) layer 1's are too, h1 bit for bit (values)."""
    x, w1, b1, w2, b2 = (_bf(a) for a in tie_inputs(512, h2, 20 + h2))
    _, want = k_order_forward(x, w1, b1, w2, b2)
    got = tower_forward_reference(x, w1, b1, w2, b2)
    assert torch.equal(got > 0, want > 0)
    eye, zero = torch.eye(128, dtype=torch.bfloat16), torch.zeros(128, dtype=torch.bfloat16)
    h1_want, _ = k_order_forward(x, w1, b1, eye, zero)
    h1 = tower_forward_reference(x, w1, b1, eye, zero)
    assert torch.equal(h1, h1_want)
    assert 0.4 < (h1 > 0).float().mean().item() < 0.6


def _every_bf16() -> torch.Tensor:
    bits = torch.arange(1 << 16, dtype=torch.int32)
    vals = torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16).view(torch.bfloat16)
    return vals[torch.isfinite(vals.float())]


def _next_above(t: int) -> int:
    """The bf16 value next above bits t in value order (the kernel's
    `next_above`)."""
    return 0x0001 if t & 0x7FFF == 0 else t - 1 if t & 0x8000 else t + 1


def _packed_ties(r: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's tie test on pre = bf16(r + b): 0 <= pre <= d, with d =
    bf16(next_above(-b) + b) (`ties2` and `tie_ceiling` of
    `csrc/relu_ties.cuh`), for one bias."""
    bb = int(b.view(torch.int16).item()) & 0xFFFF
    above = torch.tensor([_next_above(bb ^ 0x8000)], dtype=torch.int32).to(torch.int16)
    d = (above.view(torch.bfloat16).float() + b.float()).to(torch.bfloat16).float()
    pre = (r.float() + b.float()).to(torch.bfloat16).float()
    return (pre >= 0) & (pre <= d)


@pytest.mark.parametrize("b", [0.0, -0.0, 0.1, -1.5, 3.0e-3, 1.0e-30, -250.0, 1.0e-40, -3.0e-39,
                               6.5e4, -1.0e38, 9.2e-41, -9.2e-41])
def test_kernel_tie_test_is_tie_mask(b):
    """Over every finite bf16 value r: the form the kernel takes the tie test
    in (on pre = bf16(r + b), two values a bf16x2 word) marks exactly the
    values `tie_mask` marks (-b and the value next above it, a zero standing
    for both zeros), at the biases of `test_torch_relu_ties.py` and at the
    smallest subnormals, whose neighbour -b is a zero."""
    vals = _every_bf16()
    bias = _bf([b])
    want = tie_mask(vals[None, :], bias.expand(vals.shape[0]))[0]
    assert torch.equal(_packed_ties(vals, bias), want)


def test_kernel_tie_test_over_random_biases():
    vals = _every_bf16()
    rng = np.random.default_rng(6)
    for bias in vals[torch.from_numpy(rng.integers(0, vals.shape[0], 200))]:
        want = tie_mask(vals[None, :], bias.reshape(1).expand(vals.shape[0]))[0]
        assert torch.equal(_packed_ties(vals, bias.reshape(1)), want), bias.item()


def test_cpu_call_takes_the_plain_version_and_counts_no_launch():
    x, w1, b1, w2, b2 = (_bf(a) for a in _draws(512, 40, 4))
    before = tower_forward.launches
    got = tower_forward(x, w1, b1, w2, b2)
    assert torch.equal(got, tower_forward_reference(x, w1, b1, w2, b2))
    # the weights as `nn.Linear` weights' transposed views read the same values
    assert torch.equal(tower_forward(x, w1.T.contiguous().T, b1, w2.T.contiguous().T, b2), got)
    assert tower_forward.launches == before
    assert tower_forward._built is None  # nothing was built


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, w1, b1, w2, b2 = (_bf(a) for a in _draws(512, 64, 5))
    with pytest.raises(ValueError, match="do not chain"):
        tower_forward(x, w1, b1, w2[:64], b2)
    with pytest.raises(ValueError, match="do not chain"):
        tower_forward(x, w1, b1[:64], w2, b2)
    with pytest.raises(ValueError, match="2-d"):
        tower_forward(x[0], w1, b1, w2, b2)
    with pytest.raises(ValueError, match="B % 512"):  # fits: the batch granule
        tower_forward(x[:500], w1, b1, w2, b2)
    with pytest.raises(ValueError, match="d_in = h1 = 128"):  # fits: the widths
        tower_forward(x[:, :64], w1[:64, :64], b1[:64], w2[:64], b2)
    with pytest.raises(ValueError, match="h2 <= 128"):
        tower_forward(x, w1, b1, torch.zeros(128, 129, dtype=torch.bfloat16),
                      torch.zeros(129, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="bfloat16"):
        tower_forward(x.float(), w1, b1, w2, b2)
    with pytest.raises(TypeError, match="bfloat16"):
        tower_forward(x, w1, b1, w2, b2.float())
    with pytest.raises(ValueError, match="share a device"):
        tower_forward(x, w1, b1, w2.to("meta"), b2)


def test_split_launch_refuses_cpu_tensors_and_unknown_stages():
    """A split launch (the kernel run up to a stage, for timing) has no plain
    version: on CPU tensors it raises, as for a stage it does not know or
    inputs the kernel does not take, and it builds and counts nothing."""
    x, w1, b1, w2, b2 = (_bf(a) for a in _draws(512, 64, 7))
    before = tower_forward.launches
    with pytest.raises(ValueError, match="stage must be one of"):
        tower_forward.split("epilogues", x, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="H2 = 64 on CUDA tensors"):
        tower_forward.split("ties", x, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="B % 512"):
        tower_forward.split("loads", x[:500], w1, b1, w2, b2)
    assert tower_forward.launches == before
    assert tower_forward._built is None


def test_mlp2relu_on_cpu_keeps_the_widened_route():
    """`Mlp2Relu` on CPU tensors: the forward stays the widened route (f32
    GEMMs, bf16 add, ReLU) and launches nothing; its backward runs through
    the tower backward's plain version."""
    x, w1, b1, w2, b2 = (_bf(a).requires_grad_() for a in _draws(512, 64, 6))
    before = tower_forward.launches
    out = Mlp2Relu.apply(w1, b1, w2, b2, x)
    assert tower_forward.launches == before
    with torch.no_grad():
        assert torch.equal(out, torch.relu(_mm(torch.relu(_mm(x, w1) + b1), w2) + b2))
        assert torch.equal(out, _mlp2_fwd_impl(w1, b1, w2, b2, x))
    out.float().sum().backward()
    assert all(t.grad is not None and t.grad.shape == t.shape for t in (x, w1, b1, w2, b2))
