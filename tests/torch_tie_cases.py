"""Tower inputs whose layer-1 sums sit on bf16 rounding ties against -b1,
and the forward that sums every product in k order: shared by the CPU tests
of `ops/relu_ties.py` and its card tests (this module imports no JAX).

Column c of W1 starts with m_c (a bf16 value in [1, 2)) and 2^-8, against
x's leading 1, 1, and b1[c] = -m_c: the first two terms sum to the midpoint
between m_c and the next bf16 value. The other 126 products are tiny
(|x| ~ 1, |W1| ~ 2^-24), so every layer-1 sum lies within a few f32 ulps of
that midpoint, and the summation order decides its bf16 rounding, and with
it the ReLU: bf16(m_c) + b1 = 0 is off, the next value is on."""

import numpy as np
import torch


def bf16_values(a) -> np.ndarray:
    """float32 numpy values rounded to bf16 (round to nearest even)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def tie_inputs(b: int, h2: int, seed: int, tie_cols: int = 128):
    """(x [b, 128], w1 [128, 128], b1 [128], w2 [128, h2], b2 [h2]) as float32
    arrays of bf16 values, w in the reference's [in, out] layout. With
    `tie_cols` < 128 only the first `tie_cols` columns of layer 1 sit on
    ties; the others are drawn as a tower's weights and biases."""
    rng = np.random.default_rng(seed)
    m = 1 + rng.integers(0, 128, 128) / 128  # bf16 values in [1, 2)
    x = rng.normal(size=(b, 128))
    x[:, :2] = 1.0
    w1 = rng.normal(size=(128, 128)) * 2.0 ** -24
    w1[0], w1[1] = m, 2.0 ** -8
    w2 = rng.normal(size=(128, h2), scale=0.1)
    b1, b2 = -m, rng.normal(size=h2, scale=0.1)
    if tie_cols < 128:
        w1[:, tie_cols:] = rng.normal(size=(128, 128 - tie_cols), scale=0.1)
        b1[tie_cols:] = rng.normal(size=128 - tie_cols, scale=0.1)
    return (bf16_values(x), bf16_values(w1), bf16_values(b1), bf16_values(w2),
            bf16_values(b2))


def k_order_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w in f32, each output summed in k order with one rounding an add
    (the products of bf16 values are exact in f32): an f32 GEMM's order."""
    a, w = a.float(), w.float()
    s = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32, device=a.device)
    for k in range(a.shape[1]):
        s = s + a[:, k:k + 1] * w[k]
    return s


def k_order_forward(x, w1, b1, w2, b2) -> tuple[torch.Tensor, torch.Tensor]:
    """(h1, out) of the fused tower's bf16 forward with every GEMM summed in
    k order: the plain route's ReLU decisions."""
    def layer(a, w, b):
        pre = k_order_matmul(a, w).to(torch.bfloat16) + b.to(torch.bfloat16)
        return torch.relu(pre)
    h1 = layer(x, w1, b1)
    return h1, layer(h1, w2, b2)
