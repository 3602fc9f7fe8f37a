"""The fused tower backward (kernel #8, `csrc/tower_bwd.cu`) against its
plain version on the card: bf16 and f32 io, every H2 the towers take, batches
that leave the persistent grid's last wave partly idle, one tile, a half tile
at f32 io, the layer whose every layer-1 sum ties, and dq / out as offset
views. This file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tower_bwd_cuda.py

Without a CUDA device the tests skip (the kernel has no CPU mode)."""

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu_torch.ops.tower_bwd import (
    tower_backward,
    tower_backward_reference,
)
from torch_tie_cases import k_order_backward, tie_inputs, tower_bwd_inputs

IO_DTYPES = [torch.bfloat16, torch.float32]
# batches: one 64-row tile; 133 tiles (one more than the H100's 132 SMs: one
# block walks two); a last tile of 32 rows (f32 io only: bf16 io takes
# multiples of 64); 32 rows alone, a half tile; the BCE step's 262,144 rows
# (at the towers' H2 only: the CUDA graph's eager-against-replayed check
# relies on its launches repeating bit for bit)
BATCHES = {"one tile": 64, "133 tiles": 133 * 64, "a half tile last": 4096 + 32,
           "a half tile": 32, "the towers' batch": 262_144}
# bf16 io takes batches of whole 64-row tiles (the wrapper refuses others)
CASES = [(h2, io, batch) for h2 in (1, 8, 40, 64, 100, 128) for io in IO_DTYPES
         for batch in BATCHES
         if (io == torch.float32 or BATCHES[batch] % 64 == 0)
         and (batch != "the towers' batch" or h2 in (64, 128))]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _close(got, want):
    """dx, dW1 and dW2 within one bf16 ulp of their largest magnitude (a sum
    on a bf16 rounding boundary rounds either way in another order), db1 and
    db2 within 1e-5 x their largest (f32 sums in another order)."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        scale = w.float().abs().max().item()
        tol = 2.0 ** -8 * scale if i in (0, 1, 3) else 1e-5 * scale
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _same_bits(first, second):
    return all(torch.equal(_bits(a), _bits(b)) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("h2, io_dtype, batch", CASES,
                         ids=[f"{h2}-{str(io)[6:]}-{batch}" for h2, io, batch in CASES])
def test_matches_plain_and_repeats_bit_for_bit(dev, h2, io_dtype, batch):
    """The kernel against `tower_backward_reference` at the tolerances of
    `_close`; one launch a call; a second launch bit for bit the first."""
    b = BATCHES[batch]
    args = tower_bwd_inputs(dev, b, h2, io_dtype, 100 + h2)
    before = tower_backward.launches
    got = [t.clone() for t in tower_backward(*args)]
    assert tower_backward.launches == before + 1
    again = tower_backward(*args)
    want = tower_backward_reference(*args)
    torch.cuda.synchronize()
    assert got[0].dtype == io_dtype
    _close(got, want)
    assert _same_bits(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("io_dtype", IO_DTYPES)
@pytest.mark.parametrize("h2", [64, 128])
def test_every_layer_one_sum_at_a_tie(dev, io_dtype, h2):
    """The tie layer of `tests/torch_tie_cases.py` (every layer-1 sum within a
    few f32 ulps of a bf16 rounding midpoint against -b1, so its order
    decides its ReLU): the kernel decides every one in k order, as the
    forward does. Held to the plain version with pre1 in k order at the
    tolerances of `_close` (a flipped decision moves a row of dx by a tenth
    of its largest value and db1 by a whole d1 value); two launches bit for
    bit."""
    b = 16_384
    x, w1, b1, w2, _ = tie_inputs(b, h2, 20 + h2)
    rng = np.random.default_rng(h2)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
    args = (t(x, io_dtype), t(rng.normal(loc=0.5, size=(b, h2)), io_dtype),
            t(np.maximum(rng.normal(size=(b, h2)), 0), io_dtype), t(w1), t(b1), t(w2))
    got = [t.clone() for t in tower_backward(*args)]
    again = tower_backward(*args)
    want = k_order_backward(*args)
    torch.cuda.synchronize()
    _close(got, want)
    assert _same_bits(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("io_dtype", IO_DTYPES)
@pytest.mark.parametrize("h2", [1, 8, 40])
def test_dq_and_out_as_offset_views(dev, io_dtype, h2):
    """dq and out as views one row into larger buffers (on a 16-byte boundary
    or not, as h2 and the dtype fall): bit for bit the same call on
    contiguous copies."""
    b = 4096
    x, dq, out, w1, b1, w2 = tower_bwd_inputs(dev, b, h2, io_dtype, 40 + h2)
    dq_big = torch.cat([dq[:1], dq])
    out_big = torch.cat([out[:1], out])
    dq_view, out_view = dq_big[1:], out_big[1:]
    assert dq_view.data_ptr() != dq_big.data_ptr()
    got = [t.clone() for t in tower_backward(x, dq_view, out_view, w1, b1, w2)]
    want = tower_backward(x, dq, out, w1, b1, w2)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
