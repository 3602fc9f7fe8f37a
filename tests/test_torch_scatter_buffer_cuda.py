"""Kernels #4 and #6 in their bf16-buffer mode (`buffer_dtype=torch.bfloat16`,
the reference's `scatter_buffer_dtype="bfloat16"`) against their plain
PyTorch versions on the card. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_scatter_buffer_cuda.py

The bf16 buffer sums each run in position order with a rounding after every
add, in the kernel (a long run walked whole by its second pass) and in the
plain version (`bf16_buffer_sums`), so the two must agree bit for bit. The
update on top takes mean(g^2), which the kernel sums in its own order; to see
the buffer's bits through the whole update the "probe" inputs start every row
at zero with an accumulator of 2^60: the mean then adds nothing to it (it is
below half an ulp of 2^60), sqrt(2^60) = 2^30, and lr = 1 makes the new row
exactly -buffer * 2^-30, in either order, so kernel and plain version agree
bit for bit on every output. On ordinary inputs they agree within the f32
mode's tolerance (rtol 1e-5).

Without a CUDA device the tests skip (the kernels have no CPU mode)."""

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import (
    rowwise_adagrad,
    rowwise_adagrad_reference,
)
from two_tower_recommender_model_tpu_torch.ops.quantized_kernel import (
    quantized_rowwise_adagrad_fused,
    quantized_rowwise_adagrad_fused_reference,
)
from torch_sorted_runs import RUN_CASES, run_case_ids

BF16 = torch.bfloat16
PROBE_ACC = 2.0 ** 60


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ids(case: str, rng) -> tuple[int, np.ndarray, np.ndarray | None]:
    """(N, [M] ids in the kernel's order, the device sort's permutation or
    None) for each id pattern."""
    if case == "uniform":
        n, m = 50_000, 65_536
        return n, np.sort(rng.integers(0, n, m)), None
    if case == "rank-1":  # item ids drawn as rank^-1: a hot id of about 21,800 positions
        n, m = 49_688, 262_144
        p = 1.0 / np.arange(1, n + 1)
        raw = rng.choice(n, m, p=p / p.sum())
        order = np.argsort(raw, kind="stable")
        return n, raw[order], order.astype(np.int32)
    if case == "one-run":  # every position one id
        return 100, np.full(4096, 37), None
    if case == "sentinels":
        n, m = 500, 4096
        ids = np.sort(rng.integers(0, n, m))
        ids[-700:] = n
        ids[1000:1700] = 250  # a long run mid-batch
        return n, np.sort(ids), None
    return (*run_case_ids(case), None)


CASES = ["uniform", "rank-1", "one-run", "sentinels", *RUN_CASES]


def _inputs(dev, case, d, grad_dtype, seed=0):
    rng = np.random.default_rng(seed)
    n, ids, perm = _ids(case, rng)
    m = len(ids)
    grads = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev, grad_dtype)
    ids_t = torch.from_numpy(ids.astype(np.int32)).to(dev)
    perm_t = None if perm is None else torch.from_numpy(perm).to(dev)
    return n, ids_t, grads, perm_t


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("table_dtype", [torch.float32, BF16])
def test_rowwise_adagrad_bf16_buffer_bit_for_bit(dev, case, d, table_dtype):
    grad_dtype = torch.float32 if table_dtype == torch.float32 else BF16
    n, ids, grads, perm = _inputs(dev, case, d, grad_dtype)
    table = torch.zeros((n, d), dtype=table_dtype, device=dev)
    acc = torch.full((n,), PROBE_ACC, device=dev)
    t_k, a_k, t_p, a_p = table.clone(), acc.clone(), table.clone(), acc.clone()
    before = rowwise_adagrad.launches
    rowwise_adagrad(t_k, a_k, ids, grads, 1.0, 0.0, perm=perm, buffer_dtype=BF16)
    rowwise_adagrad_reference(t_p, a_p, ids, grads, 1.0, 0.0, perm=perm, buffer_dtype=BF16)
    torch.cuda.synchronize()
    assert rowwise_adagrad.launches == before + 1
    assert torch.equal(_bits(t_k), _bits(t_p))
    assert torch.equal(_bits(a_k), _bits(a_p))
    # a second launch gives the same bits
    t_2, a_2 = table.clone(), acc.clone()
    rowwise_adagrad(t_2, a_2, ids, grads, 1.0, 0.0, perm=perm, buffer_dtype=BF16)
    assert torch.equal(_bits(t_2), _bits(t_k))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["rank-1", "run-3000", "one-run"])
def test_the_bf16_mode_is_not_the_f32_sum(dev, case):
    """On a long run the bf16 buffer stalls where the f32 sum does not: the
    two modes' rows differ (so the probe can tell them apart)."""
    n, ids, grads, perm = _inputs(dev, case, 128, torch.float32)
    grads = grads.abs()
    outs = []
    for buf in (BF16, None):
        t = torch.zeros((n, 128), device=dev)
        a = torch.full((n,), PROBE_ACC, device=dev)
        rowwise_adagrad(t, a, ids, grads, 1.0, 0.0, perm=perm, buffer_dtype=buf)
        outs.append(t)
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "rank-1", "sentinels", "run-3000"])
@pytest.mark.parametrize("d", [128, 64])
def test_rowwise_adagrad_bf16_buffer_on_ordinary_inputs(dev, case, d):
    """Random rows and accumulators: untouched rows bitwise, the rest within
    rtol 1e-5 (mean(g^2) in the kernel's order)."""
    n, ids, grads, perm = _inputs(dev, case, d, torch.float32, seed=1)
    gen = torch.Generator(device=dev).manual_seed(1)
    table = torch.rand((n, d), device=dev, generator=gen) - 0.5
    acc = torch.rand((n,), device=dev, generator=gen)
    t_k, a_k, t_p, a_p = table.clone(), acc.clone(), table.clone(), acc.clone()
    rowwise_adagrad(t_k, a_k, ids, grads, 0.05, 1e-10, perm=perm, buffer_dtype=BF16)
    rowwise_adagrad_reference(t_p, a_p, ids, grads, 0.05, 1e-10, perm=perm, buffer_dtype=BF16)
    torch.cuda.synchronize()
    live = torch.zeros(n, dtype=torch.bool, device=dev)
    live[ids[ids < n].long()] = True
    assert torch.equal(_bits(t_k[~live]), _bits(table[~live]))
    torch.testing.assert_close(t_k, t_p, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a_k, a_p, rtol=1e-5, atol=1e-6)


def _zero_first_short_run(ids, grads, perm, n) -> int:
    """Zero the gradients of the first id when its run is short (not the
    hot id): a named row whose sum is zero. Returns that id, or None."""
    first = ids[0].item()
    rows = (ids == first).nonzero().flatten()
    if first >= n or len(rows) >= 64:
        return None
    grads[rows if perm is None else perm[rows].long()] = 0
    return first


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("grad_dtype", [torch.float32, BF16])
def test_quantized_adagrad_bf16_buffer_bit_for_bit(dev, case, d, grad_dtype):
    """Int8 rows at zero (scale 0) and the probe accumulator: the new scale is
    the buffer's max |value| x 2^-30 and the values its quantization, the
    same arithmetic in both, so every output bit for bit. A named row whose
    sum is zero is written too (its scale stays 0)."""
    n, ids, grads, perm = _inputs(dev, case, d, grad_dtype)
    _zero_first_short_run(ids, grads, perm, n)
    values = torch.zeros((n, d), dtype=torch.int8, device=dev)
    scales = torch.zeros(n, device=dev)
    acc = torch.full((n,), PROBE_ACC, device=dev)
    k = [values.clone(), scales.clone(), acc.clone()]
    p = [values.clone(), scales.clone(), acc.clone()]
    before = quantized_rowwise_adagrad_fused.launches
    quantized_rowwise_adagrad_fused(*k, ids, grads, 1.0, 0.0, perm=perm, buffer_dtype=BF16)
    quantized_rowwise_adagrad_fused_reference(*p, ids, grads, 1.0, 0.0, perm=perm,
                                              buffer_dtype=BF16)
    torch.cuda.synchronize()
    assert quantized_rowwise_adagrad_fused.launches == before + 1
    assert torch.equal(k[0], p[0])
    assert torch.equal(_bits(k[1]), _bits(p[1]))
    assert torch.equal(_bits(k[2]), _bits(p[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uniform", "rank-1", "sentinels", "run-33"])
def test_quantized_adagrad_bf16_buffer_on_ordinary_inputs(dev, case):
    """Quantized random rows: untouched rows' bytes and scales kept; scales
    and accumulators within rtol 1e-5, int8 values within one step; the
    named row whose sum is zero requantized from itself, bit for bit the
    plain version's."""
    n, ids, grads, perm = _inputs(dev, case, 128, BF16, seed=2)
    first = _zero_first_short_run(ids, grads, perm, n)
    gen = torch.Generator(device=dev).manual_seed(2)
    values = torch.randint(-127, 128, (n, 128), dtype=torch.int8, device=dev, generator=gen)
    scales = torch.rand((n,), device=dev, generator=gen)
    acc = torch.rand((n,), device=dev, generator=gen)
    k = [values.clone(), scales.clone(), acc.clone()]
    p = [values.clone(), scales.clone(), acc.clone()]
    quantized_rowwise_adagrad_fused(*k, ids, grads, 0.05, 1e-10, perm=perm, buffer_dtype=BF16)
    quantized_rowwise_adagrad_fused_reference(*p, ids, grads, 0.05, 1e-10, perm=perm,
                                              buffer_dtype=BF16)
    torch.cuda.synchronize()
    live = torch.zeros(n, dtype=torch.bool, device=dev)
    live[ids[ids < n].long()] = True
    assert torch.equal(k[0][~live], values[~live])
    assert torch.equal(_bits(k[1][~live]), _bits(scales[~live]))
    torch.testing.assert_close(k[1], p[1], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(k[2], p[2], rtol=1e-5, atol=1e-7)
    assert (k[0].int() - p[0].int()).abs().max().item() <= 1
    if first is not None:
        assert torch.equal(k[0][first], p[0][first])
        assert torch.equal(_bits(k[1][first:first + 1]), _bits(p[1][first:first + 1]))
