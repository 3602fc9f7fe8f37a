"""The gather probe's CUDA kernels (`csrc/probe_sum.cu`, kernels #12 and
#13) against their plain PyTorch versions, on the card, and the probe tool
on the card at a small size. This file imports no JAX, so it runs where the
card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_probe_cuda.py

Without a CUDA device the tests skip (the kernels have no CPU mode)."""

import json

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu_torch.ops.probe_sum import (
    probe_block_sums,
    probe_block_sums2,
    probe_block_sums2_reference,
    probe_block_sums_reference,
    probe_sum,
    probe_sum2,
)
from two_tower_recommender_model_tpu_torch.tools import probe_consumer


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _tol(x: torch.Tensor) -> torch.Tensor:
    """rtol 1e-5 of each block's sum of magnitudes: f32 summation order."""
    return 1e-5 * probe_block_sums_reference(x.abs())


SHAPES = [(512, 8), (1636, 64), (8192, 128), (4096, 3), (1024, 1), (2048, 516)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_sums_match_plain(dev, m, d, dtype):
    rng = np.random.default_rng(m + d)
    x = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev, dtype)
    before = probe_block_sums.launches
    got = probe_block_sums(x)
    again = probe_block_sums(x)
    want = probe_block_sums_reference(x)
    torch.cuda.synchronize()
    assert probe_block_sums.launches == before + 2
    assert got.shape == (m // 512,) and got.dtype == torch.float32
    assert torch.equal(got, again)  # a fixed order, no atomics
    assert ((got - want).abs() <= _tol(x)).all(), (got - want).abs().max().item()
    assert torch.equal(probe_sum(x), probe_block_sums(x)[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_sums2_match_plain(dev, m, d, dtype):
    rng = np.random.default_rng(m * 3 + d)
    a = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev, dtype)
    b = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev, dtype)
    before = probe_block_sums2.launches
    got = probe_block_sums2(a, b)
    again = probe_block_sums2(a, b)
    want = probe_block_sums2_reference(a, b)
    torch.cuda.synchronize()
    assert probe_block_sums2.launches == before + 2
    assert torch.equal(got, again)
    assert ((got - want).abs() <= _tol(a) + _tol(b)).all()
    # the two sums are added once: the one-operand kernel's values, added in f32
    assert torch.equal(got, probe_block_sums(a) + probe_block_sums(b))
    assert torch.equal(probe_sum2(a, b), got[-1])


@pytest.mark.cuda
def test_rows_past_the_last_full_block_are_not_read(dev):
    x = torch.ones((1536 + 100, 16), device=dev)
    x[1536:] = float("nan")
    got = probe_block_sums(x)
    assert got.tolist() == [512 * 16.0] * 3


@pytest.mark.cuda
def test_bad_operands_raise_on_the_card(dev):
    before = probe_block_sums.launches
    with pytest.raises(ValueError, match="at least 512"):
        probe_block_sums(torch.zeros((100, 8), device=dev))
    with pytest.raises(ValueError, match="16-byte aligned"):
        probe_block_sums(torch.zeros((1025, 3), device=dev)[1:])  # contiguous, 12 bytes in
    with pytest.raises(ValueError, match="share"):
        probe_block_sums2(torch.zeros((512, 8), device=dev), torch.zeros((512, 8)))
    assert probe_block_sums.launches == before


@pytest.mark.cuda
def test_probe_tool_runs_on_the_card(dev, capsys):
    before = probe_block_sums.launches, probe_block_sums2.launches
    assert probe_consumer.main(["--m", "2048", "--k", "3"]) == 0  # the card is the default
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["case"] for r in lines[:-1]] == list(probe_consumer.CASES)
    assert lines[-1] == {"all": lines[:-1]}
    assert all(r["ms"] > 0 for r in lines[:-1])
    # three cases through kernel #12 and one through #13, each a warm-up and three launches
    assert probe_block_sums.launches - before[0] == 3 * 4
    assert probe_block_sums2.launches - before[1] == 4
    cases = probe_consumer.build_cases(2048, dev, seed=1)
    cpu = probe_consumer.build_cases(2048, torch.device("cpu"), seed=1)
    assert set(cases) == set(cpu)
    for fn in cases.values():
        assert torch.isfinite(fn()).item()
