"""The gather probe's block-sum kernels (the plain versions, which CPU
tensors take) against numpy and against the reference tool's Pallas kernels
`pallas_sum` / `pallas_sum2` in interpret mode, on the same numpy-seeded
inputs; and the port's probe tool end to end on the CPU at a tiny size."""

import importlib.util
import json
import os

import jax.numpy as jnp
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
from two_tower_recommender_model_tpu_torch.tools import probe_consumer as port_tool

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref_tool():
    """The reference tool, imported by path: `tools/` is not a package."""
    spec = importlib.util.spec_from_file_location(
        "ref_probe_consumer", os.path.join(_ROOT, "tools", "probe_consumer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _blocks(x: np.ndarray) -> np.ndarray:
    g = x.shape[0] // 512
    return x[:g * 512].astype(np.float64).reshape(g, -1).sum(1)


def _tol(*xs: np.ndarray) -> float:
    """rtol 1e-5 of the largest block's sum of magnitudes: f32 summation order."""
    return 1e-5 * max(np.abs(x[:x.shape[0] // 512 * 512]).reshape(x.shape[0] // 512, -1)
                      .sum(1).max() for x in xs) * len(xs)


SHAPES = [(512, 8), (1024, 64), (1636, 64), (2048, 128), (1000, 3)]


@pytest.mark.parametrize("m,d", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_sums_reference_matches_numpy(m, d, dtype):
    rng = np.random.default_rng(m + d)
    x = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dtype)
    y = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dtype)
    xn, yn = x.float().numpy(), y.float().numpy()
    got = probe_block_sums_reference(x)
    assert got.dtype == torch.float32 and got.shape == (m // 512,)
    np.testing.assert_allclose(got.numpy(), _blocks(xn), rtol=0, atol=_tol(xn))
    got2 = probe_block_sums2_reference(x, y)
    np.testing.assert_allclose(got2.numpy(), _blocks(xn) + _blocks(yn), rtol=0,
                               atol=_tol(xn, yn))
    # on CPU tensors the wrappers take the plain versions and count no launch
    before = probe_block_sums.launches, probe_block_sums2.launches
    assert torch.equal(probe_block_sums(x), got) and torch.equal(probe_block_sums2(x, y), got2)
    assert (probe_block_sums.launches, probe_block_sums2.launches) == before


@pytest.mark.parametrize("m,d", [(1024, 64), (1636, 64), (1536, 128), (600, 8)])
def test_probe_sum_matches_pallas_sum(ref_tool, m, d):
    """`probe_sum` returns what `pallas_sum` returns: the LAST full block's
    sum (every grid step overwrites the one before), not the whole array's."""
    rng = np.random.default_rng(m * 7 + d)
    x = rng.normal(size=(m, d)).astype(np.float32)
    want = float(ref_tool.pallas_sum(jnp.asarray(x)))
    got = probe_sum(torch.from_numpy(x))
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=0, atol=_tol(x))
    last = m // 512 - 1
    np.testing.assert_allclose(want, x[last * 512:(last + 1) * 512].astype(np.float64).sum(),
                               rtol=0, atol=_tol(x))
    if m >= 1024:  # and so neither is the whole array's sum
        assert abs(want - x.astype(np.float64).sum()) > 10 * _tol(x)


@pytest.mark.parametrize("m,d", [(1024, 64), (1636, 64), (1536, 32)])
def test_probe_sum2_matches_pallas_sum2(ref_tool, m, d):
    rng = np.random.default_rng(m * 11 + d)
    a = rng.normal(size=(m, d)).astype(np.float32)
    b = rng.normal(size=(m, d)).astype(np.float32)
    want = float(ref_tool.pallas_sum2(jnp.asarray(a), jnp.asarray(b)))
    got = probe_sum2(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dim() == 0
    np.testing.assert_allclose(got.item(), want, rtol=0, atol=_tol(a, b))


def test_bf16_operand_is_widened_like_the_reference(ref_tool):
    """`pallas_sum` casts its operand to f32 first; so does the port."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(1024, 16)).astype(np.float32)).to(torch.bfloat16)
    want = float(ref_tool.pallas_sum(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)))
    np.testing.assert_allclose(probe_sum(x).item(), want, rtol=0, atol=_tol(x.float().numpy()))


@pytest.mark.parametrize("bad,err", [
    (lambda: probe_block_sums(torch.zeros(511, 8)), ValueError),  # the reference's grid is empty
    (lambda: probe_sum2(torch.zeros(100, 8), torch.zeros(100, 8)), ValueError),
    (lambda: probe_block_sums(torch.zeros(1024)), ValueError),
    (lambda: probe_block_sums(torch.zeros(1024, 8, dtype=torch.float64)), TypeError),
    (lambda: probe_block_sums2(torch.zeros(1024, 8), torch.zeros(1024, 4)), ValueError),
    (lambda: probe_block_sums2(torch.zeros(1024, 8), torch.zeros(1024, 8).bfloat16()), ValueError),
    (lambda: probe_block_sums(torch.zeros(8, 1024).T), ValueError),  # not contiguous
    (lambda: probe_block_sums(torch.zeros(1024, 8), torch.zeros(1024, 8)), TypeError),
])
def test_bad_operands_are_refused(bad, err):
    with pytest.raises(err):
        bad()


def test_tool_runs_its_seven_cases_on_the_cpu(capsys):
    assert port_tool.main(["--device", "cpu", "--m", "1024", "--k", "2"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["case"] for r in lines[:-1]] == list(port_tool.CASES) and len(lines) == 8
    assert lines[-1] == {"all": lines[:-1]}
    assert all(np.isfinite(r["ms"]) and r["ms"] >= 0 for r in lines[:-1])


def test_tool_cases_compute_what_they_name():
    """On the CPU each case's value equals a direct numpy computation on the
    same seeded inputs (the kernels' plain versions run)."""
    m = 1536
    dev = torch.device("cpu")
    cases = port_tool.build_cases(m, dev, seed=3)
    gen = torch.Generator().manual_seed(3)  # the draws of `build_cases`, in its order
    x128 = torch.randn((port_tool.N, 128), generator=gen)
    w128 = torch.randn((128, 8), generator=gen)
    ids = torch.randint(0, port_tool.N, (m,), generator=gen)
    gm = torch.randn((m, 128), generator=gen)
    perm = torch.randperm(m, generator=gen)
    last = slice(m - 512, m)
    want = {
        "same_ids": x128[ids].double().sum(),
        "same_ids_bar": x128[ids].double().sum(),
        "h128_pallas": x128[ids][last].double().sum(),
        "h128_perm_mat": (gm[perm].double() @ w128.double()).sum(),
        "h64x2_pallas": gm[perm][last].double().sum(),
        "k1_unsorted": x128[ids][last].double().sum(),
        "k1_sorted": x128[torch.sort(ids).values][last].double().sum(),
    }
    assert set(cases) == set(port_tool.CASES)
    for name, fn in cases.items():
        np.testing.assert_allclose(fn().item(), want[name].item(), rtol=0, atol=0.05,
                                   err_msg=name)  # sums of ~1e5 unit normals, f32 order


def test_tool_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_tool.main(["--m", "1024", "--k", "1"])
