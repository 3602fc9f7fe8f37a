"""bf16 parameters on the card: kernel #3's bf16 mode (the bf16 table's
gradient, each run summed in position order with a rounding after every
add) bit for bit against its plain version, on both walks; `OptaxAdam` on
CUDA parameters (capturable: a device rate and device counts) bit for bit
the same updates on the CPU; and a bf16 ranker step through #1 and #3
against the same step through their plain versions. This file imports no
JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_bf16_params_cuda.py

Without a CUDA device the tests skip (the kernels have no CPU mode)."""

import dataclasses

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu_torch import config as cfg_lib
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.models import concat_mlp
from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import (
    block_sorted_aggregate,
    block_sorted_aggregate_reference,
)
from two_tower_recommender_model_tpu_torch.ops.embedding_kernel import (
    pooled_gather,
    pooled_gather_reference,
)
from two_tower_recommender_model_tpu_torch.train import optimizer as opt_lib
from torch_sorted_runs import span_order_sums


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16)


def _rank1_ids(rng, n: int, m: int) -> np.ndarray:
    """m ids drawn with probability proportional to 1 / (rank + 1)."""
    p = 1.0 / np.arange(1, n + 1)
    return rng.choice(n, m, p=p / p.sum())


# name -> (N, M, D, ids): "sorted" host-sorted ids, "perm" unsorted ids with
# 5% sentinels through the stable sort's permutation (the ranker's call),
# "rank-1" sorted rank^-1 ids (the longest run past 20,000 positions: the
# bf16 mode's pass 2 walks it whole). D = 128 takes the half-warp walk, 30
# and 1,024 the general walk.
CASES = {
    "ranker-user": (206_209, 8_192, 128, "perm"),
    "ranker-item": (49_688, 8_192, 128, "perm"),
    "sorted-262144": (206_209, 262_144, 128, "sorted"),
    "rank-1-262144": (49_688, 262_144, 128, "rank-1"),
    "d30-perm": (49_688, 8_192, 30, "perm"),
    "d1024-perm": (5_000, 16_384, 1024, "perm"),
    "d1024-rank-1": (2_000, 32_768, 1024, "rank-1"),
    "d30-rank-1": (2_000, 65_536, 30, "rank-1"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CASES))
def test_aggregate_bf16_mode_matches_plain(dev, case, grad_dtype):
    n, m, d, kind = CASES[case]
    rng = np.random.default_rng(m + d)
    ids = _rank1_ids(rng, n, m) if kind == "rank-1" else rng.integers(0, n, m)
    perm = None
    if kind == "perm":
        ids[rng.random(m) < 0.05] = n  # dead slots
        sids, perm = torch.sort(torch.from_numpy(ids.astype(np.int32)).to(dev), stable=True)
        perm = perm.to(torch.int32)
    else:
        sids = torch.from_numpy(np.sort(ids).astype(np.int32)).to(dev)
    if kind == "rank-1":
        longest = np.bincount(ids).max()
        assert longest > (20_000 if m == 262_144 else 64), longest
    grads = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev, grad_dtype)
    before = block_sorted_aggregate.launches
    got = block_sorted_aggregate(n, sids, grads, perm=perm, buffer_dtype=torch.bfloat16)
    again = block_sorted_aggregate(n, sids, grads, perm=perm, buffer_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert block_sorted_aggregate.launches == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (n, d)
    assert torch.equal(_bits(got), _bits(again))
    want = block_sorted_aggregate_reference(n, sids, grads, perm, buffer_dtype=torch.bfloat16)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_aggregate_f32_mode_is_unchanged(dev):
    """Without a buffer dtype the output is f32, each run's sum in the span
    walk's order bit for bit, as before the bf16 mode."""
    rng = np.random.default_rng(0)
    sids = torch.from_numpy(np.sort(rng.integers(0, 300, 4_096)).astype(np.int32)).to(dev)
    grads = torch.from_numpy(rng.normal(size=(4_096, 64)).astype(np.float32)).to(dev)
    got = block_sorted_aggregate(300, sids, grads)
    assert got.dtype == torch.float32
    rows, sums = span_order_sums(sids.cpu().numpy(), grads.cpu(), 300)
    want = torch.zeros((300, 64))
    want[rows] = sums
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(learning_rate=1e-3),
                                dict(learning_rate=3e-3, weight_decay=0.01),
                                dict(learning_rate=1e-3, schedule="cosine", total_steps=20,
                                     warmup_steps=5)])
def test_optax_adam_on_the_card_is_the_cpu_bit_for_bit(dev, kw):
    """20 updates of bf16 weights on the card (capturable: the rate and the
    counts are device tensors) and on the CPU from the same bf16 gradients:
    weights and moments bit for bit (the card's powf, sqrt and divisions
    against the CPU's, each rounded to bf16)."""
    rng = np.random.default_rng(1)
    shapes = [(256, 128), (128,), (128, 64), (64,)]
    p0 = [torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32)).to(torch.bfloat16)
          for s in shapes]
    recipe = opt_lib.dense_optimizer(**kw)
    cpu = [torch.nn.Parameter(p.clone()) for p in p0]
    gpu = [torch.nn.Parameter(p.clone().to(dev)) for p in p0]
    opt_cpu, opt_gpu = recipe.build(cpu), recipe.build(gpu)
    assert type(opt_gpu) is opt_lib.OptaxAdam and opt_gpu.param_groups[0]["capturable"]
    for t in range(20):
        for a, b, s in zip(cpu, gpu, shapes):
            g = torch.from_numpy(rng.normal(0, 1e-2, s).astype(np.float32)).to(torch.bfloat16)
            a.grad, b.grad = g, g.to(dev)
        recipe.step(opt_cpu, t)
        recipe.step(opt_gpu, t)
    torch.cuda.synchronize()
    for a, b in zip(cpu, gpu):
        assert torch.equal(_bits(a.detach()), _bits(b.detach().cpu()))
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(_bits(opt_cpu.state[a][key]), _bits(opt_gpu.state[b][key].cpu()))


def _plain_lookup(table, ids, mask, pooling, compute_dtype):
    """`pooled_lookup`'s single-slot call through the gather's plain version."""
    return pooled_gather_reference(table, ids.to(torch.int32), mask.to(torch.float32),
                                   compute_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_a_bf16_ranker_step_matches_the_plain_route(dev, compute_dtype, monkeypatch):
    """The ranker at `param_dtype="bfloat16"` (300 x 120 rows, dim 32,
    single-slot features) at batch 4,096: one step through #1 and #3 (bf16
    mode) against the same step through their plain versions on the card,
    from the same state: the tables and every other parameter bit for bit;
    two launches of each kernel a step."""
    cfg = dataclasses.replace(cfg_lib.two_tower_model_config(
        300, 120, embedding_dim=32, compute_dtype=compute_dtype), param_dtype="bfloat16")
    ds = SyntheticClickstream(299, 119, seed=3, popularity=1.0)
    batch = Featurizer(cfg, device=dev)(ds.sample(4_096))
    runs = {}
    for route in ("kernels", "plain"):
        if route == "plain":
            monkeypatch.setattr(concat_mlp, "pooled_lookup", _plain_lookup)
            monkeypatch.setattr(concat_mlp, "block_sorted_aggregate",
                                block_sorted_aggregate_reference)
        step, init = concat_mlp.make_ranker_train_step(cfg, 1e-2)
        state = init(torch.Generator(device=dev).manual_seed(0), (32, 16))
        assert type(state["opt"]) is opt_lib.OptaxAdam
        gathers, aggregates = pooled_gather.launches, block_sorted_aggregate.launches
        state, out = step(state, batch)
        torch.cuda.synchronize()
        counts = (pooled_gather.launches - gathers, block_sorted_aggregate.launches - aggregates)
        runs[route] = ({name: p.detach().clone() for name, p in
                        state["params"].named_parameters()}, counts)
    (params, counts), (plain, plain_counts) = runs["kernels"], runs["plain"]
    assert counts == (2, 2) and plain_counts == (0, 0)
    for name, want in plain.items():
        assert want.dtype == torch.bfloat16
        assert torch.equal(_bits(params[name]), _bits(want)), name
