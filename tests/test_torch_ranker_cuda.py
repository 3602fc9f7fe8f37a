"""The ranker's kernels on the card: the dense aggregate (#3) with the device
sort's permutation, as the ranker's table gradient calls it, and a ranker
step through kernels #1 and #3 against the plain route. This file imports no
JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ranker_cuda.py

Without a CUDA device the tests skip (the kernels have no CPU mode)."""

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
from torch_sorted_runs import span_order_sums


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d,hot", [(206_209, 8_192, 128, 0), (49_688, 8_192, 128, 0),
                                       (5_000, 65_536, 64, 3_000), (300, 4_096, 32, 0)])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
def test_aggregate_with_perm_is_the_ordered_sum(dev, n, m, d, hot, grad_dtype):
    """Unsorted ids sorted stably on the card, #3 given the permutation: each
    row bit for bit the sum of its gradient rows in stable-sorted order (the
    span walk's order where a run is longer than a warp's window: `hot`
    positions of one id), sentinels dropped; two launches bit for bit."""
    rng = np.random.default_rng(n + m)
    ids = rng.integers(0, n, m)
    ids[rng.random(m) < 0.05] = n  # dead slots
    if hot:
        ids[rng.choice(m, hot, replace=False)] = 7
    grads = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev, grad_dtype)
    sids, perm = torch.sort(torch.from_numpy(ids.astype(np.int32)).to(dev), stable=True)
    perm = perm.to(torch.int32)
    before = block_sorted_aggregate.launches
    got = block_sorted_aggregate(n, sids, grads, perm=perm)
    again = block_sorted_aggregate(n, sids, grads, perm=perm)
    torch.cuda.synchronize()
    assert block_sorted_aggregate.launches == before + 2
    assert torch.equal(_bits(got), _bits(again))
    rows, sums = span_order_sums(sids.cpu().numpy(), grads[perm.long()].float().cpu(), n)
    want = torch.zeros((n, d))
    want[rows] = sums
    assert torch.equal(_bits(got.cpu()), _bits(want))
    if not hot:  # complete runs: the CPU's index_add_ in stable-sorted order, too
        ref = block_sorted_aggregate_reference(n, sids.cpu(), grads.cpu(), perm.cpu())
        assert torch.equal(_bits(got.cpu()), _bits(ref))


def _plain_lookup(table, ids, mask, pooling, compute_dtype):
    """`pooled_lookup` through the gather's plain version."""
    w = mask.to(torch.float32)
    if pooling == "mean":
        w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1.0)
    return pooled_gather_reference(table, ids.to(torch.int32), w, compute_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_a_ranker_step_matches_the_plain_route(dev, compute_dtype, monkeypatch):
    """The flagship-shaped ranker (300 x 120 rows, dim 32) at batch 4,096:
    the forward, the loss and every gradient through #1 and #3 against the
    same step through their plain versions on the card (f32: within 1e-5 x
    max; bf16 compute: 2^-7 x max on all but 1/8 of the elements, as
    tests/test_torch_ranker.py holds the port to the reference); two
    launches of each kernel a step."""
    cfg = cfg_lib.two_tower_model_config(300, 120, embedding_dim=32,
                                         compute_dtype=compute_dtype)
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
        gathers, aggregates = pooled_gather.launches, block_sorted_aggregate.launches
        state, out = step(state, batch)
        torch.cuda.synchronize()
        counts = (pooled_gather.launches - gathers, block_sorted_aggregate.launches - aggregates)
        opt = state["opt"]
        runs[route] = (out, {name: opt.state[p]["exp_avg"].clone()
                             for name, p in state["params"].named_parameters()}, counts)
    (out, mu, counts), (plain_out, plain_mu, plain_counts) = runs["kernels"], runs["plain"]
    assert counts == (2, 2) and plain_counts == (0, 0)
    rel = 1e-5 if compute_dtype == "float32" else 2.0 ** -7
    share = 0.0 if compute_dtype == "float32" else 1 / 8
    torch.testing.assert_close(out["logits"].float(), plain_out["logits"].float(), rtol=0,
                               atol=rel * plain_out["logits"].float().abs().max().item())
    for name, want in plain_mu.items():
        diff = (mu[name] - want).abs()
        bad = (diff > rel * want.abs().max()).float().mean().item()
        assert bad <= share, (name, bad, diff.max().item())
