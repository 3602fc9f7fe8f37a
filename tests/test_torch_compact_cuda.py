"""The compact wire's decode (`data/compact.py:batch_from_compact`) on the
card, inside a captured CUDA graph: bit for bit the CPU decode and the CPU
`unpack_batch` of the same packed batches. This file imports no JAX, so it
runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_compact_cuda.py

Without a CUDA device the tests skip."""

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu_torch import config as cfg_lib
from two_tower_recommender_model_tpu_torch.data import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.data.compact import (
    CompactBatch,
    CompactFeaturizer,
    CompactScheme,
    batch_from_compact,
    compact_from_packed,
)
from two_tower_recommender_model_tpu_torch.data.device_featurizer import (
    PackedBatch,
    PackedFeaturizer,
    unpack_batch,
)
from two_tower_recommender_model_tpu_torch.train.pipeline import map_leaves

USERS, ITEMS = 206_209, 49_688


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _flagship():
    return cfg_lib.two_tower_model_config(USERS, ITEMS, embedding_dim=8, layer_sizes=(16, 8))


def _columns(case: str, b: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    if case == "sparse":  # users spread over the table: deltas > 255, the sidecar in use
        return {"user_id": rng.integers(1, USERS, b), "product_id": rng.integers(1, ITEMS, b),
                "label": rng.integers(0, 2, b)}
    cols = SyntheticClickstream(USERS, ITEMS, seed=seed).sample(b)
    cols["user_id"][::61] = 0  # missing ids: sorted last, encoded as N + 1
    cols["product_id"][::37] = 0
    return cols


def _leaves(cb):
    out = []
    map_leaves(cb, lambda t: out.append(t) or t)
    return out


def _flat(batch) -> list[torch.Tensor]:
    out = [batch.labels]
    for name in sorted(batch.features):
        out += [batch.features[name].ids, batch.features[name].mask]
    return out


def _check_graph_decode(dev, cfg, scheme, cbs, pbs, pack_label):
    """Capture the decode of a static payload once, replay it for each
    payload, and hold each replay to the CPU decode and to `unpack_batch`."""
    static = map_leaves(cbs[0], lambda t: t.to(dev))
    batch_from_compact(static, cfg, scheme)  # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        decoded = batch_from_compact(static, cfg, scheme)
    for cb, pb in zip(cbs, pbs):
        for dst, src in zip(_leaves(static), _leaves(map_leaves(cb, lambda t: t))):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want = batch_from_compact(map_leaves(cb, lambda t: t), cfg, scheme)
        packed = unpack_batch(map_leaves(pb, lambda t: t), cfg, pack_label=pack_label)
        for got, w, p in zip(_flat(decoded), _flat(want), _flat(packed)):
            assert got.dtype == w.dtype == p.dtype
            assert torch.equal(got.cpu(), w) and torch.equal(w, p)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["delta", "delta-sparse", "no-delta", "delta-no-label"])
def test_decode_in_a_graph_equals_the_cpu_decode(dev, case):
    """The flagship scheme at batch 262,144 (with the user slot
    delta-encoded: a payload whose sidecar holds exceptions, and one without
    the label in the wire) and without the delta slot: three payloads
    through one captured decode."""
    cfg = _flagship()
    delta, pack_label = case != "no-delta", case != "delta-no-label"
    scheme = CompactScheme.from_model(cfg, pack_label=pack_label,
                                      delta_feature="user_id" if delta else None)
    inner = PackedFeaturizer(cfg, pack_label=pack_label,
                             sort_feature="user_id" if delta else None)
    feat = CompactFeaturizer(inner, scheme)
    b = 512 if case == "delta-sparse" else 262_144
    cols = [_columns("sparse" if case == "delta-sparse" else "dense", b, s) for s in range(3)]
    pbs = [inner(c) for c in cols]
    cbs = [feat(c) for c in cols]
    if case == "delta-sparse":
        assert all((cb.delta_extra > 0).sum() > 100 for cb in cbs)
    _check_graph_decode(dev, cfg, scheme, cbs, pbs, pack_label)


@pytest.mark.cuda
def test_segmented_decode_in_a_graph(dev):
    """delta_segments = 4: four separately sorted slices assembled on the
    batch axis decode in a graph to the four slices' `unpack_batch`."""
    cfg = _flagship()
    scheme = CompactScheme.from_model(cfg, pack_label=True, delta_feature="user_id",
                                      delta_segments=4)
    inner = PackedFeaturizer(cfg, pack_label=True, sort_feature="user_id")
    cbs, pbs = [], []
    for rep in range(2):
        slices = [inner(_columns("dense", 8192, 10 * rep + h)) for h in range(4)]
        parts = [compact_from_packed(p, scheme) for p in slices]
        cbs.append(CompactBatch(
            wire=np.concatenate([c.wire for c in parts], axis=-1),
            rem=np.concatenate([c.rem for c in parts], axis=-1),
            labels=np.concatenate([c.labels for c in parts]),
            delta_pos=np.concatenate([c.delta_pos for c in parts]),
            delta_extra=np.concatenate([c.delta_extra for c in parts])))
        pbs.append(PackedBatch(ids_raw=np.concatenate([p.ids_raw for p in slices]),
                               labels=np.concatenate([p.labels for p in slices])))
    _check_graph_decode(dev, cfg, scheme, cbs, pbs, True)
