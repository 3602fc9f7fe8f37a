"""Parity of the PyTorch port's featurizer with the JAX package's: the same
columns give bitwise-equal ids, masks and labels."""

import dataclasses

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu import config as cfg_lib
from two_tower_recommender_model_tpu.data.featurizer import Featurizer as JaxFeaturizer
from two_tower_recommender_model_tpu.data.featurizer import pad_batch as jax_pad_batch
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer, pad_batch


def _config():
    """The flagship pair plus a 3-slot history bag on the item table."""
    base = cfg_lib.two_tower_model_config(1000, 300, embedding_dim=32, layer_sizes=(64, 32))
    items = dataclasses.replace(base.tables[1], feature_names=("product_id", "history"))
    return dataclasses.replace(
        base,
        tables=(base.tables[0], items),
        features=base.features + (cfg_lib.FeatureConfig("history", items.name, 3, "mean"),),
        query_tower=dataclasses.replace(base.query_tower, features=("user_id", "history")),
    )


def _port(cfg):
    """The same configuration in the port's own dataclasses."""
    return port_config.model_config_from_dict(dataclasses.asdict(cfg))


def _columns(kind, rng, n=64):
    cols = {
        "user_id": rng.integers(0, 5000, n),
        "product_id": rng.integers(0, 900, n),
        "label": rng.integers(0, 2, n),
        "age": rng.normal(size=n),
    }
    if kind == "1d":  # a 1-D history column pads to L = 3
        cols["history"] = rng.integers(0, 900, n)
    elif kind == "2d_wide":  # wider than L: truncated
        cols["history"] = rng.integers(0, 900, (n, 5))
    elif kind == "ragged":
        lists = [list(rng.integers(1, 900, rng.integers(0, 5))) for _ in range(n)]
        cols["history"] = Featurizer(_port(_config()), device="cpu").ragged("history", lists)
        np.testing.assert_array_equal(
            cols["history"], JaxFeaturizer(_config()).ragged("history", lists))
    elif kind == "zeros":
        cols["history"] = np.zeros((n, 3), np.int64)
        cols["user_id"][::2] = 0
    elif kind == "negative":
        cols["history"] = rng.integers(-2000, 2000, (n, 3))
        cols["user_id"] = rng.integers(-10**9, 10**9, n)
    return cols


@pytest.mark.parametrize("drop_zero_ids", [True, False])
@pytest.mark.parametrize("kind", ["1d", "2d_wide", "ragged", "zeros", "negative"])
def test_featurizer_bitwise(kind, drop_zero_ids):
    cfg = _config()
    cols = _columns(kind, np.random.default_rng(7))
    ref = JaxFeaturizer(cfg, drop_zero_ids, dense_cols=("age",))(cols)
    got = Featurizer(_port(cfg), drop_zero_ids, dense_cols=("age",), device="cpu")(cols)
    assert set(got.features) == set(ref.features)
    for name, feat in ref.features.items():
        ids, mask = got.features[name].ids, got.features[name].mask
        assert ids.dtype == torch.int32 and mask.dtype == torch.float32
        np.testing.assert_array_equal(ids.numpy(), np.asarray(feat.ids))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(feat.mask))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(got.dense.numpy(), np.asarray(ref.dense))


def test_featurizer_rejects_3d_column():
    cols = _columns("1d", np.random.default_rng(0))
    cols["history"] = np.zeros((4, 2, 2), np.int64)
    with pytest.raises(ValueError, match="1D or 2D"):
        Featurizer(_port(_config()), device="cpu")(cols)


@pytest.mark.parametrize("multiple", [1, 16, 48])
def test_pad_batch_matches_reference(multiple):
    cfg = _config()
    cols = _columns("ragged", np.random.default_rng(3), n=37)
    ref = jax_pad_batch(JaxFeaturizer(cfg, dense_cols=("age",))(cols), multiple)
    got = pad_batch(Featurizer(_port(cfg), dense_cols=("age",), device="cpu")(cols), multiple)
    assert got.batch_size == ref.batch_size
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(ref.weights))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(got.dense.numpy(), np.asarray(ref.dense))
    for name, feat in ref.features.items():
        np.testing.assert_array_equal(got.features[name].ids.numpy(), np.asarray(feat.ids))
        np.testing.assert_array_equal(got.features[name].mask.numpy(), np.asarray(feat.mask))


@pytest.mark.parametrize("rows", [0, 13, 64])
@pytest.mark.parametrize("packed", [False, True])
def test_pad_batch_to_matches_jax(rows, packed):
    """`pad_batch_to` grows a batch (a 0-row one too) to exactly 64 rows of
    zero-weight padding, as the reference's does, for a `Batch` and for a
    numpy `PackedBatch` with its label packed (the empty label placeholder
    kept); more rows than asked for raise."""
    from two_tower_recommender_model_tpu.data.device_featurizer import (
        PackedFeaturizer as JaxPacked,
    )
    from two_tower_recommender_model_tpu.data.featurizer import pad_batch_to as jax_pad_to
    from two_tower_recommender_model_tpu_torch.data.device_featurizer import PackedFeaturizer
    from two_tower_recommender_model_tpu_torch.data.featurizer import pad_batch_to

    cfg = _config()
    rng = np.random.default_rng(rows)
    cols = {"user_id": rng.integers(0, 1000, rows), "product_id": rng.integers(0, 300, rows),
            "history": rng.integers(0, 300, (rows, 3)), "label": rng.integers(0, 2, rows)}
    if packed:
        want = jax_pad_to(JaxPacked(cfg, pack_label=True)(cols), 64)
        got = pad_batch_to(PackedFeaturizer(_port(cfg), pack_label=True)(cols), 64)
        leaves = [(got.ids_raw, want.ids_raw), (got.labels, want.labels),
                  (got.weights, want.weights)]
    else:
        want = jax_pad_to(JaxFeaturizer(cfg)(cols), 64)
        got = pad_batch_to(Featurizer(_port(cfg), device="cpu")(cols), 64)
        leaves = [(got.labels, want.labels), (got.weights, want.weights)]
        leaves += [(got.features[k].ids, want.features[k].ids) for k in want.features]
        leaves += [(got.features[k].mask, want.features[k].mask) for k in want.features]
    assert got.batch_size == want.batch_size == 64
    for g, w in leaves:
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    with pytest.raises(ValueError):
        pad_batch_to(got, 32)
