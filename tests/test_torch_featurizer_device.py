"""The port's synthetic data and packed input against the JAX package's: the
same arrays for the same seed, the same packed host arrays, and `unpack_batch`
bitwise equal to JAX's and to the port's host `Featurizer`."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu import config as jax_config
from two_tower_recommender_model_tpu.data import device_featurizer as jax_df
from two_tower_recommender_model_tpu.data.synthetic import (
    SyntheticClickstream as JaxSyntheticClickstream,
)
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.data import device_featurizer as port_df
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.train.pipeline import map_leaves, prefetch_to_device


@pytest.mark.parametrize("kwargs", [dict(seed=0), dict(seed=11, noise=0.05, latent_dim=4),
                                    dict(num_users=300, num_items=50, seed=3, popularity=1.1)])
@pytest.mark.parametrize("split,start", [("train", 0), ("val", 3), ("t1", 7)])
def test_synthetic_matches_jax(kwargs, split, start):
    got = SyntheticClickstream(**kwargs).sample(257, split=split, start=start)
    want = JaxSyntheticClickstream(**kwargs).sample(257, split=split, start=start)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _rich(lib):
    """A 3-slot bag on the item table, beside the flagship pair."""
    cfg = lib.two_tower_model_config(1000, 300)
    items = dataclasses.replace(cfg.tables[1], feature_names=("product_id", "history"))
    return dataclasses.replace(
        cfg, tables=(cfg.tables[0], items),
        features=cfg.features + (lib.FeatureConfig("history", items.name, 3, "mean"),))


def _columns(n=200, seed=0):
    rng = np.random.default_rng(seed)
    cols = {"user_id": rng.integers(0, 5000, n), "product_id": rng.integers(0, 900, n),
            "history": rng.integers(0, 900, (n, 3)), "label": rng.integers(0, 2, n)}
    cols["user_id"][::9] = 0
    cols["history"][::4, 1:] = 0
    cols["user_id"][1] = 3 * 2 ** 31 + 5  # past int32: pre-hashed on the host
    cols["product_id"][2] = -7  # a negative raw id hashes like Python's %
    return cols


CASES = [dict(), dict(pack_label=True), dict(pack_label=True, sort_feature="user_id"),
         dict(sort_feature="product_id")]


@pytest.mark.parametrize("kwargs", CASES)
def test_packed_host_arrays_match_jax(kwargs):
    cols = _columns()
    got = port_df.PackedFeaturizer(_rich(port_config), **kwargs)(cols)
    want = jax_df.PackedFeaturizer(_rich(jax_config), **kwargs)(cols)
    for f in ("ids_raw", "labels"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)))
        assert getattr(got, f).dtype == np.asarray(getattr(want, f)).dtype


@pytest.mark.parametrize("kwargs", CASES)
@pytest.mark.parametrize("drop_zero_ids", [True, False])
def test_unpack_batch_is_bitwise_jax_and_the_host_featurizer(kwargs, drop_zero_ids):
    cols = _columns()
    pack_label = kwargs.get("pack_label", False)
    pb = port_df.PackedFeaturizer(_rich(port_config), **kwargs)(cols)
    got = port_df.unpack_batch(map_leaves(pb, lambda t: t), _rich(port_config), drop_zero_ids,
                               pack_label)
    jpb = jax_df.PackedFeaturizer(_rich(jax_config), **kwargs)(cols)
    jpb = jpb.replace(ids_raw=jnp.asarray(jpb.ids_raw), labels=jnp.asarray(jpb.labels))
    want = jax_df.unpack_batch(jpb, _rich(jax_config), drop_zero_ids, pack_label)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.labels.dtype == torch.int32
    for name, f in want.features.items():
        np.testing.assert_array_equal(got.features[name].ids.numpy(), np.asarray(f.ids))
        np.testing.assert_array_equal(got.features[name].mask.numpy(), np.asarray(f.mask))
        assert got.features[name].ids.dtype == torch.int32
    if "sort_feature" not in kwargs:  # the host featurizer keeps row order
        host = Featurizer(_rich(port_config), drop_zero_ids=drop_zero_ids, device="cpu")(cols)
        assert torch.equal(host.labels, got.labels)
        for name, f in host.features.items():
            assert torch.equal(f.ids, got.features[name].ids)
            assert torch.equal(f.mask, got.features[name].mask)


def test_sort_puts_missing_ids_last_and_keeps_ties_in_order():
    cfg = _rich(port_config)
    cols = _columns()
    pb = port_df.PackedFeaturizer(cfg, pack_label=True, sort_feature="user_id")(cols)
    batch = port_df.unpack_batch(map_leaves(pb, lambda t: t), cfg, pack_label=True)
    key = torch.where(batch.features["user_id"].mask[:, 0] > 0,
                      batch.features["user_id"].ids[:, 0], 1000)
    assert torch.all(key[1:] >= key[:-1])
    assert (key == 1000).sum() == (np.asarray(cols["user_id"]) == 0).sum()


def test_prefetch_to_device_on_the_cpu_keeps_batches_and_order():
    cfg = _rich(port_config)
    featurize = port_df.PackedFeaturizer(cfg)
    batches = [_columns(seed=s) for s in range(5)]
    got = list(prefetch_to_device(iter(batches), featurize, "cpu", prefetch=2))
    assert len(got) == 5
    for cols, pb in zip(batches, got):
        assert isinstance(pb.ids_raw, torch.Tensor)
        np.testing.assert_array_equal(pb.ids_raw.numpy(), featurize(cols).ids_raw)


def test_prefetch_raises_the_featurizer_error():
    def featurize(cols):
        raise KeyError("broken column")

    with pytest.raises(KeyError, match="broken column"):
        list(prefetch_to_device(iter([_columns()]), featurize, "cpu"))
