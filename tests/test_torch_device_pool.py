"""The port's device-drawn batch pools (`data/device_pool.py`) keep
`PackedFeaturizer`'s layout: ranges [1, N], the sorted slot-0 key, the
label in bit 30, and they unpack through the port's `unpack_batch`. The
draws come from a `torch.Generator` (on the CPU here), so they are held to
these invariants, as the reference's `tests/test_device_pool.py` holds its
`jax.random` draws, not to the reference's values."""

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu_torch import config as cfg_lib
from two_tower_recommender_model_tpu_torch.data.device_featurizer import (
    PackedBatch,
    unpack_batch,
)
from two_tower_recommender_model_tpu_torch.data.device_pool import device_batch_pool

U, I = 1009, 517


def _mcfg():
    return cfg_lib.two_tower_model_config(num_users=U, num_items=I, embedding_dim=8)


def test_layout_and_ranges():
    pool = device_batch_pool(_mcfg(), 64, 3, pack_label=True, sort=False, seed=1, device="cpu")
    assert pool.shape == (3, 64, 2) and pool.dtype == torch.int32
    arr = pool.numpy()
    raw0 = arr[:, :, 0] & ((1 << 30) - 1)
    labels = (arr[:, :, 0] >> 30) & 1
    assert raw0.min() >= 1 and raw0.max() <= U
    assert arr[:, :, 1].min() >= 1 and arr[:, :, 1].max() <= I
    assert (labels == (raw0 & 1)).all()  # learnable labels: the slot-0 id's parity
    # distinct payloads per pool entry
    assert not np.array_equal(arr[0], arr[1])
    assert not np.array_equal(arr[1], arr[2])
    # a seed gives one pool
    again = device_batch_pool(_mcfg(), 64, 3, pack_label=True, sort=False, seed=1, device="cpu")
    assert torch.equal(pool, again)


def test_sorted_invariant():
    pool = device_batch_pool(_mcfg(), 256, 2, pack_label=True, sort=True, seed=2, device="cpu")
    arr = pool.numpy()
    key = arr[:, :, 0] & ((1 << 30) - 1)  # the raw id is the sort key here
    assert (np.diff(key, axis=1) >= 0).all()
    # the rows moved together: each row's label bit still is its slot-0 parity
    assert ((arr[:, :, 0] >> 30) & 1 == (key & 1)).all()


def test_unpacks_through_device_featurizer():
    mcfg = _mcfg()
    pool = device_batch_pool(mcfg, 32, 1, pack_label=True, sort=True, seed=3, device="cpu")
    batch = unpack_batch(PackedBatch(ids_raw=pool[0], labels=torch.zeros(0, dtype=torch.int32)),
                         mcfg, pack_label=True)
    assert batch.labels.shape == (32,)
    assert set(batch.labels.unique().tolist()) <= {0, 1}
    ids_u = batch.features["user_id"].ids.numpy()
    raw_u = pool[0, :, 0].numpy() & ((1 << 30) - 1)
    np.testing.assert_array_equal(ids_u[:, 0], raw_u % U)  # hashed == raw, but N itself
    assert ids_u.max() < U
    assert float(batch.features["user_id"].mask.min()) == 1.0  # no id is missing


def test_no_pack_label():
    pool = device_batch_pool(_mcfg(), 16, 2, pack_label=False, sort=False, seed=4, device="cpu")
    assert pool[:, :, 0].max().item() <= U  # no label bit set
    big = cfg_lib.two_tower_model_config(num_users=1 << 30, num_items=I, embedding_dim=8)
    with pytest.raises(ValueError, match="2\\^30"):
        device_batch_pool(big, 16, 1, pack_label=True, device="cpu")
