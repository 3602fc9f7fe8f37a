"""The port's feature engineering (`data/feature_engineering.py`, numpy)
against the JAX package's (pandas): each function, and the whole prepare
chain from the replica's CSVs to the per-split columns, bit for bit."""

import numpy as np
import pandas as pd
import pytest

from two_tower_recommender_model_tpu.data import feature_engineering as ref
from two_tower_recommender_model_tpu.data import ingest as ref_ingest
from two_tower_recommender_model_tpu.data.replica import write_instacart_replica
from two_tower_recommender_model_tpu_torch.data import feature_engineering as port
from two_tower_recommender_model_tpu_torch.data import ingest as port_ingest


def assert_frame_equal(got: dict, want: pd.DataFrame) -> None:
    assert list(got) == list(want.columns)
    for c in want.columns:
        w = want[c].to_numpy()
        if w.dtype.kind in "iuf":
            assert got[c].dtype == w.dtype, c
            np.testing.assert_array_equal(got[c], w)
        else:
            assert got[c].tolist() == list(w), c


def to_frame(df: pd.DataFrame) -> dict:
    return {c: df[c].to_numpy() for c in df.columns}


@pytest.fixture(scope="module")
def detail(tmp_path_factory):
    """The order_detail of a ~300-user replica, both sides' (held equal by
    `test_torch_data_ingest.py`)."""
    d = tmp_path_factory.mktemp("replica")
    write_instacart_replica(str(d), num_users=300, num_products=150, seed=2)
    out = {}
    for side, ing in (("ref", ref_ingest), ("port", port_ingest)):
        tables = [ing.read_csv_table(str(d / f), t) for f, t in (
            ("orders.csv", "orders"), ("order_products__prior.csv", "order_products"),
            ("products.csv", "products"))]
        out[side] = (ing.build_order_detail(*tables), tables[2]["product_id"])
    return out


def test_positive_pairs(detail):
    want = ref.build_positive_pairs(detail["ref"][0])
    got = port.build_positive_pairs(detail["port"][0])
    assert len(want) < len(detail["ref"][0])  # there were duplicates to drop
    assert_frame_equal(got, want)


def test_positive_pairs_keep_first_appearance_with_large_ids():
    inter = pd.DataFrame({"user_id": np.array([9, 2**40, 9, 3, 2**40, 9], np.int64),
                          "product_id": np.array([5, 1, 5, 5, 1, 2**35], np.int64)})
    assert_frame_equal(port.build_positive_pairs(to_frame(inter)),
                       ref.build_positive_pairs(inter))


@pytest.mark.parametrize("seed", [0, 7])
def test_sample_negatives(detail, seed):
    pos_r = ref.build_positive_pairs(detail["ref"][0])
    pos_p = port.build_positive_pairs(detail["port"][0])
    want = ref.sample_negatives(pos_r, detail["ref"][1].to_numpy(), seed=seed)
    got = port.sample_negatives(pos_p, detail["port"][1], seed=seed)
    assert 0 < len(want) <= len(pos_r)  # capped where a user's complement is smaller
    assert_frame_equal(got, want)


@pytest.mark.parametrize("side", [ref, port], ids=["ref", "port"])
def test_sample_negatives_refuses_a_user_with_every_item(side):
    pos = pd.DataFrame({"user_id": [1, 1, 2], "product_id": [10, 11, 10]})
    with pytest.raises(ValueError, match="whole catalog"):
        side.sample_negatives(pos if side is ref else to_frame(pos), np.array([10, 11]))


@pytest.fixture(scope="module")
def unioned(detail):
    out = {}
    for side, mod in (("ref", ref), ("port", port)):
        pos = mod.build_positive_pairs(detail[side][0])
        items = detail[side][1]
        neg = mod.sample_negatives(pos, items.to_numpy() if side == "ref" else items, seed=0)
        out[side] = mod.union_pos_neg(pos, neg)
    return out


def test_union(unioned):
    assert_frame_equal(unioned["port"], unioned["ref"])


@pytest.mark.parametrize("seed,fractions", [(0, (0.8, 0.9)), (3, (0.5, 0.75))])
def test_per_user_split(unioned, seed, fractions):
    want = ref.per_user_split(unioned["ref"], seed=seed, fractions=fractions)
    got = port.per_user_split(unioned["port"], seed=seed, fractions=fractions)
    assert set(want["split"]) == {"train", "val", "test"}
    assert_frame_equal(got, want)


def test_per_user_split_with_singleton_users():
    df = pd.DataFrame({"user_id": np.array([4, 4, 1, 9, 4, 1], np.int64),
                       "product_id": np.arange(6, dtype=np.int64),
                       "label": np.array([1, 0, 1, 1, 0, 0], np.int64)})
    assert_frame_equal(port.per_user_split(to_frame(df), seed=5),
                       ref.per_user_split(df, seed=5))


@pytest.mark.parametrize("side", [ref, port], ids=["ref", "port"])
def test_user_coverage_is_asserted(side):
    df = pd.DataFrame({"user_id": [1, 1, 2], "split": ["train", "val", "test"]})
    with pytest.raises(AssertionError, match="1 users have no train rows"):
        side.assert_user_coverage(df if side is ref else to_frame(df))


def test_index_ids(unioned):
    split_r = ref.per_user_split(unioned["ref"], seed=0)
    split_p = port.per_user_split(unioned["port"], seed=0)
    want, want_map = ref.index_ids(split_r)
    got, got_map = port.index_ids(split_p)
    assert_frame_equal(got, want)
    for col in ("user_id", "product_id"):
        # the same keys in the same order (the order id_mappings.npz stores)
        assert list(got_map[col].items()) == list(want_map[col].items())


def test_binarize_ratings():
    r = np.array([1, 5, 3, 2.5, 4, 3.1])
    np.testing.assert_array_equal(port.binarize_ratings(r), ref.binarize_ratings(r))
    np.testing.assert_array_equal(port.binarize_ratings(r, 3.0), ref.binarize_ratings(r, 3.0))


def test_whole_prepare_chain(detail):
    """order_detail -> positives -> negatives -> split -> indexing -> the
    per-split columns the shard writer takes."""
    outs = {}
    for side, mod in (("ref", ref), ("port", port)):
        det, items = detail[side]
        pos = mod.build_positive_pairs(det)
        neg = mod.sample_negatives(pos, items.to_numpy() if side == "ref" else items, seed=0)
        indexed, mappings = mod.index_ids(mod.per_user_split(mod.union_pos_neg(pos, neg), seed=0))
        outs[side] = (mod.splits_to_columns(indexed), mappings)
    (got, got_map), (want, want_map) = outs["port"], outs["ref"]
    for split in ("train", "val", "test"):
        assert list(got[split]) == list(want[split])
        for c in want[split]:
            assert got[split][c].dtype == np.int64
            np.testing.assert_array_equal(got[split][c], want[split][c])
    assert [list(m) for m in got_map.values()] == [list(m) for m in want_map.values()]
