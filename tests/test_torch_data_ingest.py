"""The port's ingest (`data/ingest.py`, numpy and `csv`) against the JAX
package's (pandas): `read_csv_table` gives the same columns, dtypes and
values, NaN where pandas reads a missing field, and `build_order_detail` the
same rows in the same order."""

import numpy as np
import pandas as pd
import pytest

from two_tower_recommender_model_tpu.data import ingest as ref
from two_tower_recommender_model_tpu.data.replica import write_instacart_replica
from two_tower_recommender_model_tpu_torch.data import ingest as port

TABLE_OF = {
    "orders.csv": "orders",
    "products.csv": "products",
    "order_products__prior.csv": "order_products",
    "order_products__train.csv": "order_products",
    "departments.csv": "departments",
    "aisles.csv": "aisles",
}


def assert_frame_equal(got: dict, want: pd.DataFrame) -> None:
    """Column names and order, dtypes (int64, float64, strings) and values,
    row for row; NaN matches NaN."""
    assert list(got) == list(want.columns)
    for c in want.columns:
        w = want[c]
        g = got[c]
        assert len(g) == len(w), c
        if pd.api.types.is_integer_dtype(w.dtype):
            assert g.dtype == np.int64, c
            np.testing.assert_array_equal(g, w.to_numpy())
        elif pd.api.types.is_float_dtype(w.dtype):
            assert g.dtype == np.float64, c
            np.testing.assert_array_equal(g, w.to_numpy(), strict=True)
        else:
            assert g.dtype == object, c
            want_vals = [None if pd.isna(v) else v for v in w.to_numpy(dtype=object)]
            got_vals = [None if isinstance(v, float) and np.isnan(v) else v for v in g]
            assert got_vals == want_vals, c


@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("replica")
    write_instacart_replica(str(d), num_users=300, num_products=150, seed=1)
    return d


@pytest.mark.parametrize("name", list(TABLE_OF))
def test_read_csv_table_matches_on_the_replica(csv_dir, name):
    path = str(csv_dir / name)
    assert_frame_equal(port.read_csv_table(path, TABLE_OF[name]),
                       ref.read_csv_table(path, TABLE_OF[name]))


# the real dataset's quirks: quoted names with commas and doubled quotes, an
# empty days_since_prior_order on first orders, zero-padded hours, and a
# field pandas reads as missing
QUIRKS = {
    "orders": ("order_id,user_id,eval_set,order_number,order_dow,order_hour_of_day,"
               "days_since_prior_order\n"
               "2539329,1,prior,1,2,08,\n"
               "2398795,1,prior,2,3,07,15.0\n"
               "473747,1,prior,3,3,12,21.0\n"
               "1187899,1,train,11,4,08,NA\n"),
    "products": ("product_id,product_name,aisle_id,department_id\n"
                 "1,Chocolate Sandwich Cookies,61,19\n"
                 '2,"All-Seasons Salt, Iodized",104,13\n'
                 '3,"Robust Golden ""Unsweetened"" Tea",94,7\n'
                 "4,NA,38,1\n"
                 '5,"line\nbreak",5,13\n'),
    "departments": "department_id,department\n19,snacks\n13,pantry\n7,\n",
}


@pytest.mark.parametrize("table", list(QUIRKS))
def test_read_csv_table_matches_on_kaggle_quirks(tmp_path, table):
    path = tmp_path / f"{table}.csv"
    path.write_text(QUIRKS[table])
    got = port.read_csv_table(str(path), table)
    assert_frame_equal(got, ref.read_csv_table(str(path), table))


def test_quoted_comma_and_empty_days_values(tmp_path):
    for table in ("orders", "products"):
        (tmp_path / f"{table}.csv").write_text(QUIRKS[table])
    orders = port.read_csv_table(str(tmp_path / "orders.csv"), "orders")
    products = port.read_csv_table(str(tmp_path / "products.csv"), "products")
    assert np.isnan(orders["days_since_prior_order"][0])
    assert orders["days_since_prior_order"][1] == 15.0
    assert orders["order_hour_of_day"].tolist() == [8, 7, 12, 8]
    assert products["product_name"][1] == "All-Seasons Salt, Iodized"
    assert products["product_name"][2] == 'Robust Golden "Unsweetened" Tea'


@pytest.mark.parametrize("side", [ref, port], ids=["ref", "port"])
def test_missing_column_raises(tmp_path, side):
    path = tmp_path / "orders.csv"
    path.write_text("order_id,user_id,eval_set\n1,2,prior\n")
    with pytest.raises(ValueError, match="missing columns"):
        side.read_csv_table(str(path), "orders")


def test_header_only_integer_table(tmp_path):
    path = tmp_path / "op.csv"
    path.write_text("order_id,product_id,add_to_cart_order,reordered\n")
    assert_frame_equal(port.read_csv_table(str(path), "order_products"),
                       ref.read_csv_table(str(path), "order_products"))


def _tables(csv_dir, reader):
    return tuple(reader(str(csv_dir / f), t) for f, t in (
        ("orders.csv", "orders"), ("order_products__prior.csv", "order_products"),
        ("products.csv", "products")))


def test_build_order_detail_matches(csv_dir):
    want = ref.build_order_detail(*_tables(csv_dir, ref.read_csv_table))
    got = port.build_order_detail(*_tables(csv_dir, port.read_csv_table))
    assert len(want) > 1000
    assert_frame_equal(got, want)


def test_build_order_detail_inner_join_drops_unmatched_rows(csv_dir):
    """Orders and products with gaps: the unmatched order_products rows go,
    and the rest keep order_products' row order."""
    orders, prior, products = _tables(csv_dir, ref.read_csv_table)
    orders = orders.iloc[::3].sample(frac=1.0, random_state=0)  # a third, shuffled
    products = products[products.product_id % 4 != 0]
    want = ref.build_order_detail(orders, prior, products)
    got = port.build_order_detail(
        *({c: (df[c].to_numpy(dtype=object) if df[c].dtype == object
               or pd.api.types.is_string_dtype(df[c].dtype) else df[c].to_numpy())
           for c in df.columns} for df in (orders, prior, products)))
    assert 0 < len(want) < len(prior)
    assert_frame_equal(got, want)


def test_duplicate_right_hand_keys_raise():
    orders = {"order_id": np.array([1, 1]), "user_id": np.array([5, 6])}
    op = {"order_id": np.array([1]), "product_id": np.array([2])}
    with pytest.raises(ValueError, match="duplicate keys"):
        port._merge_inner(op, orders, "order_id")
