"""The port's replica writer (`data/replica.py`) against the JAX package's:
the same arguments write the same six CSVs, byte for byte, on numpy alone
where the reference formats with pandas' `to_csv`."""

import numpy as np
import pandas as pd
import pytest

from two_tower_recommender_model_tpu.data import replica as ref
from two_tower_recommender_model_tpu_torch.data import replica as port

FILES = ["orders.csv", "products.csv", "order_products__prior.csv",
         "order_products__train.csv", "departments.csv", "aisles.csv"]
# (users, products, seed, chunk_rows): the default chunk and a small one, so
# the prior/train files are appended chunk by chunk
CASES = {"one-chunk": (300, 150, 3, 4_000_000), "chunked": (120, 80, 5, 997)}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    out = {}
    for name, (users, products, seed, chunk) in CASES.items():
        d = tmp_path_factory.mktemp(name)
        stats = {}
        for side, mod in (("ref", ref), ("port", port)):
            stats[side] = mod.write_instacart_replica(str(d / side), num_users=users,
                                                      num_products=products, seed=seed,
                                                      chunk_rows=chunk)
        out[name] = (d, stats)
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", FILES)
def test_replica_csv_is_byte_identical(written, case, name):
    d, _ = written[case]
    with open(d / "ref" / name, "rb") as f:
        want = f.read()
    with open(d / "port" / name, "rb") as f:
        got = f.read()
    assert got == want


@pytest.mark.parametrize("case", list(CASES))
def test_replica_summary_matches(written, case):
    _, stats = written[case]
    assert stats["port"] == stats["ref"]
    assert stats["port"]["prior_rows"] > 0 and stats["port"]["train_rows"] > 0


def test_chunked_writes_are_appended_once_with_one_header(written):
    d, stats = written["chunked"]
    with open(d / "port" / "order_products__prior.csv") as f:
        lines = f.read().splitlines()
    assert lines[0] == "order_id,product_id,add_to_cart_order,reordered"
    assert sum(line.startswith("order_id") for line in lines) == 1
    assert len(lines) - 1 == stats["port"]["prior_rows"]


def test_field_formatting_matches_to_csv(tmp_path):
    """Integers at digit boundaries, an empty field and strings, as pandas
    writes them."""
    ints = np.array([0, 1, 9, 10, 99, 100, 12345, 2**40, 9_999_999_999], np.int64)
    empty = np.zeros(len(ints), bool)
    empty[[0, 5]] = True
    obj = ints.astype(object)
    obj[empty] = ""
    names = np.array([f"item_{i}" for i in range(len(ints))])
    path = tmp_path / "want.csv"
    pd.DataFrame({"a": ints, "b": obj, "c": names}).to_csv(path, index=False)
    got = port._csv_bytes([port._int_field(ints), port._int_field(ints, empty=empty),
                           port._str_field(names)], "a,b,c")
    assert got == path.read_bytes()


@pytest.mark.parametrize("bad", ["a,b", 'say "x"', "two\nlines"])
def test_strings_that_need_quoting_are_refused(bad):
    with pytest.raises(ValueError, match="quote"):
        port._str_field(np.array(["fine", bad]))


def test_negative_integers_are_refused():
    with pytest.raises(ValueError, match="non-negative"):
        port._int_field(np.array([3, -1]))


def test_real_scale_constants_match():
    assert (port.REAL_USERS, port.REAL_PRODUCTS, port.REAL_DEPARTMENTS, port.REAL_AISLES) == (
        ref.REAL_USERS, ref.REAL_PRODUCTS, ref.REAL_DEPARTMENTS, ref.REAL_AISLES)
