"""Columnar raw-data ingest: Instacart CSVs with their declared schemas, and
the order_detail join.

The port's own copy of `two_tower_recommender_model_tpu/data/ingest.py`, on
numpy and the standard library (the card's machine has no pandas): a table
is a `data.Frame`, with the columns and values `pd.read_csv` gives the
reference. Tables with a string column go through the `csv` module (quoted
fields, commas inside quotes); all-integer tables (the ~30M-row
`order_products__prior.csv`) through `np.loadtxt`, at C speed.
`write_parquet` writes a table as the reference's `df.to_parquet` does,
through pyarrow, which it imports when it is called.
"""

from __future__ import annotations

import csv
import os
import warnings

import numpy as np

from two_tower_recommender_model_tpu_torch.data import Frame

INSTACART_SCHEMAS: dict[str, dict[str, str]] = {
    "orders": {
        "order_id": "int64", "user_id": "int64", "eval_set": "string",
        "order_number": "int64", "order_dow": "int64", "order_hour_of_day": "int64",
        "days_since_prior_order": "float64",
    },
    "products": {
        "product_id": "int64", "product_name": "string", "aisle_id": "int64",
        "department_id": "int64",
    },
    "order_products": {
        "order_id": "int64", "product_id": "int64", "add_to_cart_order": "int64",
        "reordered": "int64",
    },
    "departments": {"department_id": "int64", "department": "string"},
    "aisles": {"aisle_id": "int64", "aisle": "string"},
}


# the fields `pd.read_csv` reads as missing by default (its `na_values`)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})


def _column(values, dtype: str | None) -> np.ndarray:
    """One CSV column of strings as `dtype` ("int64"; "float64" or "string"
    with the missing fields of `NA_VALUES` as NaN), or, for a column the
    schema does not name, inferred as the reference's reader does: int64,
    else float64, else strings."""
    if dtype == "string":
        return np.array([np.nan if v in NA_VALUES else v for v in values], dtype=object)
    if dtype is None:
        for guess in ("int64", "float64"):
            try:
                return _column(values, guess)
            except ValueError:
                continue
        return _column(values, "string")
    if dtype == "float64":
        return np.fromiter((np.nan if v in NA_VALUES else float(v) for v in values),
                           np.float64, len(values))
    return np.array(values, dtype=np.int64) if len(values) else np.zeros(0, np.int64)


def read_csv_table(path: str, table: str) -> Frame:
    """A CSV with its declared schema; columns in file order."""
    schema = INSTACART_SCHEMAS[table]
    with open(path, newline="") as f:
        header = next(csv.reader(f))
        missing = set(schema) - set(header)
        if missing:
            raise ValueError(f"{table}: missing columns {sorted(missing)}")
        if all(schema.get(c) == "int64" for c in header):
            with warnings.catch_warnings():  # a header-only file is an empty table
                warnings.filterwarnings("ignore", "loadtxt: input contained no data")
                data = np.loadtxt(f, dtype=np.int64, delimiter=",", ndmin=2)
            return {c: np.ascontiguousarray(data[:, i]) if data.size else np.zeros(0, np.int64)
                    for i, c in enumerate(header)}
        rows = list(csv.reader(f))
    for i, row in enumerate(rows):
        if len(row) != len(header):
            raise ValueError(f"{path}: line {i + 2} has {len(row)} fields, expected "
                             f"{len(header)}")
    cols = list(zip(*rows)) if rows else [()] * len(header)
    return {c: _column(v, schema.get(c)) for c, v in zip(header, cols)}


def write_parquet(df: Frame, out_dir: str, name: str) -> str:
    """`out_dir/name.parquet` with the frame's columns in order, as the
    reference's `df.to_parquet(path, index=False)` writes them: each column
    converted as pandas hands one to pyarrow (`from_pandas`: a float NaN or
    a missing string is null), a string column as `large_string` (pandas 3's
    string dtype; pandas 2's object columns wrote `string`, the same
    values), snappy-compressed by `pq.write_table`'s default, which pandas
    keeps. Returns the path."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    def column(values: np.ndarray):
        col = pa.array(np.asarray(values), from_pandas=True)
        return col.cast(pa.large_string()) if pa.types.is_string(col.type) else col

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.parquet")
    pq.write_table(pa.table({c: column(v) for c, v in df.items()}), path)
    return path


def _merge_inner(left: Frame, right: Frame, on: str) -> Frame:
    """`left.merge(right, on=on, how="inner")` for unique right-hand keys:
    left's rows in left's order, those without a match dropped, left's
    columns then right's other columns."""
    rkeys = right[on]
    order = np.argsort(rkeys, kind="stable")
    sorted_keys = rkeys[order]
    if len(sorted_keys) > 1 and (sorted_keys[1:] == sorted_keys[:-1]).any():
        raise ValueError(f"merge on {on!r}: duplicate keys in the right-hand table")
    overlap = (set(left) & set(right)) - {on}
    if overlap:
        raise ValueError(f"merge on {on!r}: both tables have columns {sorted(overlap)}")
    # the key's sorted position, clipped into range; a row matches where the key is there
    pos = np.minimum(np.searchsorted(sorted_keys, left[on]), max(len(sorted_keys) - 1, 0))
    hit = sorted_keys[pos] == left[on] if len(sorted_keys) else np.zeros(len(left[on]), bool)
    ridx = order[pos[hit]]
    out = {k: v[hit] for k, v in left.items()}
    out.update({k: v[ridx] for k, v in right.items() if k != on})
    return out


def build_order_detail(orders: Frame, order_products: Frame, products: Frame) -> Frame:
    """The order_detail join: orders x order_products x products -> one row
    per (order, product) with its user_id, in order_products' row order."""
    df = _merge_inner(order_products, orders, "order_id")
    df = _merge_inner(df, products, "product_id")
    return {c: df[c] for c in ("order_id", "user_id", "product_id", "product_name",
                               "order_number", "add_to_cart_order", "reordered", "eval_set")}
