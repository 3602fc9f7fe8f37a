"""The port's native TTRS reader (`native/`: its own copy of the C++ reader,
built with g++ into the package's build root) against the JAX package's
native reader and the numpy reader, on compressed and uncompressed shards,
through `ShardedDataset(use_native=True/None/False)`; and the port's
`data.ingest.write_parquet` against the reference's `df.to_parquet`."""

import os

import numpy as np
import pyarrow.parquet as pq
import pytest

from two_tower_recommender_model_tpu.data import ingest as ref_ingest
from two_tower_recommender_model_tpu.data import shards as ref_shards
from two_tower_recommender_model_tpu.data.replica import write_instacart_replica
from two_tower_recommender_model_tpu.native.ttrs import native_read_shard as ref_native_read
from two_tower_recommender_model_tpu_torch.buildroot import PerProcess
from two_tower_recommender_model_tpu_torch.data import ingest as port_ingest
from two_tower_recommender_model_tpu_torch.data import shards as port_shards
from two_tower_recommender_model_tpu_torch.native import build as native_build
from two_tower_recommender_model_tpu_torch.native import ttrs as port_native


def _columns(seed: int, n: int) -> dict:
    """Every dtype and rank the pipeline's shards carry, and more."""
    rng = np.random.default_rng(seed)
    return {
        "user_id": rng.integers(1, 1 << 40, n).astype(np.int64),
        "product_id": rng.integers(1, 97, n).astype(np.int32),
        "label": rng.integers(0, 2, n).astype(np.uint8),
        "seen": rng.random(n) < 0.3,
        "dense": rng.normal(size=(n, 3)).astype(np.float32),
        "history": rng.integers(0, 61, (n, 2, 4)).astype(np.int64),
        "weight": rng.random(n),  # f64
    }


@pytest.fixture(scope="module", params=[True, False], ids=["zlib", "raw"])
def dataset(request, tmp_path_factory):
    """Four shards (700, 700, 700, 3 rows) and an empty batch written by the
    JAX package's writer; raw shards are the pre-packed kind (mmapped by
    default)."""
    d = str(tmp_path_factory.mktemp("ttrs") / "d")
    ref_shards.write_dataset(d, iter([_columns(0, 1_500), _columns(1, 0), _columns(2, 603)]),
                             700, compress=request.param)
    return d, request.param


def _equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("columns", [None, ["dense", "user_id"], ["history"], []])
def test_native_reader_matches_the_reference_readers(dataset, columns):
    """Each shard read by the port's native reader equals the JAX package's
    native reader and both numpy readers (the port's and the reference's)
    column for column: dtype, shape and every value; the arrays are fresh
    and writable."""
    d, _ = dataset
    for f in sorted(x for x in os.listdir(d) if x.endswith(".ttrs")):
        path = os.path.join(d, f)
        got = port_native.native_read_shard(path, columns)
        _equal(got, ref_native_read(path, columns))
        _equal(got, port_shards.read_shard(path, columns))
        _equal(got, ref_shards.read_shard(path, columns))
        assert all(a.flags.writeable for a in got.values())


@pytest.mark.parametrize("use_native", [True, None, False])
def test_sharded_dataset_follows_the_reference_rule(dataset, use_native):
    """`use_native` as the reference reads it: None takes the native reader
    for shards that are not mmapped (the raw dataset's default), True takes
    it whatever the shards, False never; mmapped shards read in numpy. Every
    shard's columns equal the reference dataset's (numpy reader)."""
    d, compressed = dataset
    ds = port_shards.ShardedDataset(d, use_native=use_native)
    ref = ref_shards.ShardedDataset(d, use_native=use_native)
    assert ds.mmap == ref.mmap == (not compressed)
    assert ds.use_native == ref.use_native == (
        use_native if use_native is not None else compressed)
    plain = ref_shards.ShardedDataset(d, use_native=False)
    for i in range(ds.num_shards):
        _equal(ds.read_shard(i, ["label", "history"]), plain.read_shard(i, ["label", "history"]))
    forced = port_shards.ShardedDataset(d, use_native=use_native, mmap=False)
    assert forced.use_native == (use_native is not False)
    for i in range(forced.num_shards):
        _equal(forced.read_shard(i), plain.read_shard(i))


def test_reader_builds_into_the_build_root(tmp_path, monkeypatch):
    """The library goes to `$TTRM_TORCH_BUILD_DIR/ttrs_reader-<hash>/`, never
    beside its source; a second call loads what is there."""
    monkeypatch.setenv("TTRM_TORCH_BUILD_DIR", str(tmp_path))
    path = native_build.build_ttrs_reader()
    assert path.startswith(str(tmp_path)) and os.path.exists(path)
    assert os.path.basename(os.path.dirname(path)).startswith("ttrs_reader-")
    assert native_build.build_ttrs_reader() == path
    src_dir = os.path.dirname(native_build.SOURCE)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]


def test_without_a_build_none_reads_in_numpy_and_true_raises(dataset, monkeypatch):
    """Where the library cannot be built (no g++ or no zlib), None reads in
    numpy, as the reference falls back, and True raises saying why."""
    def fail():
        raise RuntimeError("g++ failed (exit 1): zlib.h: No such file or directory")

    monkeypatch.setattr(native_build, "build_ttrs_reader", fail)
    monkeypatch.setattr(native_build, "_LOADED", PerProcess())
    d, _ = dataset
    ds = port_shards.ShardedDataset(d, use_native=None, mmap=False)
    assert ds.use_native is False
    _equal(ds.read_shard(0), ref_shards.read_shard(os.path.join(d, ds.shard_files[0])))
    with pytest.raises(RuntimeError, match="native TTRS reader is unavailable.*zlib"):
        port_shards.ShardedDataset(d, use_native=True)


# --- write_parquet ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def replica(tmp_path_factory):
    d = tmp_path_factory.mktemp("replica")
    write_instacart_replica(str(d), num_users=200, num_products=120, seed=3)
    return d


def _same_parquet(got: str, want: str) -> None:
    """The same columns in the same order, the same arrow types and values
    (nulls where pandas has NaN or a missing string)."""
    g, w = pq.read_table(got), pq.read_table(want)
    assert g.schema.names == w.schema.names
    assert [f.type for f in g.schema] == [f.type for f in w.schema]
    assert g.num_rows == w.num_rows
    for name in w.schema.names:
        assert g.column(name).to_pylist() == w.column(name).to_pylist(), name


@pytest.mark.parametrize("name,table", [("orders.csv", "orders"),
                                        ("products.csv", "products"),
                                        ("order_products__train.csv", "order_products")])
def test_write_parquet_matches_the_reference(replica, tmp_path, name, table):
    """A table of the replica, read by each package's reader and written by
    each package's `write_parquet`, reads back the same."""
    path = str(replica / name)
    got = port_ingest.write_parquet(port_ingest.read_csv_table(path, table),
                                    str(tmp_path / "port"), table)
    want = ref_ingest.write_parquet(ref_ingest.read_csv_table(path, table),
                                    str(tmp_path / "ref"), table)
    assert got == str(tmp_path / "port" / f"{table}.parquet")
    _same_parquet(got, want)


def test_write_parquet_of_the_join_and_missing_values(replica, tmp_path):
    """The order_detail join (string and integer columns) and a table with
    missing values (a NaN float, a missing string) read back the same."""
    tables = {t: str(replica / f) for f, t in (("orders.csv", "orders"),
                                               ("order_products__prior.csv", "order_products"),
                                               ("products.csv", "products"))}
    got = port_ingest.build_order_detail(*(port_ingest.read_csv_table(p, t)
                                           for t, p in tables.items()))
    want = ref_ingest.build_order_detail(*(ref_ingest.read_csv_table(p, t)
                                           for t, p in tables.items()))
    _same_parquet(port_ingest.write_parquet(got, str(tmp_path / "p"), "order_detail"),
                  ref_ingest.write_parquet(want, str(tmp_path / "r"), "order_detail"))
    quirks = tmp_path / "orders.csv"
    quirks.write_text("order_id,user_id,eval_set,order_number,order_dow,order_hour_of_day,"
                      "days_since_prior_order\n2539329,1,prior,1,2,08,\n"
                      "2398795,1,NA,2,3,07,15.0\n")
    _same_parquet(
        port_ingest.write_parquet(port_ingest.read_csv_table(str(quirks), "orders"),
                                  str(tmp_path / "p"), "orders"),
        ref_ingest.write_parquet(ref_ingest.read_csv_table(str(quirks), "orders"),
                                 str(tmp_path / "r"), "orders"))
