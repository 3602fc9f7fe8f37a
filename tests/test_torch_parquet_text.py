"""Parquet input (`data/parquet.py`, `serving.batch.batch_predict(input_format=
"parquet")`) and item text features (`data/text_features.py`) against the
JAX package's on the same inputs."""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from two_tower_recommender_model_tpu import config as jax_config
from two_tower_recommender_model_tpu.data import parquet as jax_parquet
from two_tower_recommender_model_tpu.data import text_features as jax_text
from two_tower_recommender_model_tpu.serving.batch import batch_predict as jax_batch_predict
from two_tower_recommender_model_tpu.serving.scorer import load_scorer as jax_load_scorer
from two_tower_recommender_model_tpu.train.step import create_train_state as jax_create
from two_tower_recommender_model_tpu.utils.checkpoint import export_model as jax_export
from two_tower_recommender_model_tpu_torch.data import parquet, text_features
from two_tower_recommender_model_tpu_torch.data.shards import ShardedDataset, write_dataset
from two_tower_recommender_model_tpu_torch.serving import load_scorer
from two_tower_recommender_model_tpu_torch.serving.batch import batch_predict


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROWS = 2_500


def _columns(seed=2):
    rng = np.random.default_rng(seed)
    cols = {"user_id": rng.integers(0, 400, ROWS), "product_id": rng.integers(0, 100, ROWS),
            "label": rng.integers(0, 2, ROWS).astype(np.int32),
            "price": rng.random(ROWS).astype(np.float32)}
    cols["user_id"][::11] = 0
    return cols


def _batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])


def test_parquet_round_trip_matches_jax(tmp_path):
    cols = _columns()
    files = parquet.write_parquet_dataset(str(tmp_path / "p"), cols, rows_per_file=1_000)
    jfiles = jax_parquet.write_parquet_dataset(str(tmp_path / "j"), cols, rows_per_file=1_000)
    assert [f.rsplit("/", 1)[1] for f in files] == [f.rsplit("/", 1)[1] for f in jfiles]
    assert len(files) == 3
    for path in (str(tmp_path / "p"), str(tmp_path / "p" / "*.parquet"), files[0]):
        for kwargs in ({}, {"drop_last": True}, {"columns": ["user_id", "label"]},
                       {"int64_ids": False}):
            got = list(parquet.parquet_batches(path, 700, **kwargs))
            want = list(jax_parquet.parquet_batches(path, 700, **kwargs))
            _batches_equal(got, want)
    got = list(parquet.parquet_batches(str(tmp_path / "p"), 700))
    assert [len(b["label"]) for b in got] == [700, 700, 700, 400]
    assert got[0]["user_id"].dtype == np.int64 and got[0]["price"].dtype == np.float32
    np.testing.assert_array_equal(np.concatenate([b["user_id"] for b in got]), cols["user_id"])
    with pytest.raises(FileNotFoundError):
        next(parquet.parquet_batches(str(tmp_path / "none*.parquet"), 10))


def test_parquet_preprocess_hook_matches_jax(tmp_path):
    cols = _columns(3)
    parquet.write_parquet_dataset(str(tmp_path), cols, rows_per_file=900)

    def pre(c):  # drop a column, derive one, filter rows: batches re-cut after the hook
        keep = c["label"] == 1
        return {"user_id": c["user_id"][keep], "pair": c["user_id"][keep] * 1000
                + c["product_id"][keep]}

    got = list(parquet.parquet_batches(str(tmp_path), 256, preprocess=pre))
    want = list(jax_parquet.parquet_batches(str(tmp_path), 256, preprocess=pre))
    _batches_equal(got, want)
    assert sum(len(b["pair"]) for b in got) == int((cols["label"] == 1).sum())


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("model")
    cfg = jax_config.two_tower_model_config(num_users=300, num_items=80, embedding_dim=16,
                                            layer_sizes=(32, 8))
    state, _ = jax_create(jax.random.key(1), cfg, jax_config.TrainConfig())
    jax_export(str(root), cfg, state)
    return str(root)


def _read(path):
    ds = ShardedDataset(path)
    parts = [ds.read_shard(i) for i in range(ds.num_shards)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def test_batch_predict_on_parquet_matches_jax_and_the_ttrs_route(tmp_path, model_dir):
    """Parquet in, TTRS shards out: the same index and rows as the JAX
    package's parquet route, and the predictions bit for bit the port's TTRS
    route on the same rows."""
    cols = _columns(4)
    parquet.write_parquet_dataset(str(tmp_path / "pq"), cols, rows_per_file=1_000)
    write_dataset(str(tmp_path / "ttrs"), cols, rows_per_shard=1_000)
    scorer = load_scorer(model_dir, device="cpu")
    index = batch_predict(scorer, str(tmp_path / "pq"), str(tmp_path / "out"), batch_size=700,
                          input_format="parquet", rows_per_shard=1_000)
    jindex = jax_batch_predict(jax_load_scorer(model_dir), str(tmp_path / "pq"),
                               str(tmp_path / "jout"), batch_size=700, input_format="parquet",
                               rows_per_shard=1_000)
    assert index == jindex and index["total_rows"] == ROWS
    got, want = _read(str(tmp_path / "out")), _read(str(tmp_path / "jout"))
    assert set(got) == set(want) == {*cols, "prediction"}
    for k in cols:
        np.testing.assert_array_equal(got[k], cols[k])
    np.testing.assert_allclose(got["prediction"], want["prediction"], rtol=0, atol=1e-6)
    batch_predict(scorer, str(tmp_path / "ttrs"), str(tmp_path / "tout"), batch_size=700,
                  rows_per_shard=1_000)
    np.testing.assert_array_equal(got["prediction"], _read(str(tmp_path / "tout"))["prediction"])


TEXTS = ["Organic Bananas produce fresh fruits", "", "Whole MILK dairy eggs",
         "organic bananas", "a", "Ünïcödé crème brûlée 42", "  spaced   out  words  "]


@pytest.mark.parametrize("dim,ngrams,lower", [(256, (3, 4), True), (32, (2,), False),
                                              (7, (), True)])
def test_embed_text_is_the_references_bit_for_bit(dim, ngrams, lower):
    got = text_features.embed_text(TEXTS, dim=dim, char_ngrams=ngrams, lowercase=lower)
    want = jax_text.embed_text(TEXTS, dim=dim, char_ngrams=ngrams, lowercase=lower)
    assert got.dtype == np.float32 and got.shape == (len(TEXTS), dim)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert text_features.concat_text_fields("a", "", None, "b") == \
        jax_text.concat_text_fields("a", "", None, "b") == "a b"


def test_cosine_similarity_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(50, 16)), rng.normal(size=(50, 16))
    a[3] = 0.0  # a zero row: similarity 0
    got = text_features.cosine_similarity(a, b)
    np.testing.assert_array_equal(got, jax_text.cosine_similarity(a, b))
    assert got[3] == 0.0
    emb = text_features.embed_text(TEXTS, dim=64)
    np.testing.assert_allclose(text_features.cosine_similarity(emb[:1], emb[3:4]),
                               jax_text.cosine_similarity(emb[:1], emb[3:4]))


@pytest.mark.parametrize("ext", [".npz", ".parquet"])
def test_precomputed_embeddings_round_trip(tmp_path, ext):
    rng = np.random.default_rng(1)
    ids = np.array([5, 1, 3, 8])
    emb = rng.normal(size=(4, 6)).astype(np.float32)
    path = str(tmp_path / f"e{ext}")
    text_features.save_precomputed_embeddings(path, ids, emb)
    got = text_features.load_precomputed_embeddings(path, num_ids=10)
    want = jax_text.load_precomputed_embeddings(path, num_ids=10)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (11, 6) and not got[0].any()
    np.testing.assert_array_equal(got[ids], emb)
    # the reference's file reads back through the port, and the other way round
    jpath = str(tmp_path / f"j{ext}")
    jax_text.save_precomputed_embeddings(jpath, ids, emb)
    np.testing.assert_array_equal(text_features.load_precomputed_embeddings(jpath), got[:9])


@pytest.mark.parametrize("bad,match", [
    ({"ids": np.array([0, 1]), "embeddings": np.ones((2, 3), np.float32)}, ">= 1"),
    ({"ids": np.array([1, 1]), "embeddings": np.ones((2, 3), np.float32)}, "duplicate"),
    ({"ids": np.array([1, 2]), "embeddings": np.ones((3, 3), np.float32)}, "expected"),
    ({"ids": np.array([1.5, 2.0]), "embeddings": np.ones((2, 3), np.float32)}, "integers"),
    ({"other": np.array([1])}, "missing array"),
])
def test_precomputed_embeddings_are_checked(tmp_path, bad, match):
    path = str(tmp_path / "bad.npz")
    np.savez(path, **bad)
    for lib in (text_features, jax_text):
        with pytest.raises(ValueError, match=match):
            lib.load_precomputed_embeddings(path)
    with pytest.raises(ValueError, match="exceeds"):
        np.savez(path, ids=np.array([4]), embeddings=np.ones((1, 2), np.float32))
        text_features.load_precomputed_embeddings(path, num_ids=3)
    with pytest.raises(ValueError, match="unsupported"):
        text_features.save_precomputed_embeddings(str(tmp_path / "x.csv"), [1], [[1.0]])


def test_product_feature_table_matches_jax():
    products = pd.DataFrame({
        "product_id": np.arange(1, 31),
        "product_name": [f"organic product {i} pack" for i in range(1, 31)],
        "department": [f"department_{i % 7}" for i in range(1, 31)],
        "aisle": [f"aisle_{i % 5}" if i % 4 else "" for i in range(1, 31)],
    })
    table, emb = text_features.build_product_text_features(products, dim=48)
    jtable, jemb = jax_text.build_product_text_features(products, dim=48)
    np.testing.assert_array_equal(emb, jemb)
    assert list(table.columns) == list(jtable.columns) == ["product_id", "text_emb"]
    np.testing.assert_array_equal(table["product_id"].to_numpy(), jtable["product_id"].to_numpy())
    np.testing.assert_array_equal(np.stack(table["text_emb"]), np.stack(jtable["text_emb"]))
