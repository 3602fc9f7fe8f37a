"""Offline batch scoring (`serving.batch.batch_predict`) and the per-user
retrieval table (`evaluation.retrieval.per_user_retrieval_table`) against
the JAX package's functions on the same inputs."""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from two_tower_recommender_model_tpu import config as jax_config
from two_tower_recommender_model_tpu.data.shards import ShardedDataset as JaxShardedDataset
from two_tower_recommender_model_tpu.evaluation.retrieval import (
    per_user_retrieval_table as jax_per_user_retrieval_table,
)
from two_tower_recommender_model_tpu.serving.batch import batch_predict as jax_batch_predict
from two_tower_recommender_model_tpu.serving.scorer import load_scorer as jax_load_scorer
from two_tower_recommender_model_tpu.train.step import create_train_state as jax_create
from two_tower_recommender_model_tpu.utils.checkpoint import export_model as jax_export
from two_tower_recommender_model_tpu_torch.data.shards import ShardedDataset, write_dataset
from two_tower_recommender_model_tpu_torch.evaluation.retrieval import per_user_retrieval_table
from two_tower_recommender_model_tpu_torch.serving import load_scorer
from two_tower_recommender_model_tpu_torch.serving.batch import batch_predict

ROWS = 2_500


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test steps are small, and the suite runs
    several test processes on the same cores, where torch's thread pools
    would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """A JAX-exported model, a raw TTRS dataset of ROWS rows over three
    shards, and both packages' batch scoring of it (700 rows a batch, 1,000
    rows an output shard)."""
    root = tmp_path_factory.mktemp("batch")
    cfg = jax_config.two_tower_model_config(num_users=300, num_items=80, embedding_dim=16,
                                            layer_sizes=(32, 8))
    state, _ = jax_create(jax.random.key(1), cfg, jax_config.TrainConfig())
    model_dir = str(root / "model")
    jax_export(model_dir, cfg, state)
    rng = np.random.default_rng(2)
    cols = {"user_id": rng.integers(0, 400, ROWS), "product_id": rng.integers(0, 100, ROWS),
            "label": rng.integers(0, 2, ROWS).astype(np.int32)}
    cols["user_id"][::11] = 0
    data = str(root / "data")
    write_dataset(data, cols, rows_per_shard=1_000)
    out = {}
    for name, fn, scorer in (
            ("port", batch_predict, load_scorer(model_dir, device="cpu")),
            ("jax", jax_batch_predict, jax_load_scorer(model_dir))):
        path = str(root / name)
        index = fn(scorer, data, path, batch_size=700, rows_per_shard=1_000)
        out[name] = (path, index)
    return cols, out, model_dir, data


def _read(reader, path):
    ds = reader(path)
    parts = [ds.read_shard(i) for i in range(ds.num_shards)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def test_batch_predict_matches_jax(scored):
    cols, out, _, _ = scored
    (path, index), (jpath, jindex) = out["port"], out["jax"]
    assert index == jindex
    assert index["total_rows"] == ROWS and [s["rows"] for s in index["shards"]] == [1000, 1000, 500]
    got, want = _read(ShardedDataset, path), _read(JaxShardedDataset, jpath)
    assert set(got) == set(want) == {"user_id", "product_id", "label", "prediction"}
    for k in ("user_id", "product_id", "label"):
        np.testing.assert_array_equal(got[k], cols[k])  # in the input's order
        np.testing.assert_array_equal(got[k], want[k])
    assert got["prediction"].dtype == np.float32
    np.testing.assert_allclose(got["prediction"], want["prediction"], rtol=0, atol=1e-6)


def test_batch_predict_keeps_the_named_columns_and_scores_batch_by_batch(scored, tmp_path):
    cols, _, model_dir, data = scored
    scorer = load_scorer(model_dir, device="cpu")
    index = batch_predict(scorer, data, str(tmp_path / "o"), batch_size=1_024,
                          keep_columns=("user_id",))
    assert index["total_rows"] == ROWS and len(index["shards"]) == 1
    got = _read(ShardedDataset, str(tmp_path / "o"))
    assert set(got) == {"user_id", "prediction"}
    want = np.concatenate([
        scorer.predict({k: v[i:i + 1_024] for k, v in cols.items()})
        for i in range(0, ROWS, 1_024)])
    np.testing.assert_array_equal(got["prediction"], want)
    # parquet input from a path with no parquet files, and unknown formats, are refused
    # (the parquet route itself: tests/test_torch_parquet_text.py)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no parquet files"):
        batch_predict(scorer, str(tmp_path / "empty"), str(tmp_path / "p"),
                      input_format="parquet")
    with pytest.raises(ValueError, match="input_format"):
        batch_predict(scorer, "d", str(tmp_path / "p"), input_format="csv")


def test_per_user_retrieval_table_matches_jax():
    rng = np.random.default_rng(9)
    users = np.sort(rng.choice(1_000, 40, replace=False))
    pred_ids = rng.integers(1, 200, (40, 100))
    targets = [list(rng.integers(1, 200, rng.integers(1, 8))) for _ in users]
    targets[3] = list(pred_ids[3, :5])  # some hits at the top
    for ks in ((100,), (10, 100)):
        got = per_user_retrieval_table(pred_ids, users, targets, ks=ks)
        want = jax_per_user_retrieval_table(pred_ids, users, targets, ks=ks)
        assert isinstance(got, pd.DataFrame) and len(got) == len(users)
        pd.testing.assert_frame_equal(got, want)
    assert got.loc[3, "recall_at_10"] > 0
