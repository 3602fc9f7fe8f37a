"""Offline batch inference over a dataset directory.

Port of `two_tower_recommender_model_tpu/serving/batch.py`: stream a TTRS or
parquet dataset through `Scorer.predict` in order, add a `prediction`
column, and write TTRS shards out. The TTRS loader's reader thread reads the
next shard while the card scores the current batch; parquet input
(`data/parquet.py`, pyarrow) is read a row group at a time.
"""

from __future__ import annotations

import numpy as np

from two_tower_recommender_model_tpu_torch.data.loader import StreamLoader
from two_tower_recommender_model_tpu_torch.data.shards import ShardWriter
from two_tower_recommender_model_tpu_torch.serving.scorer import Scorer


def batch_predict(
    scorer: Scorer,
    dataset_path: str,
    output_path: str,
    batch_size: int = 4096,
    input_format: str = "ttrs",  # "ttrs" | "parquet"
    keep_columns: tuple[str, ...] | None = None,
    rows_per_shard: int = 1 << 18,
) -> dict:
    """Score every row of the dataset, in its order; returns the output
    dataset's index. The output keeps the input's columns (only
    `keep_columns` when given) and adds `prediction` (f32)."""
    if input_format == "ttrs":
        batches = StreamLoader(dataset_path, batch_size, shuffle=False, drop_last=False)
    elif input_format == "parquet":
        from two_tower_recommender_model_tpu_torch.data.parquet import parquet_batches

        batches = parquet_batches(dataset_path, batch_size)
    else:
        raise ValueError(f"unknown input_format {input_format!r}")
    with ShardWriter(output_path, rows_per_shard) as w:
        for cols in batches:
            preds = scorer.predict(cols)
            out = {
                k: np.asarray(v)
                for k, v in cols.items()
                if keep_columns is None or k in keep_columns
            }
            out["prediction"] = preds.astype(np.float32)
            w.write(out)
    return w.close()
