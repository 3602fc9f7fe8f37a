"""Parquet input: batches of columns read from parquet files, and the writer.

The port's own copy of `two_tower_recommender_model_tpu/data/parquet.py`
(numpy and pyarrow; pyarrow is imported inside the two functions, never when
this module is imported, so the rest of the port runs without it).
`parquet_batches` reads parquet file(s) or a directory a row group at a
time, applies an optional columnar preprocess function and yields
dict-of-numpy batches with int64 integer columns: the same batches the TTRS
loader gives, so they feed the same featurizers and `Scorer.predict`.
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Iterator, Mapping

import numpy as np


def _files(path: str) -> list[str]:
    if os.path.isdir(path):
        return sorted(glob.glob(os.path.join(path, "*.parquet")))
    return sorted(glob.glob(path)) if any(c in path for c in "*?[") else [path]


def parquet_batches(
    path: str,
    batch_size: int,
    columns: list[str] | None = None,
    preprocess: Callable[[dict], Mapping[str, np.ndarray]] | None = None,
    drop_last: bool = False,
    int64_ids: bool = True,
) -> Iterator[dict[str, np.ndarray]]:
    """Stream dict-of-columns batches of `batch_size` rows from parquet
    file(s), a glob or a directory (its `*.parquet`, in name order); the last
    short batch unless `drop_last`."""
    import pyarrow.parquet as pq

    files = _files(path)
    if not files:
        raise FileNotFoundError(f"no parquet files at {path}")

    buf: dict[str, list[np.ndarray]] = {}
    buf_rows = 0

    def drain(n):
        nonlocal buf, buf_rows
        cols = {k: np.concatenate(v) if len(v) > 1 else v[0] for k, v in buf.items()}
        batch = {k: v[:n] for k, v in cols.items()}
        buf = {k: [v[n:]] for k, v in cols.items()}
        buf_rows -= n
        return batch

    for f in files:
        pf = pq.ParquetFile(f)
        for rg in range(pf.num_row_groups):
            tbl = pf.read_row_group(rg, columns=columns)
            cols = {name: tbl.column(name).to_numpy(zero_copy_only=False)
                    for name in tbl.column_names}
            if int64_ids:
                cols = {k: v.astype(np.int64) if v.dtype.kind in "iu" else v
                        for k, v in cols.items()}
            if preprocess is not None:
                cols = dict(preprocess(cols))
            n = len(next(iter(cols.values())))
            for k, v in cols.items():
                buf.setdefault(k, []).append(np.asarray(v))
            buf_rows += n
            while buf_rows >= batch_size:
                yield drain(batch_size)
    if buf_rows and not drop_last:
        yield drain(buf_rows)


def write_parquet_dataset(path: str, columns: Mapping[str, np.ndarray],
                          rows_per_file: int = 1 << 20) -> list[str]:
    """Columns -> `path/part_00000.parquet`, ... of at most `rows_per_file`
    rows each; returns the files written."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(path, exist_ok=True)
    n = len(next(iter(columns.values())))
    out = []
    for i, start in enumerate(range(0, n, rows_per_file)):
        tbl = pa.table({k: v[start:start + rows_per_file] for k, v in columns.items()})
        fp = os.path.join(path, f"part_{i:05d}.parquet")
        pq.write_table(tbl, fp)
        out.append(fp)
    return out
