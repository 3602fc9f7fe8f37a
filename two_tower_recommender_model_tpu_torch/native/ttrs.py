"""The native TTRS reader's Python face (ctypes).

`native_read_shard(path, columns)` returns what `data.shards.read_shard`
returns (without mmap): `{name: array}` in the header's order, the requested
columns only, each a fresh writable array. `ShardedDataset` reads through it
when the library builds (`data/shards.py`).
"""

from __future__ import annotations

import ctypes

import numpy as np

from two_tower_recommender_model_tpu_torch.native.build import load_ttrs_reader


class NativeShardReader:
    """One open shard: its header parsed, its payloads read on `read`."""

    def __init__(self, path: str):
        self._lib = load_ttrs_reader(required=True)
        self._h = self._lib.ttrs_open(path.encode())
        if not self._h:
            raise IOError(f"ttrs_open failed for {path}")
        self.path = path

    @property
    def rows(self) -> int:
        return self._lib.ttrs_rows(self._h)

    def columns(self) -> list[str]:
        n = self._lib.ttrs_num_columns(self._h)
        return [self._lib.ttrs_column_name(self._h, i).decode() for i in range(n)]

    def _col_info(self, i: int) -> tuple[np.dtype, tuple[int, ...], int]:
        dtype = np.dtype(self._lib.ttrs_column_dtype(self._h, i).decode())
        ndim = self._lib.ttrs_column_ndim(self._h, i)
        shape = tuple(self._lib.ttrs_column_dim(self._h, i, d) for d in range(ndim))
        return dtype, shape, self._lib.ttrs_column_nbytes(self._h, i)

    def read(self, columns: list[str] | None = None) -> dict[str, np.ndarray]:
        """The columns (all when None), each inflated on a thread of its own."""
        names = self.columns()
        want = [i for i, n in enumerate(names) if columns is None or n in columns]
        outs, bufs, caps = {}, [], []
        for i in want:
            dtype, shape, nbytes = self._col_info(i)
            arr = np.empty(shape, dtype=dtype)
            outs[names[i]] = arr
            bufs.append(arr.ctypes.data_as(ctypes.c_void_p))
            caps.append(nbytes)
        if not want:
            return outs
        rc = self._lib.ttrs_read_columns_parallel(
            self._h, (ctypes.c_int * len(want))(*want), len(want),
            (ctypes.c_void_p * len(want))(*bufs), (ctypes.c_int64 * len(want))(*caps))
        if rc != 0:
            raise IOError(f"ttrs read failed rc={rc} for {self.path}")
        return outs

    def close(self) -> None:
        if self._h:
            self._lib.ttrs_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def native_available() -> bool:
    """Whether the library builds and loads here (built at the first call)."""
    return load_ttrs_reader() is not None


def native_read_shard(path: str, columns: list[str] | None = None) -> dict[str, np.ndarray]:
    reader = NativeShardReader(path)
    try:
        return reader.read(columns)
    finally:
        reader.close()
