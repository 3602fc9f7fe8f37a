"""TTRS: a columnar shard format for streaming training data.

The port's own copy of `two_tower_recommender_model_tpu/data/shards.py`
(numpy, json and zlib): the same columns give byte-identical shard files and
`index.json`. A dataset directory holds `index.json` plus N shard files, each
a self-describing binary blob of per-column contiguous arrays (optionally
zlib-compressed per column).

Layout of one shard file:

    magic   b"TTRS1\\n"
    u64     header length (little-endian)
    header  JSON: {"rows": R, "columns": [{"name", "dtype", "shape",
                                           "compressed", "stored_bytes"}]}
    payload per-column bytes, in header order

The payload is raw C-order little-endian array data, mmapped when
uncompressed. `ShardedDataset` reads a shard through the native C++ reader
(`native/`: the columns inflated on a thread each) where it builds, as the
reference does, and in numpy (`read_shard`) otherwise.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Iterator, Mapping, Sequence

import numpy as np

from two_tower_recommender_model_tpu_torch.native.build import load_ttrs_reader
from two_tower_recommender_model_tpu_torch.native.ttrs import native_available, native_read_shard

MAGIC = b"TTRS1\n"
INDEX_NAME = "index.json"


def write_shard(path: str, columns: Mapping[str, np.ndarray], compress: bool = True) -> int:
    cols = {k: np.ascontiguousarray(v) for k, v in columns.items()}
    rows = {len(v) for v in cols.values()}
    if len(rows) != 1:
        raise ValueError(f"ragged columns: {[(k, len(v)) for k, v in cols.items()]}")
    (nrows,) = rows
    header_cols = []
    payloads = []
    for name, arr in cols.items():
        raw = arr.tobytes()
        stored = zlib.compress(raw, 6) if compress else raw
        if compress and len(stored) >= len(raw):
            stored, comp = raw, False
        else:
            comp = compress
        header_cols.append({
            "name": name,
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "compressed": comp,
            "stored_bytes": len(stored),
        })
        payloads.append(stored)
    header = json.dumps({"rows": nrows, "columns": header_cols}).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        for p in payloads:
            f.write(p)
    return nrows


def _read_header(f, path: str) -> tuple[dict, int]:
    """(header, payload offset) of an open shard file."""
    if f.read(len(MAGIC)) != MAGIC:
        raise ValueError(f"{path}: bad magic")
    hlen = int.from_bytes(f.read(8), "little")
    return json.loads(f.read(hlen)), len(MAGIC) + 8 + hlen


def read_shard(path: str, columns: Sequence[str] | None = None,
               mmap: bool = False) -> dict[str, np.ndarray]:
    """`mmap=True` maps uncompressed columns straight from the page cache
    (zero-copy until touched), the fast path of pre-packed uncompressed
    datasets (`data/prepacked.py`). Compressed columns always inflate.
    Unrequested columns are seeked past, never read."""
    with open(path, "rb") as f:
        header, off = _read_header(f, path)
        out = {}
        for col in header["columns"]:
            if columns is not None and col["name"] not in columns:
                f.seek(col["stored_bytes"], 1)
                off += col["stored_bytes"]
                continue
            dtype = np.dtype(col["dtype"])
            shape = tuple(col["shape"])
            if mmap and not col["compressed"]:
                arr = np.memmap(path, dtype=dtype, mode="r", offset=off, shape=shape)
                f.seek(col["stored_bytes"], 1)
            else:
                stored = f.read(col["stored_bytes"])
                raw = zlib.decompress(stored) if col["compressed"] else stored
                arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
            off += col["stored_bytes"]
            out[col["name"]] = arr
    return out


def shard_rows(path: str) -> int:
    with open(path, "rb") as f:
        return _read_header(f, path)[0]["rows"]


def read_schema(path: str) -> dict[str, tuple[np.dtype, tuple[int, ...]]]:
    """Column schema {name: (dtype, trailing_shape)} from a shard header only
    (no payload IO): a host that owns no shard of a dataset still builds
    correctly typed empty batches (`loader.py`, `align_hosts="pad"`)."""
    with open(path, "rb") as f:
        header = _read_header(f, path)[0]
    return {c["name"]: (np.dtype(c["dtype"]), tuple(c["shape"][1:])) for c in header["columns"]}


class ShardWriter:
    """Stream rows into a shard directory with a row limit per shard, writing
    `index.json` on close."""

    def __init__(self, out_dir: str, rows_per_shard: int = 1 << 18, compress: bool = True,
                 extra_index: Mapping | None = None):
        self.out_dir = out_dir
        self.rows_per_shard = rows_per_shard
        self.compress = compress
        self.extra_index = dict(extra_index) if extra_index else None
        self._buf: dict[str, list[np.ndarray]] = {}
        self._buf_rows = 0
        self._shards: list[dict] = []
        self._index: dict | None = None
        os.makedirs(out_dir, exist_ok=True)

    def write(self, columns: Mapping[str, np.ndarray]) -> None:
        cols = {k: np.asarray(v) for k, v in columns.items()}
        n = len(next(iter(cols.values())))
        start = 0
        while start < n:
            take = min(self.rows_per_shard - self._buf_rows, n - start)
            for k, v in cols.items():
                self._buf.setdefault(k, []).append(v[start: start + take])
            self._buf_rows += take
            start += take
            if self._buf_rows >= self.rows_per_shard:
                self._flush()

    def _flush(self) -> None:
        if not self._buf_rows:
            return
        name = f"shard_{len(self._shards):06d}.ttrs"
        cols = {k: np.concatenate(v) for k, v in self._buf.items()}
        rows = write_shard(os.path.join(self.out_dir, name), cols, self.compress)
        self._shards.append({"file": name, "rows": rows})
        self._buf, self._buf_rows = {}, 0

    def close(self) -> dict:
        if self._index is not None:
            return self._index  # idempotent: the context manager and write_dataset both close
        self._flush()
        index = {
            "format": "ttrs",
            "version": 1,
            "total_rows": sum(s["rows"] for s in self._shards),
            "shards": self._shards,
        }
        if self.extra_index:
            index.update(self.extra_index)
        with open(os.path.join(self.out_dir, INDEX_NAME), "w") as f:
            json.dump(index, f, indent=1)
        self._index = index
        return index

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_dataset(
    out_dir: str,
    batches: Iterator[Mapping[str, np.ndarray]] | Mapping[str, np.ndarray],
    rows_per_shard: int = 1 << 18,
    compress: bool = True,
    extra_index: Mapping | None = None,
) -> dict:
    """Write a full dataset dir from one dict-of-columns or an iterator of them."""
    if isinstance(batches, Mapping):
        batches = [batches]
    extra = dict(extra_index or {})
    if not compress:
        extra.setdefault("uncompressed", True)
    with ShardWriter(out_dir, rows_per_shard, compress, extra_index=extra) as w:
        for b in batches:
            w.write(b)
    return w.close()


class ShardedDataset:
    """A TTRS dataset directory: index + lazy shard reads.

    The reference's rule for the reader: `use_native=None` reads through the
    native C++ reader (`native/ttrs_reader.cpp`, parallel zlib inflate) when
    the shards are not mmapped and the library builds here, else in numpy;
    `True` reads through it and raises if it cannot be built; `False` reads
    in numpy. Mmapped datasets read in numpy whatever `use_native` says."""

    def __init__(self, path: str, use_native: bool | None = None, mmap: bool | None = None):
        self.path = path
        with open(os.path.join(path, INDEX_NAME)) as f:
            self.index = json.load(f)
        if self.index.get("format") != "ttrs":
            raise ValueError(f"{path}: not a ttrs dataset")
        self.shard_files = [s["file"] for s in self.index["shards"]]
        self.shard_row_counts = [s["rows"] for s in self.index["shards"]]
        # pre-packed uncompressed datasets default to the zero-copy mmap reader;
        # the native reader's parallel inflate pays only where there is something
        # to inflate
        self.mmap = bool(self.index.get("uncompressed")) if mmap is None else mmap
        if use_native is None:
            use_native = not self.mmap and native_available()
        elif use_native:
            load_ttrs_reader(required=True)
        self.use_native = use_native

    @property
    def total_rows(self) -> int:
        return self.index["total_rows"]

    @property
    def num_shards(self) -> int:
        return len(self.shard_files)

    def schema(self, columns: Sequence[str] | None = None):
        """{name: (dtype, trailing_shape)} from the first shard's header."""
        if not self.shard_files:
            raise ValueError(f"{self.path}: empty dataset has no schema")
        sch = read_schema(os.path.join(self.path, self.shard_files[0]))
        if columns is not None:
            sch = {k: v for k, v in sch.items() if k in columns}
        return sch

    def read_shard(self, i: int, columns: Sequence[str] | None = None) -> dict[str, np.ndarray]:
        path = os.path.join(self.path, self.shard_files[i])
        if self.use_native and not self.mmap:
            return native_read_shard(path, list(columns) if columns is not None else None)
        return read_shard(path, columns, mmap=self.mmap)
