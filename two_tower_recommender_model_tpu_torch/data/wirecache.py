"""Wire cache: pre-encoded compact batches, streamed from mmap every epoch.

Port of `two_tower_recommender_model_tpu/data/wirecache.py` (numpy and the
standard library; the same format, so a cache that either package builds is
read by the other).

A packed epoch's host work per batch is the `sort_feature` row sort and the
compact encode. A wire cache does both once, at build time, and stores the
exact `CompactBatch` payload of every batch (sorted, delta-encoded,
bit-packed, label-packed) as flat planes. An epoch's host path is then:

    mmap batch planes (page-cache views)
    -> np.stack K views into the macro-batch (the one copy)
    -> the host-to-device copy

Batch order (`WireCache.order`): "loader" replays the build's batch
sequence, which is the dynamic path's, bit for bit; "rotate" turns that
sequence by a seeded offset, for reuse of one composition across epochs; a
uniform "shuffle" cost recall@100 at full scale in the reference's
measurements (0.222-0.227 against 0.249 in loader order,
BENCH_FULL_SCALE.md), so it is not for multi-epoch quality runs.

Layout of a cache directory:

    meta.json         format, batch count and size, scheme fingerprint
    wire.bin          [NB, W8, B]   uint8
    rem.bin           [NB, R, B//8] uint8   (bit-packed remainder; optional)
    labels.bin        [NB, B]       int32   (absent when the label rides the wire)
    dense.bin         [NB, B, D]    float32 (optional)
    delta_pos.bin     [NB, K]       int32   (delta-slot exceptions; optional)
    delta_extra.bin   [NB, K]       int32
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Iterable, Iterator, Mapping

import numpy as np

from two_tower_recommender_model_tpu_torch.data.compact import CompactBatch, CompactScheme

_FORMAT = "ttrm-wirecache-v1"
_DTYPES = {"wire": np.uint8, "rem": np.uint8, "labels": np.int32, "dense": np.float32,
           "delta_pos": np.int32, "delta_extra": np.int32}


def _scheme_fingerprint(scheme: CompactScheme) -> dict:
    """The scheme as JSON values (tuples -> lists), compared exactly between
    build time and read time."""
    return json.loads(json.dumps(dataclasses.asdict(scheme)))


def build_wire_cache(out_dir: str, column_batches: Iterable[Mapping[str, np.ndarray]],
                     featurizer, *, drop_ragged_tail: bool = True,
                     fingerprint: Mapping | None = None) -> dict:
    """Encode every batch of `column_batches` through `featurizer` (a
    `CompactFeaturizer`, its inner sort included) and store the payloads.

    Every batch must have the first batch's size; a smaller final batch is
    dropped (and counted in the meta) when `drop_ragged_tail`, else it
    raises. Returns the meta dict."""
    scheme: CompactScheme = featurizer.scheme
    os.makedirs(out_dir, exist_ok=True)
    files: dict[str, object] = {}
    shapes: dict[str, list[int]] = {}
    nb = 0
    dropped_rows = 0
    batch_size = None

    def sink(name: str, arr: np.ndarray | None):
        if arr is None:
            return
        arr = np.ascontiguousarray(arr)
        if name not in files:
            files[name] = open(os.path.join(out_dir, f"{name}.bin"), "wb")
            shapes[name] = [*arr.shape]
        elif shapes[name] != [*arr.shape]:
            raise ValueError(f"wire cache {name}: batch shape {[*arr.shape]} != first "
                             f"batch's {shapes[name]}")
        files[name].write(arr.tobytes())

    try:
        for cols in column_batches:
            cb: CompactBatch = featurizer(cols)
            if cb.weights is not None:
                raise ValueError("wire cache stores training batches; weights (eval padding) "
                                 "are not supported")
            b = cb.batch_size
            if batch_size is None:
                batch_size = b
            elif b != batch_size:
                if drop_ragged_tail and b < batch_size:
                    dropped_rows += b
                    continue
                raise ValueError(f"batch size changed {batch_size} -> {b}")
            sink("wire", cb.wire)
            sink("rem", cb.rem)
            sink("labels", cb.labels if cb.labels.size else None)
            sink("dense", cb.dense)
            sink("delta_pos", cb.delta_pos)
            sink("delta_extra", cb.delta_extra)
            nb += 1
    finally:
        for f in files.values():
            f.close()
    if nb == 0:
        raise ValueError("wire cache: no batches")
    meta = {
        "format": _FORMAT,
        "num_batches": nb,
        "batch_size": batch_size,
        "dropped_tail_rows": dropped_rows,
        "planes": {name: shapes[name] for name in files},
        "scheme": _scheme_fingerprint(scheme),
        # the caller's dataset identity (data dir, row counts), checked at read
        # time so a stale cache cannot train old data or another batch size
        "fingerprint": json.loads(json.dumps(fingerprint)) if fingerprint else None,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class WireCache:
    """Reader half: mmap the planes, stream seeded per-epoch batch orders.

    `batches(epoch)` yields `CompactBatch`es whose leaves are views into the
    page cache; `np.stack` in the macro assembler makes the one copy."""

    def __init__(self, path: str, scheme: CompactScheme | None = None, seed: int = 0,
                 batch_size: int | None = None, fingerprint: Mapping | None = None):
        self.path = path
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta.get("format") != _FORMAT:
            raise ValueError(f"{path}: not a wire cache (format={self.meta.get('format')!r})")
        if scheme is not None and self.meta["scheme"] != _scheme_fingerprint(scheme):
            raise ValueError(f"{path}: cache was built with a different wire scheme — "
                             "rebuild it for this model/config")
        if batch_size is not None and int(self.meta["batch_size"]) != batch_size:
            raise ValueError(f"{path}: cache was built at batch_size={self.meta['batch_size']}, "
                             f"run wants {batch_size} — rebuild it")
        if fingerprint is not None and self.meta.get("fingerprint") is not None:
            want = json.loads(json.dumps(fingerprint))
            if self.meta["fingerprint"] != want:
                raise ValueError(f"{path}: cache was built from a different dataset "
                                 f"({self.meta['fingerprint']} != {want}) — rebuild it")
        self.num_batches = int(self.meta["num_batches"])
        self.batch_size = int(self.meta["batch_size"])
        self.seed = seed
        self._planes = {
            name: np.memmap(os.path.join(path, f"{name}.bin"), dtype=_DTYPES[name],
                            mode="r").reshape(self.num_batches, *shape)
            for name, shape in self.meta["planes"].items()}

    def order(self, epoch: int, mode: str = "shuffle") -> np.ndarray:
        """Batch order for `epoch`, the same in every process:

        - "loader": the build's (= `StreamLoader`'s) order, which replays the
          dynamic path's batch sequence;
        - "rotate": that order cyclically turned by a seeded offset;
        - "shuffle": a seeded uniform permutation.
        """
        if mode == "loader":
            return np.arange(self.num_batches)
        key = zlib.crc32(f"wirecache:{self.seed}:{epoch}".encode())
        if mode == "rotate":
            off = key % max(self.num_batches, 1)
            return np.roll(np.arange(self.num_batches), -int(off))
        if mode != "shuffle":
            raise ValueError(f"order mode must be loader|rotate|shuffle, got {mode!r}")
        return np.random.default_rng(key).permutation(self.num_batches)

    def _batch(self, i: int) -> CompactBatch:
        p = self._planes
        return CompactBatch(
            wire=p["wire"][i],
            rem=p["rem"][i] if "rem" in p else None,
            labels=p["labels"][i] if "labels" in p else np.zeros(0, np.int32),
            dense=p["dense"][i] if "dense" in p else None,
            weights=None,
            delta_pos=p["delta_pos"][i] if "delta_pos" in p else None,
            delta_extra=p["delta_extra"][i] if "delta_extra" in p else None,
        )

    def batches(self, epoch: int = 0, host_index: int = 0, host_count: int = 1,
                skip_batches: int = 0, limit_batches: int | None = None,
                order_mode: str = "shuffle") -> Iterator[CompactBatch]:
        """This host's slice of the epoch: disjoint, equal-count contiguous
        runs of the epoch's order (the `StreamLoader` contract);
        `skip_batches` resumes mid-slice. `limit_batches` truncates the slice
        after the host slicing."""
        if not (0 <= host_index < host_count):
            raise ValueError(f"host_index {host_index} out of range {host_count}")
        per_host = self.num_batches // host_count
        order = self.order(epoch, order_mode)[host_index * per_host:(host_index + 1) * per_host]
        if limit_batches is not None:
            order = order[:limit_batches]
        for i in order[skip_batches:]:
            yield self._batch(int(i))
