"""Vectorized featurizer: columnar batches -> fixed-shape device batches.

Port of `two_tower_recommender_model_tpu/data/featurizer.py`. The hashing is
the reference's, in numpy and bit for bit:

- each categorical id is hashed into its table with `value % num_embeddings`,
  taken in int64;
- a falsy (0) id is dropped: its slot gets id 0 and mask 0, so the pooled
  embedding of an all-dropped bag is zero (`drop_zero_ids=False` makes id 0 a
  real id);
- labels become int32.

Batches are fixed-shape `[B, L]` id + mask tensors. Each field moves to the
device in one transfer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from two_tower_recommender_model_tpu_torch.device import resolve_device

from two_tower_recommender_model_tpu_torch.config import ModelConfig


@dataclasses.dataclass
class SparseFeature:
    """A fixed-shape pooled-bag feature: ids `[B, L]` int32, mask `[B, L]` f32.

    mask[b, l] = 1.0 where ids[b, l] is a real id; padded and dropped slots
    are 0, with id 0."""

    ids: torch.Tensor
    mask: torch.Tensor


@dataclasses.dataclass
class Batch:
    """One batch. `weights` (optional, [B]) marks per-sample validity:
    padding rows carry weight 0 (see `pad_batch`)."""

    features: dict[str, SparseFeature]
    labels: torch.Tensor  # [B] int32
    dense: torch.Tensor | None = None  # [B, dense_dim] float32 side features
    weights: torch.Tensor | None = None  # [B] float32 sample weights

    @property
    def batch_size(self) -> int:
        return self.labels.shape[0]


def pad_batch(batch, multiple: int):
    """Pad to a multiple of `multiple` rows with zero-weight samples (id 0,
    mask 0, label 0), so a ragged tail batch keeps a fixed shape (or splits
    evenly over the data ranks of a mesh) without skewing metrics. Takes a
    `Batch` or a `PackedBatch` (packed rows pad with id 0, the missing
    sentinel; `labels` may be the empty placeholder of a packed label), with
    tensor or numpy leaves."""
    return _pad_rows(batch, (-batch.batch_size) % multiple)


def pad_batch_to(batch, rows: int):
    """Pad to exactly `rows` rows with zero-weight samples. Unlike
    `pad_batch` this also grows a 0-row batch into an all-padding one of the
    common shape, which still runs its step (and a mesh's collectives)."""
    pad = rows - batch.batch_size
    if pad < 0:
        raise ValueError(f"batch has {batch.batch_size} rows > pad_to={rows}")
    return _pad_rows(batch, pad)


def _pad_rows(batch, pad: int):
    def padrows(x):
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        x = np.asarray(x)
        return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])

    b = batch.batch_size
    weights = batch.weights
    if weights is None:
        like = batch.ids_raw if hasattr(batch, "ids_raw") else batch.labels
        weights = (torch.ones(b, dtype=torch.float32, device=like.device)
                   if isinstance(like, torch.Tensor) else np.ones(b, np.float32))
    if pad == 0:
        return dataclasses.replace(batch, weights=weights)
    if hasattr(batch, "ids_raw"):  # a PackedBatch
        return dataclasses.replace(
            batch, ids_raw=padrows(batch.ids_raw),
            labels=batch.labels if batch.labels.shape[0] == 0 else padrows(batch.labels),
            dense=None if batch.dense is None else padrows(batch.dense),
            weights=padrows(weights))
    return Batch(
        features={k: SparseFeature(ids=padrows(v.ids), mask=padrows(v.mask))
                  for k, v in batch.features.items()},
        labels=padrows(batch.labels),
        dense=None if batch.dense is None else padrows(batch.dense),
        weights=padrows(weights),
    )


class Featurizer:
    """Builds `Batch`es on `device` from dict-of-columns with numpy hashing."""

    def __init__(self, model_config: ModelConfig, drop_zero_ids: bool = True,
                 dense_cols: Sequence[str] = (), label_col: str = "label",
                 device: torch.device | str | None = None):
        self.config = model_config
        self.drop_zero_ids = drop_zero_ids
        self.dense_cols = tuple(dense_cols)
        self.label_col = label_col
        self.device = resolve_device(device)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def __call__(self, columns: Mapping[str, Any]) -> Batch:
        feats: dict[str, SparseFeature] = {}
        for fc in self.config.features:
            table = self.config.table(fc.table)
            col = np.asarray(columns[fc.name])
            if col.ndim == 1:
                ids = col.reshape(-1, 1)
            elif col.ndim == 2:
                ids = col
            else:
                raise ValueError(f"feature {fc.name!r}: expected 1D or 2D column, got {col.shape}")
            L = fc.max_ids_per_sample
            if ids.shape[1] > L:
                ids = ids[:, :L]
            elif ids.shape[1] < L:
                pad = np.zeros((ids.shape[0], L - ids.shape[1]), dtype=ids.dtype)
                ids = np.concatenate([ids, pad], axis=1)
            ids = ids.astype(np.int64)
            if self.drop_zero_ids:
                mask = (ids != 0).astype(np.float32)
            else:
                mask = np.ones(ids.shape, dtype=np.float32)
            hashed = (ids % table.num_embeddings).astype(np.int32)
            hashed = np.where(mask > 0, hashed, 0).astype(np.int32)
            feats[fc.name] = SparseFeature(ids=self._to_device(hashed),
                                           mask=self._to_device(mask))

        labels = np.asarray(columns[self.label_col]).astype(np.int32).reshape(-1)

        dense = None
        if self.dense_cols:
            dense = self._to_device(np.stack(
                [np.asarray(columns[c]).astype(np.float32) for c in self.dense_cols], axis=1
            ))
        return Batch(features=feats, labels=self._to_device(labels), dense=dense)

    def ragged(self, feature: str, values: Sequence[Sequence[int]]) -> np.ndarray:
        """Pad a list-of-lists bag column to the feature's `[B, L]` shape."""
        fc = self.config.feature(feature)
        L = fc.max_ids_per_sample
        out = np.zeros((len(values), L), dtype=np.int64)
        for i, row in enumerate(values):
            row = list(row)[:L]
            out[i, : len(row)] = row
        return out
