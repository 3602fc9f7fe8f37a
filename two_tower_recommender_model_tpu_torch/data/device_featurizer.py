"""Packed input: the host packs raw ids, the device hashes and masks them.

Port of `two_tower_recommender_model_tpu/data/device_featurizer.py`.

- host half (`PackedFeaturizer`, numpy): stack the raw id columns into ONE
  int32 array `[B, total_slots]` (+ labels, + optional dense), optionally
  with the binary label in bit 30 of slot 0 and the rows sorted by one
  single-slot feature's hashed id (`sort_packed_batch`, missing ids last);
- device half (`unpack_batch`, torch): the `id % num_embeddings` hash, the
  falsy-id drop mask and the label bit, on whatever device the packed
  tensors are on. Bitwise equal to the host `Featurizer` on the same columns.

`PackedBatch` holds numpy arrays on the host and tensors after
`train.pipeline.prefetch_to_device` has moved it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping

import numpy as np
import torch

from two_tower_recommender_model_tpu_torch.config import ModelConfig
from two_tower_recommender_model_tpu_torch.data.featurizer import Batch, SparseFeature

_LABEL_BIT = 30
_ID_MASK = (1 << _LABEL_BIT) - 1


@dataclasses.dataclass
class PackedBatch:
    """Transfer-optimal batch: one id array, one label array."""

    ids_raw: Any  # [B, total_slots] int32 raw (unhashed) ids
    labels: Any  # [B] int32 ([0] when the label bit is packed into ids_raw)
    dense: Any = None
    weights: Any = None  # [B] f32; zero-weight rows are padding

    @property
    def batch_size(self) -> int:
        return self.ids_raw.shape[0]


def _sort_slot_offset(model_cfg: ModelConfig, sort_feature: str) -> tuple[int, int]:
    """(slot offset, num_embeddings) of a single-slot sort feature."""
    off = 0
    for fc in model_cfg.features:
        if fc.name == sort_feature:
            if fc.max_ids_per_sample != 1:
                raise ValueError(f"sort_feature {sort_feature!r} must be single-slot")
            return off, model_cfg.feature_table(sort_feature).num_embeddings
        off += fc.max_ids_per_sample
    raise ValueError(f"sort_feature {sort_feature!r}: no such feature")


def sort_packed_batch(pb: PackedBatch, slot_off: int, num_embeddings: int,
                      pack_label: bool) -> PackedBatch:
    """Reorder rows so the slot's HASHED ids are non-decreasing, missing ids
    (raw 0) last: the key the update path sees, where `row_grad_flatten`
    maps a masked slot to the sentinel N. Ties keep their row order. Row
    order within a batch does not change the loss."""
    col = np.asarray(pb.ids_raw[:, slot_off])
    if pack_label and slot_off == 0:
        col = col & _ID_MASK
    key = col % num_embeddings
    key = np.where(col == 0, num_embeddings, key)
    # one int64 sort of (key << 32 | row): stable by construction, since ties
    # break on the row index (the key fits 31 bits: num_embeddings < 2^30)
    comb = key.astype(np.int64) << 32
    comb |= np.arange(key.shape[0], dtype=np.int64)
    comb.sort()
    order = comb.astype(np.int32)  # low 32 bits = original row index
    return PackedBatch(
        ids_raw=np.ascontiguousarray(pb.ids_raw[order]),
        labels=pb.labels[order] if pb.labels.size else pb.labels,
        dense=None if pb.dense is None else np.ascontiguousarray(pb.dense[order]),
        weights=None if pb.weights is None else pb.weights[order],
    )


class PackedFeaturizer:
    """Host half: dict-of-columns -> numpy `PackedBatch` (no hashing, no
    masks). `sort_feature` names a single-slot feature to sort each batch's
    rows by (`sort_packed_batch`)."""

    def __init__(self, model_cfg: ModelConfig, dense_cols: tuple[str, ...] = (),
                 label_col: str = "label", pack_label: bool = False,
                 sort_feature: str | None = None):
        """`pack_label=True` puts the binary label in bit 30 of slot 0, so a
        batch ships as one int32 array. It needs every table below 2^30 rows
        and binary labels; `unpack_batch` must get the same flag."""
        self.config = model_cfg
        self.dense_cols = tuple(dense_cols)
        self.label_col = label_col
        self.pack_label = pack_label
        if pack_label:
            for t in model_cfg.tables:
                if t.num_embeddings >= (1 << _LABEL_BIT):
                    raise ValueError(f"pack_label needs tables < 2^30 rows; {t.name} too big")
        self.slots: list[tuple[str, int, int]] = [
            (fc.name, fc.max_ids_per_sample, model_cfg.feature_table(fc.name).num_embeddings)
            for fc in model_cfg.features
        ]
        self.total_slots = sum(s for _, s, _ in self.slots)
        self.sort_feature = sort_feature
        self._sort = _sort_slot_offset(model_cfg, sort_feature) if sort_feature else None

    @staticmethod
    def _fit_int32(col: np.ndarray, num_embeddings: int, lo: int | None = None,
                   hi: int | None = None) -> np.ndarray:
        """Raw ids outside [lo, hi] (int32's range by default) are hashed on
        the host into a value that keeps what the device recomputes: the hash
        (`v % N == raw % N`) and the missing-id mask (`v == 0` iff
        `raw == 0`, with N itself, which hashes to 0, standing in for a
        nonzero id). The window is checked by value for every dtype."""
        info = np.iinfo(np.int32)
        lo = info.min if lo is None else lo
        hi = info.max if hi is None else hi
        if not col.size or (col.min(initial=0) >= lo and col.max(initial=0) <= hi):
            return col
        v = col % num_embeddings
        return np.where((col != 0) & (v == 0), num_embeddings, v)

    def __call__(self, columns: Mapping[str, np.ndarray]) -> PackedBatch:
        first = np.asarray(columns[self.label_col])
        b = len(first)
        ids = np.zeros((b, self.total_slots), np.int32)
        off = 0
        for name, L, num_embeddings in self.slots:
            # the label bit lives in slot 0: its raw ids are pre-hashed into
            # [0, 2^30) so they cannot reach bit 30
            lo, hi = (0, _ID_MASK) if self.pack_label and off == 0 else (None, None)
            col = self._fit_int32(np.asarray(columns[name]), num_embeddings, lo, hi)
            if col.ndim == 1:
                ids[:, off] = col
            else:
                take = min(col.shape[1], L)
                ids[:, off: off + take] = col[:, :take]
            off += L
        dense = None
        if self.dense_cols:
            dense = np.stack(
                [np.asarray(columns[c]).astype(np.float32) for c in self.dense_cols], axis=1)
        labels = first.astype(np.int32)
        if self.pack_label:
            np.bitwise_or(ids[:, 0], labels << _LABEL_BIT, out=ids[:, 0])
            labels = np.zeros(0, np.int32)  # carried inside ids_raw
        pb = PackedBatch(ids_raw=ids, labels=labels, dense=dense)
        if self._sort is not None:
            pb = sort_packed_batch(pb, *self._sort, self.pack_label)
        return pb


def unpack_batch(packed: PackedBatch, model_cfg: ModelConfig, drop_zero_ids: bool = True,
                 pack_label: bool = False) -> Batch:
    """Device half: slice, hash and mask a `PackedBatch` of tensors into a
    `Batch` on the same device."""
    ids_raw = packed.ids_raw
    labels = packed.labels
    if pack_label:
        labels = (ids_raw[:, 0] >> _LABEL_BIT) & 1
        ids_raw = torch.cat([(ids_raw[:, :1] & _ID_MASK), ids_raw[:, 1:]], dim=1)
    feats: dict[str, SparseFeature] = {}
    off = 0
    for fc in model_cfg.features:
        L = fc.max_ids_per_sample
        raw = ids_raw[:, off: off + L]
        hashed = torch.remainder(raw, model_cfg.table(fc.table).num_embeddings).to(torch.int32)
        if drop_zero_ids:
            live = raw != 0
            mask = live.to(torch.float32)
            hashed = torch.where(live, hashed, 0).to(torch.int32)
        else:
            mask = torch.ones(raw.shape, dtype=torch.float32, device=raw.device)
        feats[fc.name] = SparseFeature(ids=hashed.contiguous(), mask=mask)
        off += L
    return Batch(features=feats, labels=labels.to(torch.int32), dense=packed.dense,
                 weights=packed.weights)


def make_packed_train_step(train_step, model_cfg: ModelConfig, drop_zero_ids: bool = True,
                           pack_label: bool = False):
    """Wrap a (state, Batch) train step to take a `PackedBatch`."""

    @functools.wraps(train_step)
    def step(state, packed: PackedBatch):
        return train_step(state, unpack_batch(packed, model_cfg, drop_zero_ids, pack_label))

    return step


def make_packed_eval_step(eval_step, model_cfg: ModelConfig, drop_zero_ids: bool = True,
                          pack_label: bool = False):
    """Wrap a (state, eval_state, Batch) eval step to take a `PackedBatch`."""

    @functools.wraps(eval_step)
    def step(state, eval_state, packed: PackedBatch):
        return eval_step(state, eval_state,
                         unpack_batch(packed, model_cfg, drop_zero_ids, pack_label))

    return step
