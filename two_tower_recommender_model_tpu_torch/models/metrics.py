"""Streaming eval metrics.

Port of `two_tower_recommender_model_tpu/models/metrics.py`: a fixed-bin
histogram AUROC whose state is two `[bins]` count vectors on the device
(update is a pair of `index_add_`s, compute the Mann-Whitney statistic over
the bins; with 8,192 bins on sigmoid scores it is within ~1e-4 of the exact
AUROC), `exact_auroc` (the sort-based oracle) and the running mean of the
eval loss.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from two_tower_recommender_model_tpu_torch.device import resolve_device


@dataclasses.dataclass
class AUROCState:
    pos: torch.Tensor  # [bins] float32 counts of positive scores
    neg: torch.Tensor  # [bins] float32


def auroc_init(bins: int = 8192, device: torch.device | str | None = None) -> AUROCState:
    device = resolve_device(device)
    return AUROCState(pos=torch.zeros(bins, dtype=torch.float32, device=device),
                      neg=torch.zeros(bins, dtype=torch.float32, device=device))


def auroc_update(state: AUROCState, logits: torch.Tensor, labels: torch.Tensor,
                 weights: torch.Tensor | None = None) -> AUROCState:
    bins = state.pos.shape[0]
    scores = torch.sigmoid(logits.to(torch.float32))
    idx = torch.clamp((scores * bins).to(torch.int32), 0, bins - 1).long()
    w = torch.ones_like(scores) if weights is None else weights.to(torch.float32)
    lab = labels.to(torch.float32)
    return AUROCState(pos=state.pos.index_add(0, idx, w * lab),
                      neg=state.neg.index_add(0, idx, w * (1.0 - lab)))


def auroc_compute(state: AUROCState) -> torch.Tensor:
    """AUC by the Mann-Whitney statistic on binned counts: pos/neg pairs in
    distinct bins are ordered by bin, same-bin pairs count 1/2."""
    pos, neg = state.pos, state.neg
    neg_below = torch.cat([torch.zeros(1, dtype=neg.dtype, device=neg.device),
                           torch.cumsum(neg, 0)[:-1]])
    correct = torch.sum(pos * (neg_below + 0.5 * neg))
    total = torch.sum(pos) * torch.sum(neg)
    return torch.where(total > 0, correct / total, torch.tensor(0.5, device=pos.device))


def auroc_merge(a: AUROCState, b: AUROCState) -> AUROCState:
    return AUROCState(pos=a.pos + b.pos, neg=a.neg + b.neg)


def exact_auroc(logits: np.ndarray, labels: np.ndarray) -> float:
    """Exact AUROC (rank statistic with midrank ties) — test oracle."""
    scores = np.asarray(logits, dtype=np.float64)
    labels = np.asarray(labels).astype(bool)
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    r = 1.0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i: j + 1]] = 0.5 * (r + r + (j - i))
        r += j - i + 1
        i = j + 1
    n_pos = labels.sum()
    n_neg = (~labels).sum()
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


@dataclasses.dataclass
class MeanState:
    total: torch.Tensor
    count: torch.Tensor


def mean_init(device: torch.device | str | None = None) -> MeanState:
    device = resolve_device(device)
    return MeanState(total=torch.zeros((), dtype=torch.float32, device=device),
                     count=torch.zeros((), dtype=torch.float32, device=device))


def mean_update(state: MeanState, value: torch.Tensor, n) -> MeanState:
    return MeanState(total=state.total + value.to(torch.float32) * n, count=state.count + n)


def mean_compute(state: MeanState) -> torch.Tensor:
    return torch.where(state.count > 0, state.total / state.count,
                       torch.tensor(0.0, device=state.count.device))
