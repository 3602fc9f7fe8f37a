"""Losses.

Port of `two_tower_recommender_model_tpu/models/losses.py`:

- `bce_with_logits` — binary cross-entropy over dot-product logits, with
  optional per-example weights (zero-weight rows are padding);
- `weighted_bce_with_logits` — BCE weighted per interaction type, the types
  given as one-hot dense columns.

The losses run in the logits' dtype (bf16 under bf16 compute), as the
reference's do. The in-batch sampled softmax is not ported yet (ROADMAP M9):
`make_loss_fn("sampled_softmax")` raises.
"""

from __future__ import annotations

import torch


def bce_per_example(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Element-wise binary cross-entropy on logits, in the stable form."""
    labels = labels.to(logits.dtype)
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean binary cross-entropy on logits; with `weights`, the weighted sum
    over the total weight (at least 1)."""
    per = bce_per_example(logits, labels)
    if weights is not None:
        per = per * weights.to(per.dtype)
        return per.sum() / torch.clamp(weights.sum(), min=1.0)
    return per.mean()


def weighted_bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                             type_onehot: torch.Tensor,
                             type_weights: torch.Tensor) -> torch.Tensor:
    """BCE weighted per interaction type, the types as one-hot columns."""
    weights = type_onehot.to(logits.dtype) @ type_weights.to(logits.dtype)
    return bce_with_logits(logits, labels, weights)


def make_loss_fn(name: str, type_weights: tuple[float, ...] | None = None,
                 type_onehot_start: int = 0):
    """Loss factory: `loss_fn(q, c, batch) -> (loss, logits)`. For
    "weighted_bce", `type_weights` gives one weight per interaction type and
    the one-hot types arrive as dense columns
    `batch.dense[:, type_onehot_start : type_onehot_start + len(type_weights)]`."""
    if name == "bce":
        def loss_fn(q, c, batch):
            logits = torch.sum(q * c, dim=1)
            return bce_with_logits(logits, batch.labels), logits
        return loss_fn
    if name == "weighted_bce":
        if not type_weights:
            raise ValueError('loss="weighted_bce" requires non-empty type_weights')
        lo, hi = type_onehot_start, type_onehot_start + len(type_weights)

        def loss_fn(q, c, batch):
            logits = torch.sum(q * c, dim=1)
            if batch.dense is None:
                raise ValueError("weighted_bce needs dense one-hot type columns in the batch "
                                 "(configure the featurizer's dense_cols)")
            tw = torch.tensor(type_weights, dtype=torch.float32, device=logits.device)
            return weighted_bce_with_logits(logits, batch.labels, batch.dense[:, lo:hi],
                                            tw), logits
        return loss_fn
    if name == "sampled_softmax":
        raise NotImplementedError(
            "the in-batch sampled softmax is not ported to the PyTorch package yet (ROADMAP M9)")
    raise ValueError(f"unknown loss {name!r}")


def loss_fn_from_config(train_cfg):
    """The training loss of a `TrainConfig`."""
    return make_loss_fn(train_cfg.loss, type_weights=train_cfg.loss_type_weights,
                        type_onehot_start=train_cfg.loss_type_onehot_start)
