"""Losses.

Port of `two_tower_recommender_model_tpu/models/losses.py`:

- `bce_with_logits` — binary cross-entropy over dot-product logits, with
  optional per-example weights (zero-weight rows are padding);
- `weighted_bce_with_logits` — BCE weighted per interaction type, the types
  given as one-hot dense columns;
- `in_batch_sampled_softmax` — the retrieval objective: every other positive
  item of the batch is a negative, with the optional logQ correction of the
  sampling bias and accidental-hit masking. Three plain routes by batch size,
  as the reference's (dense up to 4,096 rows, row blocks with recompute in
  the backward above that, padded to a multiple of 512 where no block size
  divides the batch), and the fused route through the CUDA kernels of
  `ops/softmax_kernel.py`. The data-parallel route
  (`sharded_in_batch_sampled_softmax`) runs each rank's `[B_local, B]`
  stripe of the score matrix through the same kernels at its row offset.

The BCE losses run in the logits' dtype (bf16 under bf16 compute), as the
reference's do; the softmax's scores are f32 sums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from two_tower_recommender_model_tpu_torch.ops.softmax_kernel import (
    NEG,
    sampled_softmax_fused,
    sampled_softmax_fused_parts,
    softmax_kernel_shapes_ok,
)


def bce_per_example(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Element-wise binary cross-entropy on logits, in the stable form. The
    max with 0 is `torch.relu`, whose gradient at 0 is 0, as the
    reference's `jnp.maximum(logits, 0)` has it: at a logit of exactly 0
    (frequent in bf16) the gradient is -label in both packages."""
    labels = labels.to(logits.dtype)
    return torch.relu(logits) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


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


def _use_fused_softmax(b: int, d: int, implementation: str, device: torch.device,
                       b_local: int | None = None) -> bool:
    """Whether a batch (or, with `b_local`, one rank's `[b_local, b]`
    stripe of it) takes the fused kernels. "off" never does, and shapes
    outside `softmax_kernel_shapes_ok` never do. "on" takes the fused route
    on any device (on CPU tensors its wrappers run their plain versions, with
    the kernels' bf16 rounding points); "auto" takes it for CUDA tensors. The
    reference's "auto" is a table of step times measured on its TPU, which
    says nothing about this card: a rule of the card's own waits for its
    measured times."""
    if implementation not in ("auto", "on", "off"):
        raise ValueError(f"softmax implementation must be auto|on|off, got {implementation!r}")
    if implementation == "off" or not softmax_kernel_shapes_ok(b, d, b_local):
        return False
    return implementation == "on" or device.type == "cuda"


def in_batch_sampled_softmax(
    query_emb: torch.Tensor,  # [B, D]
    cand_emb: torch.Tensor,  # [B, D]
    labels: torch.Tensor,  # [B]: only label == 1 rows contribute (their item is the positive)
    item_ids: torch.Tensor | None = None,  # [B] ids for accidental-hit masking
    log_q: torch.Tensor | None = None,  # [B] log sampling probability of each in-batch item
    temperature: float = 1.0,
    implementation: str = "auto",  # "auto" | "on" | "off": the fused kernels
) -> torch.Tensor:
    """Sampled softmax over in-batch negatives.

    scores[i, j] = <q_i, c_j> / T; row i's positive is column i. Rows whose
    label is 0 are dropped from the loss but still serve as negative columns.
    The logQ correction subtracts the log-probability that item j appears in
    the batch; columns with the same item id as the row's positive are masked
    out (accidental hits)."""
    b = query_emb.shape[0]
    if _use_fused_softmax(b, query_emb.shape[1], implementation, query_emb.device):
        return sampled_softmax_fused(query_emb, cand_emb, labels, item_ids, log_q, temperature)
    chunk = _auto_row_chunk(b)
    if chunk is not None:
        return _chunked_sampled_softmax(query_emb, cand_emb, labels, item_ids, log_q,
                                        temperature, chunk)
    if b > 4096:
        # no usable divisor: pad to a multiple of 512 and mask the pad columns out of
        # every denominator, never the dense [B, B] matrix at this size
        r = 512
        pad = (-b) % r

        def zpad(x, value=0):
            return F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad), value=value)

        return _chunked_sampled_softmax(
            zpad(query_emb), zpad(cand_emb), zpad(labels),
            None if item_ids is None else zpad(item_ids, -1),
            None if log_q is None else zpad(log_q), temperature, r, n_valid=b)
    scores = (query_emb.float() @ cand_emb.float().T) / temperature
    if log_q is not None:
        scores = scores - log_q[None, :].float()
    if item_ids is not None:
        dup = item_ids[None, :] == item_ids[:, None]
        eye = torch.eye(b, dtype=torch.bool, device=scores.device)
        scores = scores.masked_fill(dup & ~eye, NEG)
    per_row = -torch.diagonal(torch.log_softmax(scores, dim=1))
    w = labels.to(per_row.dtype)
    return (per_row * w).sum() / torch.clamp(w.sum(), min=1.0)


def _auto_row_chunk(b: int, target_block: int = 1 << 24) -> int | None:
    """Row-block size of the blockwise softmax: each [R, B] score block near
    `target_block` f32 elements (64 MB). None means the dense path (small
    batches) or no power-of-two divisor."""
    if b <= 4096:
        return None
    r = max(8, target_block // b)
    r = 1 << (r.bit_length() - 1)  # floor to a power of 2
    while r > 1 and b % r:
        r >>= 1
    return r if 1 < r < b and b % r == 0 else None


def _chunked_sampled_softmax(q, c, labels, item_ids, log_q, temperature, r,
                             n_valid: int | None = None):
    """Blockwise in-batch softmax over [R, B] row blocks of the score matrix.
    Each block is checkpointed: the backward recomputes its scores, so the
    O(B^2) matrix is kept neither for the forward nor for the backward. Each
    row's logsumexp is whole within its block, so the math is the dense
    path's; only the final sum over blocks reorders f32 additions."""
    tot, cnt = _stripe_parts(q, c, labels, item_ids, item_ids, log_q, temperature, r, 0,
                             n_valid)
    return tot / torch.clamp(cnt, min=1.0)


def _stripe_parts(q, c, labels, row_ids, col_ids, log_q, temperature, r: int, row_offset: int,
                  n_valid: int | None = None, checkpoint: bool = True):
    """(sum over label == 1 rows of lse_i - s_i,pos, their count) for the q
    rows [row_offset, row_offset + BQ) of the in-batch softmax over all BK
    columns of `c`, in row blocks of `r` (the last may be shorter), each
    checkpointed unless `checkpoint` is False: the plain route of a batch
    (`row_offset` 0) and of one data-parallel stripe."""
    b = c.shape[0]
    ct = c.to(q.dtype).T  # [D, B], shared by every block
    adj = None if log_q is None else log_q.float()
    cols = torch.arange(b, device=q.device)

    def block_loss(qc, lab_c, ids_c, base):
        scores = (qc.float() @ ct.float()) / temperature  # f32 sums whatever the dtype
        if adj is not None:
            scores = scores - adj[None, :]
        if n_valid is not None and n_valid < b:
            # pad columns must not act as in-batch negatives
            scores = scores.masked_fill((cols >= n_valid)[None, :], NEG)
        eye = (base + cols[:qc.shape[0]])[:, None] == cols[None, :]
        if ids_c is not None:
            scores = scores.masked_fill((col_ids[None, :] == ids_c[:, None]) & ~eye, NEG)
        lse = torch.logsumexp(scores, dim=1)
        pos = torch.sum(torch.where(eye, scores, 0.0), dim=1)  # s_ii
        w = lab_c.float()
        return ((lse - pos) * w).sum(), w.sum()

    tot = torch.zeros((), dtype=torch.float32, device=q.device)
    cnt = torch.zeros((), dtype=torch.float32, device=q.device)
    for lo in range(0, q.shape[0], r):
        args = (q[lo:lo + r], labels[lo:lo + r],
                None if row_ids is None else row_ids[lo:lo + r], row_offset + lo)
        if checkpoint:
            s, n = torch.utils.checkpoint.checkpoint(block_loss, *args, use_reentrant=False)
        else:
            s, n = block_loss(*args)
        tot, cnt = tot + s, cnt + n
    return tot, cnt


def sharded_in_batch_sampled_softmax(
    mesh,
    query_emb: torch.Tensor,  # [B_local, D]: this rank's slice of the batch
    cand_emb: torch.Tensor,  # [B_local, D]
    labels: torch.Tensor,  # [B_local]
    item_ids: torch.Tensor | None = None,  # [B_local]
    log_q: torch.Tensor | None = None,  # [B_local]
    temperature: float = 1.0,
    implementation: str = "auto",
) -> torch.Tensor:
    """The data-parallel in-batch sampled softmax, one rank's part: the
    candidate embeddings, their item ids and logQ all-gathered over the data
    group (the embeddings differentiably: the gradient of the all-gather is
    the reduce-scatter of each rank's dc to the candidate's owner), and this
    rank's `[B_local, B]` stripe of the score matrix at `row_offset = d x
    B_local`: through the fused kernels (#9-#11, their plain versions on CPU
    tensors) where `_use_fused_softmax` takes the stripe's shape, else the
    plain row blocks, never the whole `[B, B]`. The count of label-1 rows is
    summed over the data group (it does not depend on the parameters).
    Returns this rank's loss `num_local / max(den_global, 1)`: its gradients
    summed over data are the global batch's, and so is its value."""
    from two_tower_recommender_model_tpu_torch.parallel.sharded import (
        _all_gather,
        all_gather_rows,
    )

    b_local, d = query_emb.shape
    group, n = mesh.data_group, mesh.data
    b, off = b_local * n, mesh.d * b_local
    c_all = all_gather_rows(cand_emb, group, n)
    ids_all = None if item_ids is None else _all_gather(item_ids.to(torch.int32), group, n)
    lq_all = None if log_q is None else _all_gather(log_q.float(), group, n)
    row_ids = None if item_ids is None else item_ids.to(torch.int32)
    if _use_fused_softmax(b, d, implementation, query_emb.device, b_local):
        num, den = sampled_softmax_fused_parts(query_emb, c_all, labels, row_ids, ids_all,
                                               lq_all, temperature, row_offset=off)
    else:
        r = b_local if b <= 4096 else max(1, min(b_local, (1 << 24) // b))
        num, den = _stripe_parts(query_emb, c_all, labels, row_ids, ids_all, lq_all,
                                 temperature, r, off, checkpoint=b > 4096)
    den = den.detach().clone()
    torch.distributed.all_reduce(den, group=group)
    return num / torch.clamp(den, min=1.0)


def item_log_q_from_counts(counts: torch.Tensor, item_ids: torch.Tensor) -> torch.Tensor:
    """logQ per in-batch item from a corpus count table, the popularity
    correction of in-batch negatives: log(max(count_i, 1) / max(total, 1))."""
    counts = counts.float()
    total = torch.clamp(counts.sum(), min=1.0)
    return torch.log(torch.clamp(counts[item_ids.long()], min=1.0) / total)


def make_loss_fn(name: str, candidate_id_feature: str | None = None,
                 type_weights: tuple[float, ...] | None = None, type_onehot_start: int = 0,
                 temperature: float = 1.0, softmax_implementation: str = "auto", mesh=None):
    """Loss factory: `loss_fn(q, c, batch, log_q=None) -> (loss, logits)`.
    For "sampled_softmax", `candidate_id_feature` names the batch feature
    whose first-slot ids identify the in-batch items (it enables the
    accidental-hit masking). For "weighted_bce", `type_weights` gives one
    weight per interaction type and the one-hot types arrive as dense columns
    `batch.dense[:, type_onehot_start : type_onehot_start + len(type_weights)]`."""
    if name == "bce":
        def loss_fn(q, c, batch, log_q=None):
            logits = torch.sum(q * c, dim=1)
            return bce_with_logits(logits, batch.labels), logits
        return loss_fn
    if name == "weighted_bce":
        if not type_weights:
            raise ValueError('loss="weighted_bce" requires non-empty type_weights')
        lo, hi = type_onehot_start, type_onehot_start + len(type_weights)

        def loss_fn(q, c, batch, log_q=None):
            logits = torch.sum(q * c, dim=1)
            if batch.dense is None:
                raise ValueError("weighted_bce needs dense one-hot type columns in the batch "
                                 "(configure the featurizer's dense_cols)")
            tw = torch.tensor(type_weights, dtype=torch.float32, device=logits.device)
            return weighted_bce_with_logits(logits, batch.labels, batch.dense[:, lo:hi],
                                            tw), logits
        return loss_fn
    if name == "sampled_softmax":
        def loss_fn(q, c, batch, log_q=None):
            logits = torch.sum(q * c, dim=1)
            item_ids = None
            if candidate_id_feature is not None and candidate_id_feature in batch.features:
                item_ids = batch.features[candidate_id_feature].ids[:, 0]
            if mesh is not None:
                loss = sharded_in_batch_sampled_softmax(
                    mesh, q, c, batch.labels, item_ids, log_q, temperature=temperature,
                    implementation=softmax_implementation)
            else:
                loss = in_batch_sampled_softmax(q, c, batch.labels, item_ids, log_q,
                                                temperature=temperature,
                                                implementation=softmax_implementation)
            return loss, logits
        return loss_fn
    raise ValueError(f"unknown loss {name!r}")


def loss_fn_from_config(train_cfg, model_cfg, sharded: bool = False, mesh=None):
    """The training loss of a `TrainConfig` and a `ModelConfig`: the single
    point where the train steps select it. `sharded` with a `mesh` routes the
    sampled softmax through `sharded_in_batch_sampled_softmax` (each rank its
    stripe; the loss is this rank's part, its gradients summed over data the
    global batch's); the sharded step's BCE is `parallel.sharded`'s own."""
    return make_loss_fn(
        train_cfg.loss,
        candidate_id_feature=model_cfg.candidate_tower.features[0],
        type_weights=train_cfg.loss_type_weights,
        type_onehot_start=train_cfg.loss_type_onehot_start,
        temperature=train_cfg.softmax_temperature,
        softmax_implementation=train_cfg.softmax_kernel,
        mesh=mesh if sharded else None)
