"""Full-corpus tower embedding export and the retrieval evaluation.

Port of `two_tower_recommender_model_tpu/evaluation/retrieval.py`:
`export_feature_embeddings`, `retrieval_metrics`, `split_positives`,
`evaluate_retrieval`, `make_retrieval_eval_fn` and `per_user_retrieval_table`.
The row gather goes through `pooled_lookup` with one slot and weight 1, so on
a CUDA model the export runs the pooled-gather kernel too; an int8 table's
rows come straight
from the int8 gather kernel (the reference dequantizes the whole table
first; the rows are the same). `per_user_retrieval_table` returns a pandas
DataFrame, as the reference's does: pandas is imported inside it, so
importing this module (and the port) loads no pandas.
"""

from __future__ import annotations

import numpy as np
import torch

from two_tower_recommender_model_tpu_torch.config import ModelConfig
from two_tower_recommender_model_tpu_torch.models.two_tower import TwoTower, torch_dtype
from two_tower_recommender_model_tpu_torch.ops.embedding_ops import pooled_lookup
from two_tower_recommender_model_tpu_torch.ops.topk import chunked_topk


def _tower_for_feature(model_cfg: ModelConfig, feature_name: str):
    for key, tower in (("query_tower", model_cfg.query_tower),
                       ("candidate_tower", model_cfg.candidate_tower)):
        if feature_name in tower.features:
            return key, tower
    raise ValueError(f"feature {feature_name!r} feeds no tower")


@torch.no_grad()
def export_feature_embeddings(
    model: TwoTower,
    feature_name: str,
    ids: np.ndarray | None = None,
    batch_size: int = 8192,
    dense: np.ndarray | None = None,
) -> torch.Tensor:
    """Tower-space embeddings `[len(ids), out]` on the model's device for
    every id of one feature (all of them when `ids` is None). The tower's
    other features pool to zero (the reference's 0-length-bag trick), and
    `dense` ([len(ids), tower.dense_dim]) supplies its dense side input per
    id, zeros when omitted."""
    cfg = model.cfg
    tower_key, tower = _tower_for_feature(cfg, feature_name)
    fc = cfg.feature(feature_name)
    table_cfg = cfg.table(fc.table)
    table = model.tables[fc.table]
    mlp = getattr(model, tower_key)
    device = table.device
    compute_dtype = torch_dtype(cfg.compute_dtype)
    if ids is None:
        ids = np.arange(table_cfg.num_embeddings)
    # the featurizer's modulo hash: raw ids outside [0, N) hit the row they trained on
    ids = np.asarray(ids) % table_cfg.num_embeddings
    if dense is not None:
        dense = np.asarray(dense, np.float32)
        if dense.shape != (len(ids), tower.dense_dim):
            raise ValueError(f"dense {dense.shape} != ({len(ids)}, {tower.dense_dim})")
        dense = torch.from_numpy(dense).to(device)
    ids_dev = torch.from_numpy(ids.astype(np.int32).reshape(-1, 1)).to(device)

    out = []
    for start in range(0, len(ids), batch_size):
        chunk = ids_dev[start : start + batch_size]
        ones = torch.ones(chunk.shape, dtype=torch.float32, device=device)
        rows = pooled_lookup(table, chunk, ones, "sum", compute_dtype)
        xs = []
        for f in tower.features:
            if f == feature_name:
                xs.append(rows)
            else:
                dim = cfg.feature_table(f).embedding_dim
                xs.append(rows.new_zeros((rows.shape[0], dim)))
        if tower.dense_dim:
            xs.append(rows.new_zeros((rows.shape[0], tower.dense_dim)) if dense is None
                      else dense[start : start + batch_size].to(rows.dtype))
        x = torch.cat(xs, dim=1) if len(xs) > 1 else xs[0]
        out.append(mlp(x, compute_dtype))
    if not out:
        return torch.empty((0, tower.layer_sizes[-1]), dtype=compute_dtype, device=device)
    return torch.cat(out)


def retrieval_metrics(
    pred_ids: np.ndarray,  # [U, k] retrieved ids, best first
    targets: list,  # per-user iterable of relevant ids
    ks: tuple[int, ...] = (10, 100),
) -> dict[str, float]:
    """Per-user retriever metrics averaged over the users that have targets:
    mrr, and recall, precision, hit rate and ndcg at each k. Recall divides
    by the number of targets, not by min(targets, k): a user with more than k
    held-out positives cannot reach recall 1."""
    pred_ids = np.asarray(pred_ids)
    max_k = pred_ids.shape[1]
    out: dict[str, list[float]] = {}
    for k in ks:
        if k > max_k:
            raise ValueError(f"k={k} > retrieved {max_k}")
    for preds, tgt in zip(pred_ids, targets):
        tgt = set(int(t) for t in tgt)
        if not tgt:
            continue
        hits = np.isin(preds, np.fromiter(tgt, dtype=np.int64)).astype(np.float64)
        first_hit = np.argmax(hits) if hits.any() else None
        out.setdefault("mrr", []).append(0.0 if first_hit is None else 1.0 / (first_hit + 1))
        for k in ks:
            h = hits[:k]
            rel = h.sum()
            out.setdefault(f"recall_at_{k}", []).append(rel / len(tgt))
            out.setdefault(f"precision_at_{k}", []).append(rel / k)
            out.setdefault(f"hit_rate_at_{k}", []).append(1.0 if rel > 0 else 0.0)
            dcg = (h / np.log2(np.arange(2, k + 2))).sum()
            ideal = (1.0 / np.log2(np.arange(2, min(len(tgt), k) + 2))).sum()
            out.setdefault(f"ndcg_at_{k}", []).append(dcg / ideal if ideal > 0 else 0.0)
    return {name: float(np.mean(vals)) for name, vals in out.items()}


def split_positives(
    split_path: str,
    user_col: str = "user_id",
    item_col: str = "product_id",
    label_col: str = "label",
) -> dict[int, list]:
    """Held-out positives grouped per user from a TTRS split directory (raw
    columns or pre-packed), in the split's row order: the eval set of the
    retrieval protocol."""
    from two_tower_recommender_model_tpu_torch.data.loader import StreamLoader
    from two_tower_recommender_model_tpu_torch.data.shards import ShardedDataset

    dataset = ShardedDataset(split_path)
    packed_meta = dataset.index.get("packed")
    if packed_meta:
        # the feature -> slot mapping comes from the dataset's RECORDED layout
        # (multi-slot features or another feature order shift the slots)
        slot_of, off = {}, 0
        for name, L, _n in packed_meta["slots"]:
            slot_of[name] = off
            off += L
        if user_col not in slot_of or item_col not in slot_of:
            raise ValueError(f"packed split {split_path}: features {list(slot_of)} do not "
                             f"include {user_col!r}/{item_col!r}")
        u_slot, i_slot = slot_of[user_col], slot_of[item_col]
    columns = None if packed_meta else [user_col, item_col, label_col]
    user_positives: dict[int, list] = {}
    loader = StreamLoader(dataset, 1 << 16, shuffle=False, drop_last=False, columns=columns)
    for cols in loader:
        if packed_meta:
            ids = np.asarray(cols["packed_ids"])
            us = ids[:, u_slot]
            if packed_meta["pack_label"]:
                labels = (ids[:, 0] >> 30) & 1  # the label bit rides bit 30 of slot 0
                if u_slot == 0:
                    us = us & ((1 << 30) - 1)
            else:
                labels = np.asarray(cols["labels"])
            ps = ids[:, i_slot]
            if packed_meta["pack_label"] and i_slot == 0:
                ps = ps & ((1 << 30) - 1)
        else:
            labels = np.asarray(cols[label_col])
            us, ps = np.asarray(cols[user_col]), np.asarray(cols[item_col])
        m = labels == 1
        for u, p in zip(us[m], ps[m]):
            user_positives.setdefault(int(u), []).append(int(p))
    return user_positives


def evaluate_retrieval(
    model: TwoTower,
    user_positives: dict[int, list],  # user id -> held-out relevant item ids
    query_feature: str = "user_id",
    candidate_feature: str = "product_id",
    k: int = 100,
    max_users: int = 10_000,
    ks: tuple[int, ...] = (10, 100),
    exclude_item_zero: bool = True,
    query_dense: np.ndarray | None = None,  # [num_query_ids_total, Dq] per raw id
    candidate_dense: np.ndarray | None = None,  # [num_items, Dc] per raw id
) -> dict[str, float]:
    """The retrieval protocol: held-out positives per user, an exact top-k
    search per user over the whole corpus (at most `max_users` users, in id
    order), and the averaged retriever metrics. The model carries its config,
    so the reference's `(params, model_cfg)` pair is one argument here."""
    if not user_positives:
        raise ValueError("user_positives is empty: the split has no label == 1 rows to "
                         "evaluate against (check the split / label column)")
    users = np.array(sorted(user_positives.keys())[:max_users])
    user_emb = export_feature_embeddings(
        model, query_feature, ids=users,
        dense=None if query_dense is None else np.asarray(query_dense)[users])
    item_emb = export_feature_embeddings(model, candidate_feature, dense=candidate_dense)
    start = 1 if exclude_item_zero else 0  # id 0 is the missing-id sentinel
    _, idx = chunked_topk(user_emb, item_emb[start:], k=k)
    pred_ids = idx.cpu().numpy() + start
    metrics = retrieval_metrics(pred_ids, [user_positives[u] for u in users], ks=ks)
    metrics["num_users"] = float(len(users))
    return metrics


def make_retrieval_eval_fn(
    model_cfg: ModelConfig,
    user_positives: dict[int, list],
    query_feature: str = "user_id",
    candidate_feature: str = "product_id",
    k: int = 100,
    ks: tuple[int, ...] = (100,),
    max_users: int = 2_000,
    metric_prefix: str = "val_",
    params_fn=None,
    **eval_kwargs,
):
    """The per-epoch retrieval hook of `train_val_test(retrieval_eval_fn=...)`:
    `fn(state) -> {"val_recall_at_100": ...}` by the exact top-k on a user
    subsample. Validation AUROC is no selection signal for the in-batch
    sampled softmax (it can fall while recall holds); with
    `select_best="val_recall_at_100"` the loop keeps the epoch that retrieves
    best. `params_fn(state) -> model` overrides the default `full_params`;
    `model_cfg` is the reference's signature (the state's model carries it)."""
    del model_cfg

    def fn(state) -> dict[str, float]:
        if params_fn is not None:
            model = params_fn(state)
        else:
            from two_tower_recommender_model_tpu_torch.train.step import full_params

            model = full_params(state)
        m = evaluate_retrieval(model, user_positives, query_feature=query_feature,
                               candidate_feature=candidate_feature, k=k, max_users=max_users,
                               ks=ks, **eval_kwargs)
        return {f"{metric_prefix}{name}": v for name, v in m.items()}

    return fn


def per_user_retrieval_table(
    pred_ids: np.ndarray, users: np.ndarray, targets: list, ks: tuple[int, ...] = (100,)
):
    """The per-user eval table, a pandas DataFrame: one row per user with
    its targets, its predictions and its own retriever metrics
    (`retrieval_metrics` of that user alone)."""
    import pandas as pd

    rows = []
    for u, preds, tgt in zip(users, np.asarray(pred_ids), targets):
        m = retrieval_metrics(preds[None, :], [tgt], ks=ks)
        rows.append({
            "user_id": u,
            "product_id_list": list(map(int, tgt)),
            "product_id_pred": [int(p) for p in preds],
            **m,
        })
    return pd.DataFrame(rows)
