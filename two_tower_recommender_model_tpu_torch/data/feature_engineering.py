"""Offline feature engineering, columnar and vectorised.

The port's own copy of `two_tower_recommender_model_tpu/data/feature_engineering.py`,
on numpy alone: each function takes and returns `data.Frame`s and gives the
reference's pandas results bit for bit.

- positive pairs: distinct (user, product) from interactions, label 1, in
  order of first appearance (`drop_duplicates`);
- random negatives: per user, `len(positives)` items drawn from the
  catalogue minus the user's positives, label 0, unioned 1:1;
- per-user split: rows shuffled (`df.sample(frac=1.0, random_state=seed)`
  is `RandomState(seed).permutation`), every user's first row forced into
  train, the rest cut at per-user row-percent fractions 80/10/10, with the
  "no user lacks train rows" invariant asserted;
- id indexing: contiguous 1-based indices in order of first appearance
  (`pd.unique`); 0 stays the missing-id sentinel the featurizer drops.
"""

from __future__ import annotations

import numpy as np

from two_tower_recommender_model_tpu_torch.data import Frame


def _first_rows(*keys: np.ndarray) -> np.ndarray:
    """Row indices of the first occurrence of each distinct key tuple, in
    row order."""
    combined = np.zeros(len(keys[0]), np.int64)
    for key in keys:  # dense ranks keep the combined key within int64
        uniq, inv = np.unique(key, return_inverse=True)
        combined = combined * len(uniq) + inv
    _, first = np.unique(combined, return_index=True)
    return np.sort(first)


def _group_positions(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(position of each row within its key's group, in row order; the
    group's size): `groupby(sort=False).cumcount()` and `transform("size")`."""
    n = len(keys)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]]) if n else np.zeros(0, np.int64)
    sizes = np.diff(np.r_[starts, n])
    pos_sorted = np.arange(n) - np.repeat(starts, sizes)
    row_idx = np.empty(n, np.int64)
    row_idx[order] = pos_sorted
    counts = np.empty(n, np.int64)
    counts[order] = np.repeat(sizes, sizes)
    return row_idx, counts


def build_positive_pairs(interactions: Frame, user_col: str = "user_id",
                         item_col: str = "product_id") -> Frame:
    """Distinct (user, item) with label=1, in order of first appearance."""
    first = _first_rows(interactions[user_col], interactions[item_col])
    return {user_col: interactions[user_col][first], item_col: interactions[item_col][first],
            "label": np.ones(len(first), np.int64)}


def sample_negatives(
    positives: Frame,
    all_items: np.ndarray,
    seed: int = 0,
    user_col: str = "user_id",
    item_col: str = "product_id",
) -> Frame:
    """Per user, sample len(user_positives) items uniformly from the
    complement of the user's positives. Vectorised global rejection
    sampling: one candidate slot per needed negative; every round rejects
    candidates that collide with the user's positives or an accepted
    negative (sorted int64 (user, item) keys + searchsorted) and redraws only
    the unfilled slots."""
    rng = np.random.default_rng(seed)
    all_items = np.asarray(all_items)
    unique_items = np.unique(all_items)

    users_arr = np.asarray(positives[user_col])
    items_arr = np.asarray(positives[item_col])
    uniq_users, pos_counts = np.unique(users_arr, return_counts=True)
    # membership keys: user rank * K + item index (dense indices keep the key in int64)
    k_items = len(unique_items)
    pos_item_idx = np.searchsorted(unique_items, items_arr)
    user_rank_arr = np.searchsorted(uniq_users, users_arr)
    pos_keys = np.sort(user_rank_arr.astype(np.int64) * k_items + pos_item_idx)

    # negatives per user capped by the complement size (so the loop ends);
    # positives are distinct, so a user's group size is its distinct positives
    complement = k_items - pos_counts
    if (complement <= 0).any():
        bad = uniq_users[complement <= 0][0]
        raise ValueError(f"user {bad!r} has positives covering the whole catalog; "
                         "cannot sample distinct negatives")
    take_n = np.minimum(pos_counts, complement)

    slot_user_rank = np.repeat(np.arange(len(uniq_users), dtype=np.int64), take_n)
    total = len(slot_user_rank)
    filled_item_idx = np.empty(total, np.int64)
    unfilled = np.arange(total)
    taken_keys = pos_keys  # membership: positives + accepted negatives
    while len(unfilled):
        cand = rng.integers(0, k_items, size=len(unfilled))
        keys = slot_user_rank[unfilled] * k_items + cand
        # reject: collision with positives/accepted, or a duplicate within the round
        first = np.zeros(len(keys), bool)
        order = np.argsort(keys, kind="stable")
        ks = keys[order]
        first[order] = np.concatenate([[True], ks[1:] != ks[:-1]])
        pos_hit = np.searchsorted(taken_keys, keys)
        collide = ((pos_hit < len(taken_keys))
                   & (taken_keys[np.minimum(pos_hit, len(taken_keys) - 1)] == keys))
        ok = first & ~collide
        filled_item_idx[unfilled[ok]] = cand[ok]
        taken_keys = np.sort(np.concatenate([taken_keys, keys[ok]]))
        unfilled = unfilled[~ok]
    return {user_col: uniq_users[slot_user_rank], item_col: unique_items[filled_item_idx],
            "label": np.zeros(total, np.int64)}


def union_pos_neg(pos: Frame, neg: Frame) -> Frame:
    """1:1 union: positives' rows, then negatives'."""
    if list(pos) != list(neg):
        raise ValueError(f"union of frames with columns {list(pos)} and {list(neg)}")
    return {k: np.concatenate([pos[k], neg[k]]) for k in pos}


def per_user_split(
    df: Frame,
    seed: int = 0,
    fractions: tuple[float, float] = (0.8, 0.9),
    user_col: str = "user_id",
) -> Frame:
    """Shuffle the rows and add a `split` column ('train'/'val'/'test'): the
    first row of every user (in shuffled order) is forced into train, the
    rest cut at the per-user row-percent fractions."""
    perm = np.random.RandomState(seed).permutation(len(df[user_col]))
    df = {k: v[perm] for k, v in df.items()}
    row_idx, counts = _group_positions(df[user_col])
    pct = (row_idx + 1) / counts
    split = np.where(pct <= fractions[0], "train", np.where(pct <= fractions[1], "val", "test"))
    df["split"] = np.where(row_idx == 0, "train", split)  # every user trains
    assert_user_coverage(df, user_col)
    return df


def assert_user_coverage(df: Frame, user_col: str = "user_id") -> None:
    """The split invariant: no user may lack train rows."""
    users = np.unique(df[user_col])
    train_users = np.unique(df[user_col][df["split"] == "train"])
    missing = np.setdiff1d(users, train_users)
    if len(missing):
        raise AssertionError(
            f"{len(missing)} users have no train rows (e.g. {sorted(missing.tolist())[:5]})")


def index_ids(df: Frame, cols: tuple[str, ...] = ("user_id", "product_id")
              ) -> tuple[Frame, dict[str, dict]]:
    """Contiguous 1-based indexing per column, in order of first appearance;
    index 0 is reserved for "missing" (the featurizer's falsy-drop
    sentinel). Returns (df with `{col}_index` columns, {col: {original ->
    index}})."""
    mappings: dict[str, dict] = {}
    out = dict(df)
    for col in cols:
        uniq, first, inv = np.unique(df[col], return_index=True, return_inverse=True)
        by_appearance = np.argsort(first, kind="stable")
        index_of_sorted = np.empty(len(uniq), np.int64)
        index_of_sorted[by_appearance] = np.arange(1, len(uniq) + 1)
        mappings[col] = {v: i + 1 for i, v in enumerate(uniq[by_appearance])}
        out[f"{col}_index"] = index_of_sorted[inv.reshape(-1)]
    return out, mappings


def binarize_ratings(ratings: np.ndarray, threshold: float | None = None) -> np.ndarray:
    """Explicit ratings -> binary labels: below the (mean) threshold -> 0,
    else 1."""
    ratings = np.asarray(ratings, dtype=np.float64)
    if threshold is None:
        threshold = float(ratings.mean())
    return (ratings >= threshold).astype(np.int64)


def splits_to_columns(
    df: Frame,
    user_col: str = "user_id_index",
    item_col: str = "product_id_index",
) -> dict[str, dict[str, np.ndarray]]:
    """Per-split dict-of-columns ready for the TTRS shard writer."""
    out = {}
    for split in ("train", "val", "test"):
        m = df["split"] == split
        out[split] = {
            "user_id": df[user_col][m].astype(np.int64),
            "product_id": df[item_col][m].astype(np.int64),
            "label": df["label"][m].astype(np.int64),
        }
    return out
