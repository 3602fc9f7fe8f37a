"""Schema-faithful Instacart replica generator.

The port's own copy of `two_tower_recommender_model_tpu/data/replica.py`, on
numpy alone: the same arguments draw the same numbers in the same order and
write the same bytes as the reference's pandas `to_csv` (header line, no
index column, `days_since_prior_order` as an integer or an empty field).
Whole columns are formatted at once by `_csv_bytes`, not row by row: at the
real scale the prior file has ~30M rows.

It writes the file set and schemas the real dataset ships, at the real scale
by default (206,209 users, 49,688 products, ~3.2M orders, ~30M prior
order-products rows), so the whole pipeline (fetch -> prepare -> train ->
retrieval eval) runs end to end without a download:

- baskets are drawn from a latent-preference model (user x item affinity +
  Zipf item popularity + noise), so two-tower training has signal to
  recover;
- per-user order counts (4..100), basket sizes (~9) and the prior/train
  eval_set split (the last order of each user is "train") follow the
  published dataset's shapes.

Files written: orders.csv, products.csv, order_products__prior.csv,
order_products__train.csv, departments.csv, aisles.csv.
"""

from __future__ import annotations

import os

import numpy as np

REAL_USERS = 206_209
REAL_PRODUCTS = 49_688
REAL_DEPARTMENTS = 21
REAL_AISLES = 134


def _positions_within_groups(sizes: np.ndarray) -> np.ndarray:
    """[1..s0, 1..s1, ...] for group sizes, vectorised."""
    total = int(sizes.sum())
    starts = np.cumsum(sizes) - sizes
    return np.arange(total, dtype=np.int64) - np.repeat(starts, sizes) + 1


def _int_field(v: np.ndarray, empty: np.ndarray | None = None) -> np.ndarray:
    """Non-negative integers as right-aligned ASCII digits, `[n, width]`
    uint8 with 0 bytes before the digits (and in every byte of an `empty`
    row), which `_csv_bytes` drops."""
    v = np.asarray(v, np.int64)
    if v.size and v.min() < 0:
        raise ValueError("the replica writer formats non-negative integers only")
    width = len(str(int(v.max()))) if v.size else 1
    out = np.zeros((len(v), width), np.uint8)
    for k in range(width):  # the k-th digit from the right, where the number has one
        digit = (v // 10**k) % 10 + ord("0")
        out[:, width - 1 - k] = np.where((v >= 10**k) | (k == 0), digit, 0)
    if empty is not None:
        out[empty] = 0
    return out


def _str_field(s: np.ndarray) -> np.ndarray:
    """Plain ASCII strings as `[n, width]` uint8, 0-padded on the right."""
    b = np.asarray(s).astype(np.bytes_).view(np.uint8).reshape(len(s), -1)
    if np.isin(b, np.frombuffer(b',"\n\r', np.uint8)).any():
        raise ValueError("the replica writer does not quote fields")
    return b


def _csv_bytes(fields: list[np.ndarray], header: str | None) -> bytes:
    """The CSV text of `[n, width]` uint8 fields joined by commas, one row a
    line: a byte matrix with the separators as columns, its 0 bytes dropped."""
    n = len(fields[0])
    sep = np.full((n, 1), ord(","), np.uint8)
    parts = []
    for f in fields:
        parts += [f, sep]
    parts[-1] = np.full((n, 1), ord("\n"), np.uint8)
    flat = np.hstack(parts).ravel()
    body = flat[flat != 0].tobytes()
    return body if header is None else (header + "\n").encode() + body


def _write_csv(path: str, columns: dict[str, np.ndarray], header: bool = True,
               mode: str = "w") -> None:
    with open(path, mode + "b") as f:
        f.write(_csv_bytes(list(columns.values()), ",".join(columns) if header else None))


def write_instacart_replica(
    out_dir: str,
    num_users: int = REAL_USERS,
    num_products: int = REAL_PRODUCTS,
    mean_orders_per_user: float = 15.6,
    mean_basket: float = 9.0,
    latent_dim: int = 4,
    popularity: float = 1.0,
    noise: float = 0.35,
    seed: int = 0,
    chunk_rows: int = 4_000_000,
) -> dict:
    """Generate the CSV set. Returns summary counts. Memory-bounded: basket
    sampling and CSV writing stream in `chunk_rows` chunks."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)

    # --- products / departments / aisles -------------------------------
    dept = np.arange(1, REAL_DEPARTMENTS + 1)
    _write_csv(os.path.join(out_dir, "departments.csv"), {
        "department_id": _int_field(dept),
        "department": _str_field(np.char.add("department_", dept.astype(str)))})
    aisle = np.arange(1, REAL_AISLES + 1)
    _write_csv(os.path.join(out_dir, "aisles.csv"), {
        "aisle_id": _int_field(aisle),
        "aisle": _str_field(np.char.add("aisle_", aisle.astype(str)))})
    pid = np.arange(1, num_products + 1)
    _write_csv(os.path.join(out_dir, "products.csv"), {
        "product_id": _int_field(pid),
        "product_name": _str_field(np.char.add("product_", pid.astype(str))),
        "aisle_id": _int_field(rng.integers(1, REAL_AISLES + 1, num_products)),
        "department_id": _int_field(rng.integers(1, REAL_DEPARTMENTS + 1, num_products))})

    # --- latent preference model (the signal the model must recover) ----
    user_latent = rng.normal(size=(num_users + 1, latent_dim)).astype(np.float32)
    item_latent = rng.normal(size=(num_products + 1, latent_dim)).astype(np.float32)
    # Zipf-ish popularity over items (popular products bought by everyone)
    pop = 1.0 / np.arange(1, num_products + 1) ** popularity
    item_perm = rng.permutation(num_products) + 1  # which ids are popular
    pop_p = pop / pop.sum()

    # --- orders ---------------------------------------------------------
    # per-user order counts: clipped lognormal, 4..100 (real data's bounds)
    counts = np.clip(
        rng.lognormal(mean=np.log(mean_orders_per_user) - 0.25, sigma=0.7, size=num_users),
        4, 100,
    ).astype(np.int64)
    total_orders = int(counts.sum())
    order_user = np.repeat(np.arange(1, num_users + 1), counts)
    order_number = _positions_within_groups(counts)
    order_id = rng.permutation(total_orders) + 1  # ids not sorted by user (real data)
    eval_is_train = order_number == np.repeat(counts, counts)  # each user's last order
    days = rng.integers(1, 31, total_orders)  # the first order's field stays empty
    _write_csv(os.path.join(out_dir, "orders.csv"), {
        "order_id": _int_field(order_id),
        "user_id": _int_field(order_user),
        "eval_set": _str_field(np.where(eval_is_train, "train", "prior")),
        "order_number": _int_field(order_number),
        "order_dow": _int_field(rng.integers(0, 7, total_orders)),
        "order_hour_of_day": _int_field(rng.integers(0, 24, total_orders)),
        "days_since_prior_order": _int_field(days, empty=order_number == 1)})

    # --- order products (prior + train), chunked ------------------------
    basket = np.clip(rng.poisson(mean_basket - 1, total_orders) + 1, 1, 60)
    total_rows = int(basket.sum())
    row_order_idx = np.repeat(np.arange(total_orders), basket)
    cart_pos = _positions_within_groups(basket)

    def sample_items(user_ids: np.ndarray, block_rng) -> np.ndarray:
        """Popularity-weighted candidates, pick argmax user-affinity of k:
        preference-correlated, popularity-skewed baskets."""
        k = 4
        n = len(user_ids)
        cands = item_perm[block_rng.choice(num_products, size=(n, k), p=pop_p)]
        aff = np.einsum("nd,nkd->nk", user_latent[user_ids], item_latent[cands])
        aff += block_rng.normal(scale=noise * (aff.std() + 1e-6), size=aff.shape)
        return cands[np.arange(n), aff.argmax(axis=1)]

    paths = {
        "prior": os.path.join(out_dir, "order_products__prior.csv"),
        "train": os.path.join(out_dir, "order_products__train.csv"),
    }
    rows_out = {"prior": 0, "train": 0}
    header = {"prior": True, "train": True}
    for lo in range(0, total_rows, chunk_rows):
        hi = min(lo + chunk_rows, total_rows)
        oi = row_order_idx[lo:hi]
        block_rng = np.random.default_rng(np.random.SeedSequence([seed, 7, lo]))
        items = sample_items(order_user[oi], block_rng)
        cols = {
            "order_id": order_id[oi],
            "product_id": items,
            "add_to_cart_order": cart_pos[lo:hi],
            "reordered": block_rng.integers(0, 2, hi - lo),
        }
        train_mask = eval_is_train[oi]
        for which, m in (("prior", ~train_mask), ("train", train_mask)):
            if not m.any():
                continue
            _write_csv(paths[which], {k: _int_field(v[m]) for k, v in cols.items()},
                       header=header[which], mode="w" if header[which] else "a")
            header[which] = False
            rows_out[which] += int(m.sum())

    return {
        "users": num_users,
        "products": num_products,
        "orders": total_orders,
        "prior_rows": rows_out["prior"],
        "train_rows": rows_out["train"],
    }
