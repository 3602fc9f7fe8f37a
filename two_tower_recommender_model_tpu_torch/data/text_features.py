"""Item text features: deterministic text embeddings and similarity.

The port's own copy of `two_tower_recommender_model_tpu/data/text_features.py`,
framework-free (numpy and the standard library; pandas and pyarrow are
imported only inside the functions that return or read them). The embedder
is a feature-hashing n-gram encoder: each token and character n-gram hashes
(blake2b) into one of `dim` slots with a sign, and the vector is
L2-normalised. It stands in for a hosted text encoder's vectors, which
`load_precomputed_embeddings` ingests in the same shape; the consumers
(cosine similarity, the product feature table, the candidate tower's dense
side input) do not care which produced them.
"""

from __future__ import annotations

import hashlib

import numpy as np


def concat_text_fields(*fields: str, sep: str = " ") -> str:
    """The non-empty fields joined by `sep`."""
    return sep.join(str(f) for f in fields if f)


def _stable_hash(token: str, salt: int) -> int:
    h = hashlib.blake2b(f"{salt}:{token}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little")


def embed_text(texts: list[str], dim: int = 256, char_ngrams: tuple[int, ...] = (3, 4),
               lowercase: bool = True) -> np.ndarray:
    """`[len(texts), dim]` f32, L2-normalised hashed n-gram embeddings: the
    whitespace tokens and the character n-grams of " text " each add +-1 at
    their hash's slot."""
    out = np.zeros((len(texts), dim), np.float32)
    for i, text in enumerate(texts):
        if lowercase:
            text = str(text).lower()
        tokens = list(text.split())
        for n in char_ngrams:
            padded = f" {text} "
            tokens.extend(padded[j:j + n] for j in range(len(padded) - n + 1))
        for tok in tokens:
            h = _stable_hash(tok, 0)
            idx = h % dim
            sign = 1.0 if (h >> 32) & 1 else -1.0
            out[i, idx] += sign
        norm = np.linalg.norm(out[i])
        if norm > 0:
            out[i] /= norm
    return out


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise cosine similarity of two `[N, D]` arrays (0 where a row is
    all zeros)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    num = np.einsum("ij,ij->i", a, b)
    den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
    out = np.zeros_like(num)
    np.divide(num, den, out=out, where=den > 0)
    return out


def save_precomputed_embeddings(path: str, ids: np.ndarray, embeddings: np.ndarray,
                                id_col: str = "product_id", emb_col: str = "text_emb") -> None:
    """Write an (id -> embedding) file, 1-based ids (0 is the missing
    sentinel): `.npz` (arrays `id_col`, `emb_col`) or `.parquet` (an id
    column and a list column)."""
    ids = np.asarray(ids)
    embeddings = np.asarray(embeddings, np.float32)
    if path.endswith(".npz"):
        np.savez(path, **{id_col: ids, emb_col: embeddings})
    elif path.endswith(".parquet"):
        import pyarrow as pa
        import pyarrow.parquet as pq

        pq.write_table(pa.table({id_col: ids, emb_col: list(embeddings)}), path)
    else:
        raise ValueError(f"unsupported embedding file {path!r} (.npz|.parquet)")


def load_precomputed_embeddings(path: str, id_col: str = "product_id",
                                emb_col: str = "text_emb",
                                num_ids: int | None = None) -> np.ndarray:
    """A precomputed (id -> embedding) file (`.npz` with arrays `id_col` /
    `emb_col` or `ids` / `embeddings`; `.parquet` with an id column and a
    list-of-float column) as a dense `[num_ids + 1, D]` f32 lookup table,
    row 0 the missing-id sentinel (zeros). Checks: integer ids >= 1, no
    duplicates, one embedding per id, one width."""
    if path.endswith(".npz"):
        data = np.load(path)

        def pick(primary, fallback):
            if primary in data.files:
                return np.asarray(data[primary])
            if fallback in data.files:
                return np.asarray(data[fallback])
            raise ValueError(f"{path}: missing array {primary!r} (or {fallback!r}); "
                             f"has {data.files}")
        ids = pick(id_col, "ids")
        emb = pick(emb_col, "embeddings")
    elif path.endswith(".parquet"):
        import pyarrow.parquet as pq

        t = pq.read_table(path)
        if id_col not in t.column_names or emb_col not in t.column_names:
            raise ValueError(f"{path}: needs columns {id_col!r} and {emb_col!r}; "
                             f"has {t.column_names}")
        ids = t.column(id_col).to_numpy()
        emb = np.stack(t.column(emb_col).to_pylist())
    else:
        raise ValueError(f"unsupported embedding file {path!r} (.npz|.parquet)")

    ids = np.asarray(ids)
    emb = np.asarray(emb, np.float32)
    if not np.issubdtype(ids.dtype, np.integer):
        raise ValueError(f"{id_col} must be integers, got {ids.dtype}")
    if emb.ndim != 2 or len(ids) != len(emb):
        raise ValueError(f"expected [N] ids + [N, D] embeddings, got {ids.shape} / {emb.shape}")
    if len(ids) and ids.min() < 1:
        raise ValueError("ids must be >= 1 (0 is the missing-id sentinel)")
    if len(np.unique(ids)) != len(ids):
        raise ValueError(f"{id_col} contains duplicate ids")
    n = int(num_ids if num_ids is not None else (ids.max() if len(ids) else 0))
    if len(ids) and ids.max() > n:
        raise ValueError(f"id {ids.max()} exceeds num_ids={n}")
    table = np.zeros((n + 1, emb.shape[1]), np.float32)
    table[ids] = emb
    return table


def build_product_text_features(products, text_cols: tuple[str, ...] = ("department", "aisle",
                                                                        "product_name"),
                                id_col: str = "product_id", dim: int = 256):
    """The product feature table: (a pandas DataFrame of `id_col` and a
    `text_emb` list column, the `[N, dim]` matrix in row order) from a
    DataFrame with `id_col` and the text columns. pandas is imported here."""
    import pandas as pd

    texts = [concat_text_fields(*(row[c] for c in text_cols)) for _, row in products.iterrows()]
    emb = embed_text(texts, dim=dim)
    table = pd.DataFrame({id_col: products[id_col].to_numpy(), "text_emb": list(emb)})
    return table, emb
