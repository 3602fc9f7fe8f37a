"""Synthetic clickstream generator.

The port's own copy of `two_tower_recommender_model_tpu/data/synthetic.py`
(numpy only, no framework), so the port's training drives need nothing of the
JAX package. The same seed, split and start give the same arrays as the JAX
package's copy (`tests/test_torch_data.py` holds them equal).

Each user has a latent preference vector and each item a latent attribute
vector; positives are the best of a few preference-scored candidates and
negatives are uniform, labels {0, 1}. Deterministic in (seed, split, start).
"""

from __future__ import annotations

import zlib

import numpy as np


class SyntheticClickstream:
    """Generates (user_id, product_id, label) interaction batches.

    Ids are 1-based (0 is reserved as the reference's "falsy = missing"
    sentinel, `03_model_training.py:358-365`).
    """

    def __init__(
        self,
        num_users: int = 10_000,
        num_items: int = 2_000,
        latent_dim: int = 16,
        seed: int = 0,
        noise: float = 0.25,
        popularity: float = 0.0,
    ):
        """`popularity > 0` gives items a Zipf-like draw distribution with
        exponent `popularity` for the positive-candidate pool (real catalogs
        are heavy-tailed; the resulting popularity signal is what makes
        held-out pairs predictable at low observations-per-user)."""
        self.num_users = num_users
        self.num_items = num_items
        rng = np.random.default_rng(seed)
        self._user_latent = rng.normal(size=(num_users + 1, latent_dim)).astype(np.float32)
        self._item_latent = rng.normal(size=(num_items + 1, latent_dim)).astype(np.float32)
        self._user_latent /= np.linalg.norm(self._user_latent, axis=1, keepdims=True)
        self._item_latent /= np.linalg.norm(self._item_latent, axis=1, keepdims=True)
        self.latent_dim = latent_dim
        self.noise = noise
        self.seed = seed
        self.popularity = popularity
        if popularity > 0:
            ranks = np.arange(1, num_items + 1, dtype=np.float64)
            w = ranks ** (-popularity)
            # random rank assignment so item id does not encode popularity
            w = w[rng.permutation(num_items)]
            self._item_probs = w / w.sum()
        else:
            self._item_probs = None

    def _draw_items(self, rng, size):
        if self._item_probs is None:
            return rng.integers(1, self.num_items + 1, size=size)
        return rng.choice(self.num_items, size=size, p=self._item_probs) + 1

    def _affinity(self, users: np.ndarray, items: np.ndarray) -> np.ndarray:
        return np.einsum("bd,bd->b", self._user_latent[users], self._item_latent[items])

    def sample(self, n: int, split: str = "train", start: int = 0) -> dict[str, np.ndarray]:
        """Draw n interactions. Half positives (high-affinity items for the
        user), half uniform negatives — mirroring the 1:1 pos/neg union of
        `02_feature_engineering.py:74`."""
        # zlib.crc32, not hash(): str hash is randomized per process
        # (PYTHONHASHSEED), which would break cross-process determinism
        split_key = zlib.crc32(split.encode()) & 0x7FFFFFFF
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, split_key, start]))
        users = rng.integers(1, self.num_users + 1, size=n)
        # Candidate pool per row; pick argmax-affinity among k candidates for
        # positives => preference-correlated positives (popularity-weighted
        # candidates when configured => popular items are bought more).
        k = 8
        cands = self._draw_items(rng, (n, k))
        aff = np.einsum("bd,bkd->bk", self._user_latent[users], self._item_latent[cands])
        aff += rng.normal(scale=self.noise, size=aff.shape).astype(np.float32)
        pos_items = cands[np.arange(n), aff.argmax(axis=1)]
        neg_items = rng.integers(1, self.num_items + 1, size=n)
        labels = rng.random(n) < 0.5
        items = np.where(labels, pos_items, neg_items)
        return {
            "user_id": users.astype(np.int64),
            "product_id": items.astype(np.int64),
            "label": labels.astype(np.int64),
        }

    def batches(self, batch_size: int, num_batches: int, split: str = "train"):
        """Yield dict-of-columns batches (the loader-facing iterator shape)."""
        for i in range(num_batches):
            yield self.sample(batch_size, split=split, start=i)

    def ground_truth_topk(self, user_ids: np.ndarray, k: int) -> np.ndarray:
        """True top-k items per user under the latent model (for retrieval
        eval sanity tests)."""
        scores = self._user_latent[user_ids] @ self._item_latent[1:].T
        top = np.argsort(-scores, axis=1)[:, :k] + 1
        return top
