"""Online retrieval service: user -> top-k items, as a callable and over HTTP.

Port of `two_tower_recommender_model_tpu/serving/retrieval_service.py`
(single device): the item corpus is embedded once (full-corpus export) and
kept on the model's device; each query embeds the user(s) and runs the
exact chunked top-k. Item 0 (the missing-id sentinel) is left out of the
corpus by default. The multi-device (`mesh`) form is not ported yet.

HTTP surface (added to `ModelServer` when constructed with a
`RetrievalService`):

    POST /retrieve  {"user_id": [u1, u2], "k": 10}
                 -> {"items": [[...], [...]], "scores": [[...], [...]]}
"""

from __future__ import annotations

import numpy as np
import torch

from two_tower_recommender_model_tpu_torch.evaluation.retrieval import export_feature_embeddings
from two_tower_recommender_model_tpu_torch.models.two_tower import TwoTower
from two_tower_recommender_model_tpu_torch.ops.topk import chunked_topk


class RetrievalService:
    def __init__(
        self,
        model: TwoTower,
        query_feature: str = "user_id",
        candidate_feature: str = "product_id",
        exclude_item_zero: bool = True,
        max_k: int = 1000,
    ):
        self.query_feature = query_feature
        self.candidate_feature = candidate_feature
        self.max_k = max_k
        self._start = 1 if exclude_item_zero else 0
        self.refresh(model)

    @torch.no_grad()
    def retrieve(self, user_ids, k: int = 100) -> tuple[np.ndarray, np.ndarray]:
        """(items [U, k], scores [U, k]) — best first; exact over the corpus."""
        if not (1 <= k <= min(self.max_k, self.corpus_size)):
            raise ValueError(
                f"k={k} out of range [1, {min(self.max_k, self.corpus_size)}]"
            )
        q = export_feature_embeddings(self.model, self.query_feature, ids=np.asarray(user_ids))
        scores, idx = chunked_topk(q, self.corpus, k=k)
        return idx.cpu().numpy() + self._start, scores.cpu().numpy()

    def refresh(self, model: TwoTower) -> None:
        """Serve `model` and re-embed the corpus with it (the index-sync role)."""
        self.model = model
        item_emb = export_feature_embeddings(model, self.candidate_feature)
        self.corpus = item_emb[self._start :]
        self.corpus_size = int(self.corpus.shape[0])
