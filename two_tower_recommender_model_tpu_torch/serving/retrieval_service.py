"""Online retrieval service: user -> top-k items, as a callable and over HTTP.

Port of `two_tower_recommender_model_tpu/serving/retrieval_service.py`:
the item corpus is embedded once (full-corpus export) and kept on the
model's device; each query embeds the user(s) and runs the exact chunked
top-k. Item 0 (the missing-id sentinel) is left out of the corpus by
default. With a `mesh` (`parallel.mesh`) every rank keeps its row shard of
the corpus padded to a multiple of the ranks, resident across calls, and
every rank answers the same queries through the exact sharded top-k
(`parallel.sharded.make_sharded_topk`), the pad rows masked.

HTTP surface (added to `ModelServer` when constructed with a
`RetrievalService`):

    POST /retrieve  {"user_id": [u1, u2], "k": 10}
                 -> {"items": [[...], [...]], "scores": [[...], [...]]}
"""

from __future__ import annotations

import functools

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
        mesh=None,
    ):
        """`mesh`: row-shard the corpus over the mesh's ranks and route the
        queries through the sharded top-k; every rank must call `retrieve`
        with the same users (and `refresh` with the same model)."""
        self.query_feature = query_feature
        self.candidate_feature = candidate_feature
        self.max_k = max_k
        self.mesh = mesh
        self._start = 1 if exclude_item_zero else 0
        if mesh is not None:
            from two_tower_recommender_model_tpu_torch.parallel.sharded import make_sharded_topk

            # one sharded top-k a k, the 8 most recent kept
            self._sharded_topk = functools.lru_cache(maxsize=8)(
                lambda k: make_sharded_topk(mesh, k))
        self.refresh(model)

    @torch.no_grad()
    def retrieve(self, user_ids, k: int = 100) -> tuple[np.ndarray, np.ndarray]:
        """(items [U, k], scores [U, k]) — best first; exact over the corpus."""
        if not (1 <= k <= min(self.max_k, self.corpus_size)):
            raise ValueError(
                f"k={k} out of range [1, {min(self.max_k, self.corpus_size)}]"
            )
        q = export_feature_embeddings(self.model, self.query_feature, ids=np.asarray(user_ids))
        if self.mesh is None:
            scores, idx = chunked_topk(q, self.corpus, k=k)
        else:
            scores, idx = self._sharded_topk(k)(q.to(self.mesh.device), self.corpus_shard,
                                                valid=self.corpus_size)
        return idx.cpu().numpy() + self._start, scores.cpu().numpy()

    def refresh(self, model: TwoTower) -> None:
        """Serve `model` and re-embed the corpus with it (the index-sync role)."""
        self.model = model
        item_emb = export_feature_embeddings(model, self.candidate_feature)
        self.corpus = item_emb[self._start :]
        self.corpus_size = int(self.corpus.shape[0])
        if self.mesh is not None:
            from two_tower_recommender_model_tpu_torch.parallel.sharded import shard_corpus

            # the padded corpus stays resident and row-sharded across calls
            self.corpus_shard, _ = shard_corpus(self.corpus.to(self.mesh.device), self.mesh)
