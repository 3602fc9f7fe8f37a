"""Exact chunked matmul top-k retrieval.

Port of `two_tower_recommender_model_tpu/ops/topk.py:chunked_topk`. Scores
are a `[Q, I]` float32 product that never materializes whole: queries are
taken `query_chunk` at a time, the corpus `corpus_chunk` rows at a time, and
a running top-k is merged with each chunk's scores. Columns past the last
corpus row (the ragged tail of the last chunk) score -inf, so they can never
evict a real entry; so do the rows at or past `valid` where the caller
passes it (a corpus padded to a multiple of the ranks, kept resident: the
sharded top-k's shards), masked before each merge.

Tie rule: among equal scores the lower corpus index wins, as with
`jax.lax.top_k`. Each merge selects from the concatenation (running top-k,
chunk) with a *stable* descending sort, which keeps equal scores in their
concatenation order; the running entries all have lower indices than the
chunk's and are themselves in index order among ties, so by induction every
tie resolves to the lower index. (`torch.topk` on CUDA promises no order
among ties, and the towers' final ReLU makes exact-zero ties common.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _merge(top_vals, top_idx, scores, cand_idx, k):
    all_vals = torch.cat([top_vals, scores], dim=1)
    all_idx = torch.cat([top_idx, cand_idx.expand(scores.shape[0], -1)], dim=1)
    vals, pos = torch.sort(all_vals, dim=1, descending=True, stable=True)
    return vals[:, :k], torch.gather(all_idx, 1, pos[:, :k])


def chunked_topk(
    queries: torch.Tensor,  # [Q, D]
    corpus: torch.Tensor,  # [I, D]
    k: int = 100,
    corpus_chunk: int = 4096,
    query_chunk: int = 1024,
    valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k dot-product retrieval. Returns (scores [Q, k] float32,
    indices [Q, k] int64) with indices into `corpus` rows, sorted descending
    by score, ties to the lower index. Rows at or past `valid` (default:
    every row is real) score -inf before the merge, as padding does. Where k
    exceeds the real rows, the missing entries score -inf with index 0."""
    qn = queries.shape[0]
    n_items = corpus.shape[0]
    valid = n_items if valid is None else max(0, min(int(valid), n_items))
    corpus_chunk = min(corpus_chunk, max(128, n_items))
    query_chunk = min(query_chunk, max(1, qn))
    dev = queries.device
    out_vals = [torch.empty((0, k), device=dev)]
    out_idx = [torch.empty((0, k), dtype=torch.int64, device=dev)]
    for qs in range(0, qn, query_chunk):
        qc = queries[qs : qs + query_chunk].float()
        top_vals = torch.full((qc.shape[0], k), float("-inf"), device=dev)
        top_idx = torch.zeros((qc.shape[0], k), dtype=torch.int64, device=dev)
        for cs in range(0, n_items, corpus_chunk):
            chunk = corpus[cs : cs + corpus_chunk].float()
            scores = qc @ chunk.T
            if chunk.shape[0] < corpus_chunk:  # ragged last chunk: pad columns score -inf
                scores = F.pad(scores, (0, corpus_chunk - chunk.shape[0]), value=float("-inf"))
            if valid < cs + chunk.shape[0]:  # rows past the real corpus, masked pre-selection
                scores[:, max(valid - cs, 0):] = float("-inf")
            cand_idx = torch.arange(cs, cs + corpus_chunk, device=dev)[None, :]
            top_vals, top_idx = _merge(top_vals, top_idx, scores, cand_idx, k)
        out_vals.append(top_vals)
        out_idx.append(top_idx)
    return torch.cat(out_vals), torch.cat(out_idx)
