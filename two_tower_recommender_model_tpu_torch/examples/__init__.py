"""Runnable examples of the port, each `python -m
two_tower_recommender_model_tpu_torch.examples.<name> [--device cpu] ...`
(the card unless given `--device`), and each a `main(...)` that returns its
metrics:

- `end_to_end_instacart_style` — interactions -> positives and sampled
  negatives -> per-user split -> TTRS shards -> streaming training with
  checkpoints and tracking -> restore -> export -> serving -> retrieval eval.
- `full_scale_synthetic`       — the same loop at the reference's scale
  (206,209 users, 49,688 items, 26M interactions; flags cut it): pre-packed
  shards, K-step graphs, exact retrieval over 10,000 users.
- `sweep_example`              — a TPE sweep over layer sizes, both learning
  rates and the batch size; ASHA; the winner's multi-seed run.
- `text_side_features`         — product text -> hashed n-gram embeddings ->
  the candidate tower's dense input -> training -> retrieval with them.
- `tune_retrieval_smoke`       — a TPE sweep of the sampled softmax on
  recall@100 over the Instacart replica, through the port's `cli` modules.
- `workshop_ratings_style`     — ratings -> binary labels -> a small-table
  model -> an HTTP endpoint on localhost.
"""
