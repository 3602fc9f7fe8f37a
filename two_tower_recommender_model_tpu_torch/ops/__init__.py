from two_tower_recommender_model_tpu_torch.ops.embedding_ops import pooled_lookup  # noqa: F401
from two_tower_recommender_model_tpu_torch.ops.topk import chunked_topk  # noqa: F401
