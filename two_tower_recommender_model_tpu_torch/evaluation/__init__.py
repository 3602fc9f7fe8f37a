from two_tower_recommender_model_tpu_torch.evaluation.retrieval import (  # noqa: F401
    export_feature_embeddings,
)
