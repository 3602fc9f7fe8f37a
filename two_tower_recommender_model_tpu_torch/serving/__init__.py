from two_tower_recommender_model_tpu_torch.serving.scorer import (  # noqa: F401
    Scorer,
    load_scorer,
    load_scorer_from_registry,
)
from two_tower_recommender_model_tpu_torch.serving.retrieval_service import (  # noqa: F401
    RetrievalService,
)
