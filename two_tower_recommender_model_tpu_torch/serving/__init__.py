from two_tower_recommender_model_tpu_torch.serving.scorer import Scorer, load_scorer  # noqa: F401
from two_tower_recommender_model_tpu_torch.serving.retrieval_service import (  # noqa: F401
    RetrievalService,
)
