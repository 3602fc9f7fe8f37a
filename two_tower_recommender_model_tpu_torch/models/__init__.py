from two_tower_recommender_model_tpu_torch.models.two_tower import (  # noqa: F401
    TwoTower,
    forward,
    init_params,
    params_from_numpy,
    params_to_numpy,
    pooled_embeddings,
    towers_forward,
)
