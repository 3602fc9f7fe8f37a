from two_tower_recommender_model_tpu_torch.utils.checkpoint import load_model  # noqa: F401
