from two_tower_recommender_model_tpu_torch.utils.checkpoint import (  # noqa: F401
    Checkpointer,
    export_model,
    load_model,
)
