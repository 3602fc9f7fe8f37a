"""Hyperparameter search: sweeps (random, grid, TPE), ASHA, and multi-seed
training. The port's own copy of `two_tower_recommender_model_tpu/tuning/`."""

from two_tower_recommender_model_tpu_torch.tuning.sweep import (  # noqa: F401
    Choice,
    LogUniform,
    Uniform,
    run_sweep,
    sample_space,
)
from two_tower_recommender_model_tpu_torch.tuning.multi_seed import multi_seed_train  # noqa: F401
