from two_tower_recommender_model_tpu_torch.train.step import (  # noqa: F401
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from two_tower_recommender_model_tpu_torch.train.loop import evaluate, train_val_test  # noqa: F401
