from two_tower_recommender_model_tpu_torch.train.step import (  # noqa: F401
    TrainState,
    create_train_state,
    make_eval_step,
    make_multi_step,
    make_train_step,
    stack_batches,
    train_state_from_numpy,
)
from two_tower_recommender_model_tpu_torch.train.loop import (  # noqa: F401
    evaluate,
    train_one_epoch_packed,
    train_val_test,
)
from two_tower_recommender_model_tpu_torch.train.resilient import resilient_fit  # noqa: F401
