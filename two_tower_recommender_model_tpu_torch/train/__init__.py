from two_tower_recommender_model_tpu_torch.train.step import (  # noqa: F401
    TrainState,
    create_train_state,
    make_eval_step,
    make_multi_step,
    make_train_step,
    stack_batches,
)
from two_tower_recommender_model_tpu_torch.train.loop import (  # noqa: F401
    evaluate,
    train_one_epoch_packed,
    train_val_test,
)
