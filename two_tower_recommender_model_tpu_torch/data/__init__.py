from two_tower_recommender_model_tpu_torch.data.featurizer import (  # noqa: F401
    Batch,
    Featurizer,
    SparseFeature,
    pad_batch,
)
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream  # noqa: F401
