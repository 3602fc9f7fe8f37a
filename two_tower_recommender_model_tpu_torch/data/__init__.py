"""The port's data path: featurizers, the synthetic clickstream, and the
host side of the Instacart pipeline (replica CSVs, ingest, feature
engineering, TTRS shards, the streaming loader, pre-packed datasets).

The host modules run on numpy and the standard library alone. Where the JAX
package passes a `pd.DataFrame`, they pass a `Frame`: a dict of equal-length
numpy columns, in column order. String columns are object arrays of `str`,
and missing floats are NaN.
"""

import numpy as np

from two_tower_recommender_model_tpu_torch.data.featurizer import (  # noqa: F401
    Batch,
    Featurizer,
    SparseFeature,
    pad_batch,
    pad_batch_to,
)
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream  # noqa: F401

Frame = dict[str, np.ndarray]  # a table: column name -> equal-length numpy column
