"""Native (C++) host components, loaded with ctypes.

`load_ttrs_reader()` builds (at first use, never at import) and loads the
TTRS shard reader; `ShardedDataset` reads in numpy where it does not build.
"""

from two_tower_recommender_model_tpu_torch.native.build import (  # noqa: F401
    build_ttrs_reader,
    load_ttrs_reader,
)
from two_tower_recommender_model_tpu_torch.native.ttrs import (  # noqa: F401
    NativeShardReader,
    native_available,
    native_read_shard,
)
