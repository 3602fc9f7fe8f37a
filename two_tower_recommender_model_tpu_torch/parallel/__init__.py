"""Data-parallel training with sharded tables on `torch.distributed`: the
mesh (`mesh`), the launch (`launch`), the planner (`planner`) and the sharded
state, lookups, updates and steps, the sharded softmax's collectives, the
compact wire on a mesh and the sharded top-k (`sharded`)."""

from two_tower_recommender_model_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    topology_summary,
)
from two_tower_recommender_model_tpu_torch.parallel.planner import (  # noqa: F401
    ShardingPlan,
    TableShard,
    comm_volume_report,
    plan_sharding,
)
from two_tower_recommender_model_tpu_torch.parallel.sharded import (  # noqa: F401
    batch_sharding,
    compact_shardings,
    macro_batch_sharding,
    make_sharded_compact_multi_step,
    make_sharded_eval_step,
    make_sharded_multi_step,
    make_sharded_topk,
    make_sharded_train_step,
    shard_corpus,
    shard_train_state,
    unshard_train_state,
)
