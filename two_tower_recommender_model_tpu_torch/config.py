"""Typed model configuration of the port.

The same dataclasses, fields and defaults as the model half of
`two_tower_recommender_model_tpu/config.py` (`TableConfig`, `FeatureConfig`,
`TowerConfig`, `ModelConfig`, `two_tower_model_config`, `to_json`,
`model_config_from_dict`), so a `model_config.json` exported by the JAX
package loads here field for field (`tests/test_torch_config.py` holds the two
equal). The port keeps its own copy because nothing it runs may import the JAX
package. `TrainConfig` is the JAX package's, field for field, so a config
written for one trains the other; the training step refuses the fields whose
features the port does not have yet (`train/step.py`). `MeshConfig` comes with
the multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """One embedding table; several sparse features may share its rows."""

    name: str
    num_embeddings: int
    embedding_dim: int = 128
    feature_names: tuple[str, ...] = ()
    # per-table storage dtype ("float32" | "bfloat16" | "int8"); None -> the
    # model-wide table_dtype
    dtype: str | None = None

    def __post_init__(self):
        if not self.feature_names:
            object.__setattr__(self, "feature_names", (self.name,))


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """One sparse input feature: the table it reads and its bag geometry.
    Bags are `[B, L]` id tensors with a `[B, L]` validity mask, where L is
    `max_ids_per_sample`."""

    name: str
    table: str
    max_ids_per_sample: int = 1
    pooling: str = "sum"  # "sum" | "mean"


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    """One tower: the features it consumes, optional dense side input, MLP
    sizes. `final_activation=True` is torchrec's MLP (activation after every
    layer, the last included)."""

    features: tuple[str, ...]
    layer_sizes: tuple[int, ...] = (128, 64)
    dense_dim: int = 0
    activation: str = "relu"
    final_activation: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The full two-tower model: tables, feature wiring and two towers."""

    tables: tuple[TableConfig, ...]
    features: tuple[FeatureConfig, ...]
    query_tower: TowerConfig
    candidate_tower: TowerConfig
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # "bfloat16": bf16 tower matmuls, f32 accumulation
    # table storage dtype; None -> param_dtype
    table_dtype: str | None = None
    # "auto" | "on" | "off": the fused tower-backward kernel of training;
    # serving ignores it
    fused_tower_backward: str = "auto"

    @property
    def resolved_table_dtype(self) -> str:
        return self.table_dtype or self.param_dtype

    def table_dtype_of(self, table_name: str) -> str:
        """Storage dtype for one table (per-table override, else model-wide)."""
        return self.table(table_name).dtype or self.resolved_table_dtype

    def table(self, name: str) -> TableConfig:
        for t in self.tables:
            if t.name == name:
                return t
        raise KeyError(f"no table named {name!r}")

    def feature(self, name: str) -> FeatureConfig:
        for f in self.features:
            if f.name == name:
                return f
        raise KeyError(f"no feature named {name!r}")

    def feature_table(self, feature_name: str) -> TableConfig:
        return self.table(self.feature(feature_name).table)

    @property
    def tower_out_dim(self) -> int:
        return self.query_tower.layer_sizes[-1]

    def validate(self) -> None:
        table_names = {t.name for t in self.tables}
        feat_names = {f.name for f in self.features}
        for f in self.features:
            if f.table not in table_names:
                raise ValueError(f"feature {f.name!r} references unknown table {f.table!r}")
        for tower_name, tower in (("query", self.query_tower), ("candidate", self.candidate_tower)):
            for fn in tower.features:
                if fn not in feat_names:
                    raise ValueError(f"{tower_name} tower references unknown feature {fn!r}")
        # retrieval scores q . c, so both towers end at one width
        if self.query_tower.layer_sizes[-1] != self.candidate_tower.layer_sizes[-1]:
            raise ValueError("query and candidate towers must share the final layer size")
        if self.fused_tower_backward not in ("auto", "on", "off"):
            raise ValueError(
                f"fused_tower_backward must be auto|on|off, got "
                f"{self.fused_tower_backward!r}"
            )


def two_tower_model_config(
    num_users: int,
    num_items: int,
    embedding_dim: int = 128,
    layer_sizes: tuple[int, ...] = (128, 64),
    user_feature: str = "user_id",
    item_feature: str = "product_id",
    compute_dtype: str = "float32",
) -> ModelConfig:
    """The flagship architecture: two tables, one feature each, symmetric
    towers."""
    cfg = ModelConfig(
        tables=(
            TableConfig(f"t_{user_feature}", num_users, embedding_dim, (user_feature,)),
            TableConfig(f"t_{item_feature}", num_items, embedding_dim, (item_feature,)),
        ),
        features=(
            FeatureConfig(user_feature, f"t_{user_feature}"),
            FeatureConfig(item_feature, f"t_{item_feature}"),
        ),
        query_tower=TowerConfig((user_feature,), tuple(layer_sizes)),
        candidate_tower=TowerConfig((item_feature,), tuple(layer_sizes)),
        compute_dtype=compute_dtype,
    )
    cfg.validate()
    return cfg


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters: the same fields and defaults as the JAX
    package's `TrainConfig` (`tests/test_torch_config.py` holds them equal).
    What each field does in the port is said where `train/step.py` and
    `train/loop.py` read it."""

    epochs: int = 3
    batch_size: int = 1024
    learning_rate: float = 1e-3  # dense towers (Adam)
    sparse_learning_rate: float = 1e-2  # embedding tables (row-wise Adagrad)
    adagrad_eps: float = 1e-10
    loss: str = "bce"  # "bce" | "weighted_bce" | "sampled_softmax"
    logq_correction: bool = True  # only for sampled_softmax
    softmax_temperature: float = 1.0  # only for sampled_softmax
    # weighted_bce: one weight per interaction type; the one-hot type columns
    # live in batch.dense[:, start : start + len(weights)]
    loss_type_weights: tuple[float, ...] | None = None
    loss_type_onehot_start: int = 0
    seed: int = 0
    validation_freq: int | None = None  # mid-epoch val every N steps
    limit_train_batches: int | None = None
    limit_val_batches: int | None = None
    limit_test_batches: int | None = None
    print_sharding_plan: bool = True
    drop_zero_ids: bool = True  # falsy ids get a 0-length bag
    # a single-slot feature whose hashed ids arrive sorted within each batch
    # (the featurizer sorts rows by it): its table's update skips the sort
    sorted_feature: str | None = None
    # "float32" only in the port ("bfloat16" aggregation buffers: ROADMAP)
    scatter_buffer_dtype: str = "float32"
    # "off" | "float32" | "bfloat16": the dtype of the [M, D] gradient rows
    # the row-wise Adagrad kernel sums ("off" and "float32" pass f32)
    block_sorted_kernel: str = "off"
    # route the sorted feature's forward gather through the sorted-lookup
    # call site (the pooled-gather kernel either way)
    block_sorted_gather: bool = True
    device_sorted_gather: bool = False  # not ported (ROADMAP)
    softmax_kernel: str = "auto"  # only for sampled_softmax
    # the exchange of the row-sharded float tables that the host does not sort
    # (`parallel/sharded.py`): "dense" (all-gather / reduce-scatter) | "alltoall"
    # (each id's row and gradient straight between its data rank and its owner,
    # through buckets of fixed capacity; the ids past it are counted, and the
    # loops raise on a nonzero count)
    sharded_exchange: str = "dense"
    # alltoall: a bucket holds this multiple of B_local * L / ranks distinct ids
    exchange_capacity_factor: float = 1.25
    exchange_wire_dtype: str = "float32"  # alltoall: the rows' and gradients' wire dtype
    checkpoint_dir: str | None = None
    checkpoint_every_epochs: int = 1


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh of `data x model` ranks (`parallel/mesh.py`).
    `data` is the batch / data-parallel axis; `model` the second table axis.
    Tables row-shard over the flattened (data, model) ranks, one global copy
    of every row, while the dense towers replicate and sync their gradients
    over `data`."""

    data: int = 1
    model: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model


def to_json(cfg: Any) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)


def model_config_from_dict(d: Mapping[str, Any]) -> ModelConfig:
    """Rebuild a ModelConfig from its `to_json` form (the `model_config.json`
    of an export)."""
    tables = tuple(
        TableConfig(t["name"], t["num_embeddings"], t["embedding_dim"],
                    tuple(t["feature_names"]), t.get("dtype"))
        for t in d["tables"]
    )
    features = tuple(
        FeatureConfig(f["name"], f["table"], f["max_ids_per_sample"], f["pooling"])
        for f in d["features"]
    )

    def tower(td):
        return TowerConfig(
            tuple(td["features"]), tuple(td["layer_sizes"]), td["dense_dim"],
            td["activation"], td["final_activation"],
        )

    cfg = ModelConfig(
        tables=tables,
        features=features,
        query_tower=tower(d["query_tower"]),
        candidate_tower=tower(d["candidate_tower"]),
        param_dtype=d.get("param_dtype", "float32"),
        compute_dtype=d.get("compute_dtype", "float32"),
        table_dtype=d.get("table_dtype"),
        fused_tower_backward=d.get("fused_tower_backward", "auto"),
    )
    cfg.validate()
    return cfg
