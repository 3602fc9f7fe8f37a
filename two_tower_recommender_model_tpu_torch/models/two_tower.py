"""The TwoTower model as an `nn.Module`.

Port of `two_tower_recommender_model_tpu/models/two_tower.py` (the serving
forward): per tower, the pooled embeddings of that tower's features are
concatenated (plus optional dense side features) and projected through an
MLP; the score is the dot product of the two tower outputs.

The forward keeps the reference's two stages, so the train step can keep
the embedding backward sparse:
  - `pooled_embeddings(tables, batch, cfg)` — gather + pool, through the
    pooled-gather kernel on CUDA tensors (the host-sorted feature of a train
    step through the sorted-lookup call site, `block_sorted_feature`; the
    single-slot features the host did not sort through the device-sorted
    front-end, `device_sorted_features`),
  - `towers_forward(model, pooled, dense)` — the dense towers, with the fused
    tower backward where `cfg.fused_tower_backward` resolves to on.

A table stored as int8 (`table_dtype="int8"`, model-wide or per table) is a
`QuantizedTable` (`ops/quantized.py`) and goes through the int8 pooled-gather
kernel. A table stored as bf16 (`table_dtype="bfloat16"`) is a bf16 tensor:
the pooled-gather kernel widens its rows, sums a bag in f32 and emits the
compute dtype, rounding once (the reference sums a bag's slots in the
compute dtype: equal at one slot, within one ulp of the largest partial sum
at several).

Weights cross between the packages as numpy arrays in the JAX pytree layout
(`params_from_numpy` / `params_to_numpy`):

    {"tables": {table_name: [N, D] (a bf16 table as f32 values that bf16
                            holds exactly, or as the raw bf16 bits in uint16
                            or an `ml_dtypes` bfloat16 array), or for an int8
                            table {"values": [N, D] int8, "scales": [N] f32}},
     "query_tower": {"layer_i": {"kernel": [in, out], "bias": [out]}},
     "candidate_tower": {...}}
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
from torch import nn

from two_tower_recommender_model_tpu_torch.device import resolve_device

from two_tower_recommender_model_tpu_torch.config import ModelConfig, TowerConfig
from two_tower_recommender_model_tpu_torch.data.featurizer import Batch
from two_tower_recommender_model_tpu_torch.models.mlp import MLP, init_mlp
from two_tower_recommender_model_tpu_torch.ops.embedding_ops import (
    block_sorted_lookup,
    device_sorted_lookup,
    pooled_lookup,
)
from two_tower_recommender_model_tpu_torch.ops.quantized import (
    QuantizedTable,
    dequantize_table,
    init_quantized_table,
    quantize_table,
)

_TOWERS = ("query_tower", "candidate_tower")

# int8 tables with at least this many rows are never drawn whole in f32 (4M
# rows x 128 f32 is 2 GB; the tables int8 storage exists for are far larger):
# `init_params` initializes them chunk by chunk (`init_quantized_table`)
BIG_INT8_INIT_ROWS = 4_000_000


def torch_dtype(name: str) -> torch.dtype:
    """A config dtype name ("float32" | "bfloat16" | "int8") as a torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}[name]


def init_table(generator: torch.Generator, num_embeddings: int, dim: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """EmbeddingBag-style init U(-sqrt(1/N), sqrt(1/N)), drawn in f32 from
    `generator` on the generator's device, then cast once to `dtype`."""
    bound = (1.0 / num_embeddings) ** 0.5
    t = torch.empty((num_embeddings, dim), dtype=torch.float32, device=generator.device)
    return t.uniform_(-bound, bound, generator=generator).to(dtype)


def tower_in_dim(cfg: ModelConfig, tower: TowerConfig) -> int:
    return sum(cfg.feature_table(f).embedding_dim for f in tower.features) + tower.dense_dim


class TableDict(nn.Module):
    """The model's tables by name, in the config's order: a float table (f32
    or bf16) as a frozen `nn.Parameter` `[N, D]`, an int8 table as a `QuantizedTable`
    (`.values`, `.scales`). `tables[name] = new` replaces a table by either
    kind, so an update that returns new tensors can be installed."""

    def __init__(self, tables: dict):
        super().__init__()
        self._names: list[str] = []
        for name, table in tables.items():
            self[name] = table

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        return self._modules[name]

    def __setitem__(self, name: str, table) -> None:
        self._parameters.pop(name, None)
        self._modules.pop(name, None)
        if isinstance(table, QuantizedTable):
            self.add_module(name, table)
        else:
            if not isinstance(table, nn.Parameter):
                table = nn.Parameter(table, requires_grad=False)
            self.register_parameter(name, table)
        if name not in self._names:
            self._names.append(name)

    def __contains__(self, name: str) -> bool:
        return name in self._names

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def keys(self):
        return list(self._names)

    def values(self):
        return [self[name] for name in self._names]

    def items(self):
        return [(name, self[name]) for name in self._names]


class TwoTower(nn.Module):
    """Tables (`self.tables[name]`: `[N, D]`, or a `QuantizedTable` for an
    int8 table) and the two MLP towers.

    Parameters are allocated uninitialized on `device` (the card when None:
    `device.default_device`); `init_params` draws
    them and `params_from_numpy` copies them in. The tables take no autograd
    gradient (the reference updates them sparsely, outside autodiff).
    `tables`, when given, are used as they are instead of allocated: a
    sharded state's model holds its rank's shards and buckets
    (`parallel/sharded.py`)."""

    def __init__(self, cfg: ModelConfig, device: torch.device | str | None = None,
                 tables: dict | None = None):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        device = resolve_device(device)

        def empty_table(t):
            shape, dtype = (t.num_embeddings, t.embedding_dim), cfg.table_dtype_of(t.name)
            if dtype == "int8":
                return QuantizedTable(
                    torch.empty(shape, dtype=torch.int8, device=device),
                    torch.empty(t.num_embeddings, dtype=torch.float32, device=device))
            return torch.empty(shape, dtype=torch_dtype(dtype), device=device)

        self.tables = TableDict(tables if tables is not None
                                else {t.name: empty_table(t) for t in cfg.tables})
        dtype = torch_dtype(cfg.param_dtype)
        for key in _TOWERS:
            tower = getattr(cfg, key)
            setattr(self, key, MLP(tower_in_dim(cfg, tower), tower.layer_sizes,
                                   tower.activation, tower.final_activation, dtype, device))

    @property
    def device(self) -> torch.device:
        return next(iter(self.tables.values())).device

    def forward(self, batch: Batch) -> tuple[torch.Tensor, torch.Tensor]:
        return forward(self, batch)


def init_params(cfg: ModelConfig, generator: torch.Generator) -> TwoTower:
    """A randomly initialized `TwoTower` on the generator's device. An int8
    table is drawn in f32 and quantized; one of `BIG_INT8_INIT_ROWS` rows or
    more is never drawn whole: it is initialized chunk by chunk from a
    generator of its own, seeded from `generator`'s seed and the table's name.
    (The reference's `init_params` returns the f32 draw and leaves both steps
    to `create_train_state`; the port's returns a module whose tables already
    have their storage type, so it does them here.)"""
    model = TwoTower(cfg, device=generator.device)
    with torch.no_grad():
        for t in cfg.tables:
            if cfg.table_dtype_of(t.name) != "int8":
                model.tables[t.name].copy_(init_table(
                    generator, t.num_embeddings, t.embedding_dim, model.tables[t.name].dtype))
            elif t.num_embeddings < BIG_INT8_INIT_ROWS:
                model.tables[t.name] = quantize_table(
                    init_table(generator, t.num_embeddings, t.embedding_dim))
            else:
                seed = (generator.initial_seed() + zlib.crc32(t.name.encode())) % (1 << 63)
                own = torch.Generator(device=generator.device).manual_seed(seed)
                model.tables[t.name] = init_quantized_table(own, t.num_embeddings,
                                                            t.embedding_dim)
        dtype = torch_dtype(cfg.param_dtype)
        for key in _TOWERS:
            tower = getattr(cfg, key)
            setattr(model, key, init_mlp(generator, tower_in_dim(cfg, tower), tower.layer_sizes,
                                         dtype, tower.activation, tower.final_activation))
    return model


def copy_from_numpy(dst: torch.Tensor, src, name: str, transpose: bool = False) -> None:
    """Copy a numpy array into a parameter: f32 values (rounded once into a
    bf16 parameter), or bf16 bits (an `ml_dtypes` bfloat16 array or its
    uint16 view) into a bf16 one, exactly."""
    src = np.asarray(src)
    if src.dtype.name == "bfloat16":  # an `ml_dtypes` array: numpy has no bf16 of its own
        src = src.view(np.uint16)
    if transpose:
        src = src.T
    if src.dtype == np.uint16:  # the raw bits of bf16 values
        if dst.dtype != torch.bfloat16:
            raise ValueError(f"{name} is {dst.dtype}: bf16 bits (uint16) are for a bfloat16 "
                             "table or parameter")
        dst.copy_(torch.from_numpy(np.array(src, order="C").view(np.int16)).view(torch.bfloat16))
    else:
        dst.copy_(torch.from_numpy(np.array(src, np.float32, order="C")))


def params_from_numpy(params: dict, cfg: ModelConfig,
                      device: torch.device | str | None = None) -> TwoTower:
    """Build the port's module from the JAX pytree layout as numpy arrays."""
    model = TwoTower(cfg, device=resolve_device(device))
    with torch.no_grad():
        for name, table in model.tables.items():
            src = params["tables"][name]
            if isinstance(table, QuantizedTable):
                if not (isinstance(src, dict) and {"values", "scales"} <= set(src)):
                    raise ValueError(f"table {name!r} is int8: expected "
                                     "{'values': int8 [N, D], 'scales': f32 [N]}")
                values, scales = np.asarray(src["values"]), np.asarray(src["scales"])
                if values.dtype != np.int8 or values.shape != tuple(table.shape) \
                        or scales.shape != (table.shape[0],):
                    raise ValueError(f"table {name!r}: values {values.dtype} {values.shape}, "
                                     f"scales {scales.shape} != int8 {tuple(table.shape)}")
                table.values.copy_(torch.from_numpy(values))
                table.scales.copy_(torch.from_numpy(scales.astype(np.float32)))
                continue
            src = np.asarray(src)
            if src.shape != tuple(table.shape):
                raise ValueError(f"table {name!r}: shape {src.shape} != {tuple(table.shape)}")
            copy_from_numpy(table, src, f"table {name!r}")
        for key in _TOWERS:
            layers = getattr(model, key).layers
            if len(params[key]) != len(layers):
                raise ValueError(f"{key}: {len(params[key])} layers != {len(layers)}")
            for i, layer in enumerate(layers):
                p = params[key][f"layer_{i}"]
                kernel = np.asarray(p["kernel"], np.float32)
                if kernel.shape != (layer.in_features, layer.out_features):
                    raise ValueError(f"{key}/layer_{i}: kernel shape {kernel.shape}")
                layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(kernel.T)))
                layer.bias.copy_(torch.from_numpy(np.asarray(p["bias"], np.float32)))
    return model


def params_to_numpy(model: TwoTower, dequantize: bool = False) -> dict:
    """The inverse of `params_from_numpy`: float32 numpy arrays in the JAX
    pytree layout (bfloat16 tables widen exactly to float32). An int8 table
    comes back as its `{"values", "scales"}`, or with `dequantize` as the f32
    rows it stands for (what the portable export stores)."""

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", torch.float32).numpy()

    def host_table(t):
        if not isinstance(t, QuantizedTable):
            return host(t)
        if dequantize:
            return host(dequantize_table(t))
        return {"values": t.values.cpu().numpy(), "scales": host(t.scales)}

    out: dict = {"tables": {name: host_table(t) for name, t in model.tables.items()}}
    for key in _TOWERS:
        out[key] = {
            f"layer_{i}": {"kernel": host(layer.weight).T.copy(), "bias": host(layer.bias)}
            for i, layer in enumerate(getattr(model, key).layers)
        }
    return out


def pooled_embeddings(tables, batch: Batch, cfg: ModelConfig,
                      block_sorted_feature: str | None = None,
                      block_sorted_dtype: str = "float32",
                      device_sorted_features: tuple[str, ...] = ()) -> dict[str, torch.Tensor]:
    """Per-feature pooled embeddings `{feature: [B, D_f]}`, cast to the
    compute dtype when it differs from the table storage dtype.

    `block_sorted_feature` names the (single-slot, host-sorted) feature the
    train step gathers through the sorted-lookup call site
    (`ops.embedding_ops.block_sorted_lookup`, the reference's Pallas kernel
    #2): one pooled-gather launch with the slot mask as the row weight,
    emitting the compute dtype. Under `block_sorted_dtype="bfloat16"` the
    rows of a float table are rounded to bf16, as the reference's bf16
    one-hot gather rounds them; an int8 table's rows are dequantized in f32
    whatever that option says, as the reference's int8 gather leaves them
    (f32 out where no compute dtype is set).

    `device_sorted_features` names (single-slot) features the host did not
    sort whose gathers take the device-sorted front-end
    (`ops.embedding_ops.device_sorted_lookup`; `TrainConfig.
    device_sorted_gather`): a dead slot's id becomes the sentinel N, an
    exact zero row, and the rows are multiplied by the slot mask and cast to
    the compute dtype, with the same bf16 rounding of float rows under
    `block_sorted_dtype="bfloat16"`."""
    compute_dtype = (
        torch_dtype(cfg.compute_dtype)
        if cfg.compute_dtype != cfg.resolved_table_dtype
        else None
    )
    out = {}
    for fc in cfg.features:
        feat = batch.features[fc.name]
        if fc.name == block_sorted_feature:
            if fc.max_ids_per_sample != 1:
                raise ValueError(f"block_sorted_feature {fc.name!r} must be single-slot")
            table = tables[fc.table]
            quantized = isinstance(table, QuantizedTable)
            rows_dtype = compute_dtype
            if block_sorted_dtype == "bfloat16" and not quantized:
                rows_dtype = torch.bfloat16
            rows = block_sorted_lookup(table, feat.ids[:, 0], feat.mask[:, 0],
                                       out_dtype=rows_dtype)
            out[fc.name] = rows.to(compute_dtype or (torch.float32 if quantized else table.dtype))
            continue
        if fc.name in device_sorted_features:
            table = tables[fc.table]
            quantized = isinstance(table, QuantizedTable)
            n = cfg.table(fc.table).num_embeddings
            ids = torch.where(feat.mask[:, 0] > 0, feat.ids[:, 0].to(torch.int32), n)
            dtype = compute_dtype or (torch.float32 if quantized else table.dtype)
            rows = device_sorted_lookup(table, ids, matmul_dtype=block_sorted_dtype,
                                        out_dtype=dtype)
            out[fc.name] = rows * feat.mask[:, :1].to(dtype)
            continue
        out[fc.name] = pooled_lookup(
            tables[fc.table], feat.ids, feat.mask, fc.pooling, compute_dtype
        )
    return out


def _tower(mlp: MLP, tower: TowerConfig, pooled, dense, cfg: ModelConfig) -> torch.Tensor:
    xs = [pooled[f] for f in tower.features]
    if tower.dense_dim:
        if dense is None:
            raise ValueError("tower expects dense features but batch.dense is None")
        xs.append(dense.to(xs[0].dtype))
    x = torch.cat(xs, dim=1) if len(xs) > 1 else xs[0]
    # "auto": the fused kernel's bf16 operands are the bf16-compute
    # backward's numerics class, and it runs on the card (on the CPU it would
    # only be its plain version)
    fused = cfg.fused_tower_backward == "on" or (
        cfg.fused_tower_backward == "auto" and cfg.compute_dtype == "bfloat16"
        and x.device.type == "cuda")
    return mlp(x, torch_dtype(cfg.compute_dtype), fused_backward=fused)


def towers_forward(model: TwoTower, pooled: dict[str, torch.Tensor],
                   dense: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """(query_embedding, candidate_embedding)."""
    cfg = model.cfg
    q = _tower(model.query_tower, cfg.query_tower, pooled, dense, cfg)
    c = _tower(model.candidate_tower, cfg.candidate_tower, pooled, dense, cfg)
    return q, c


def forward(model: TwoTower, batch: Batch) -> tuple[torch.Tensor, torch.Tensor]:
    pooled = pooled_embeddings(model.tables, batch, model.cfg)
    return towers_forward(model, pooled, batch.dense)


def score(model: TwoTower, batch: Batch) -> torch.Tensor:
    """Dot-product logits."""
    q, c = forward(model, batch)
    return torch.sum(q * c, dim=1)
