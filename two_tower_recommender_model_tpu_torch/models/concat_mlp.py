"""Concat-MLP ranker: the pointwise ranking model family.

Port of `two_tower_recommender_model_tpu/models/concat_mlp.py`. Not a
two-tower retrieval model: every feature's pooled embedding (and the dense
side input) is concatenated and pushed through one MLP of Linear + ReLU +
Dropout blocks to a scalar logit, trained with BCE. The tables train by
plain autodiff under the same Adam as the MLP (`make_ranker_train_step`),
so, unlike the two-tower step's row-wise Adagrad, they need a dense
gradient:

- forward: each feature's pooled lookup is kernel #1 (`pooled_lookup`, the
  two-tower model's own gather) inside `PooledLookup`, an autograd Function;
- backward: the slot rows `w[b, l] * g[b]` (in the reference's rounding
  order: the pooled gradient divided by the bag's live count for mean
  pooling, then masked, in the compute dtype), their ids sorted stably on
  the device, and kernel #3 (`block_sorted_aggregate`, with the sort's
  permutation) sums them by id into a dense `[N, D]` table gradient of the
  table's dtype. A stable sort keeps each id's rows in (b, l) order, the
  order in which XLA's CPU scatter sums the reference's transpose of
  `jnp.take`. A bf16 table's gradient is that scatter in bf16: each slot row
  rounded to bf16 (the transpose of the cast to the compute dtype), then
  added from bf16 zero with a rounding after every add, #3's bf16 mode.

The MLP's products are `_mm` (f32 sums, one rounding to the compute dtype),
the bias added in the compute dtype, as the reference's `jnp.dot` with
`preferred_element_type=f32`. Dropout draws from an explicit
`torch.Generator`, so a step is deterministic given it (its draws are not
`jax.random`'s).

The tables and the MLP take `cfg.param_dtype` (f32 or bf16), as the
reference's; over bf16 parameters the one Adam is `OptaxAdam`, optax's
arithmetic in bf16.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from two_tower_recommender_model_tpu_torch.config import ModelConfig
from two_tower_recommender_model_tpu_torch.data.featurizer import Batch
from two_tower_recommender_model_tpu_torch.models.losses import bce_with_logits
from two_tower_recommender_model_tpu_torch.models.mlp import MLP, init_mlp
from two_tower_recommender_model_tpu_torch.models.two_tower import (
    copy_from_numpy,
    init_table,
    torch_dtype,
)
from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import block_sorted_aggregate
from two_tower_recommender_model_tpu_torch.ops.embedding_ops import pooled_lookup
from two_tower_recommender_model_tpu_torch.ops.tower_fwd import _mm
from two_tower_recommender_model_tpu_torch.train.optimizer import DenseOptimizer, dense_optimizer


def slot_row_grads(g: torch.Tensor, mask: torch.Tensor, pooling: str) -> torch.Tensor:
    """`[B, L, D]`: the gradient of each slot's row from the pooled gradient
    `g` `[B, D]`, in g's dtype: `g / max(count, 1) * mask` for mean pooling,
    `g * mask` for sum, the transpose of the reference's masked pool."""
    if pooling == "mean":
        counts = mask.sum(dim=1, keepdim=True).to(g.dtype)
        g = g / torch.clamp(counts, min=1.0)
    elif pooling != "sum":
        raise ValueError(f"unknown pooling {pooling!r}")
    return g[:, None, :] * mask[..., None].to(g.dtype)


def table_grad(num_rows: int, ids: torch.Tensor, mask: torch.Tensor, rows: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The dense `[num_rows, D]` gradient of a table of `dtype` from its
    slots' rows `[B, L, D]`: dead slots dropped (the sentinel id), the ids
    sorted stably on the device, each id's rows summed in (b, l) order by
    kernel #3 with the sort's permutation: in f32, or for a bf16 table in
    #3's bf16 mode (the rows rounded to bf16, a rounding after every add)."""
    flat = torch.where(mask.reshape(-1) > 0, ids.reshape(-1).to(torch.int32), num_rows)
    sids, perm = torch.sort(flat, stable=True)
    mode = {"buffer_dtype": torch.bfloat16} if dtype == torch.bfloat16 else {}
    return block_sorted_aggregate(num_rows, sids.contiguous(),
                                  rows.reshape(-1, rows.shape[-1]).contiguous(),
                                  perm=perm.to(torch.int32), **mode)


class PooledLookup(torch.autograd.Function):
    """`pooled_lookup(table, ids, mask, pooling, compute_dtype)` with a
    gradient for the table: forward one launch of kernel #1, backward one
    launch of kernel #3 (`table_grad`)."""

    @staticmethod
    def forward(ctx, table, ids, mask, pooling, compute_dtype):
        ctx.save_for_backward(ids, mask)
        ctx.pooling, ctx.num_rows, ctx.dtype = pooling, table.shape[0], table.dtype
        return pooled_lookup(table.detach(), ids, mask, pooling, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        ids, mask = ctx.saved_tensors
        rows = slot_row_grads(g, mask, ctx.pooling)
        return table_grad(ctx.num_rows, ids, mask, rows, ctx.dtype), None, None, None, None


class Ranker(nn.Module):
    """The ranker's parameters: `tables` (one `[N, D]` parameter a table) and
    `mlp` (hidden layers, then one logit), both of `cfg.param_dtype`, filled
    by `init_ranker_params` or `ranker_params_from_numpy`."""

    def __init__(self, cfg: ModelConfig, hidden_sizes: Sequence[int],
                 device: torch.device | str):
        super().__init__()
        dtype = torch_dtype(cfg.param_dtype)
        self.tables = nn.ParameterDict({
            t.name: nn.Parameter(torch.empty((t.num_embeddings, t.embedding_dim), dtype=dtype,
                                             device=device))
            for t in cfg.tables})
        in_dim = sum(cfg.feature_table(f.name).embedding_dim for f in cfg.features)
        in_dim += cfg.query_tower.dense_dim + cfg.candidate_tower.dense_dim
        self.mlp = MLP(in_dim, (*hidden_sizes, 1), final_activation=False, dtype=dtype,
                       device=device)


def init_ranker_params(generator: torch.Generator, cfg: ModelConfig,
                       hidden_sizes: tuple[int, ...] = (128, 64)) -> Ranker:
    """Every feature (both "towers") concatenated into one MLP ending in one
    logit; tables drawn as the two-tower model's (`init_table`), the MLP as
    torch's Linear (`init_mlp`), in f32 on the generator's device, then
    rounded to `cfg.param_dtype`."""
    model = Ranker(cfg, hidden_sizes, generator.device)
    with torch.no_grad():
        for t in cfg.tables:
            model.tables[t.name].copy_(init_table(generator, t.num_embeddings, t.embedding_dim))
        fresh = init_mlp(generator, model.mlp.layers[0].in_features, (*hidden_sizes, 1),
                         final_activation=False)
        model.mlp.load_state_dict(fresh.state_dict())
    return model


def ranker_params_from_numpy(params: dict, cfg: ModelConfig,
                             device: torch.device | str | None = None) -> Ranker:
    """A `Ranker` from the JAX package's params as numpy arrays,
    `{"tables": {name: [N, D]}, "mlp": {"layer_i": {"kernel": [in, out],
    "bias": [out]}}}` (kernels transposed into `nn.Linear` layout). A bf16
    parameter takes its values as f32 (rounded once) or as bf16 bits: an
    `ml_dtypes` bfloat16 array or its uint16 view, as `params_from_numpy`."""
    from two_tower_recommender_model_tpu_torch.device import resolve_device

    hidden = tuple(np.asarray(params["mlp"][f"layer_{i}"]["bias"]).shape[0]
                   for i in range(len(params["mlp"]) - 1))
    model = Ranker(cfg, hidden, resolve_device(device))
    with torch.no_grad():
        for name, t in params["tables"].items():
            copy_from_numpy(model.tables[name], t, name)
        for i, layer in enumerate(model.mlp.layers):
            src = params["mlp"][f"layer_{i}"]
            copy_from_numpy(layer.weight, src["kernel"], f"mlp/layer_{i}/kernel", transpose=True)
            copy_from_numpy(layer.bias, src["bias"], f"mlp/layer_{i}/bias")
    return model


def ranker_forward(params: Ranker, batch: Batch, cfg: ModelConfig, dropout_rate: float = 0.0,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """`[B]` logits. Hidden blocks are Linear + ReLU + Dropout (with
    `dropout_rate` > 0 and a `generator`: each value kept with probability
    1 - rate and scaled by 1 / (1 - rate)), the final layer linear."""
    compute_dtype = torch_dtype(cfg.compute_dtype)
    gather_dtype = compute_dtype if cfg.compute_dtype != cfg.resolved_table_dtype else None
    xs = []
    for fc in cfg.features:
        feat = batch.features[fc.name]
        xs.append(PooledLookup.apply(params.tables[fc.table], feat.ids, feat.mask, fc.pooling,
                                     gather_dtype))
    if batch.dense is not None:
        xs.append(batch.dense.to(xs[0].dtype))
    x = torch.cat(xs, dim=1).to(compute_dtype)
    layers = params.mlp.layers
    for i, layer in enumerate(layers):
        x = _mm(x, layer.weight.to(compute_dtype).T) + layer.bias.to(compute_dtype)
        if i < len(layers) - 1:
            x = torch.relu(x)
            if dropout_rate > 0.0 and generator is not None:
                x = dropout(x, dropout_rate, generator)
    return x[:, 0]


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Each value kept with probability 1 - rate (one uniform draw a value
    from `generator`) and divided by 1 - rate, the others 0."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    # a tensor divisor: a true division on the card too
    return torch.where(keep, x / x.new_full((), 1.0 - rate), 0.0)


def make_ranker_train_step(cfg: ModelConfig, learning_rate: float = 1e-3,
                           dropout_rate: float = 0.0):
    """The ranker's training: ONE Adam (optax's semantics, the port's
    `dense_optimizer`) over the tables and the MLP by plain autodiff. Returns
    `(step, init_fn)`: `init_fn(generator, hidden_sizes=(128, 64))` makes the
    state `{"params": Ranker, "opt", "step": 0, "generator"}` on the
    generator's device, and `step(state, batch) -> (state, {"loss",
    "logits"})` updates it in place; dropout draws from the state's
    generator."""
    recipe: DenseOptimizer = dense_optimizer(learning_rate)

    def init_fn(generator: torch.Generator, hidden_sizes=(128, 64)) -> dict:
        params = init_ranker_params(generator, cfg, hidden_sizes)
        return {"params": params, "opt": recipe.build(params.parameters()), "step": 0,
                "generator": generator}

    def step(state: dict, batch: Batch):
        opt = state["opt"]
        opt.zero_grad(set_to_none=True)
        gen = state["generator"] if dropout_rate > 0 else None
        logits = ranker_forward(state["params"], batch, cfg, dropout_rate, gen)
        loss = bce_with_logits(logits, batch.labels)
        loss.backward()
        recipe.step(opt, state["step"])
        state["step"] += 1
        return state, {"loss": loss.detach(), "logits": logits.detach()}

    return step, init_fn
