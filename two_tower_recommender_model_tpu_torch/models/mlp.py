"""MLP towers matching `torchrec.modules.mlp.MLP` semantics.

Port of `two_tower_recommender_model_tpu/models/mlp.py` (`init_mlp` and the
forward of `apply_mlp`). Each layer is Linear -> activation, *including the
final layer* (torchrec applies the activation unconditionally, so the
reference towers emit non-negative embeddings); `final_activation=False`
gives the linear-head variant.

Weights live in `nn.Linear` layout, `weight` `[out, in]`; the JAX package
keeps `kernel` `[in, out]` (`params_from_numpy` in `models/two_tower.py`
transposes between them).

The fused Pallas tower backward (`_mlp2_relu`) is not ported yet: it belongs
to the training step.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS = {
    "relu": torch.relu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "none": lambda x: x,
}


def apply_mlp(
    layers: Sequence[nn.Linear],
    x: torch.Tensor,
    activation: str = "relu",
    final_activation: bool = True,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """The tower forward. With `compute_dtype`, inputs and weights are cast to
    it, each matmul accumulates in float32, its result is cast to the compute
    dtype, and the bias is added in that dtype (the reference's bf16 rule)."""
    act = _ACTIVATIONS[activation]
    n = len(layers)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    for i, layer in enumerate(layers):
        kernel, bias = layer.weight, layer.bias
        if compute_dtype is not None:
            kernel = kernel.to(compute_dtype)
            bias = bias.to(compute_dtype)
        x = torch.matmul(x.float(), kernel.float().T).to(x.dtype) + bias
        if i < n - 1 or final_activation:
            x = act(x)
    return x


class MLP(nn.Module):
    """A stack of `nn.Linear` layers run by `apply_mlp`. Parameters are left
    uninitialized (no draw from the global generator): fill them with
    `init_mlp` or copy weights in."""

    def __init__(self, in_size: int, layer_sizes: Sequence[int], activation: str = "relu",
                 final_activation: bool = True, dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        sizes = [in_size, *layer_sizes]
        device = "cpu" if device is None else device
        self.layers = nn.ModuleList(
            torch.nn.utils.skip_init(nn.Linear, a, b, dtype=dtype, device=device)
            for a, b in zip(sizes[:-1], sizes[1:])
        )
        self.activation = activation
        self.final_activation = final_activation

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
        return apply_mlp(self.layers, x, self.activation, self.final_activation, compute_dtype)


def init_mlp(
    generator: torch.Generator,
    in_size: int,
    layer_sizes: Sequence[int],
    dtype: torch.dtype = torch.float32,
    activation: str = "relu",
    final_activation: bool = True,
) -> MLP:
    """Torch-Linear-style init: W ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the same
    for the bias, drawn from `generator` on the generator's device."""
    mlp = MLP(in_size, layer_sizes, activation, final_activation, dtype, generator.device)
    with torch.no_grad():
        for layer in mlp.layers:
            bound = 1.0 / layer.in_features ** 0.5
            layer.weight.uniform_(-bound, bound, generator=generator)
            layer.bias.uniform_(-bound, bound, generator=generator)
    return mlp
