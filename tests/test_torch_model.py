"""The port's MLP towers and TwoTower forward against the JAX package's, on
the same numpy weights and batches (JAX at "highest" matmul precision)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu import config as cfg_lib
from two_tower_recommender_model_tpu.data.featurizer import Featurizer as JaxFeaturizer
from two_tower_recommender_model_tpu.models import two_tower as jax_two_tower
from two_tower_recommender_model_tpu.models.mlp import apply_mlp as jax_apply_mlp
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.models import two_tower
from two_tower_recommender_model_tpu_torch.models.mlp import MLP, apply_mlp, init_mlp

# f32: the same products, summed in another order; bf16: one rounding of an
# O(1) value is up to 2^-8 relative, a few of them compound through two layers
TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=0, atol=2e-2)}


def numpy_params(cfg, seed=0):
    """Seeded weights in the JAX pytree layout."""
    rng = np.random.default_rng(seed)
    params = {"tables": {t.name: rng.uniform(-1, 1, (t.num_embeddings, t.embedding_dim))
                         .astype(np.float32) for t in cfg.tables}}
    for key in ("query_tower", "candidate_tower"):
        tower = getattr(cfg, key)
        sizes = [jax_two_tower.tower_in_dim(cfg, tower), *tower.layer_sizes]
        params[key] = {}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            bound = 1.0 / np.sqrt(a)
            params[key][f"layer_{i}"] = {
                "kernel": rng.uniform(-bound, bound, (a, b)).astype(np.float32),
                "bias": rng.uniform(-bound, bound, b).astype(np.float32),
            }
    return params


def model_config(final_activation=True, compute_dtype="float32", rich=False, dim=32):
    """The flagship pair at 1,000 users x 300 items; `rich` adds a 3-slot
    mean-pooled history bag to the query tower and dense side inputs."""
    cfg = cfg_lib.two_tower_model_config(1000, 300, embedding_dim=dim, layer_sizes=(64, 32),
                                         compute_dtype=compute_dtype)
    qt = dataclasses.replace(cfg.query_tower, final_activation=final_activation)
    ct = dataclasses.replace(cfg.candidate_tower, final_activation=final_activation)
    if rich:
        items = dataclasses.replace(cfg.tables[1], feature_names=("product_id", "history"))
        cfg = dataclasses.replace(
            cfg, tables=(cfg.tables[0], items),
            features=cfg.features + (cfg_lib.FeatureConfig("history", items.name, 3, "mean"),))
        qt = dataclasses.replace(qt, features=("user_id", "history"), dense_dim=4)
        ct = dataclasses.replace(ct, dense_dim=4)
    cfg = dataclasses.replace(cfg, query_tower=qt, candidate_tower=ct)
    cfg.validate()
    return cfg


def port(cfg):
    """The same configuration in the port's own dataclasses."""
    return port_config.model_config_from_dict(dataclasses.asdict(cfg))


def columns(cfg, n=96, seed=1):
    rng = np.random.default_rng(seed)
    cols = {"user_id": rng.integers(0, 3000, n), "product_id": rng.integers(0, 900, n),
            "label": rng.integers(0, 2, n)}
    cols["user_id"][::7] = 0
    dense_cols = ()
    if any(f.name == "history" for f in cfg.features):
        cols["history"] = rng.integers(0, 900, (n, 3))
        cols["history"][::3, 1:] = 0
        dense_cols = tuple(f"d{i}" for i in range(4))
        for c in dense_cols:
            cols[c] = rng.normal(size=n)
    return cols, dense_cols


def test_params_round_trip():
    cfg = model_config(rich=True)
    params = numpy_params(cfg)
    back = two_tower.params_to_numpy(two_tower.params_from_numpy(params, port(cfg), "cpu"))
    assert back.keys() == params.keys()
    for name, t in params["tables"].items():
        np.testing.assert_array_equal(back["tables"][name], t)
    for key in ("query_tower", "candidate_tower"):
        assert back[key].keys() == params[key].keys()
        for lname, layer in params[key].items():
            for p, arr in layer.items():
                np.testing.assert_array_equal(back[key][lname][p], arr)


def test_params_from_numpy_rejects_wrong_shapes():
    cfg = model_config()
    params = numpy_params(cfg)
    params["query_tower"]["layer_0"]["kernel"] = params["query_tower"]["layer_0"]["kernel"].T
    with pytest.raises(ValueError, match="kernel shape"):
        two_tower.params_from_numpy(params, port(cfg), "cpu")


# gelu runs at f32 only: jax.nn.gelu evaluates its tanh polynomial in bf16
# with a rounding per step, torch in f32 with one rounding at the end, so
# their bf16 gelus differ by more than the matmul rule under test
@pytest.mark.parametrize("final_activation", [True, False])
@pytest.mark.parametrize("activation,compute_dtype", [
    ("relu", "float32"), ("relu", "bfloat16"), ("tanh", "float32"), ("tanh", "bfloat16"),
    ("gelu", "float32")])
def test_apply_mlp_matches_jax(activation, final_activation, compute_dtype):
    rng = np.random.default_rng(3)
    sizes = (64, 32)
    x = rng.normal(size=(40, 48)).astype(np.float32)
    jparams = {}
    mlp = MLP(48, sizes, activation, final_activation, device="cpu")
    with torch.no_grad():
        for i, layer in enumerate(mlp.layers):
            k = rng.uniform(-0.2, 0.2, (layer.in_features, layer.out_features)).astype(np.float32)
            b = rng.uniform(-0.2, 0.2, layer.out_features).astype(np.float32)
            jparams[f"layer_{i}"] = {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}
            layer.weight.copy_(torch.from_numpy(k.T.copy()))
            layer.bias.copy_(torch.from_numpy(b))
    want = np.asarray(jax_apply_mlp(jparams, jnp.asarray(x), activation, final_activation,
                                    jnp.dtype(compute_dtype)).astype(jnp.float32))
    with torch.no_grad():
        got = apply_mlp(mlp.layers, torch.from_numpy(x), activation, final_activation,
                        getattr(torch, compute_dtype))
        via_module = mlp(torch.from_numpy(x), getattr(torch, compute_dtype))
    assert got.dtype == getattr(torch, compute_dtype)
    if compute_dtype == "float32":
        # each package against a float64 truth first, so a failure names the
        # side that left f32 accuracy (measured here: both within 3.1e-7)
        truth = _float64_mlp(x, [(p["kernel"], p["bias"]) for p in jparams.values()],
                             activation, final_activation)
        np.testing.assert_allclose(want, truth, **TOL["float32"], err_msg="JAX vs float64")
        np.testing.assert_allclose(got.numpy(), truth, **TOL["float32"],
                                   err_msg="port vs float64")
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[compute_dtype])
    assert torch.equal(via_module, got)


def _float64_mlp(x, layers, activation, final_activation):
    acts = {"relu": lambda v: np.maximum(v, 0), "tanh": np.tanh,
            "gelu": lambda v: 0.5 * v * (1 + np.tanh(np.sqrt(2 / np.pi) * (v + 0.044715 * v**3)))}
    h = x.astype(np.float64)
    for i, (k, b) in enumerate(layers):
        h = h @ np.asarray(k, np.float64) + np.asarray(b, np.float64)
        if i < len(layers) - 1 or final_activation:
            h = acts[activation](h)
    return h


def test_init_mlp_uses_the_generator():
    a = init_mlp(torch.Generator().manual_seed(4), 16, (8, 4))
    b = init_mlp(torch.Generator().manual_seed(4), 16, (8, 4))
    for la, lb in zip(a.layers, b.layers):
        assert torch.equal(la.weight, lb.weight) and torch.equal(la.bias, lb.bias)
        bound = 1.0 / la.in_features ** 0.5
        assert la.weight.abs().max() <= bound and la.bias.abs().max() <= bound


def test_init_params_shapes_and_bounds():
    cfg = model_config(rich=True)
    model = two_tower.init_params(port(cfg), torch.Generator().manual_seed(0))
    for t in cfg.tables:
        table = model.tables[t.name]
        assert tuple(table.shape) == (t.num_embeddings, t.embedding_dim)
        assert table.abs().max() <= (1.0 / t.num_embeddings) ** 0.5
        assert not table.requires_grad
    assert model.query_tower.layers[0].in_features == 2 * 32 + 4


@pytest.mark.parametrize("rich", [False, True])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("final_activation", [True, False])
def test_forward_and_score_match_jax(final_activation, compute_dtype, rich):
    cfg = model_config(final_activation, compute_dtype, rich)
    params = numpy_params(cfg)
    cols, dense_cols = columns(cfg)
    jbatch = JaxFeaturizer(cfg, dense_cols=dense_cols)(cols)
    jparams = {"tables": {k: jnp.asarray(v) for k, v in params["tables"].items()},
               **{key: {ln: {p: jnp.asarray(a) for p, a in layer.items()}
                        for ln, layer in params[key].items()}
                  for key in ("query_tower", "candidate_tower")}}
    jq, jc = jax_two_tower.forward(jparams, jbatch, cfg)
    jscore = jax_two_tower.score(jparams, jbatch, cfg)

    model = two_tower.params_from_numpy(params, port(cfg), "cpu")
    batch = Featurizer(port(cfg), dense_cols=dense_cols, device="cpu")(cols)
    with torch.no_grad():
        q, c = two_tower.forward(model, batch)
        s = two_tower.score(model, batch)
        q2, c2 = model(batch)
    for got, want in ((q, jq), (c, jc), (s, jscore)):
        assert got.dtype == getattr(torch, compute_dtype)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   **TOL[compute_dtype])
    assert torch.equal(q, q2) and torch.equal(c, c2)
