"""`TrainConfig(device_sorted_gather=True)` in the port against the JAX
package: the block kernels' shapes gate, `device_sorted_lookup` (a device
sort, the table's gather at one slot, the inverse permute; the JAX package's
Pallas block gather in interpret mode), the route's features, and train
steps with f32 and int8 tables under both block modes in f32 compute, where
the bf16 mode rounds the pooled rows to bf16 on that route only.

Tolerances. The gathered rows are exact in both packages: f32 rows, their
bf16 rounding, and an int8 row's f32 dequantization. The steps: f32 mode at
1e-5 x each quantity's largest magnitude (f32 summation order, as
`test_torch_train_step.py`); bf16 mode at 2^-7 (the update's gradients are
rounded to bf16 in both packages, and a gradient summed in another f32 order
on a rounding boundary lands on the other side: two bf16 ulps); an int8
table's dequantized rows within one quantization step (scale / 127) on top,
as `test_torch_train_int8.py` holds them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu import config as jax_config
from two_tower_recommender_model_tpu.data.device_featurizer import (
    PackedFeaturizer as JaxPackedFeaturizer,
)
from two_tower_recommender_model_tpu.data.device_featurizer import (
    make_packed_train_step as jax_make_packed_train_step,
)
from two_tower_recommender_model_tpu.ops import block_sorted as jax_bs
from two_tower_recommender_model_tpu.ops import quantized as jq
from two_tower_recommender_model_tpu.train import step as jax_step
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.data.device_featurizer import (
    PackedFeaturizer,
    make_packed_train_step,
)
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.models.two_tower import (
    params_from_numpy,
    pooled_embeddings,
)
from two_tower_recommender_model_tpu_torch.ops import embedding_ops
from two_tower_recommender_model_tpu_torch.ops import quantized as pq
from two_tower_recommender_model_tpu_torch.train import step as port_step
from two_tower_recommender_model_tpu_torch.train.pipeline import map_leaves


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test steps are small, and the suite runs
    several test processes on the same cores, where torch's thread pools
    would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


USERS, ITEMS, D, B = 300, 80, 128, 256


@pytest.mark.parametrize("d,m,c", [(128, 256, 512), (128, 512, 512), (128, 1024, 512),
                                   (256, 768, 512), (128, 384, 512), (64, 512, 512),
                                   (128, 200, 512), (128, 128, 512), (128, 1024, 256),
                                   (100, 1024, 512), (128, 640, 128)])
def test_block_sorted_shapes_gate_equals_the_reference(d, m, c):
    assert embedding_ops.block_sorted_shapes_ok(d, m, c) == jax_bs.block_sorted_shapes_ok(d, m, c)


def _ids(rng, n, m):
    ids = rng.integers(0, n, m).astype(np.int32)
    ids[::7] = n  # sentinels: zero rows
    return ids


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_device_sorted_lookup_matches_the_reference(matmul_dtype):
    """Unsorted ids with repeats and sentinels into an f32 table: the rows in
    batch order, bit for bit the reference's (its block gather in interpret
    mode), bf16-rounded under the bf16 mode; the f32 mode is the plain
    gather's `table[ids]`."""
    rng = np.random.default_rng(3)
    table = rng.uniform(-0.5, 0.5, (USERS, D)).astype(np.float32)
    ids = _ids(rng, USERS, B)
    want = np.array(jax_bs.device_sorted_lookup(jnp.asarray(table), jnp.asarray(ids),
                                                 matmul_dtype=matmul_dtype, interpret=True))
    got = embedding_ops.device_sorted_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                                             matmul_dtype=matmul_dtype)
    assert got.dtype == torch.float32 and got.shape == (B, D)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = np.where((ids < USERS)[:, None], table[np.minimum(ids, USERS - 1)], 0.0)
    if matmul_dtype == "float32":
        np.testing.assert_array_equal(got.numpy(), plain)
    else:
        rounded = torch.from_numpy(plain).bfloat16().float().numpy()
        np.testing.assert_array_equal(got.numpy(), rounded)
        assert (got.numpy() != plain).any()
    bf16 = embedding_ops.device_sorted_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                                              matmul_dtype=matmul_dtype, out_dtype=torch.bfloat16)
    np.testing.assert_array_equal(bf16.float().numpy(), torch.from_numpy(want).bfloat16().float())


def test_device_sorted_lookup_of_an_int8_table_matches_the_reference():
    rng = np.random.default_rng(4)
    rows = rng.uniform(-0.5, 0.5, (USERS, D)).astype(np.float32)
    jt = jq.quantize_table(jnp.asarray(rows))
    ids = _ids(rng, USERS, B)
    want = np.asarray(jax_bs.device_sorted_lookup(jt, jnp.asarray(ids), interpret=True))
    pt = pq.QuantizedTable(torch.from_numpy(np.array(jt.values)),
                           torch.from_numpy(np.array(jt.scales)))
    for mode in ("float32", "bfloat16"):  # an int8 table's rows are f32 either way
        got = embedding_ops.device_sorted_lookup(pt, torch.from_numpy(ids), matmul_dtype=mode)
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-7, atol=0)
        assert (got.numpy()[ids == USERS] == 0).all()


def _configs(table_dtype, kernel, sorted_feature=None, flag=True):
    cfg = jax_config.two_tower_model_config(USERS, ITEMS, embedding_dim=D, layer_sizes=(128, 64))
    cfg = dataclasses.replace(cfg, table_dtype=table_dtype, fused_tower_backward="off")
    tcfg = jax_config.TrainConfig(batch_size=B, sorted_feature=sorted_feature,
                                  block_sorted_kernel=kernel, device_sorted_gather=flag,
                                  sparse_learning_rate=0.05, learning_rate=1e-3)
    return (cfg, tcfg, port_config.model_config_from_dict(dataclasses.asdict(cfg)),
            port_config.TrainConfig(**dataclasses.asdict(tcfg)))


def test_the_route_takes_the_references_features():
    """Both single-slot features when nothing is host-sorted; the item
    feature alone beside a host-sorted user feature; none with the block
    kernels off, with the flag off, or for a batch off the kernels' tiling
    (as `jax_step`'s `_device_sorted_features` decides)."""
    cols = SyntheticClickstream(USERS, ITEMS, seed=7).sample(B, start=0)
    feat = Featurizer(_configs("float32", "float32")[2], device="cpu")
    batch, odd = feat(cols), feat({k: v[:200] for k, v in cols.items()})
    want = {"both": ("user_id", "product_id"), "item": ("product_id",), "off": (), "flag": (),
            "odd": ()}
    for case, (kernel, sorted_feature, flag, b) in {
            "both": ("float32", None, True, batch), "item": ("bfloat16", "user_id", True, batch),
            "off": ("off", None, True, batch), "flag": ("float32", None, False, batch),
            "odd": ("float32", None, True, odd)}.items():
        _, _, pcfg, ptcfg = _configs("float32", kernel, sorted_feature, flag)
        assert port_step.device_sorted_features(pcfg, ptcfg, b) == want[case], case


def _numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    params = {"tables": {}}
    for t in cfg.tables:
        rows = rng.uniform(-0.5, 0.5, (t.num_embeddings, t.embedding_dim)).astype(np.float32)
        if cfg.table_dtype_of(t.name) == "int8":
            qt = jq.quantize_table(jnp.asarray(rows))
            rows = {"values": np.array(qt.values), "scales": np.array(qt.scales)}
        params["tables"][t.name] = rows
    for key in ("query_tower", "candidate_tower"):
        sizes = [D, *getattr(cfg, key).layer_sizes]
        params[key] = {}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            bound = 1.0 / np.sqrt(a)
            params[key][f"layer_{i}"] = {
                "kernel": rng.uniform(-bound, bound, (a, b)).astype(np.float32),
                "bias": rng.uniform(-bound, bound, b).astype(np.float32)}
    return params


def _states(cfg, tcfg, pcfg, ptcfg, params):
    jstate, jopt = jax_step.create_train_state(jax.random.key(0), cfg, tcfg)
    tables = {name: jq.QuantizedTable(values=jnp.asarray(t["values"]),
                                      scales=jnp.asarray(t["scales"]))
              if isinstance(t, dict) else jnp.asarray(t) for name, t in params["tables"].items()}
    dense = {k: jax.tree.map(jnp.asarray, params[k]) for k in ("query_tower", "candidate_tower")}
    jstate = jstate.replace(tables=tables, dense_params=dense, dense_opt_state=jopt.init(dense))
    pstate, popt = port_step.create_train_state(torch.Generator().manual_seed(0), pcfg, ptcfg)
    model = params_from_numpy(params, pcfg, "cpu")
    pstate = port_step.TrainState(0, model, pstate.adagrad_acc,
                                  popt.build(port_step.tower_parameters(model)),
                                  pstate.item_counts)
    return jstate, jopt, pstate, popt


def _dense(table):
    if isinstance(table, pq.QuantizedTable):
        return pq.dequantize_table(table).numpy()
    if isinstance(table, jq.QuantizedTable):
        return np.asarray(jq.dequantize_table(table))
    return np.asarray(table.detach() if isinstance(table, torch.Tensor) else table)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("kernel", ["float32", "bfloat16"])
@pytest.mark.parametrize("table_dtype", ["float32", "int8"])
def test_device_sorted_gather_steps_match_jax(table_dtype, kernel):
    """Three packed steps with `device_sorted_gather=True` and no host sort,
    so both features take the route, from the same numpy state: the loss
    and logits of each step, and after the first the tables' change, the
    accumulators and the towers' gradients (Adam's first moment), against
    the JAX package's step. Before the steps, the rounding rule: under the
    bf16 mode a float table's pooled rows are bf16 values in f32 compute,
    where the plain gather (the flag off) keeps them f32."""
    rel = 1e-5 if kernel == "float32" else 2.0 ** -7
    cfg, tcfg, pcfg, ptcfg = _configs(table_dtype, kernel)
    params = _numpy_params(cfg)
    jstate, jopt, pstate, popt = _states(cfg, tcfg, pcfg, ptcfg, params)
    jtrain = jax_make_packed_train_step(jax_step.make_train_step(cfg, tcfg, jopt, jit=False), cfg)
    ptrain = make_packed_train_step(port_step.make_train_step(pcfg, ptcfg, popt), pcfg)
    jfeat, pfeat = JaxPackedFeaturizer(cfg), PackedFeaturizer(pcfg)
    ds = SyntheticClickstream(USERS, ITEMS, seed=7)
    cols = [ds.sample(B, start=i) for i in range(3)]
    for c in cols:
        c["user_id"][::11] = 0  # missing ids: dead slots, the sentinel's zero rows

    batch = Featurizer(pcfg, device="cpu")(cols[0])
    routed = pooled_embeddings(pstate.model.tables, batch, pcfg, block_sorted_dtype=kernel,
                               device_sorted_features=("user_id", "product_id"))
    plain = pooled_embeddings(pstate.model.tables, batch, pcfg)
    for name, rows in routed.items():
        assert rows.dtype == torch.float32
        assert (rows[batch.features[name].mask[:, 0] == 0] == 0).all()
        if kernel == "bfloat16" and table_dtype == "float32":
            assert torch.equal(rows, rows.bfloat16().float()) and not torch.equal(rows, plain[name])
            assert torch.equal(rows, plain[name].bfloat16().float())
        else:
            assert torch.equal(rows, plain[name])

    start = {name: _dense(t).copy() for name, t in pstate.model.tables.items()}  # in place
    for i, c in enumerate(cols):
        jstate, jout = jtrain(jstate, jax.tree.map(jnp.asarray, jfeat(c)))
        pstate, pout = ptrain(pstate, map_leaves(pfeat(c), lambda t: t))
        _close(pout["loss"].item(), float(jout["loss"]), rel)
        _close(pout["logits"], jout["logits"], rel)
        if i:
            continue
        for name, t in pstate.model.tables.items():
            got, want, t0 = _dense(t), _dense(jstate.tables[name]), start[name]
            moved = np.any(want != t0, axis=1)
            assert moved.any() and not moved.all()
            np.testing.assert_array_equal(got[~moved], t0[~moved])
            tol = rel * np.abs(want - t0).max()
            if table_dtype == "int8":
                tol = tol + np.maximum(t.scales.numpy(),
                                       np.asarray(jstate.tables[name].scales))[:, None] / 127
            assert (np.abs(got - want) <= tol).all(), (name, np.abs(got - want).max())
            _close(pstate.adagrad_acc[name], jstate.adagrad_acc[name],
                   rel if kernel == "float32" else 2.0 ** -6)
        mu = jstate.dense_opt_state[0].mu
        for key in ("query_tower", "candidate_tower"):
            for j, layer in enumerate(getattr(pstate.model, key).layers):
                m = pstate.dense_opt_state.state
                _close(m[layer.weight]["exp_avg"].T, mu[key][f"layer_{j}"]["kernel"], rel)
                _close(m[layer.bias]["exp_avg"], mu[key][f"layer_{j}"]["bias"], rel)
    assert pstate.step == 3
