"""The int8 slice as a whole against the JAX package: train steps from the
same numpy int8 values and scales, the `sparse_update` override routes, the
portable export in both directions, and the serving stack on an int8 model."""

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
from two_tower_recommender_model_tpu.evaluation.retrieval import (
    export_feature_embeddings as jax_export_embeddings,
)
from two_tower_recommender_model_tpu.ops import quantized as jq
from two_tower_recommender_model_tpu.serving import RetrievalService as JaxRetrievalService
from two_tower_recommender_model_tpu.serving import Scorer as JaxScorer
from two_tower_recommender_model_tpu.serving import load_scorer as jax_load_scorer
from two_tower_recommender_model_tpu.train import optimizer as jax_opt
from two_tower_recommender_model_tpu.train import step as jax_step
from two_tower_recommender_model_tpu.utils.checkpoint import export_model as jax_export_model
from two_tower_recommender_model_tpu.utils.checkpoint import load_model as jax_load_model
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.data.device_featurizer import (
    PackedFeaturizer,
    make_packed_train_step,
)
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.evaluation.retrieval import (
    evaluate_retrieval,
    export_feature_embeddings,
)
from two_tower_recommender_model_tpu_torch.models.two_tower import params_from_numpy
from two_tower_recommender_model_tpu_torch.ops import quantized as pq
from two_tower_recommender_model_tpu_torch.serving import RetrievalService, Scorer, load_scorer
from two_tower_recommender_model_tpu_torch.train import optimizer as port_opt
from two_tower_recommender_model_tpu_torch.train import step as port_step
from two_tower_recommender_model_tpu_torch.train.loop import train_val_test
from two_tower_recommender_model_tpu_torch.train.pipeline import map_leaves
from two_tower_recommender_model_tpu_torch.utils.checkpoint import export_model, load_model


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


def _port(cfg):
    return port_config.model_config_from_dict(dataclasses.asdict(cfg))


def _numpy_params(cfg, seed=0, int8=True):
    """Tables as numpy int8 values and scales (quantized by the JAX package),
    towers as f32 arrays: what both packages start from."""
    rng = np.random.default_rng(seed)
    params = {"tables": {}}
    for t in cfg.tables:
        rows = rng.uniform(-0.5, 0.5, (t.num_embeddings, t.embedding_dim)).astype(np.float32)
        if int8 and cfg.table_dtype_of(t.name) == "int8":
            qt = jq.quantize_table(jnp.asarray(rows))
            rows = {"values": np.array(qt.values), "scales": np.array(qt.scales)}
        params["tables"][t.name] = rows
    for key in ("query_tower", "candidate_tower"):
        sizes = [cfg.tables[0].embedding_dim, *getattr(cfg, key).layer_sizes]
        params[key] = {}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            bound = 1.0 / np.sqrt(a)
            params[key][f"layer_{i}"] = {
                "kernel": rng.uniform(-bound, bound, (a, b)).astype(np.float32),
                "bias": rng.uniform(-bound, bound, b).astype(np.float32)}
    return params


def _jax_params(params):
    tables = {name: jq.QuantizedTable(values=jnp.asarray(t["values"]),
                                      scales=jnp.asarray(t["scales"]))
              if isinstance(t, dict) else jnp.asarray(t) for name, t in params["tables"].items()}
    return {"tables": tables, **{k: jax.tree.map(jnp.asarray, params[k])
                                 for k in ("query_tower", "candidate_tower")}}


def _states(cfg, tcfg, params):
    pcfg, ptcfg = _port(cfg), port_config.TrainConfig(**dataclasses.asdict(tcfg))
    jstate, jopt = jax_step.create_train_state(jax.random.key(0), cfg, tcfg)
    jparams = _jax_params(params)
    dense = {k: jparams[k] for k in ("query_tower", "candidate_tower")}
    jstate = jstate.replace(tables=jparams["tables"], dense_params=dense,
                            dense_opt_state=jopt.init(dense))
    pstate, popt = port_step.create_train_state(torch.Generator().manual_seed(0), pcfg, ptcfg)
    model = params_from_numpy(params, pcfg, "cpu")
    pstate = port_step.TrainState(0, model, pstate.adagrad_acc,
                                  popt.build(port_step.tower_parameters(model)),
                                  pstate.item_counts)
    return (jstate, jopt), (pstate, popt, pcfg, ptcfg)


def _dense(table):
    if isinstance(table, pq.QuantizedTable):
        return pq.dequantize_table(table).numpy()
    if isinstance(table, jq.QuantizedTable):
        return np.asarray(jq.dequantize_table(table))
    return np.asarray(table.detach() if isinstance(table, torch.Tensor) else table)


# --- train steps against the JAX package ----------------------------------------------


@pytest.mark.parametrize("kernel,compute_dtype", [("float32", "float32"), ("off", "float32"),
                                                  ("bfloat16", "bfloat16")])
def test_int8_train_steps_match_jax(kernel, compute_dtype):
    """Three packed steps, int8 tables, host-sorted by user id, from the same
    numpy values and scales. With `block_sorted_kernel` on, the JAX step runs
    its fused int8 kernels (interpret mode); "off" is its plain quantized
    update. The port runs kernel #6's plain version either way.

    After the first step every dequantized row is within one quantization
    step of the JAX package's (scale / 127: a value on a rounding boundary
    lands on either side) plus `rel` x the largest update, `rel` being the
    f32 step test's 1e-5 (summation order) or, under bf16 compute, 2^-7 (two
    bf16 ulps, as `test_torch_train_step.py` holds the f32 tables). After
    three steps the contract is the JAX package's own between its two routes
    (`test_train_step_int8_block_sorted_matches_quantized_baseline`): an
    update that landed one int8 step apart feeds back through the towers, so
    losses within rtol 1e-3 and, under f32 compute, dequantized tables within
    atol 1e-2. Under bf16 compute the end tables are not compared: the young
    accumulators (1e-9) normalise every update to about the learning rate,
    so the third step turns the bf16-level differences that steps one and
    two left in the gradients into differences of several quantization
    steps. Tables stay int8 with f32 scales and f32 accumulators."""
    cfg = jax_config.two_tower_model_config(USERS, ITEMS, embedding_dim=D,
                                            compute_dtype=compute_dtype)
    cfg = dataclasses.replace(cfg, table_dtype="int8", fused_tower_backward="off")
    tcfg = jax_config.TrainConfig(batch_size=B, sorted_feature="user_id",
                                  block_sorted_kernel=kernel, sparse_learning_rate=0.05)
    params = _numpy_params(cfg)
    (jstate, jopt), (pstate, popt, pcfg, ptcfg) = _states(cfg, tcfg, params)
    jtrain = jax_make_packed_train_step(
        jax_step.make_train_step(cfg, tcfg, jopt, jit=False), cfg)
    ptrain = make_packed_train_step(port_step.make_train_step(pcfg, ptcfg, popt), pcfg)
    jfeat = JaxPackedFeaturizer(cfg, sort_feature="user_id")
    pfeat = PackedFeaturizer(pcfg, sort_feature="user_id")
    ds = SyntheticClickstream(USERS, ITEMS, seed=7)
    start = {name: _dense(t) for name, t in pstate.model.tables.items()}
    rel = 1e-5 if compute_dtype == "float32" else 2.0 ** -7
    jlosses, plosses = [], []
    for i in range(3):
        cols = ds.sample(B, start=i)
        cols["user_id"][::11] = 0  # missing ids: dead slots
        jstate, jout = jtrain(jstate, jax.tree.map(jnp.asarray, jfeat(cols)))
        pstate, pout = ptrain(pstate, map_leaves(pfeat(cols), lambda t: t))
        jlosses.append(float(jout["loss"]))
        plosses.append(pout["loss"].float().item())
        if i == 0:
            for name, t in pstate.model.tables.items():
                got, want = _dense(t), _dense(jstate.tables[name])
                one_step = np.maximum(t.scales.numpy(),
                                      np.asarray(jstate.tables[name].scales))[:, None] / 127
                tol = rel * np.abs(want - start[name]).max() + one_step
                assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
                np.testing.assert_allclose(pstate.adagrad_acc[name].numpy(),
                                           np.asarray(jstate.adagrad_acc[name]),
                                           rtol=1e-5 if rel == 1e-5 else 2.0 ** -6, atol=1e-12)
    np.testing.assert_allclose(plosses[0], jlosses[0], rtol=rel)
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-3)
    for name, t in pstate.model.tables.items():
        assert isinstance(t, pq.QuantizedTable)
        assert t.values.dtype == torch.int8 and t.scales.dtype == torch.float32
        assert pstate.adagrad_acc[name].dtype == torch.float32
        if compute_dtype == "float32":
            np.testing.assert_allclose(_dense(t), _dense(jstate.tables[name]), atol=1e-2)
        first = params["tables"][name]
        moved = (t.values.numpy() != first["values"]).any(axis=1)
        assert moved.any() and (name != "t_user_id" or not moved.all())
        np.testing.assert_array_equal(t.scales.numpy()[~moved], first["scales"][~moved])
    assert pstate.step == 3


def test_int8_training_tracks_f32():
    """`table_dtype="int8"` trains end to end; after 25 batches the loss is
    within 0.03 of the f32 run's (the JAX package's
    `test_int8_training_tracks_f32`) and the tables are still int8."""
    results = {}
    for td in (None, "int8"):
        mcfg = port_config.two_tower_model_config(100, 60, 16, (32, 16))
        mcfg = dataclasses.replace(mcfg, table_dtype=td)
        tcfg = port_config.TrainConfig(sparse_learning_rate=0.05)
        ds = SyntheticClickstream(100, 60, seed=0)
        feat = Featurizer(mcfg, device="cpu")
        state, opt = port_step.create_train_state(torch.Generator().manual_seed(0), mcfg, tcfg)
        step = port_step.make_train_step(mcfg, tcfg, opt)
        for cols in ds.batches(256, 25):
            state, out = step(state, feat(cols))
        if td == "int8":
            assert isinstance(state.model.tables["t_user_id"], pq.QuantizedTable)
            assert state.model.tables["t_user_id"].values.dtype == torch.int8
        results[td] = out["loss"].item()
    assert abs(results["int8"] - results[None]) < 0.03, results


def test_int8_model_learns_through_the_loop():
    """The verify drive with int8 tables on the CPU, through
    `train_val_test` and `evaluate_retrieval`: val AUROC from about 0.5 to
    0.70 or above, tables int8 at the end, a copied state independent."""
    mcfg = port_config.two_tower_model_config(2000, 500, embedding_dim=32, layer_sizes=(64, 32))
    mcfg = dataclasses.replace(
        mcfg, table_dtype="int8",
        query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(mcfg.candidate_tower, final_activation=False))
    tcfg = port_config.TrainConfig(epochs=2, sparse_learning_rate=0.1, learning_rate=3e-3,
                                   limit_val_batches=4, limit_test_batches=4)
    ds = SyntheticClickstream(2000, 500, seed=11, noise=0.05, latent_dim=4)
    state, opt = port_step.create_train_state(torch.Generator().manual_seed(0), mcfg, tcfg)
    state, res = train_val_test(
        state, port_step.make_train_step(mcfg, tcfg, opt), port_step.make_eval_step(mcfg, tcfg),
        mcfg, tcfg, Featurizer(mcfg, device="cpu"),
        train_batches_factory=lambda ep: ds.batches(1024, 120, split=f"t{ep}"),
        val_batches_factory=lambda: ds.batches(1024, 4, split="val"),
        test_batches_factory=lambda: ds.batches(1024, 4, split="test"))
    assert 0.45 <= res["baseline_val_auroc"] <= 0.55
    assert res["val_auroc"] >= 0.70 and res["test_auroc"] >= 0.70
    assert all(isinstance(t, pq.QuantizedTable) for t in state.model.tables.values())
    copied = state.copy()
    qt, ct = state.model.tables["t_user_id"], copied.model.tables["t_user_id"]
    assert torch.equal(ct.values, qt.values) and ct.values.data_ptr() != qt.values.data_ptr()
    users = np.arange(1, 101)
    truth = ds.ground_truth_topk(users, k=10)
    metrics = evaluate_retrieval(state.model, {int(u): truth[i].tolist()
                                               for i, u in enumerate(users)}, k=20, ks=(10,))
    assert 0.0 <= metrics["recall_at_10"] <= 1.0 and metrics["num_users"] == 100


# --- the sparse_update override ------------------------------------------------------------


def _sorted_first(update):
    def upd(table, acc, fids, fgrads, lr, eps):
        sids, perm = torch.sort(fids, stable=True)
        return update(table, acc, sids, fgrads[perm], lr, eps)
    return upd


OVERRIDES = {
    "block_sorted_rowwise_adagrad": _sorted_first(port_opt.block_sorted_rowwise_adagrad),
    "pallas_sparse_rowwise_adagrad": port_opt.pallas_sparse_rowwise_adagrad,
    "sparse_rowwise_adagrad (returns new tensors)": port_opt.sparse_rowwise_adagrad,
    "dense_rowwise_adagrad (returns new tensors)": port_opt.dense_rowwise_adagrad,
}


@pytest.mark.parametrize("route", list(OVERRIDES))
def test_sparse_update_overrides_match_the_default_route(route):
    """Three f32 steps with `make_train_step(..., sparse_update=...)` against
    three with the default update (kernel #4's plain version): tables and
    accumulators within rtol 1e-5 / atol 1e-6 (f32 summation order). The
    step installs what an override returns, in place or new."""
    cfg = port_config.two_tower_model_config(USERS, ITEMS, embedding_dim=32, layer_sizes=(32, 16))
    tcfg = port_config.TrainConfig(batch_size=B, sorted_feature="user_id",
                                   sparse_learning_rate=0.05)
    base, opt = port_step.create_train_state(torch.Generator().manual_seed(2), cfg, tcfg)
    feat = PackedFeaturizer(cfg, sort_feature="user_id")
    ds = SyntheticClickstream(USERS, ITEMS, seed=3)
    batches = [map_leaves(feat(ds.sample(B, start=i)), lambda t: t) for i in range(3)]
    ends = []
    for sparse_update in (None, OVERRIDES[route]):
        state = base.copy()
        step = make_packed_train_step(
            port_step.make_train_step(cfg, tcfg, opt, sparse_update=sparse_update), cfg)
        for pb in batches:
            state, out = step(state, pb)
        ends.append(state)
    want, got = ends
    for name, t in want.model.tables.items():
        assert not torch.equal(t, base.model.tables[name])
        assert isinstance(got.model.tables[name], torch.nn.Parameter)
        assert not got.model.tables[name].requires_grad
        torch.testing.assert_close(got.model.tables[name].detach(), t.detach(), rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(got.adagrad_acc[name], want.adagrad_acc[name], rtol=1e-5,
                                   atol=1e-6)
    # the state still travels: its tables are the model's parameters
    assert set(got.model.state_dict()) == set(base.model.state_dict())


def test_an_int8_table_keeps_its_update_under_an_override():
    """With `sparse_update` given, a float table takes it and an int8 table
    keeps kernel #6 (the reference's routing); `pick_table_update_fn` has the
    reference's signature."""
    cfg = port_config.two_tower_model_config(USERS, ITEMS, embedding_dim=32, layer_sizes=(32, 16))
    cfg = dataclasses.replace(
        cfg, tables=(dataclasses.replace(cfg.tables[0], dtype="int8"), cfg.tables[1]))
    tcfg = port_config.TrainConfig(batch_size=B, sorted_feature="user_id")
    seen = []

    def override(table, acc, fids, fgrads, lr, eps):
        seen.append(tuple(table.shape))
        return port_opt.sparse_rowwise_adagrad(table, acc, fids, fgrads, lr, eps)

    state, opt = port_step.create_train_state(torch.Generator().manual_seed(2), cfg, tcfg)
    before = state.copy()
    step = make_packed_train_step(
        port_step.make_train_step(cfg, tcfg, opt, sparse_update=override), cfg)
    feat = PackedFeaturizer(cfg, sort_feature="user_id")
    state, _ = step(state, map_leaves(feat(SyntheticClickstream(USERS, ITEMS, seed=3).sample(B)),
                                      lambda t: t))
    assert seen == [(ITEMS, 32)]
    user = state.model.tables["t_user_id"]
    assert isinstance(user, pq.QuantizedTable)
    assert not torch.equal(user.values, before.model.tables["t_user_id"].values)
    args = (cfg, tcfg, "t_user_id")
    assert port_step.pick_table_update_fn(*args, "t_product_id", B, False, override) is override
    assert port_step.pick_table_update_fn(*args, "t_user_id", B, True, override) is not override
    assert port_step.pick_table_update_fn(cfg, tcfg, None, "t_user_id", n_flat_ids=B,
                                          quantized=True, sparse_update=None) is not None


@pytest.mark.parametrize("int8_table", ["t_user_id", "t_product_id"])
def test_an_int8_table_under_an_override_takes_f32_gradients(int8_table):
    """Under a `sparse_update` override the reference sends an int8 table to
    its plain quantized update, on f32 gradients, whatever
    `block_sorted_kernel` says; the port's kernel #6 must get f32 gradients
    too, on the host-sorted table and through the device-sort front-end. One
    packed step in f32 compute with `block_sorted_kernel="bfloat16"`, one
    int8 table, the other (f32) table under the override in both packages,
    from the same numpy values: every dequantized row within one
    quantization step (scale / 127) plus 1e-5 x the largest update, the
    accumulators within rtol 1e-5 (f32 summation order). Gradients rounded
    to bf16 move the accumulators by about 2^-9."""
    cfg = jax_config.two_tower_model_config(USERS, ITEMS, embedding_dim=D)
    cfg = dataclasses.replace(
        cfg, fused_tower_backward="off",
        tables=tuple(dataclasses.replace(t, dtype="int8") if t.name == int8_table else t
                     for t in cfg.tables))
    tcfg = jax_config.TrainConfig(batch_size=B, sorted_feature="user_id",
                                  block_sorted_kernel="bfloat16", sparse_learning_rate=0.05)
    params = _numpy_params(cfg)
    (jstate, jopt), (pstate, popt, pcfg, ptcfg) = _states(cfg, tcfg, params)
    jtrain = jax_make_packed_train_step(
        jax_step.make_train_step(cfg, tcfg, jopt, jit=False,
                                 sparse_update=jax_opt.sparse_rowwise_adagrad), cfg)
    ptrain = make_packed_train_step(
        port_step.make_train_step(pcfg, ptcfg, popt, sparse_update=port_opt.sparse_rowwise_adagrad),
        pcfg)
    cols = SyntheticClickstream(USERS, ITEMS, seed=7).sample(B)
    cols["user_id"][::11] = 0  # missing ids: dead slots
    start = {name: _dense(t) for name, t in pstate.model.tables.items()}
    jstate, _ = jtrain(jstate, jax.tree.map(jnp.asarray,
                                            JaxPackedFeaturizer(cfg, sort_feature="user_id")(cols)))
    pstate, _ = ptrain(pstate, map_leaves(PackedFeaturizer(pcfg, sort_feature="user_id")(cols),
                                          lambda t: t))
    for name, t in pstate.model.tables.items():
        got, want = _dense(t), _dense(jstate.tables[name])
        tol = 1e-5 * np.abs(want - start[name]).max()
        if name == int8_table:
            assert isinstance(t, pq.QuantizedTable)
            tol = tol + np.maximum(t.scales.numpy(),
                                   np.asarray(jstate.tables[name].scales))[:, None] / 127
        assert (np.abs(got - want) <= tol).all(), (name, np.abs(got - want).max())
        np.testing.assert_allclose(pstate.adagrad_acc[name].numpy(),
                                   np.asarray(jstate.adagrad_acc[name]), rtol=1e-5, atol=1e-12)


# --- the export, both ways ------------------------------------------------------------------


def _int8_cfg(lib):
    cfg = lib.two_tower_model_config(USERS, ITEMS, embedding_dim=16, layer_sizes=(32, 8))
    return dataclasses.replace(cfg, table_dtype="int8")


def _requests(n=40, seed=3):
    rng = np.random.default_rng(seed)
    users = rng.integers(-50, 900, n)
    users[::6] = 0
    return {"user_id": users, "product_id": rng.integers(0, 200, n)}


def test_port_int8_export_loads_in_jax(tmp_path):
    """An int8 state exports like an f32 one: dequantized f32 arrays, no
    table dtype named; the JAX package loads it and predicts the same."""
    pcfg = _int8_cfg(port_config)
    tcfg = port_config.TrainConfig(sparse_learning_rate=0.1)
    state, opt = port_step.create_train_state(torch.Generator().manual_seed(0), pcfg, tcfg)
    step = port_step.make_train_step(pcfg, tcfg, opt)
    feat = Featurizer(pcfg, device="cpu")
    for cols in SyntheticClickstream(USERS - 1, ITEMS - 1, seed=2).batches(256, 3):
        state, _ = step(state, feat(cols))
    export_model(str(tmp_path), pcfg, state)
    jcfg, jparams = jax_load_model(str(tmp_path))
    assert jcfg.table_dtype is None and all(t.dtype is None for t in jcfg.tables)
    assert jcfg == dataclasses.replace(_int8_cfg(jax_config), table_dtype=None)
    for name, qt in state.model.tables.items():
        assert jparams["tables"][name].dtype == np.float32
        np.testing.assert_array_equal(jparams["tables"][name], pq.dequantize_table(qt).numpy())
    inputs = _requests()
    served = Scorer(state.model).predict(inputs)
    np.testing.assert_array_equal(load_scorer(str(tmp_path), device="cpu").predict(inputs), served)
    np.testing.assert_allclose(jax_load_scorer(str(tmp_path)).predict(inputs), served, rtol=1e-5,
                               atol=1e-6)  # f32 products summed in another order


def test_jax_int8_export_loads_in_the_port(tmp_path):
    jcfg = _int8_cfg(jax_config)
    state, _ = jax_step.create_train_state(jax.random.key(3), jcfg, jax_config.TrainConfig())
    assert isinstance(state.tables["t_user_id"], jq.QuantizedTable)
    jax_export_model(str(tmp_path), jcfg, state)
    pcfg, params = load_model(str(tmp_path))
    assert pcfg.table_dtype is None
    for name, qt in state.tables.items():
        np.testing.assert_array_equal(params["tables"][name], np.asarray(jq.dequantize_table(qt)))
    inputs = _requests()
    np.testing.assert_allclose(load_scorer(str(tmp_path), device="cpu").predict(inputs),
                               jax_load_scorer(str(tmp_path)).predict(inputs), rtol=1e-5,
                               atol=1e-6)


# --- serving an int8 model --------------------------------------------------------------------


@pytest.fixture(scope="module")
def int8_models():
    cfg = jax_config.two_tower_model_config(1000, 300, embedding_dim=32, layer_sizes=(64, 32))
    cfg = dataclasses.replace(cfg, table_dtype="int8")
    params = _numpy_params(cfg, seed=4)
    return cfg, _jax_params(params), params_from_numpy(params, _port(cfg), "cpu")


# f32 products summed in another order, and the dequantize's 1/127 (1 ulp)
F32 = dict(rtol=1e-5, atol=1e-6)


def test_int8_scorer_matches_jax(int8_models):
    cfg, jparams, model = int8_models
    inputs = _requests()
    got, ref = Scorer(model), JaxScorer(cfg, jparams)
    np.testing.assert_allclose(got.predict(inputs), ref.predict(inputs), **F32)
    for a, b in zip(got.embed(inputs), ref.embed(inputs)):
        np.testing.assert_allclose(a, b, **F32)


@pytest.mark.parametrize("feature,ids", [("user_id", np.array([0, 1, 7, -3, 1005, 999, 123456])),
                                         ("product_id", None)])
def test_int8_export_feature_embeddings_matches_jax(int8_models, feature, ids):
    cfg, jparams, model = int8_models
    want = np.asarray(jax_export_embeddings(jparams, cfg, feature, ids=ids, batch_size=128))
    got = export_feature_embeddings(model, feature, ids=ids, batch_size=128)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_int8_retrieval_service_matches_jax(int8_models):
    cfg, jparams, model = int8_models
    ref, svc = JaxRetrievalService(cfg, jparams), RetrievalService(model)
    assert svc.corpus_size == ref.corpus_size == 299
    users = [1, 7, 0, 999, 4321]
    for k in (1, 10, 299):
        items, scores = svc.retrieve(users, k=k)
        want_items, want_scores = ref.retrieve(users, k=k)
        np.testing.assert_array_equal(items, want_items)
        np.testing.assert_allclose(scores, want_scores, **F32)
