"""bf16 table storage (`table_dtype="bfloat16"`, model-wide or per table)
against the JAX package on the same numpy inputs: the update (kernel #4's
plain version on a bf16 table against the reference's two plain updates, the
only routes a bf16 table takes there), the lookup, train steps, the
sorted-table refusal, the export in both directions, the numpy round trip,
and serving.

bf16 keeps 8 significant bits: one ulp of x is at most 2^-7 |x|. Where two
versions sum f32 values in different orders and then round to bf16, a sum on
a rounding boundary lands on either neighbour: "equal or one bf16 ulp apart"
is `|a - b| <= 2^-7 max(|a|, |b|)`, plus the f32 checks' atol of 1e-6 for a
result where row and update cancel to nearly zero."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu import config as jax_config
from two_tower_recommender_model_tpu.data.featurizer import Featurizer as JaxFeaturizer
from two_tower_recommender_model_tpu.ops.embedding_ops import pooled_lookup as jax_pooled_lookup
from two_tower_recommender_model_tpu.serving import load_scorer as jax_load_scorer
from two_tower_recommender_model_tpu.train import optimizer as jax_opt
from two_tower_recommender_model_tpu.train import step as jax_step
from two_tower_recommender_model_tpu.utils.checkpoint import export_model as jax_export_model
from two_tower_recommender_model_tpu.utils.checkpoint import load_model as jax_load_model
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.models.two_tower import (
    init_params,
    params_from_numpy,
    params_to_numpy,
    pooled_embeddings,
)
from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import (
    rowwise_adagrad,
    rowwise_adagrad_reference,
)
from two_tower_recommender_model_tpu_torch.ops.embedding_ops import pooled_lookup
from two_tower_recommender_model_tpu_torch.ops.quantized import QuantizedTable
from two_tower_recommender_model_tpu_torch.serving import RetrievalService, Scorer, load_scorer
from two_tower_recommender_model_tpu_torch.train import optimizer as port_opt
from two_tower_recommender_model_tpu_torch.train import step as port_step
from two_tower_recommender_model_tpu_torch.train.loop import train_val_test
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


ULP = 2.0 ** -7  # one bf16 ulp of x is at most this times |x|


def _bf16(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to what bf16 holds (round to nearest even)."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def _one_ulp_apart(got, want):
    """Assert equal or one bf16 ulp apart everywhere; the share that differ."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert (np.abs(got - want) <= ULP * np.maximum(np.abs(got), np.abs(want)) + 1e-6).all(), \
        np.abs(got - want).max()
    return float((got != want).mean())


def _port(cfg):
    return port_config.model_config_from_dict(dataclasses.asdict(cfg))


# --- the update ------------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["sparse_rowwise_adagrad", "dense_rowwise_adagrad"])
@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_bf16_table_update_matches_the_reference_updates(route, grad_dtype):
    """`rowwise_adagrad_reference` (what `rowwise_adagrad` runs on CPU
    tensors, and what the CUDA kernel is held to) on a bf16 table against the
    reference's plain updates on the same bf16 table: every row equal or one
    bf16 ulp apart (the f32 sums run in different orders before the one
    rounding), fewer than 1% of the touched elements apart; rows no id names
    keep their bits; f32 accumulators within rtol 1e-5."""
    rng = np.random.default_rng(3)
    n, d, m = 200, 32, 600
    table = _bf16(rng.normal(size=(n, d)))
    acc = np.abs(rng.normal(size=n)).astype(np.float32)
    ids = rng.integers(0, n // 2, m).astype(np.int32)
    ids[rng.random(m) < 0.1] = n  # sentinels
    grads = rng.normal(size=(m, d)).astype(np.float32)
    if grad_dtype == "bfloat16":
        grads = _bf16(grads)
    want_t, want_a = getattr(jax_opt, route)(
        jnp.asarray(table).astype(jnp.bfloat16), jnp.asarray(acc), jnp.asarray(ids),
        jnp.asarray(grads).astype(grad_dtype), 0.05, 1e-10)
    assert want_t.dtype == jnp.bfloat16 and want_a.dtype == jnp.float32
    t = torch.from_numpy(table).to(torch.bfloat16)
    a = torch.from_numpy(acc.copy())
    g = torch.from_numpy(grads).to(getattr(torch, grad_dtype))
    got_t, got_a = rowwise_adagrad(t, a, torch.from_numpy(ids), g, 0.05, 1e-10)
    assert got_t is t and got_t.dtype == torch.bfloat16 and got_a.dtype == torch.float32
    touched = np.zeros(n, bool)
    touched[ids[ids < n]] = True
    got = got_t.float().numpy()
    np.testing.assert_array_equal(got[~touched], table[~touched])
    assert (got[touched] != table[touched]).any()
    share = _one_ulp_apart(got[touched], np.asarray(want_t.astype(jnp.float32))[touched])
    assert share < 0.01, share
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-5)


def test_bf16_table_update_through_the_device_sort_and_the_port_oracles():
    """The device-sort front-end and the port's own plain updates agree with
    the kernel's plain version on a bf16 table (one ulp), and the f32-table
    path is what it was: bitwise the f32 math."""
    rng = np.random.default_rng(4)
    n, d, m = 120, 16, 400
    table = torch.from_numpy(_bf16(rng.normal(size=(n, d)))).to(torch.bfloat16)
    acc = torch.from_numpy(np.abs(rng.normal(size=n)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, n + 1, m).astype(np.int32))
    grads = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32))
    want_t, want_a = rowwise_adagrad_reference(table.clone(), acc.clone(), ids, grads, 0.1)
    for matmul_dtype in ("float32", "bfloat16"):
        got_t, got_a = port_opt.device_sorted_fused_adagrad(
            table.clone(), acc.clone(), ids, grads, 0.1, matmul_dtype=matmul_dtype)
        if matmul_dtype == "float32":
            _one_ulp_apart(got_t.float(), want_t.float())
            torch.testing.assert_close(got_a, want_a, rtol=1e-5, atol=0)
        assert got_t.dtype == torch.bfloat16
    for oracle in (port_opt.sparse_rowwise_adagrad, port_opt.dense_rowwise_adagrad):
        got_t, got_a = oracle(table, acc, ids, grads, 0.1)
        assert got_t.dtype == torch.bfloat16
        _one_ulp_apart(got_t.float(), want_t.float())
        torch.testing.assert_close(got_a, want_a, rtol=1e-5, atol=0)


def test_bad_table_dtype_is_refused():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rowwise_adagrad(torch.zeros(4, 4, dtype=torch.float16), torch.zeros(4),
                        torch.zeros(2, dtype=torch.int32), torch.zeros(2, 4), 0.1)
    cfg = dataclasses.replace(port_config.two_tower_model_config(10, 10, 4, (4,)),
                              table_dtype="float16")
    with pytest.raises(ValueError, match="float32\\|bfloat16\\|int8"):
        port_step.create_train_state(torch.Generator().manual_seed(0), cfg,
                                     port_config.TrainConfig())


# --- the lookup ------------------------------------------------------------------------------


@pytest.mark.parametrize("compute_dtype", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("slots,pooling", [(1, "sum"), (3, "sum"), (3, "mean")])
def test_bf16_pooled_lookup_matches_jax(compute_dtype, slots, pooling):
    """One slot: bitwise the reference's (one row, cast once). Several slots:
    the reference sums the slots in the compute dtype, the port in f32 with
    one rounding, so a bf16 result may differ by one ulp of the largest
    partial sum (at most the sum of the rows' magnitudes); an f32 result by
    f32 summation order."""
    rng = np.random.default_rng(slots)
    n, d, b = 50, 16, 64
    table = _bf16(rng.normal(size=(n, d)))
    ids = rng.integers(0, n, (b, slots)).astype(np.int32)
    mask = (rng.random((b, slots)) > 0.2).astype(np.float32)
    want = jax_pooled_lookup(jnp.asarray(table).astype(jnp.bfloat16), jnp.asarray(ids),
                             jnp.asarray(mask), pooling,
                             None if compute_dtype is None else jnp.dtype(compute_dtype))
    got = pooled_lookup(torch.from_numpy(table).to(torch.bfloat16), torch.from_numpy(ids),
                        torch.from_numpy(mask), pooling,
                        None if compute_dtype is None else getattr(torch, compute_dtype))
    out_bf16 = compute_dtype in (None, "bfloat16")
    assert got.dtype == (torch.bfloat16 if out_bf16 else torch.float32)
    assert str(want.dtype) == ("bfloat16" if out_bf16 else "float32")
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    if slots == 1:
        np.testing.assert_array_equal(got, want)
        return
    partial = (np.abs(table[ids]) * mask[..., None]).sum(1)  # bounds every partial sum
    tol = (ULP if out_bf16 else 1e-6) * partial + 1e-30
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


# --- create, train, eval ---------------------------------------------------------------------


def _numpy_params(cfg, seed=0):
    """bf16 tables as f32 values that bf16 holds exactly; towers f32."""
    rng = np.random.default_rng(seed)
    params = {"tables": {}}
    for t in cfg.tables:
        rows = rng.uniform(-0.5, 0.5, (t.num_embeddings, t.embedding_dim)).astype(np.float32)
        params["tables"][t.name] = (_bf16(rows) if cfg.table_dtype_of(t.name) == "bfloat16"
                                    else rows)
    for key in ("query_tower", "candidate_tower"):
        tower = getattr(cfg, key)
        sizes = [sum(cfg.feature_table(f).embedding_dim for f in tower.features),
                 *tower.layer_sizes]
        params[key] = {}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            bound = 1.0 / np.sqrt(a)
            params[key][f"layer_{i}"] = {
                "kernel": rng.uniform(-bound, bound, (a, b)).astype(np.float32),
                "bias": rng.uniform(-bound, bound, b).astype(np.float32)}
    return params


def _states(cfg, tcfg, params):
    """The two packages' train states from the same numpy params; an int8
    table is quantized from its f32 rows by each package (the schemes agree
    bit for bit: `tests/test_torch_quantized.py`)."""
    from two_tower_recommender_model_tpu.ops.quantized import quantize_table as jq_quantize
    from two_tower_recommender_model_tpu_torch.ops.quantized import quantize_table

    pcfg, ptcfg = _port(cfg), port_config.TrainConfig(**dataclasses.asdict(tcfg))
    jstate, jopt = jax_step.create_train_state(jax.random.key(0), cfg, tcfg)
    tables = {}
    for name, rows in params["tables"].items():
        dtype = cfg.table_dtype_of(name)
        tables[name] = (jq_quantize(jnp.asarray(rows)) if dtype == "int8"
                        else jnp.asarray(rows).astype(dtype))
    dense = {k: jax.tree.map(jnp.asarray, params[k]) for k in ("query_tower", "candidate_tower")}
    jstate = jstate.replace(tables=tables, dense_params=dense, dense_opt_state=jopt.init(dense))
    pstate, popt = port_step.create_train_state(torch.Generator().manual_seed(0), pcfg, ptcfg)
    pparams = dict(params, tables=dict(params["tables"]))
    for name, rows in params["tables"].items():
        if cfg.table_dtype_of(name) == "int8":
            qt = quantize_table(torch.from_numpy(rows))
            pparams["tables"][name] = {"values": qt.values.numpy(), "scales": qt.scales.numpy()}
    model = params_from_numpy(pparams, pcfg, "cpu")
    pstate = port_step.TrainState(0, model, pstate.adagrad_acc,
                                  popt.build(port_step.tower_parameters(model)))
    return (jstate, jopt), (pstate, popt, pcfg, ptcfg)


def test_create_train_state_with_bf16_tables():
    cfg = dataclasses.replace(port_config.two_tower_model_config(100, 60, 16, (32, 16)),
                              table_dtype="bfloat16")
    gen = torch.Generator().manual_seed(5)
    state, _ = port_step.create_train_state(gen, cfg, port_config.TrainConfig())
    f32 = init_params(dataclasses.replace(cfg, table_dtype=None),
                      torch.Generator().manual_seed(5))
    for name, t in state.model.tables.items():
        assert isinstance(t, torch.nn.Parameter) and not t.requires_grad
        assert t.dtype == torch.bfloat16 and state.adagrad_acc[name].dtype == torch.float32
        # drawn in f32, cast once
        assert torch.equal(t.detach(), f32.tables[name].detach().to(torch.bfloat16))
    assert all(p.dtype == torch.float32 for p in port_step.tower_parameters(state.model))
    copied = state.copy()
    assert copied.model.tables["t_user_id"].dtype == torch.bfloat16
    assert copied.model.tables["t_user_id"].data_ptr() != state.model.tables["t_user_id"].data_ptr()


@pytest.mark.parametrize("sorted_feature", ["user_id", None])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_bf16_train_step_matches_jax(sorted_feature, compute_dtype):
    """One step with bf16 tables from the same numpy state. f32 compute: loss
    and logits within 1e-5 x max (f32 summation order), updated rows equal or
    one bf16 ulp apart, fewer than 1% of them apart, f32 accumulators within
    rtol 1e-5. bf16 compute: the gradients are bf16 values that may round
    either way, so the tables are held to two bf16 ulps of the largest update
    (2^-6 x max|update|, as the f32-table step test's 2^-7 plus the table's
    own rounding) and the accumulators, sums of their squares, to 2^-6 x
    max."""
    cfg = jax_config.two_tower_model_config(300, 80, embedding_dim=32, layer_sizes=(32, 16),
                                            compute_dtype=compute_dtype)
    cfg = dataclasses.replace(cfg, table_dtype="bfloat16", fused_tower_backward="off")
    tcfg = jax_config.TrainConfig(batch_size=256, sorted_feature=sorted_feature,
                                  block_sorted_kernel="off", sparse_learning_rate=0.05)
    params = _numpy_params(cfg)
    (jstate, jopt), (pstate, popt, pcfg, ptcfg) = _states(cfg, tcfg, params)
    cols = SyntheticClickstream(299, 79, seed=7).sample(256)
    cols["user_id"][::11] = 0
    if sorted_feature:
        order = np.argsort(np.where(cols["user_id"] == 0, 1 << 30, cols["user_id"] % 300),
                           kind="stable")
        cols = {k: v[order] for k, v in cols.items()}
    jstate, jout = jax_step.make_train_step(cfg, tcfg, jopt, donate=False)(
        jstate, jax.tree.map(jnp.asarray, JaxFeaturizer(cfg)(cols)))
    pstate, pout = port_step.make_train_step(pcfg, ptcfg, popt)(
        pstate, Featurizer(pcfg, device="cpu")(cols))
    rel = 1e-5 if compute_dtype == "float32" else 2.0 ** -7
    want_logits = np.asarray(jout["logits"].astype(jnp.float32))
    np.testing.assert_allclose(pout["logits"].float().numpy(), want_logits, rtol=0,
                               atol=rel * np.abs(want_logits).max())
    np.testing.assert_allclose(pout["loss"].float().item(), float(jout["loss"]), rtol=rel)
    for name, t0 in params["tables"].items():
        table = pstate.model.tables[name]
        assert table.dtype == torch.bfloat16 and str(jstate.tables[name].dtype) == "bfloat16"
        got = table.detach().float().numpy()
        want = np.asarray(jstate.tables[name].astype(jnp.float32))
        moved = np.any(want != t0, axis=1)
        assert moved.any() and not moved.all()
        np.testing.assert_array_equal(got[~moved], t0[~moved])
        if compute_dtype == "float32":
            assert _one_ulp_apart(got[moved], want[moved]) < 0.01
            np.testing.assert_allclose(pstate.adagrad_acc[name].numpy(),
                                       np.asarray(jstate.adagrad_acc[name]), rtol=1e-5,
                                       atol=1e-12)
        else:
            np.testing.assert_allclose(got - t0, want - t0, rtol=0,
                                       atol=2.0 ** -6 * np.abs(want - t0).max())
            want_acc = np.asarray(jstate.adagrad_acc[name])
            np.testing.assert_allclose(pstate.adagrad_acc[name].numpy(), want_acc, rtol=0,
                                       atol=2.0 ** -6 * want_acc.max())


def test_bf16_run_of_25_batches_tracks_jax_and_f32():
    """25 batches with bf16 tables in both packages from the same numpy
    state: the first loss within 1e-5, every loss within 5e-3 (roundings of
    table rows on a boundary feed back through the towers), the tables still
    bf16 with f32 accumulators; and the port's bf16 run ends within 0.01 of
    its own f32 run (the reference's `test_bfloat16_table_storage` bar)."""
    cfg = dataclasses.replace(jax_config.two_tower_model_config(100, 60, 16, (32, 16)),
                              table_dtype="bfloat16")
    tcfg = jax_config.TrainConfig(sparse_learning_rate=0.05)
    params = _numpy_params(cfg, seed=1)
    (jstate, jopt), (pstate, popt, pcfg, ptcfg) = _states(cfg, tcfg, params)
    jstep = jax_step.make_train_step(cfg, tcfg, jopt, donate=False)
    pstep = port_step.make_train_step(pcfg, ptcfg, popt)
    f32cfg = dataclasses.replace(pcfg, table_dtype=None)
    fstate = port_step.TrainState(
        0, params_from_numpy(params, f32cfg, "cpu"),
        {k: torch.zeros_like(v) for k, v in pstate.adagrad_acc.items()}, None)
    fstate.dense_opt_state = popt.build(port_step.tower_parameters(fstate.model))
    fstep = port_step.make_train_step(f32cfg, ptcfg, popt)
    jfeat, pfeat = JaxFeaturizer(cfg), Featurizer(pcfg, device="cpu")
    jl, pl, fl = [], [], []
    for cols in SyntheticClickstream(100, 60, seed=0).batches(128, 25):
        jstate, jout = jstep(jstate, jax.tree.map(jnp.asarray, jfeat(cols)))
        pstate, pout = pstep(pstate, pfeat(cols))
        fstate, fout = fstep(fstate, pfeat(cols))
        jl.append(float(jout["loss"]))
        pl.append(pout["loss"].item())
        fl.append(fout["loss"].item())
    np.testing.assert_allclose(pl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=5e-3)
    assert abs(pl[-1] - fl[-1]) < 0.01
    assert pl[-1] < pl[0]
    for name, t in pstate.model.tables.items():
        assert t.dtype == torch.bfloat16 and pstate.adagrad_acc[name].dtype == torch.float32
    assert pstate.step == 25


def _mixed_cfg(lib):
    """bf16, f32 and int8 tables in one model (per-table `dtype`), the query
    tower reading two of them."""
    return lib.ModelConfig(
        tables=(lib.TableConfig("t_a", 50, 8, dtype="bfloat16"),
                lib.TableConfig("t_b", 30, 8),
                lib.TableConfig("t_c", 40, 8, dtype="int8")),
        features=(lib.FeatureConfig("a", "t_a"), lib.FeatureConfig("b", "t_b"),
                  lib.FeatureConfig("c", "t_c")),
        query_tower=lib.TowerConfig(("a", "c"), (16, 8)),
        candidate_tower=lib.TowerConfig(("b",), (16, 8)))


def test_mixed_table_dtypes_train_step_matches_jax():
    """One bf16, one f32 and one int8 table: a step against the reference's
    on the same state. The bf16 table's pooled rows stay bf16 where the
    model-wide table dtype equals the compute dtype (the reference casts only
    when those two differ), in both packages."""
    cfg, tcfg = _mixed_cfg(jax_config), jax_config.TrainConfig(sparse_learning_rate=0.05)
    params = _numpy_params(cfg, seed=2)
    (jstate, jopt), (pstate, popt, pcfg, ptcfg) = _states(cfg, tcfg, params)
    assert pstate.model.tables["t_a"].dtype == torch.bfloat16
    assert pstate.model.tables["t_b"].dtype == torch.float32
    assert isinstance(pstate.model.tables["t_c"], QuantizedTable)
    rng = np.random.default_rng(0)
    cols = {"a": rng.integers(0, 50, 64), "b": rng.integers(1, 30, 64),
            "c": rng.integers(0, 40, 64), "label": rng.integers(0, 2, 64)}
    pbatch = Featurizer(pcfg, device="cpu")(cols)
    pooled = pooled_embeddings(pstate.model.tables, pbatch, pcfg)
    assert {k: v.dtype for k, v in pooled.items()} == {
        "a": torch.bfloat16, "b": torch.float32, "c": torch.float32}
    jstate, jout = jax_step.make_train_step(cfg, tcfg, jopt, donate=False)(
        jstate, jax.tree.map(jnp.asarray, JaxFeaturizer(cfg)(cols)))
    pstate, pout = port_step.make_train_step(pcfg, ptcfg, popt)(pstate, pbatch)
    np.testing.assert_allclose(pout["loss"].item(), float(jout["loss"]), rtol=1e-5)
    np.testing.assert_allclose(pout["logits"].numpy(), np.asarray(jout["logits"]), rtol=1e-4,
                               atol=1e-6)
    got_a = pstate.model.tables["t_a"].detach().float().numpy()
    want_a = np.asarray(jstate.tables["t_a"].astype(jnp.float32))
    assert (got_a != params["tables"]["t_a"]).any()
    # the pooled gradient of the bf16 table is a bf16 value in both packages
    np.testing.assert_allclose(got_a - params["tables"]["t_a"], want_a - params["tables"]["t_a"],
                               rtol=0, atol=2.0 ** -6 * np.abs(want_a - params["tables"]["t_a"]).max())
    np.testing.assert_allclose(pstate.model.tables["t_b"].detach().numpy(),
                               np.asarray(jstate.tables["t_b"]), rtol=1e-5, atol=1e-6)
    jc = jstate.tables["t_c"]
    assert (np.abs(pstate.model.tables["t_c"].values.numpy().astype(np.int32)
                   - np.asarray(jc.values).astype(np.int32)) <= 1).all()
    assert pstate.model.tables["t_a"].dtype == torch.bfloat16


@pytest.mark.parametrize("kernel", ["float32", "bfloat16"])
def test_sorted_bf16_table_with_the_block_kernel_is_refused_like_jax(kernel):
    """The reference's `ValueError`, in its words, from `make_train_step`."""
    cfg = dataclasses.replace(jax_config.two_tower_model_config(50, 40, 8, (8,)),
                              table_dtype="bfloat16")
    tcfg = jax_config.TrainConfig(sorted_feature="user_id", block_sorted_kernel=kernel)
    with pytest.raises(ValueError) as jerr:
        jax_step.make_train_step(cfg, tcfg, jax_opt.dense_optimizer(1e-3))
    with pytest.raises(ValueError) as perr:
        port_step.make_train_step(_port(cfg), port_config.TrainConfig(**dataclasses.asdict(tcfg)),
                                  port_opt.dense_optimizer(1e-3))
    assert str(perr.value) == str(jerr.value)
    assert "block_sorted_kernel supports float32 and int8 tables" in str(perr.value)


@pytest.mark.parametrize("kernel", ["off", "float32", "bfloat16"])
def test_a_bf16_tables_gradients_go_in_as_f32_whatever_the_block_kernel(kernel, monkeypatch):
    """The unsorted bf16 table under every `block_sorted_kernel` value, and
    the sorted one under "off": kernel #4 gets f32 gradients."""
    seen = []
    real = port_opt.rowwise_adagrad

    def record(table, acc, ids, grads, lr, eps, perm=None):
        seen.append((table.dtype, grads.dtype))
        return real(table, acc, ids, grads, lr, eps, perm=perm)

    monkeypatch.setattr(port_opt, "rowwise_adagrad", record)
    monkeypatch.setattr(port_step, "rowwise_adagrad", record)
    cfg = dataclasses.replace(port_config.two_tower_model_config(50, 40, 8, (8,)),
                              table_dtype="bfloat16")
    tcfg = port_config.TrainConfig(sorted_feature="user_id" if kernel == "off" else None,
                                   block_sorted_kernel=kernel)
    state, opt = port_step.create_train_state(torch.Generator().manual_seed(0), cfg, tcfg)
    cols = SyntheticClickstream(49, 39, seed=1).sample(32)
    cols = {k: v[np.argsort(cols["user_id"], kind="stable")] for k, v in cols.items()}
    port_step.make_train_step(cfg, tcfg, opt)(state, Featurizer(cfg, device="cpu")(cols))
    assert seen == [(torch.bfloat16, torch.float32)] * 2


def test_bf16_model_learns_evaluates_and_serves():
    """The verify drive with bf16 tables on the CPU: val AUROC from ~0.5 to
    0.70 or above through `train_val_test`; then `Scorer` and
    `RetrievalService` straight from the bf16 state, and its export loaded
    back (f32, no table dtype named) predicts the same: widening bf16 to f32
    is exact."""
    mcfg = port_config.two_tower_model_config(2000, 500, embedding_dim=32, layer_sizes=(64, 32))
    mcfg = dataclasses.replace(
        mcfg, table_dtype="bfloat16",
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
    assert all(t.dtype == torch.bfloat16 for t in state.model.tables.values())
    rng = np.random.default_rng(3)
    inputs = {"user_id": rng.integers(0, 2500, 50), "product_id": rng.integers(0, 600, 50)}
    served = Scorer(state.model).predict(inputs)
    assert served.shape == (50,) and np.isfinite(served).all()
    items, scores = RetrievalService(state.model).retrieve([1, 7, 1999], k=10)
    assert items.shape == (3, 10) and np.isfinite(scores).all()


# --- the export, both ways, and the numpy round trip -----------------------------------------


def _bf16_cfg(lib):
    cfg = lib.two_tower_model_config(300, 80, embedding_dim=16, layer_sizes=(32, 8))
    return dataclasses.replace(cfg, table_dtype="bfloat16")


def _requests(n=40, seed=3):
    rng = np.random.default_rng(seed)
    users = rng.integers(-50, 900, n)
    users[::6] = 0
    return {"user_id": users, "product_id": rng.integers(0, 200, n)}


def test_port_bf16_export_loads_in_jax(tmp_path):
    """A bf16 state exports widened to f32 and names no table dtype; the JAX
    package loads it and predicts the same."""
    pcfg = _bf16_cfg(port_config)
    tcfg = port_config.TrainConfig(sparse_learning_rate=0.1)
    state, opt = port_step.create_train_state(torch.Generator().manual_seed(0), pcfg, tcfg)
    step = port_step.make_train_step(pcfg, tcfg, opt)
    feat = Featurizer(pcfg, device="cpu")
    for cols in SyntheticClickstream(299, 79, seed=2).batches(256, 3):
        state, _ = step(state, feat(cols))
    export_model(str(tmp_path), pcfg, state)
    jcfg, jparams = jax_load_model(str(tmp_path))
    assert jcfg.table_dtype is None and all(t.dtype is None for t in jcfg.tables)
    assert jcfg == dataclasses.replace(_bf16_cfg(jax_config), table_dtype=None)
    for name, t in state.model.tables.items():
        assert jparams["tables"][name].dtype == np.float32
        np.testing.assert_array_equal(jparams["tables"][name], t.detach().float().numpy())
    inputs = _requests()
    served = Scorer(state.model).predict(inputs)
    # the loaded f32 model holds the same values: its f32 lookup is the bf16 lookup widened
    np.testing.assert_array_equal(load_scorer(str(tmp_path), device="cpu").predict(inputs), served)
    np.testing.assert_allclose(jax_load_scorer(str(tmp_path)).predict(inputs), served, rtol=1e-5,
                               atol=1e-6)  # f32 products summed in another order


def test_jax_bf16_export_loads_in_the_port(tmp_path):
    jcfg = _bf16_cfg(jax_config)
    state, _ = jax_step.create_train_state(jax.random.key(3), jcfg, jax_config.TrainConfig())
    assert str(state.tables["t_user_id"].dtype) == "bfloat16"
    jax_export_model(str(tmp_path), jcfg, state)
    pcfg, params = load_model(str(tmp_path))
    assert pcfg.table_dtype is None
    for name, t in state.tables.items():
        np.testing.assert_array_equal(params["tables"][name], np.asarray(t.astype(jnp.float32)))
    inputs = _requests()
    np.testing.assert_allclose(load_scorer(str(tmp_path), device="cpu").predict(inputs),
                               jax_load_scorer(str(tmp_path)).predict(inputs), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("carrier", ["float32", "uint16", "ml_dtypes"])
def test_bf16_params_round_trip_through_numpy(carrier):
    """`params_to_numpy(params_from_numpy(x)) == x` for bf16 tables given as
    f32 values that bf16 holds exactly, as the raw bf16 bits in uint16, or as
    an `ml_dtypes` bfloat16 array (what `np.asarray` makes of a bf16 jax
    array)."""
    cfg = _bf16_cfg(port_config)
    params = _numpy_params(cfg, seed=5)
    given = dict(params, tables=dict(params["tables"]))
    for name, rows in params["tables"].items():
        if carrier == "uint16":
            given["tables"][name] = rows.astype(ml_dtypes.bfloat16).view(np.uint16)
        elif carrier == "ml_dtypes":
            given["tables"][name] = np.asarray(jnp.asarray(rows).astype(jnp.bfloat16))
            assert given["tables"][name].dtype.name == "bfloat16"
    model = params_from_numpy(given, cfg, "cpu")
    assert all(t.dtype == torch.bfloat16 for t in model.tables.values())
    back = params_to_numpy(model)
    for name, rows in params["tables"].items():
        assert back["tables"][name].dtype == np.float32
        np.testing.assert_array_equal(back["tables"][name], rows)
    for key in ("query_tower", "candidate_tower"):
        for lname, layer in params[key].items():
            np.testing.assert_array_equal(back[key][lname]["kernel"], layer["kernel"])
    # f32 values that bf16 does not hold are rounded to nearest even, once
    rough = dict(params, tables={k: v + np.float32(1e-4) for k, v in params["tables"].items()})
    rounded = params_to_numpy(params_from_numpy(rough, cfg, "cpu"))
    for name, rows in rough["tables"].items():
        np.testing.assert_array_equal(rounded["tables"][name], _bf16(rows))


def test_bf16_bits_for_an_f32_table_are_refused():
    cfg = dataclasses.replace(_bf16_cfg(port_config), table_dtype=None)
    params = _numpy_params(cfg)
    params["tables"]["t_user_id"] = params["tables"]["t_user_id"].astype(
        ml_dtypes.bfloat16).view(np.uint16)
    with pytest.raises(ValueError, match="bfloat16 table"):
        params_from_numpy(params, cfg, "cpu")
