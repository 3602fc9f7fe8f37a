"""The port's sharded eval, padded and all-padding eval, sharded lookup and
packed sharded macro-step on gloo ranks, against the JAX package's sharded
and one-device counterparts on the same inputs (`tests/test_sharded.py:109`,
`:123`, `:214`, `:337`; `tests/test_table_wise.py:165`, `:190`): eval loss
and AUROC within rtol 1e-5 (every rank holds the global metrics), the
macro-step bit for bit the sequential sharded steps (on the CPU the
multi-step is a plain loop over them), and against the JAX package's steps
at `test_torch_parallel_step.py`'s bars."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from two_tower_recommender_model_tpu import config as cfg_lib
from two_tower_recommender_model_tpu.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model_tpu.data.device_featurizer import PackedFeaturizer
from two_tower_recommender_model_tpu.data.featurizer import pad_batch
from two_tower_recommender_model_tpu.models.metrics import auroc_compute, mean_compute
from two_tower_recommender_model_tpu.parallel import (
    batch_sharding,
    macro_batch_sharding,
    make_mesh,
    make_sharded_eval_step,
    make_sharded_multi_step,
    make_sharded_train_step,
    plan_sharding,
    shard_train_state,
)
from two_tower_recommender_model_tpu.parallel.sharded import unshard_train_state
from two_tower_recommender_model_tpu.train.loop import evaluate as jax_evaluate
from two_tower_recommender_model_tpu.train.step import (
    create_train_state,
    eval_state_init,
    make_eval_step,
    stack_batches,
)

ROW, TW = "row_sharded", "table_wise"


@pytest.fixture(scope="module")
def pool():
    p = ranks.RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _put(batch, mesh, sharding=batch_sharding):
    sh = sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), sh(x)), batch)


def _setup():
    mcfg = cfg_lib.two_tower_model_config(num_users=100, num_items=60, embedding_dim=16,
                                          layer_sizes=(32, 8))
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    return mcfg, tcfg, state, dense_opt


def _start(jstate) -> dict:
    host = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    adam = jstate.dense_opt_state[0]
    return {"step": int(jstate.step), "tables": host(jstate.tables),
            "adagrad_acc": host(jstate.adagrad_acc), **host(jstate.dense_params),
            "adam": {"count": int(adam.count), "mu": host(adam.mu), "nu": host(adam.nu)},
            "item_counts": None}


def _port_eval(pool, mcfg, tcfg, state, columns, mesh_shape, force, **pad):
    results = pool.run("evaluate_columns", cfg=dataclasses.asdict(mcfg),
                       tcfg=dataclasses.asdict(tcfg), start=_start(state), columns=columns,
                       mesh_shape=mesh_shape, force=force, **pad)
    inside = [r for r in results if r is not None]
    assert len(inside) == mesh_shape[0] * mesh_shape[1]
    assert all(r == inside[0] for r in inside)  # every rank holds the global metrics
    return inside[0]


def _jax_eval(estep, state, batches):
    es = eval_state_init()
    for b in batches:
        es = estep(state, es, b)
    return {"val_loss": float(mean_compute(es.loss)), "val_auroc": float(auroc_compute(es.auroc))}


def _close(got, want):
    for k in ("val_loss", "val_auroc"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("force", [{"t_user_id": ROW, "t_product_id": ROW},
                                   {"t_user_id": TW, "t_product_id": TW}],
                         ids=["row-sharded", "table-wise"])
@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
def test_sharded_eval_matches_jax(pool, force, mesh_shape):
    """`test_sharded.py:123`, `test_table_wise.py:165`: the port's `evaluate`
    through the sharded eval step against the JAX sharded and one-device
    eval steps."""
    mcfg, tcfg, state, _ = _setup()
    ds = SyntheticClickstream(100, 60, seed=2)
    columns = [ds.sample(64, start=i) for i in range(4)]
    batches = [Featurizer(mcfg)(c) for c in columns]
    one = _jax_eval(make_eval_step(mcfg, tcfg), state, [jax.tree.map(jnp.asarray, b)
                                                       for b in batches])
    mesh = make_mesh(*mesh_shape)
    plan = plan_sharding(mcfg, mesh.devices.size, force=force)
    sh = _jax_eval(make_sharded_eval_step(mcfg, tcfg, mesh, plan),
                   shard_train_state(state, plan, mesh), [_put(b, mesh) for b in batches])
    got = _port_eval(pool, mcfg, tcfg, state, columns, mesh_shape, force)
    _close(got, one)
    _close(got, sh)


def test_padded_eval_matches_unpadded(pool):
    """`test_sharded.py:214`: ragged batches of 50, 37 and 13 rows, padded
    with zero-weight rows to a multiple of the ranks (`pad_multiple`), give
    the one-device eval's metrics over the raw stream, and the JAX sharded
    eval's over the same padding."""
    mcfg, tcfg, state, _ = _setup()
    ds = SyntheticClickstream(100, 60, seed=3)
    columns = [ds.sample(n, "val", start=i) for i, n in enumerate((50, 37, 13))]
    feat = Featurizer(mcfg)
    one = _jax_eval(make_eval_step(mcfg, tcfg), state,
                    [jax.tree.map(jnp.asarray, feat(c)) for c in columns])
    force = {"t_user_id": ROW, "t_product_id": ROW}
    mesh = make_mesh(4, 1)
    plan = plan_sharding(mcfg, 4, force=force)
    sh = _jax_eval(make_sharded_eval_step(mcfg, tcfg, mesh, plan),
                   shard_train_state(state, plan, mesh),
                   [_put(pad_batch(feat(c), 4), mesh) for c in columns])
    got = _port_eval(pool, mcfg, tcfg, state, columns, (4, 1), force, pad_multiple=4)
    _close(got, one)
    _close(got, sh)


def test_pad_to_eval_with_all_padding_batches(pool):
    """`test_sharded.py:337`: `pad_to=64` grows every batch to 64 rows, and
    two 0-row batches into batches of padding alone, whose steps still run
    (every rank's collectives); they change no metric."""
    mcfg, tcfg, state, _ = _setup()
    ds = SyntheticClickstream(100, 60, seed=4)
    columns = [ds.sample(n, "val", start=i) for i, n in enumerate((64, 64, 29))]
    empty = {k: v[:0] for k, v in columns[0].items()}
    feat = Featurizer(mcfg)
    estep = make_eval_step(mcfg, tcfg)
    ref = jax_evaluate(state, estep, columns, feat, stage="val")
    padded = jax_evaluate(state, estep, columns + [empty, empty], feat, stage="val", pad_to=64)
    force = {"t_user_id": ROW, "t_product_id": TW}
    for mesh_shape in ((4, 1), (2, 2)):
        got = _port_eval(pool, mcfg, tcfg, state, columns + [empty, empty], mesh_shape, force,
                         pad_to=64)
        _close(got, ref)
        _close(got, padded)


def test_sharded_lookup_vs_local(pool):
    """`test_sharded.py:109`: the lookup over a row-sharded table on a
    (2, 2) mesh against the dense weighted sum."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(64, 8)).astype(np.float32)
    ids = rng.integers(0, 64, (16, 3)).astype(np.int32)
    w = (rng.random((16, 3)) > 0.3).astype(np.float32)
    want = (table[ids] * w[..., None]).sum(1)
    jmesh = make_mesh(2, 2)
    from two_tower_recommender_model_tpu.parallel.sharded import make_sharded_lookup

    jgot = jax.jit(make_sharded_lookup(jmesh))(
        jax.device_put(jnp.asarray(table),
                       jax.NamedSharding(jmesh, jax.P(("data", "model"), None))),
        jnp.asarray(ids), jnp.asarray(w))
    for got in pool.run("sharded_lookup", table=table, ids=ids, w=w, mesh_shape=(2, 2)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, np.asarray(jgot), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
def test_sharded_multi_step_matches_sequential(pool, mesh_shape):
    """`test_table_wise.py:190`: the packed K-step macro over the sharded
    step (user row-sharded, items table-wise) against K sequential sharded
    steps from the same start (bit for bit: on the CPU the multi-step is a
    loop over them), and against the JAX package's sharded macro-step and
    its one-device steps at the reference's bars."""
    mcfg, tcfg, state, dense_opt = _setup()
    force = {"t_user_id": ROW, "t_product_id": TW}
    ds = SyntheticClickstream(100, 60, seed=2)
    columns = [ds.sample(64, start=i) for i in range(4)]
    feat = Featurizer(mcfg)
    batches = [feat(c) for c in columns]

    mesh = make_mesh(*mesh_shape)
    plan = plan_sharding(mcfg, mesh.devices.size, force=force)
    multi = make_sharded_multi_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    mb = stack_batches([PackedFeaturizer(mcfg, pack_label=True)(c) for c in columns])
    jsh, jout = multi(shard_train_state(state, plan, mesh), _put(mb, mesh, macro_batch_sharding))
    jsh = unshard_train_state(jsh, plan, mcfg)
    from two_tower_recommender_model_tpu.train.step import make_train_step

    one, step1 = state, make_train_step(mcfg, tcfg, dense_opt, donate=False)
    for b in batches:
        one, out1 = step1(one, jax.tree.map(jnp.asarray, b))

    got = pool.run("train_steps", cfg=dataclasses.asdict(mcfg), tcfg=dataclasses.asdict(tcfg),
                   start=_start(state), batches=[ranks.batch_numpy(b) for b in batches],
                   mesh_shape=mesh_shape, force=force, packed_columns=columns)[0]
    np.testing.assert_array_equal(got["macro_losses"], got["losses"])
    for key in ("tables", "adagrad_acc"):
        for name in got["state"][key]:
            np.testing.assert_array_equal(got["macro_state"][key][name], got["state"][key][name])
    np.testing.assert_allclose(got["macro_losses"], np.asarray(jout["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["macro_losses"][-1], float(out1["loss"]), rtol=1e-5)
    for want in (jsh, one):
        for name, t in want.tables.items():
            np.testing.assert_allclose(got["macro_state"]["tables"][name], np.asarray(t),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(got["macro_state"]["adagrad_acc"][name],
                                       np.asarray(want.adagrad_acc[name]), rtol=1e-4, atol=1e-5)
        for key in ("query_tower", "candidate_tower"):
            for g, w in zip(jax.tree.leaves(got["macro_state"][key]),
                            jax.tree.leaves(want.dense_params[key])):
                np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)
