"""The all-to-all exchange (`sharded_exchange="alltoall"`) of the port's
sharded step on gloo ranks, against the JAX package
(`tests/test_sharded.py:367-606`): the capacity rule and the routing bit for
bit the reference's; the step against the port's and the JAX package's
one-device steps and the JAX package's all-to-all step, at
`test_torch_parallel_step.py`'s bars; hot ids deduplicated, the overflow
counted as the reference counts it, the bf16 wire near the f32 one, the eval
equal to the dense exchange's, the count carried by the macro-step, and the
loops raising on it.

Four ranks (spawned processes, one gloo group) serve every case."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from test_torch_parallel_step import (
    _check,
    _jax_pair,
    _port,
    _port_one_device,
    _setup,
    _start,
)
from two_tower_recommender_model_tpu import config as cfg_lib
from two_tower_recommender_model_tpu.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model_tpu.parallel.sharded import _a2a_cap, _a2a_route
from two_tower_recommender_model_tpu.train.step import create_train_state
from two_tower_recommender_model_tpu_torch.parallel import sharded as port_sharded

ROW = "row_sharded"
FORCE = {"t_user_id": ROW, "t_product_id": ROW}


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


@pytest.mark.parametrize("factor", [0.05, 0.5, 1.25, 2.0])
def test_a2a_cap_matches_reference(factor):
    for m in (1, 7, 64, 100, 512, 4096, 262_144):
        for ndev in (1, 2, 4, 8):
            for rows in (1, 5, 13, 64, 512, 10_000, 1 << 20):
                assert port_sharded.a2a_cap(m, ndev, factor, rows) == \
                    _a2a_cap(m, ndev, factor, rows), (m, ndev, rows)


def _route_case(case):
    """(flat ids, weights, rows, ndev, cap, model, model index)."""
    rng = np.random.default_rng(len(case))
    rows, ndev, m = 25, 4, 256
    ids = rng.integers(0, ndev * rows, m)
    w = np.ones(m, np.float32)
    model, index, cap = 1, 0, 16
    if case == "hot-ids":
        ids[rng.random(m) < 0.6] = 7
        ids[rng.random(m) < 0.2] = 63
    elif case == "dead-slots":
        w[rng.random(m) < 0.3] = 0.0
    elif case == "model-2":
        model, index = 2, 1
    elif case == "overflow":
        ids = rng.integers(0, rows, m)  # every id on shard 0, past its capacity
        cap = 8
    return ids.astype(np.int32), w, rows, ndev, cap, model, index


@pytest.mark.parametrize("case", ["uniform", "hot-ids", "dead-slots", "model-2", "overflow"])
def test_a2a_route_matches_reference(case):
    ids, w, rows, ndev, cap, model, index = _route_case(case)
    owner = np.clip(ids // rows, 0, ndev - 1)
    slot, ok, overflow = _a2a_route(jnp.asarray(ids), jnp.asarray(w), rows, ndev, cap,
                                    jnp.asarray(owner % model == index))
    t_ids = torch.from_numpy(ids)
    resp = port_sharded.a2a_responsible(t_ids, rows, ndev, model, index)
    got = port_sharded.a2a_route(t_ids, torch.from_numpy(w), rows, ndev, cap, resp)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(slot))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ok))
    assert int(got[2]) == int(overflow)
    if case == "overflow":
        assert int(overflow) > 0


def _alltoall(**kw):
    return cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3,
                               sharded_exchange="alltoall", **kw)


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
def test_alltoall_step_matches_one_device(pool, mesh_shape):
    """`test_sharded.py:371`: both tables row-sharded through the exchange
    (with the model axis's responsibility split at (2, 2)), no id dropped;
    against the port's and the JAX package's one-device steps and the JAX
    package's all-to-all step."""
    mcfg, batches = _setup()
    tcfg = _alltoall(exchange_capacity_factor=2.0)
    start, one, sharded, plan = _jax_pair(mcfg, tcfg, batches, mesh_shape, FORCE)
    got = _port(pool, mcfg, tcfg, start, batches, mesh_shape, FORCE)
    assert got["overflow"] == [0] * len(batches)
    _check(got, one, sharded, plan, _port_one_device(mcfg, tcfg, start, batches))


def _hot_batch(mcfg, user, n=512):
    """`test_sharded.py:423`: every row the same user, or (with `user`
    None) 64 distinct users a data slice of 128 rows, all on shard 0."""
    users = np.full(n, user, np.int64) if user is not None else \
        (np.arange(n, dtype=np.int64) % 500) + 1
    return Featurizer(mcfg)({"user_id": users,
                             "product_id": np.arange(1, n + 1, dtype=np.int64) % 59 + 1,
                             "label": np.ones(n, np.int64)})


def test_hot_id_dedupes_and_does_not_overflow(pool):
    """A hot id takes one slot of its bucket: at factor 0.05 (a capacity of
    8 distinct ids) nothing overflows, and the step matches the one-device
    steps. The item table is replicated here: on 4 ranks its 15-row shards
    would overflow a capacity of 8 (the reference's 8 devices hold 8 rows
    a shard)."""
    mcfg, _ = _setup(n=0)
    tcfg = _alltoall(exchange_capacity_factor=0.05)
    batches = [_hot_batch(mcfg, 5)]
    force = {"t_user_id": ROW, "t_product_id": "replicated"}
    start, one, sharded, plan = _jax_pair(mcfg, tcfg, batches, (4, 1), force)
    got = _port(pool, mcfg, tcfg, start, batches, (4, 1), force)
    assert got["overflow"] == [0]
    _check(got, one, sharded, plan, _port_one_device(mcfg, tcfg, start, batches))


def _overflow_setup():
    mcfg = cfg_lib.two_tower_model_config(num_users=4096, num_items=60, embedding_dim=16,
                                          layer_sizes=(32, 8))
    tcfg = cfg_lib.TrainConfig(sharded_exchange="alltoall", exchange_capacity_factor=0.05)
    state, _ = create_train_state(__import__("jax").random.key(0), mcfg, tcfg)
    return mcfg, tcfg, _start(state)


def test_overflow_is_counted_as_the_reference_counts_it(pool):
    """`test_sharded.py:442`: many distinct ids on one shard against a
    capacity of 8 distinct ids: the count equals the JAX package's all-to-all
    step's, forward and backward summed over the mesh."""
    from two_tower_recommender_model_tpu.parallel import (
        make_mesh,
        make_sharded_train_step,
        plan_sharding,
        shard_train_state,
    )
    from test_torch_parallel_step import _put_batch

    mcfg, tcfg, start = _overflow_setup()
    batch = _hot_batch(mcfg, None)
    state, dense_opt = create_train_state(__import__("jax").random.key(0), mcfg, tcfg)
    mesh = make_mesh(4, 1)
    plan = plan_sharding(mcfg, 4, force=FORCE)
    step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    _, out = step(shard_train_state(state, plan, mesh), _put_batch(batch, mesh))
    got = _port(pool, mcfg, tcfg, start, [batch], (4, 1), FORCE)
    assert got["overflow"][0] > 0
    assert got["overflow"][0] == int(out["exchange_overflow"])


def test_bf16_wire_is_near_the_f32_wire(pool):
    """`test_sharded.py:472`: rows and gradients rounded once on the wire;
    against the f32 wire at the reference's bars (the loss rtol 2e-2, the
    tables rtol 2e-2 / atol 2e-3), and against the JAX package's bf16-wire
    step at `test_torch_parallel_step.py`'s."""
    mcfg, batches = _setup(n=2)
    runs = {}
    for wire in ("float32", "bfloat16"):
        tcfg = cfg_lib.TrainConfig(sharded_exchange="alltoall", exchange_wire_dtype=wire,
                                   exchange_capacity_factor=2.0)  # the reference's rates
        start, one, sharded, plan = _jax_pair(mcfg, tcfg, batches, (4, 1), FORCE)
        runs[wire] = _port(pool, mcfg, tcfg, start, batches, (4, 1), FORCE)
    np.testing.assert_allclose(runs["bfloat16"]["losses"][-1], runs["float32"]["losses"][-1],
                               rtol=2e-2)
    np.testing.assert_allclose(runs["bfloat16"]["state"]["tables"]["t_user_id"],
                               runs["float32"]["state"]["tables"]["t_user_id"],
                               rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(runs["bfloat16"]["losses"][-1], sharded[1], rtol=1e-5)
    for name, t in sharded[0].tables.items():
        np.testing.assert_allclose(runs["bfloat16"]["state"]["tables"][name], np.asarray(t),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_eval_matches_the_dense_exchange(pool):
    """`test_sharded.py:502`: the eval forward through the exchange gives the
    dense exchange's metrics."""
    mcfg, _ = _setup(n=0)
    state, _ = create_train_state(__import__("jax").random.key(0), mcfg, cfg_lib.TrainConfig())
    start = _start(state)
    ds = SyntheticClickstream(100, 60, seed=2)
    columns = [ds.sample(64, start=i) for i in range(2)]
    got = {}
    for exchange in ("dense", "alltoall"):
        tcfg = cfg_lib.TrainConfig(sharded_exchange=exchange, exchange_capacity_factor=2.0)
        got[exchange] = pool.run("evaluate_columns", cfg=dataclasses.asdict(mcfg),
                                 tcfg=dataclasses.asdict(tcfg), start=start, columns=columns,
                                 mesh_shape=(4, 1), force=FORCE)[0]
    for key in ("val_loss", "val_auroc"):
        np.testing.assert_allclose(got["alltoall"][key], got["dense"][key], rtol=1e-6)


def test_overflow_survives_the_macro_step(pool):
    """`test_sharded.py:527`: the packed macro-step carries the K steps'
    count (0 here), the dense exchange's output has none."""
    mcfg, batches = _setup(n=0)
    ds = SyntheticClickstream(100, 60, seed=4)
    columns = [ds.sample(64, start=i) for i in range(3)]
    batches = [Featurizer(mcfg)(c) for c in columns]
    for exchange, want in (("alltoall", 0), ("dense", None)):
        tcfg = cfg_lib.TrainConfig(sharded_exchange=exchange, exchange_capacity_factor=2.0)
        state, _ = create_train_state(__import__("jax").random.key(0), mcfg, tcfg)
        got = _port(pool, mcfg, tcfg, _start(state), batches, (4, 1), FORCE,
                    packed_columns=columns)
        assert len(got["macro_losses"]) == 3
        assert got["macro_overflow"] == want


def test_the_loops_raise_on_overflow(pool):
    """`test_sharded.py:571`: `train_one_epoch` and `train_one_epoch_packed`
    raise at the epoch's end and `evaluate` before it returns metrics, with
    the reference's messages."""
    mcfg, tcfg, start = _overflow_setup()
    users = (np.arange(512, dtype=np.int64) % 500) + 1
    columns = [{"user_id": users, "product_id": np.arange(1, 513, dtype=np.int64) % 59 + 1,
                "label": np.ones(512, np.int64)} for _ in range(3)]
    got = pool.run("loops_raise", cfg=dataclasses.asdict(mcfg), tcfg=dataclasses.asdict(tcfg),
                   start=start, columns=columns, mesh_shape=(4, 1), force=FORCE)
    for r in got:
        assert "eval dropped" in r["evaluate"] and "exchange_capacity_factor" in r["evaluate"]
        for name in ("train_one_epoch", "train_one_epoch_packed"):
            assert "epoch 0: the alltoall exchange dropped" in r[name], r[name]
            assert "distinct ids past its bucket capacity" in r[name]
