"""The port's sharded train step (`parallel/sharded.py`) on gloo ranks
against the JAX package's sharded step on the same mesh shape and its
one-device step, from the same numpy start on the same batches: row-sharded,
replicated, table-wise and mixed plans; the host-sorted, block-sorted and
device-sort routes; f32 and bf16 tables; bf16 compute against the port's own
one-device step. The sharded step against the port's one-device step (the
same kernels and plain versions) at the reference's sharded-vs-one-device
bars (`tests/test_sharded.py:70-84`): the loss within rtol 1e-5, tables,
accumulators and towers within rtol 1e-4 / atol 1e-6. Against the JAX
package's steps the loss and towers at those bars too, and the tables and
accumulators at the reference's bar for an update that sums each row's
gradients in another f32 order (`tests/test_sharded_sorted.py:140`, atol
1e-5): kernel #4 and XLA's scatter sum a row's slots in different orders,
and a row whose gradients cancel moves by lr x g / rms(g), where that order
shows.

Four ranks (spawned processes, one gloo group) serve every case of the
module; a (2, 1) mesh leaves two of them out."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from two_tower_recommender_model_tpu import config as cfg_lib
from two_tower_recommender_model_tpu.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model_tpu.parallel import (
    batch_sharding,
    make_mesh,
    make_sharded_train_step,
    plan_sharding,
    shard_train_state,
)
from two_tower_recommender_model_tpu.parallel.sharded import unshard_train_state
from two_tower_recommender_model_tpu.train.step import create_train_state, make_train_step
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.parallel import planner as port_planner
from two_tower_recommender_model_tpu_torch.parallel import sharded as port_sharded
from two_tower_recommender_model_tpu_torch.train import step as port_step

ROW, REP, TW = "row_sharded", "replicated", "table_wise"


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


def _put_batch(batch, mesh):
    sh = batch_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh(x)), batch)


def _sort_batch(batch, n_users):
    """Rows by the user feature's hashed id, missing last (the reference's
    `tests/test_sharded_sorted.py:_sort_batch`)."""
    feat = batch.features["user_id"]
    key = np.where(np.asarray(feat.mask[:, 0]) > 0, np.asarray(feat.ids[:, 0]), n_users)
    order = np.argsort(key, kind="stable")
    return jax.tree.map(lambda x: np.asarray(x)[order], batch)


def _setup(dim=16, batch=64, n=4, sort=False, seed=2, **cfg_kw):
    mcfg = cfg_lib.two_tower_model_config(num_users=100, num_items=60, embedding_dim=dim,
                                          layer_sizes=(32, 8))
    mcfg = dataclasses.replace(mcfg, **cfg_kw)
    ds = SyntheticClickstream(100, 60, seed=seed)
    feat = Featurizer(mcfg)
    batches = [jax.tree.map(np.asarray, feat(ds.sample(batch, start=i))) for i in range(n)]
    if sort:
        batches = [_sort_batch(b, 100) for b in batches]
    return mcfg, batches


def _numpy(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _start(jstate) -> dict:
    """A JAX state in `train_state_from_numpy`'s layout (bf16 tables as their
    bits)."""
    host = lambda tree: jax.tree.map(_numpy, tree)  # noqa: E731
    adam = jstate.dense_opt_state[0]
    return {"step": int(jstate.step), "tables": host(jstate.tables),
            "adagrad_acc": host(jstate.adagrad_acc), **host(jstate.dense_params),
            "adam": {"count": int(adam.count), "mu": host(adam.mu), "nu": host(adam.nu)},
            "item_counts": None}


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if hasattr(a, "dtype") and \
        a.dtype.name == "bfloat16" else np.asarray(a, np.float32)


def _assert_states(got: dict, want, rtol=1e-4, atol=1e-6, table_atol=1e-5):
    """Port state (`ranks.state_numpy`) against a JAX state: tables and
    accumulators (at `table_atol`), towers."""
    for name, t in want.tables.items():
        np.testing.assert_allclose(got["tables"][name], _f32(t), rtol=rtol, atol=table_atol,
                                   err_msg=name)
        np.testing.assert_allclose(got["adagrad_acc"][name], np.asarray(want.adagrad_acc[name]),
                                   rtol=rtol, atol=table_atol, err_msg=name)
    for key in ("query_tower", "candidate_tower"):
        for layer, p in want.dense_params[key].items():
            for pname in ("kernel", "bias"):
                np.testing.assert_allclose(got[key][layer][pname], np.asarray(p[pname]),
                                           rtol=rtol, atol=atol, err_msg=f"{key}/{layer}/{pname}")


def _jax_pair(mcfg, tcfg, batches, mesh_shape, force, ref_tcfg=None):
    """(start, one-device (state, loss), sharded (gathered state, loss), plan)."""
    ref_tcfg = ref_tcfg or tcfg
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, ref_tcfg)
    start = _start(state)
    one = state
    step1 = make_train_step(mcfg, ref_tcfg, dense_opt, donate=False)
    for b in batches:
        one, out1 = step1(one, jax.tree.map(jnp.asarray, b))
    mesh = make_mesh(*mesh_shape)
    plan = plan_sharding(mcfg, mesh.devices.size, force=force)
    sh = shard_train_state(state, plan, mesh)
    step = make_sharded_train_step(mcfg, tcfg, dense_opt, mesh, plan, donate=False)
    for b in batches:
        sh, out = step(sh, _put_batch(jax.tree.map(jnp.asarray, b), mesh))
    return (start, (one, float(out1["loss"])),
            (unshard_train_state(sh, plan, mcfg), float(out["loss"])), plan)


def _port(pool, mcfg, tcfg, start, batches, mesh_shape, force, packed_columns=None):
    return pool.run("train_steps", cfg=dataclasses.asdict(mcfg), tcfg=dataclasses.asdict(tcfg),
                    start=start, batches=[ranks.batch_numpy(b) for b in batches],
                    mesh_shape=mesh_shape, force=force, packed_columns=packed_columns)[0]


def _port_one_device(mcfg, tcfg, start, batches):
    """The port's one-device step over the same batches: (state, last loss)."""
    pcfg = port_config.model_config_from_dict(dataclasses.asdict(mcfg))
    ptcfg = port_config.TrainConfig(**dataclasses.asdict(tcfg))
    pstate, popt = ranks.start_state(start, pcfg, ptcfg)
    pstep = port_step.make_train_step(pcfg, ptcfg, popt)
    for b in batches:
        pstate, pout = pstep(pstate, ranks.port_batch(ranks.batch_numpy(b)))
    return ranks.state_numpy(pstate), pout["loss"].float().item()


def _assert_port_states(got: dict, want: dict, rtol=1e-4, atol=1e-6):
    for name in want["tables"]:
        for key in ("tables", "adagrad_acc"):
            np.testing.assert_allclose(got[key][name], want[key][name], rtol=rtol, atol=atol,
                                       err_msg=f"{key}/{name}")
    for key in ("query_tower", "candidate_tower"):
        for g, w in zip(jax.tree.leaves(got[key]), jax.tree.leaves(want[key])):
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=key)


def _check(got, one, sharded, plan, mine, table_atol=1e-5):
    """`got` (the port's sharded run) against the port's one-device run
    `mine` and the JAX package's one-device and sharded runs."""
    np.testing.assert_allclose(got["losses"][-1], mine[1], rtol=1e-5)
    _assert_port_states(got["state"], mine[0])
    for want_state, want_loss in (one, sharded):
        np.testing.assert_allclose(got["losses"][-1], want_loss, rtol=1e-5)
        _assert_states(got["state"], want_state, table_atol=table_atol)
    assert got["plan"] == plan.describe()


# (mesh shape, forced strategies): test_sharded.py:51 and :87, test_table_wise.py:110
# and :142 (with the replicated mix added)
PLANS = {
    "row-2x1": ((2, 1), {"t_user_id": ROW, "t_product_id": ROW}),
    "row-4x1": ((4, 1), {"t_user_id": ROW, "t_product_id": ROW}),
    "row-2x2": ((2, 2), {"t_user_id": ROW, "t_product_id": ROW}),
    "replicated": ((4, 1), {"t_user_id": REP, "t_product_id": REP}),
    "row+replicated": ((4, 1), {"t_user_id": ROW, "t_product_id": REP}),
    "table-wise-4x1": ((4, 1), {"t_user_id": TW, "t_product_id": TW}),
    "table-wise-2x2": ((2, 2), {"t_user_id": TW, "t_product_id": TW}),
    "row+table-wise": ((4, 1), {"t_user_id": ROW, "t_product_id": TW}),
    "replicated+table-wise": ((2, 2), {"t_user_id": REP, "t_product_id": TW}),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_sharded_step_matches_jax(pool, case):
    mesh_shape, force = PLANS[case]
    mcfg, batches = _setup()
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
    start, one, sharded, plan = _jax_pair(mcfg, tcfg, batches, mesh_shape, force)
    got = _port(pool, mcfg, tcfg, start, batches, mesh_shape, force)
    _check(got, one, sharded, plan, _port_one_device(mcfg, tcfg, start, batches))
    if TW in force.values():
        assert "__tw_bucket_d16__" in got["plan"]


def test_weighted_bce_matches_jax(pool):
    """`loss="weighted_bce"` (one weight per interaction type, the types as
    one-hot dense columns): each rank's weighted sum over the global weight,
    against the JAX package's sharded and one-device steps."""
    mcfg, _ = _setup(n=0)
    ds = SyntheticClickstream(100, 60, seed=2)
    rng = np.random.default_rng(5)
    batches = []
    for i in range(3):
        cols = ds.sample(64, start=i)
        kind = rng.integers(0, 2, 64)
        cols["click"], cols["buy"] = (kind == 0).astype(np.float32), (kind == 1).astype(np.float32)
        batches.append(jax.tree.map(np.asarray, Featurizer(mcfg, dense_cols=("click", "buy"))(cols)))
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3, loss="weighted_bce",
                               loss_type_weights=(1.0, 0.25))
    mesh_shape, force = (2, 2), {"t_user_id": ROW, "t_product_id": TW}
    start, one, sharded, plan = _jax_pair(mcfg, tcfg, batches, mesh_shape, force)
    got = _port(pool, mcfg, tcfg, start, batches, mesh_shape, force)
    _check(got, one, sharded, plan, _port_one_device(mcfg, tcfg, start, batches))


# test_sharded_sorted.py:97, :112, :143, :223: (mesh, force, dim, batch, sorted
# batches, sorted_feature, block_sorted_kernel, the tables' atol against JAX)
SORTED = {
    "sorted-hint-4x1": ((4, 1), {"t_user_id": ROW, "t_product_id": ROW}, 16, 64, True,
                        "user_id", "off", 1e-5),
    "sorted-hint-2x2": ((2, 2), {"t_user_id": ROW, "t_product_id": ROW}, 16, 64, True,
                        "user_id", "off", 1e-5),
    "block-sorted-4x1": ((4, 1), {"t_user_id": ROW, "t_product_id": ROW}, 128, 128, True,
                         "user_id", "float32", 1e-5),
    "block-sorted-2x2": ((2, 2), {"t_user_id": ROW, "t_product_id": ROW}, 128, 128, True,
                         "user_id", "float32", 1e-5),
    "sorted-replicated": ((4, 1), {"t_user_id": REP, "t_product_id": ROW}, 16, 64, True,
                          "user_id", "off", 1e-5),
    "device-sort-4x1": ((4, 1), {"t_user_id": ROW, "t_product_id": REP}, 128, 128, False,
                        None, "float32", 1e-5),
    "device-sort-2x2": ((2, 2), {"t_user_id": ROW, "t_product_id": REP}, 128, 128, False,
                        None, "float32", 1e-5),
}


@pytest.mark.parametrize("case", list(SORTED))
def test_sorted_routes_match_jax(pool, case):
    """The host-sorted table's shard takes its local ids straight into the
    update (kernel #4's plain version here); the other tables the device
    sort. The one-device reference runs the plain step (`block_sorted_kernel
    ="off"`, no sorted feature), as the reference's tests do."""
    mesh_shape, force, dim, batch, sort, feature, kernel, atol = SORTED[case]
    mcfg, batches = _setup(dim=dim, batch=batch, n=3, sort=sort, seed=7)
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3,
                               sorted_feature=feature, block_sorted_kernel=kernel)
    ref_tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
    start, one, sharded, plan = _jax_pair(mcfg, tcfg, batches, mesh_shape, force, ref_tcfg)
    got = _port(pool, mcfg, tcfg, start, batches, mesh_shape, force)
    _check(got, one, sharded, plan, _port_one_device(mcfg, tcfg, start, batches), atol)


def test_sorted_shard_takes_the_bf16_buffer_like_jax(pool):
    """`scatter_buffer_dtype="bfloat16"`: the host-sorted row-sharded table's
    shard sums each run in the bf16 buffer where the reference's sharded
    update does (its 25 rows <= 8 x the 64 gathered ids). Against the port's
    one-device step at the reference's bars; against the JAX package's steps
    at `test_torch_scatter_buffer.py`'s bars after the first step: a gradient
    that rounds to the other side of a bf16 value moves a row's buffer by a
    bf16 ulp, so rows within 2^-7 x the largest update, accumulators within
    rtol 2^-6."""
    mesh_shape, force = (4, 1), {"t_user_id": ROW, "t_product_id": ROW}
    mcfg, batches = _setup(n=3, sort=True, seed=7)
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3,
                               sorted_feature="user_id", scatter_buffer_dtype="bfloat16")
    start, one, sharded, plan = _jax_pair(mcfg, tcfg, batches, mesh_shape, force)
    got = _port(pool, mcfg, tcfg, start, batches, mesh_shape, force)
    mine = _port_one_device(mcfg, tcfg, start, batches)
    np.testing.assert_allclose(got["losses"][-1], mine[1], rtol=1e-5)
    _assert_port_states(got["state"], mine[0])
    for want, loss in (one, sharded):
        np.testing.assert_allclose(got["losses"][-1], loss, rtol=1e-5)
        for name, t in want.tables.items():
            t0, w = start["tables"][name], np.asarray(t)
            np.testing.assert_allclose(got["state"]["tables"][name], w, rtol=0,
                                       atol=2.0 ** -7 * np.abs(w - t0).max())
            np.testing.assert_allclose(got["state"]["adagrad_acc"][name],
                                       np.asarray(want.adagrad_acc[name]), rtol=2.0 ** -6,
                                       atol=1e-12)


def _one_ulp_apart(got, want, t0):
    """`test_torch_bf16_tables.py`'s bar for bf16 rows: rows no update
    touched keep their bits; the moved ones are equal or one bf16 ulp apart
    (|a - b| <= 2^-7 max(|a|, |b|)), on fewer than 1% of their elements."""
    moved = np.any(want != t0, axis=1)
    assert moved.any() and not moved.all()
    np.testing.assert_array_equal(got[~moved], want[~moved])
    g, w = got[moved], want[moved]
    apart = g != w
    assert (np.abs(g - w) <= 2.0 ** -7 * np.maximum(np.abs(g), np.abs(w)))[apart].all()
    assert apart.mean() < 0.01


def test_bf16_tables_match_jax_and_the_one_device_step(pool):
    """bf16 tables, a row-sharded user table (host-sorted) and a table-wise
    item table: after one step (as `test_torch_bf16_tables.py` compares a
    step with JAX's; a row's later updates start from rows an ulp apart),
    against the port's one-device step and the JAX package's one-device
    step, the tables equal or one bf16 ulp apart (`_one_ulp_apart`), the
    accumulators within rtol 1e-5, the towers and loss at the reference's
    bars. (The JAX package's own sharded step on bf16 tables departs from
    its one-device step, by up to 0.07 on ~9% of the user table's elements
    after this step with equal accumulators, and no reference test covers
    it: ROADMAP Queue 3. The port's sharded step follows the one-device
    semantics.)"""
    mesh_shape, force = (4, 1), {"t_user_id": ROW, "t_product_id": TW}
    mcfg, batches = _setup(n=1, sort=True, seed=7, table_dtype="bfloat16")
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3,
                               sorted_feature="user_id")
    start, one, sharded, plan = _jax_pair(mcfg, tcfg, batches, mesh_shape, force)
    got = _port(pool, mcfg, tcfg, start, batches, mesh_shape, force)
    mine, mine_loss = _port_one_device(mcfg, tcfg, start, batches)
    t0 = {k: _f32(v.view(jnp.bfloat16)) for k, v in start["tables"].items()}
    wants = [(mine["tables"], mine["adagrad_acc"], mine, mine_loss)]
    wants += [({k: _f32(v) for k, v in s.tables.items()}, s.adagrad_acc, s.dense_params, loss)
              for s, loss in (one,)]
    for tables, accs, towers, loss in wants:
        np.testing.assert_allclose(got["losses"][-1], loss, rtol=1e-5)
        for name in tables:
            _one_ulp_apart(got["state"]["tables"][name], tables[name], t0[name])
            np.testing.assert_allclose(got["state"]["adagrad_acc"][name], np.asarray(accs[name]),
                                       rtol=1e-5, atol=1e-12)
        for key in ("query_tower", "candidate_tower"):
            for g, w in zip(jax.tree.leaves(got["state"][key]), jax.tree.leaves(towers[key])):
                np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-6)


def test_bf16_compute_matches_the_one_device_step(pool):
    """bf16 compute with the fused tower backward and the bf16 block-kernel
    mode at the flagship's shape (dim 128, towers (128, 64)), host-sorted by
    user, user row-sharded and items table-wise: the sharded step against the
    port's one-device step at `test_torch_train_step.py`'s bf16 bar against
    JAX, each quantity within 2^-7 x its largest magnitude: the loss of each
    of three steps; after the first, the tables' change, the accumulators
    and Adam's first moments (the towers' gradients; not the weights: Adam's
    first step moves each by +-lr whatever its gradient's size, so a
    near-zero gradient summed in another order flips it)."""
    mcfg = cfg_lib.two_tower_model_config(1000, 300, embedding_dim=128, layer_sizes=(128, 64),
                                          compute_dtype="bfloat16")
    mcfg = dataclasses.replace(mcfg, fused_tower_backward="on")
    # 2,048 rows: each rank's slice is a multiple of 512, the fused backward's
    # batch granule (`ops/tower_bwd.py:fits`), so both runs take its route
    tcfg = cfg_lib.TrainConfig(batch_size=2048, sorted_feature="user_id",
                               block_sorted_kernel="bfloat16", sparse_learning_rate=0.05,
                               learning_rate=1e-3)
    ds = SyntheticClickstream(999, 299, seed=7)
    feat = Featurizer(mcfg)
    batches = [_sort_batch(jax.tree.map(np.asarray, feat(c)), 1000)
               for c in ds.batches(2048, 3, split="train")]
    state, _ = create_train_state(jax.random.key(0), mcfg, tcfg)
    start = _start(state)
    force = {"t_user_id": ROW, "t_product_id": TW}

    def close(g, w):
        np.testing.assert_allclose(g, w, rtol=0, atol=2.0 ** -7 * np.abs(w).max())

    first, _ = _port_one_device(mcfg, tcfg, start, batches[:1])
    losses = [_port_one_device(mcfg, tcfg, start, batches[:n])[1] for n in (2, 3)]
    for mesh_shape in ((4, 1), (2, 2)):
        got = _port(pool, mcfg, tcfg, start, batches[:1], mesh_shape, force)
        for name in first["tables"]:
            t0 = _f32(state.tables[name])
            close(got["state"]["tables"][name] - t0, first["tables"][name] - t0)
            close(got["state"]["adagrad_acc"][name], first["adagrad_acc"][name])
        for g, w in zip(jax.tree.leaves(got["state"]["mu"]), jax.tree.leaves(first["mu"])):
            close(g, w)
        got = _port(pool, mcfg, tcfg, start, batches, mesh_shape, force)
        for a, b in zip(got["losses"][1:], losses):
            close(np.float32(a), np.float32(b))


def _plan(force, devices=4, **cfg_kw):
    mcfg = port_config.two_tower_model_config(100, 60, embedding_dim=16, layer_sizes=(32, 8))
    mcfg = dataclasses.replace(mcfg, **cfg_kw)
    return mcfg, port_planner.plan_sharding(mcfg, devices, force=force)


class _Mesh:
    """A stand-in mesh for the refusals, which come before any collective."""
    size, data, model, rank = 4, 4, 1, 0
    device = torch.device("cpu")


def test_block_kernel_requires_row_sharded():
    """`test_sharded_sorted.py:157`, and the sorted table's other refusals."""
    mcfg, plan = _plan({"t_user_id": REP, "t_product_id": REP})
    opt = port_step.opt_lib.dense_optimizer(1e-3)
    tcfg = port_config.TrainConfig(sorted_feature="user_id", block_sorted_kernel="float32")
    with pytest.raises(ValueError, match="row_sharded"):
        port_sharded.make_sharded_train_step(mcfg, tcfg, opt, _Mesh(), plan)
    _, plan = _plan({"t_user_id": TW, "t_product_id": REP})
    with pytest.raises(ValueError, match="row_sharded or replicated"):
        port_sharded.make_sharded_train_step(
            mcfg, port_config.TrainConfig(sorted_feature="user_id"), opt, _Mesh(), plan)


@pytest.mark.parametrize("what", ["int8-table", "column-sharded", "alltoall",
                                  "sampled-softmax", "compact-wire", "per-host-slices"])
def test_m12b_and_m12c_configurations_raise(what):
    """What the sharded path refuses (as the reference does: an int8 table
    cut by columns, a column-sharded host-sorted table, an exchange that is
    neither dense nor alltoall, a placement pytree without a slicer, a
    delta wire across hosts with another segment count) raises; what M12(c)
    brought builds (the sampled softmax's step) or cuts (a host's batch)."""
    opt = port_step.opt_lib.dense_optimizer(1e-3)
    if what == "int8-table":
        mcfg, plan = _plan({"t_user_id": "column_sharded", "t_product_id": REP},
                           table_dtype="int8")
        state, _ = port_step.create_train_state(torch.Generator().manual_seed(0), mcfg,
                                                port_config.TrainConfig())
        with pytest.raises(NotImplementedError, match="per-row scales do not split by columns"):
            port_sharded.shard_train_state(state, plan, _Mesh())
    elif what == "column-sharded":
        mcfg, plan = _plan({"t_user_id": "column_sharded", "t_product_id": REP})
        with pytest.raises(ValueError, match="row_sharded or replicated"):
            port_sharded.make_sharded_train_step(
                mcfg, port_config.TrainConfig(sorted_feature="user_id"), opt, _Mesh(), plan)
    elif what == "alltoall":
        mcfg, plan = _plan({"t_user_id": ROW, "t_product_id": REP})
        with pytest.raises(ValueError, match="dense|alltoall"):
            port_sharded.make_sharded_train_step(
                mcfg, port_config.TrainConfig(sharded_exchange="ring"), opt, _Mesh(), plan)
    elif what == "sampled-softmax":
        mcfg, plan = _plan({"t_user_id": ROW, "t_product_id": REP})
        assert callable(port_sharded.make_sharded_train_step(
            mcfg, port_config.TrainConfig(loss="sampled_softmax"), opt, _Mesh(), plan))
    elif what == "compact-wire":
        from two_tower_recommender_model_tpu_torch.data.compact import CompactScheme
        from two_tower_recommender_model_tpu_torch.train.pipeline import device_put_batch

        with pytest.raises(ValueError, match="no slicer"):
            device_put_batch({"x": np.zeros(4)}, sharding={"x": None})
        mcfg, _ = _plan({"t_user_id": ROW, "t_product_id": REP})
        scheme = CompactScheme.from_model(mcfg, delta_feature="user_id")
        with pytest.raises(ValueError, match="delta_segments=2"):
            port_sharded.sharded_compact_decoder(mcfg, scheme, _Mesh(), hosts=2)
        with pytest.raises(ValueError, match="must divide by data axis 4"):
            port_sharded.compact_shardings(_Mesh(), scheme, batch_size=6)
    else:
        from two_tower_recommender_model_tpu_torch.parallel import launch

        with pytest.MonkeyPatch.context() as m:  # rank 2 of 4: host 1's first data slice
            m.setattr(launch, "host_info", lambda: {
                "num_hosts": 2, "local_devices": 2, "process_count": 4, "host_index": 1})
            mesh = _Mesh()
            mesh.rank = mesh.d = 2
            got = launch.put_global_batch({"x": np.arange(4)}, mesh)
            np.testing.assert_array_equal(got["x"].numpy(), [0, 1])
