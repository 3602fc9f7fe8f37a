"""Sharded int8 tables of the port on gloo ranks, against the JAX package
(`tests/test_quantized.py:83-130`, `tests/test_table_wise.py:281-360`,
`tests/test_sharded_sorted.py:262-300`): row-sharded int8 tables, int8
table-wise buckets (dtype-suffixed, with their scales), mixed-dtype buckets
kept apart, replicated int8 tables, the host-sorted int8 shard (with and
without the bf16 buffer), and the shard -> unshard round trip.

Against the port's one-device step (the same kernels' plain versions, #5 and
#6) from the same numpy values and scales: the loss within rtol 1e-5, every
dequantized row within one quantization step (scale / 127: a value on a
rounding boundary lands either side, and the towers' gradients arrive summed
over the ranks in another order) plus 1e-5 x the largest update, the
accumulators within rtol 1e-4 / atol 1e-6, and the towers at
`test_torch_parallel_step.py`'s bars. Against the JAX package's one-device
and sharded steps at the reference's own closeness for int8 tables
(`tests/test_sharded_sorted.py:262-300`): the loss within rtol 1e-3, the
dequantized tables within atol 5e-3.

Four ranks (spawned processes, one gloo group) serve every case."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from test_torch_parallel_step import _jax_pair, _numpy, _port, _port_one_device, _setup
from two_tower_recommender_model_tpu import config as cfg_lib
from two_tower_recommender_model_tpu.data import Featurizer
from two_tower_recommender_model_tpu.ops import quantized as jq
from two_tower_recommender_model_tpu.train.step import create_train_state

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


def _host(t):
    """A JAX table as `train_state_from_numpy` takes it: an int8 table as
    {"values", "scales"}."""
    if isinstance(t, jq.QuantizedTable):
        return {"values": np.asarray(t.values), "scales": np.asarray(t.scales)}
    return _numpy(t)


def _start(jstate) -> dict:
    host = lambda tree: jax.tree.map(_numpy, tree)  # noqa: E731
    adam = jstate.dense_opt_state[0]
    return {"step": int(jstate.step), "tables": {k: _host(t) for k, t in jstate.tables.items()},
            "adagrad_acc": host(jstate.adagrad_acc), **host(jstate.dense_params),
            "adam": {"count": int(adam.count), "mu": host(adam.mu), "nu": host(adam.nu)},
            "item_counts": None}


def _dense(t) -> np.ndarray:
    """The f32 rows a table stands for (an int8 one dequantized as both
    packages do: values x (scale / 127))."""
    if isinstance(t, jq.QuantizedTable):
        return np.asarray(jq.dequantize_table(t))
    if isinstance(t, dict):
        return t["values"].astype(np.float32) * (t["scales"] / np.float32(127.0))[:, None]
    return np.asarray(t, np.float32)


def _run(pool, mcfg, tcfg, batches, mesh_shape, force, ref_tcfg=None):
    """(start, the JAX one-device and sharded runs, plan, the port's sharded
    run, the port's one-device run)."""
    jax_batches = [jax.tree.map(np.asarray, b) for b in batches]
    ref_tcfg = ref_tcfg or tcfg
    state, _ = create_train_state(jax.random.key(0), mcfg, ref_tcfg)
    start = _start(state)
    _, one, sharded, plan = _jax_pair(mcfg, tcfg, jax_batches, mesh_shape, force, ref_tcfg)
    got = _port(pool, mcfg, tcfg, start, jax_batches, mesh_shape, force)
    mine = _port_one_device(mcfg, tcfg, start, jax_batches)
    return start, one, sharded, plan, got, mine


def _check_int8(start, one, sharded, plan, got, mine, jax_sharded=True):
    state = got["state"]
    np.testing.assert_allclose(got["losses"][-1], mine[1], rtol=1e-5)
    for name, t in state["tables"].items():
        want = mine[0]["tables"][name]
        assert isinstance(t, dict) == isinstance(start["tables"][name], dict), name
        g, w = _dense(t), _dense(want)
        step = 0.0
        if isinstance(t, dict):
            assert t["values"].dtype == np.int8 and t["scales"].dtype == np.float32
            np.testing.assert_allclose(t["scales"], want["scales"], rtol=1e-5, err_msg=name)
            step = np.maximum(t["scales"], want["scales"])[:, None] / 127
        tol = 1e-5 * np.abs(w - _dense(start["tables"][name])).max() + step
        assert (np.abs(g - w) <= tol).all(), (name, np.abs(g - w).max())
        np.testing.assert_allclose(state["adagrad_acc"][name], mine[0]["adagrad_acc"][name],
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    for key in ("query_tower", "candidate_tower"):
        for g, w in zip(jax.tree.leaves(state[key]), jax.tree.leaves(mine[0][key])):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=key)
    for want_state, want_loss in (one, sharded) if jax_sharded else (one,):
        np.testing.assert_allclose(got["losses"][-1], want_loss, rtol=1e-3)
        for name, t in want_state.tables.items():
            np.testing.assert_allclose(_dense(state["tables"][name]), _dense(t), atol=5e-3,
                                       err_msg=name)
    assert got["plan"] == plan.describe()


def _tcfg(**kw):
    return cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3, **kw)


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
def test_int8_row_sharded_matches_one_device(pool, mesh_shape):
    """`test_quantized.py:106`: both int8 tables row-sharded: #5 partial
    pools and #6 on each shard after the device sort."""
    mcfg, batches = _setup(n=3, table_dtype="int8")
    force = {"t_user_id": ROW, "t_product_id": ROW}
    _check_int8(*_run(pool, mcfg, _tcfg(), batches, mesh_shape, force))


def test_int8_table_wise_matches_one_device(pool):
    """`test_table_wise.py:281`: both int8 tables in one dtype-suffixed
    bucket, values and scales side by side."""
    mcfg, batches = _setup(n=3, seed=5, table_dtype="int8")
    force = {"t_user_id": TW, "t_product_id": TW}
    start, one, sharded, plan, got, mine = _run(pool, mcfg, _tcfg(), batches, (4, 1), force)
    assert set(plan.buckets) == {"__tw_bucket_d16_int8__"}
    assert "__tw_bucket_d16_int8__" in got["plan"]
    _check_int8(start, one, sharded, plan, got, mine)


def test_int8_row_and_replicated_match_one_device(pool):
    """A row-sharded int8 user table and a replicated int8 item table (#5
    straight, #6 after the device sort on every rank)."""
    mcfg, batches = _setup(n=3, table_dtype="int8")
    force = {"t_user_id": ROW, "t_product_id": REP}
    _check_int8(*_run(pool, mcfg, _tcfg(), batches, (2, 2), force))


def _mixed_config():
    """`test_table_wise.py:329`: an f32 and an int8 table of one dim."""
    mcfg = cfg_lib.ModelConfig(
        tables=(cfg_lib.TableConfig("t_u", 80, 16, ("u",)),
                cfg_lib.TableConfig("t_i", 50, 16, ("i",), dtype="int8")),
        features=(cfg_lib.FeatureConfig("u", "t_u"), cfg_lib.FeatureConfig("i", "t_i")),
        query_tower=cfg_lib.TowerConfig(("u",), (16, 8)),
        candidate_tower=cfg_lib.TowerConfig(("i",), (16, 8)))
    mcfg.validate()
    return mcfg


def test_mixed_dtype_buckets_are_kept_apart(pool):
    """f32 and int8 table-wise tables of one dim land in two buckets, and the
    step matches the one-device steps."""
    mcfg = _mixed_config()
    rng = np.random.default_rng(0)
    batch = Featurizer(mcfg)({"u": rng.integers(1, 80, 64), "i": rng.integers(1, 50, 64),
                              "label": rng.integers(0, 2, 64)})
    force = {"t_u": TW, "t_i": TW}
    start, one, sharded, plan, got, mine = _run(pool, mcfg, _tcfg(), [batch], (4, 1), force)
    assert set(plan.buckets) == {"__tw_bucket_d16__", "__tw_bucket_d16_int8__"}
    assert got["state"]["tables"]["t_u"].shape == (80, 16)
    assert got["state"]["tables"]["t_i"]["values"].shape == (50, 16)
    _check_int8(start, one, sharded, plan, got, mine)


@pytest.mark.parametrize("case", ["4x1", "2x2", "bf16-buffer"])
def test_int8_sorted_shard_matches_one_device(pool, case):
    """`test_sharded_sorted.py:262`: the host-sorted int8 table's shard gathers
    through #5 at one slot and updates through #6 on its local ids as they
    are (below the shard negative, above it past its rows: sentinels); the
    other int8 table takes the device sort. With `scatter_buffer_dtype=
    "bfloat16"` (block kernels off) #6 sums each run in the bf16 buffer, and
    writes no row for the sentinels. The JAX one-device reference is the
    plain step, as the reference's test runs it; with the bf16 buffer it takes
    the buffer too, and is the only JAX step compared: the JAX package's
    sharded int8 shard takes its plain quantized update, no buffer
    (`sharded.py:705`), and departs from its own one-device step by up to
    0.11 on this case's user table. The port's sharded step keeps the
    one-device semantics (bit for bit its rows' buffer sums), as for f32
    tables."""
    mesh_shape = (2, 2) if case == "2x2" else (4, 1)
    mcfg, batches = _setup(dim=128, batch=128, n=3, sort=True, seed=7, table_dtype="int8")
    if case == "bf16-buffer":
        tcfg = _tcfg(sorted_feature="user_id", scatter_buffer_dtype="bfloat16")
        ref_tcfg = tcfg
    else:
        tcfg = _tcfg(sorted_feature="user_id", block_sorted_kernel="float32")
        ref_tcfg = _tcfg()
    force = {"t_user_id": ROW, "t_product_id": ROW}
    _check_int8(*_run(pool, mcfg, tcfg, batches, mesh_shape, force, ref_tcfg=ref_tcfg),
                jax_sharded=case != "bf16-buffer")


PLANS = {
    "int8-row": ({"t_user_id": ROW, "t_product_id": ROW}, (4, 1), "int8", 16),
    "int8-bucket+replicated": ({"t_user_id": TW, "t_product_id": REP}, (2, 2), "int8", 16),
    "f32-column-padded": ({"t_user_id": "column_sharded", "t_product_id": ROW}, (4, 1),
                          "float32", 14),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_shard_then_unshard_is_the_start(pool, case):
    """`shard_train_state` -> `unshard_train_state`, on every rank and on
    rank 0, gives the whole state back bit for bit: int8 values and scales
    out of row shards and buckets (padding cut), replicated tables, column
    slices joined and their dim padding cut."""
    force, mesh_shape, dtype, dim = PLANS[case]
    mcfg, _ = _setup(dim=dim, n=0, table_dtype=dtype)
    state, _ = create_train_state(jax.random.key(3), mcfg, cfg_lib.TrainConfig())
    start = _start(state)
    got = pool.run("round_trip", cfg=dataclasses.asdict(mcfg),
                   tcfg=dataclasses.asdict(cfg_lib.TrainConfig()), start=start,
                   mesh_shape=mesh_shape, force=force)
    assert got[0]["at0"] is not None and all(g["at0"] is None for g in got[1:])
    for r, g in enumerate(got):
        for which in ("everywhere", "at0") if r == 0 else ("everywhere",):
            s = g[which]
            for name, t in start["tables"].items():
                if isinstance(t, dict):
                    np.testing.assert_array_equal(s["tables"][name]["values"], t["values"])
                    np.testing.assert_array_equal(s["tables"][name]["scales"], t["scales"])
                else:
                    np.testing.assert_array_equal(s["tables"][name], t)
                np.testing.assert_array_equal(s["adagrad_acc"][name], start["adagrad_acc"][name])
