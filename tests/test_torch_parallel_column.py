"""Column-sharded tables of the port on gloo ranks, against the JAX package
(`tests/test_sharded.py:249-335`): every rank holds each row's slice of the
columns and the rows' accumulator whole; the lookup pools its slice (kernel
#1) and joins the slices over the mesh, the update sums each row's
gradients (kernel #3), all-reduces the rows' squared gradients over the mesh
and divides by the unpadded dim. Column-sharded tables against the port's
and the JAX package's one-device steps and the JAX package's sharded step at
(4, 1) and (2, 2), mixed with row-sharded and replicated tables, with a dim
the ranks do not divide (padded), and the int8 column guard.

The bars are `test_torch_parallel_step.py`'s: the accumulator's squared sum
runs over the columns in another order than the one-device kernel #4's
mean, within them.

Four ranks (spawned processes, one gloo group) serve every case."""

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from test_torch_parallel_step import (
    _Mesh,
    _check,
    _jax_pair,
    _plan,
    _port,
    _port_one_device,
    _setup,
)
from two_tower_recommender_model_tpu import config as cfg_lib
from two_tower_recommender_model_tpu.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.parallel import sharded as port_sharded
from two_tower_recommender_model_tpu_torch.train import step as port_step

COL, ROW, REP = "column_sharded", "row_sharded", "replicated"


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


def _tcfg():
    return cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
def test_column_sharded_matches_one_device(pool, mesh_shape):
    """`test_sharded.py:249`: both tables column-sharded."""
    mcfg, batches = _setup()
    force = {"t_user_id": COL, "t_product_id": COL}
    start, one, sharded, plan = _jax_pair(mcfg, _tcfg(), batches, mesh_shape, force)
    assert plan["t_user_id"].padded_dim % 4 == 0
    got = _port(pool, mcfg, _tcfg(), start, batches, mesh_shape, force)
    _check(got, one, sharded, plan, _port_one_device(mcfg, _tcfg(), start, batches))


@pytest.mark.parametrize("force", [{"t_user_id": ROW, "t_product_id": COL},
                                   {"t_user_id": COL, "t_product_id": REP}],
                         ids=["row+column", "column+replicated"])
def test_mixed_row_column_replicated(pool, force):
    """`test_sharded.py:282`: a column-sharded table beside a row-sharded or a
    replicated one."""
    mcfg, batches = _setup(n=2)
    start, one, sharded, plan = _jax_pair(mcfg, _tcfg(), batches, (4, 1), force)
    got = _port(pool, mcfg, _tcfg(), start, batches, (4, 1), force)
    _check(got, one, sharded, plan, _port_one_device(mcfg, _tcfg(), start, batches))


def test_column_sharded_dim_padding(pool):
    """`test_sharded.py:304`: a dim of 14 over 4 ranks pads to 16 columns
    (4 a rank, the last rank's 2 of padding); the padded columns' gradients
    are zero, the accumulator divides by 14, and the gathered table is
    [50, 14]."""
    mcfg = cfg_lib.two_tower_model_config(num_users=50, num_items=30, embedding_dim=14,
                                          layer_sizes=(16, 8))
    ds = SyntheticClickstream(50, 30, seed=1)
    batches = [jax.tree.map(np.asarray, Featurizer(mcfg)(ds.sample(32, start=i)))
               for i in range(2)]
    force = {"t_user_id": COL, "t_product_id": COL}
    tcfg = cfg_lib.TrainConfig()
    start, one, sharded, plan = _jax_pair(mcfg, tcfg, batches, (4, 1), force)
    assert plan["t_user_id"].padded_dim == 16
    got = _port(pool, mcfg, tcfg, start, batches, (4, 1), force)
    assert got["state"]["tables"]["t_user_id"].shape == (50, 14)
    _check(got, one, sharded, plan, _port_one_device(mcfg, tcfg, start, batches))


def test_int8_column_guard():
    """`test_quantized.py:83`: per-row scales do not split by columns; a
    replicated int8 table shards."""
    mcfg, plan = _plan({"t_user_id": COL, "t_product_id": COL}, table_dtype="int8")
    state, _ = port_step.create_train_state(torch.Generator().manual_seed(0), mcfg,
                                            port_config.TrainConfig())
    with pytest.raises(NotImplementedError, match="scales"):
        port_sharded.shard_train_state(state, plan, _Mesh())
    mesh = _Mesh()
    mesh.size = mesh.data = 1
    _, plan = _plan({"t_user_id": REP, "t_product_id": REP}, devices=1, table_dtype="int8")
    sh = port_sharded.shard_train_state(state, plan, mesh)
    assert isinstance(sh.model.tables["t_user_id"], port_sharded.QuantizedTable)
