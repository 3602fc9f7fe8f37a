"""Several hosts on gloo ranks: four ranks seen as two hosts of two
(torchrun's `GROUP_RANK` and `LOCAL_WORLD_SIZE` set in each rank), each host
featurizing its own half of every global batch, as the reference's two
worker processes do (`tests/test_multihost.py:84`, `:244`, `:348`, `:512`,
`:724`): `put_global_batch` into the sharded step; a packed macro-batch
from the hosts' halves; the compact wire; the delta wire, each host sorting
and encoding its half as one of two segments; the sampled softmax with its
fused route and logQ counts. Against the JAX package's one-device step on
the global batches (the reference's single-process result) and the port's
one-device step.

Tolerances: the reference's (`test_multihost.py`): the loss within rtol
1e-5, the tables within rtol 1e-4 and atol 1e-5 (atol 1e-6 there; kernel #4
and XLA's scatter sum a row's slots in different orders, as
`test_torch_parallel_step.py` has it), the towers within rtol 1e-4 / atol
1e-6; the softmax's fused route against the JAX kernels in interpret mode
at `test_torch_train_step.py`'s 2^-7 x the largest value, and at the
bars above against the port's one-device fused step; the logQ counts
exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from test_torch_parallel_softmax import FUSED_REL, _assert_close_to_jax, _close
from test_torch_parallel_step import _assert_states, _port_one_device, _start
from two_tower_recommender_model_tpu import config as cfg_lib
from two_tower_recommender_model_tpu.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model_tpu.train.step import create_train_state, make_train_step
from two_tower_recommender_model_tpu_torch.parallel import launch

ROW, TW = "row_sharded", "table_wise"
HOSTS = 2


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


def _worker_setup(softmax=False):
    """The reference workers' model, config and batches
    (`test_multihost.py:WORKER`, `WORKER_SOFTMAX`)."""
    if softmax:
        mcfg = cfg_lib.two_tower_model_config(num_users=100, num_items=60, embedding_dim=16,
                                              layer_sizes=(32, 8))
        tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3,
                                   loss="sampled_softmax", logq_correction=True,
                                   softmax_kernel="on", softmax_temperature=0.8)
        ds, b, n = SyntheticClickstream(100, 60, seed=5), 512, 2
    else:
        mcfg = cfg_lib.two_tower_model_config(num_users=64, num_items=40, embedding_dim=8,
                                              layer_sizes=(16, 8))
        tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3)
        ds, b, n = SyntheticClickstream(64, 40, seed=9), 32, 3
    return mcfg, tcfg, [ds.sample(b, start=i) for i in range(n)]


def _single_process(mcfg, tcfg, columns):
    """The JAX package's one-device steps on the global batches: (start,
    state, last loss)."""
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    start = _start(state)
    if state.item_counts is not None:
        start["item_counts"] = np.asarray(state.item_counts)
    step = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    feat = Featurizer(mcfg)
    for cols in columns:
        state, out = step(state, jax.tree.map(jnp.asarray, feat(cols)))
    return start, state, float(out["loss"])


ROUTES = {  # route -> forced strategies (test_multihost.py's workers)
    "step": {"t_user_id": ROW, "t_product_id": ROW},
    "packed": {"t_user_id": ROW, "t_product_id": TW},
    "compact": {"t_user_id": ROW, "t_product_id": ROW},
    "delta": {"t_user_id": ROW, "t_product_id": ROW},
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_two_hosts_match_single_process(pool, route):
    mcfg, tcfg, columns = _worker_setup()
    if route == "delta":
        columns[1]["user_id"][:5] = 0  # missing ids exercise the N+1 sentinel
    start, want, want_loss = _single_process(mcfg, tcfg, columns)
    got = pool.run("multihost_steps", cfg=dataclasses.asdict(mcfg),
                   tcfg=dataclasses.asdict(tcfg), start=start, columns=columns,
                   force=ROUTES[route], hosts=HOSTS, route=route)[0]
    np.testing.assert_allclose(got["losses"][-1], want_loss, rtol=1e-5)
    _assert_states(got["state"], want)
    feat = Featurizer(mcfg)
    mine, mine_loss = _port_one_device(mcfg, tcfg, start,
                                       [jax.tree.map(np.asarray, feat(c)) for c in columns])
    np.testing.assert_allclose(got["losses"][-1], mine_loss, rtol=1e-5)
    for name in mine["tables"]:
        np.testing.assert_allclose(got["state"]["tables"][name], mine["tables"][name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_two_hosts_sampled_softmax_fused_matches_single_process(pool):
    """The fused stripes over the two hosts' halves (B = 512, four stripes
    of 128 rows) with streaming logQ: the counts equal the one-device
    step's exactly."""
    mcfg, tcfg, columns = _worker_setup(softmax=True)
    start, want, want_loss = _single_process(mcfg, tcfg, columns)
    got = pool.run("multihost_steps", cfg=dataclasses.asdict(mcfg),
                   tcfg=dataclasses.asdict(tcfg), start=start, columns=columns,
                   force=ROUTES["step"], hosts=HOSTS, route="step")[0]
    np.testing.assert_array_equal(got["state"]["item_counts"], np.asarray(want.item_counts))
    _close(got["losses"][-1], want_loss, FUSED_REL, "loss")
    _assert_close_to_jax(got["state"], want, start, FUSED_REL)
    feat = Featurizer(mcfg)
    mine, mine_loss = _port_one_device(mcfg, tcfg, start,
                                       [jax.tree.map(np.asarray, feat(c)) for c in columns])
    np.testing.assert_allclose(got["losses"][-1], mine_loss, rtol=1e-5)
    for key in ("tables", "adagrad_acc"):
        for name in mine[key]:
            np.testing.assert_allclose(got["state"][key][name], mine[key][name], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{key}/{name}")


def test_a_host_must_hold_whole_data_slices(monkeypatch):
    """The mesh numbers ranks `r = d x model + m`: two hosts of three ranks
    cannot hold whole data slices of a model-2 mesh, and a host's ranks must
    be numbered in order."""
    info = {"num_hosts": 2, "local_devices": 3, "process_count": 6, "host_index": 0}
    monkeypatch.setattr(launch, "host_info", lambda: info)
    mesh = type("Mesh", (), {"data": 3, "model": 2, "size": 6, "rank": 0})()
    with pytest.raises(ValueError, match="whole data slices"):
        launch.mesh_hosts(mesh)
    info.update(local_devices=2, process_count=4, host_index=1)
    mesh = type("Mesh", (), {"data": 2, "model": 2, "size": 4, "rank": 0})()
    with pytest.raises(ValueError, match="numbered in order"):
        launch.mesh_hosts(mesh)
    info.update(host_index=0)
    assert launch.mesh_hosts(mesh) == 2
