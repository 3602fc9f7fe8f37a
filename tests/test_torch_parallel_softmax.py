"""The port's data-parallel in-batch sampled softmax
(`models.losses.sharded_in_batch_sampled_softmax` through the sharded step,
the packed macro-step and the sharded eval) on gloo ranks, against the JAX
package's sharded and one-device steps and the port's one-device step from
the same numpy start on the same batches (`tests/test_sharded_softmax.py:61`,
`:85`, `:117`, `:144`).

Each rank runs its `[B_local, B]` stripe at `row_offset = d x B_local`:
with `softmax_kernel="off"` through the plain row blocks, with "on" through
the fused route, whose kernels' plain versions carry the stripes on CPU
tensors. Tolerances: against the port's one-device step the reference's
sharded-vs-one-device bars (loss rtol 1e-5; tables, accumulators and towers
rtol 1e-4, atol 1e-6, the tables atol 1e-5 as `test_torch_parallel_step.py`
and the reference's item table: each candidate's gradient is summed over
the stripes in another f32 order). Against the JAX package the "off" route
at the same bars; the "on" route at `test_torch_train_step.py`'s bar for
the fused softmax against the JAX kernels in interpret mode, 2^-7 x the
largest value (p is rounded to bf16 in both, and a p on a rounding boundary
goes either way). The streaming logQ counts equal the one-device step's
exactly.

Four ranks (spawned processes, one gloo group) serve every case; a (2, 2)
mesh takes all four."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from test_torch_parallel_step import (
    _assert_states,
    _f32,
    _jax_pair,
    _port,
    _port_one_device,
    _start,
)
from two_tower_recommender_model_tpu import config as cfg_lib
from two_tower_recommender_model_tpu.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model_tpu.train.loop import evaluate as jax_evaluate
from two_tower_recommender_model_tpu.train.step import create_train_state, make_eval_step
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.models import losses as port_losses

ROW, TW = "row_sharded", "table_wise"
FUSED_REL = 2.0 ** -7


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


def _setup(batch_size=64, n_batches=3, logq=False, kernel="off"):
    """The reference's `_setup` (`test_sharded_softmax.py:34`)."""
    mcfg = cfg_lib.two_tower_model_config(num_users=100, num_items=60, embedding_dim=16,
                                          layer_sizes=(32, 8))
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3,
                               loss="sampled_softmax", logq_correction=logq,
                               softmax_kernel=kernel, softmax_temperature=0.8)
    ds = SyntheticClickstream(100, 60, seed=5)
    feat = Featurizer(mcfg)
    cols = [ds.sample(batch_size, start=i) for i in range(n_batches)]
    return mcfg, tcfg, [jax.tree.map(np.asarray, feat(c)) for c in cols], cols


def _close(got, want, rel, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), f"{what}: {err} > {rel} x {np.abs(want).max()}"


def _assert_close_to_jax(got: dict, want, start: dict, rel):
    """The fused route against a JAX state: each table's change and
    accumulator, the towers, within `rel` x the largest value."""
    for name, t in want.tables.items():
        t0 = np.asarray(start["tables"][name])
        _close(got["tables"][name] - t0, _f32(t) - t0, rel, name)
        _close(got["adagrad_acc"][name], np.asarray(want.adagrad_acc[name]), rel, name)
    for key in ("query_tower", "candidate_tower"):
        for layer, p in want.dense_params[key].items():
            for pname in ("kernel", "bias"):
                _close(got[key][layer][pname], np.asarray(p[pname]), rel,
                       f"{key}/{layer}/{pname}")


def _with_counts(start: dict, mcfg, tcfg) -> dict:
    state, _ = create_train_state(jax.random.key(0), mcfg, tcfg)
    if state.item_counts is not None:
        start = {**start, "item_counts": np.asarray(state.item_counts)}
    return start


def _run(pool, mcfg, tcfg, batches, cols, mesh_shape, force):
    """(the port's sharded and macro runs, the port's one-device run, the
    JAX one-device and sharded runs, the start, the plan)."""
    start, one, sharded, plan = _jax_pair(mcfg, tcfg, batches, mesh_shape, force)
    start = _with_counts(start, mcfg, tcfg)
    got = _port(pool, mcfg, tcfg, start, batches, mesh_shape, force, packed_columns=cols)
    mine = _port_one_device(mcfg, tcfg, start, batches)
    return got, mine, one, sharded, start, plan


def _check_port(got, mine, table_atol=1e-5):
    """The sharded step and the macro-step against the port's one-device
    step, and the macro-step bit for bit the sequential sharded steps."""
    np.testing.assert_allclose(got["losses"][-1], mine[1], rtol=1e-5)
    for name in mine[0]["tables"]:
        for key in ("tables", "adagrad_acc"):
            np.testing.assert_allclose(got["state"][key][name], mine[0][key][name], rtol=1e-4,
                                       atol=table_atol, err_msg=f"{key}/{name}")
    for key in ("query_tower", "candidate_tower"):
        for g, w in zip(jax.tree.leaves(got["state"][key]), jax.tree.leaves(mine[0][key])):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6, err_msg=key)
    assert got["macro_losses"] == got["losses"]
    for name in got["state"]["tables"]:
        np.testing.assert_array_equal(got["macro_state"]["tables"][name],
                                      got["state"]["tables"][name])


# (mesh, kernel, batch, logq, forced strategies)
CASES = {
    "scan-4x1": ((4, 1), "off", 64, False, {"t_user_id": ROW, "t_product_id": ROW}),
    "scan-2x2": ((2, 2), "off", 64, False, {"t_user_id": ROW, "t_product_id": ROW}),
    "fused-4x1": ((4, 1), "on", 512, False, {"t_user_id": ROW, "t_product_id": ROW}),
    "fused-logq-2x2": ((2, 2), "on", 512, True, {"t_user_id": ROW, "t_product_id": ROW}),
    "scan-logq-4x1": ((4, 1), "off", 64, True, {"t_user_id": ROW, "t_product_id": ROW}),
    "table-wise-4x1": ((4, 1), "off", 64, False, {"t_user_id": TW, "t_product_id": TW}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_softmax_matches_jax(pool, case):
    mesh_shape, kernel, batch, logq, force = CASES[case]
    mcfg, tcfg, batches, cols = _setup(batch_size=batch, n_batches=2 if kernel == "on" else 3,
                                       logq=logq, kernel=kernel)
    pcfg = port_config.model_config_from_dict(dataclasses.asdict(mcfg))
    if kernel == "on":  # the stripes take the fused route
        assert port_losses._use_fused_softmax(batch, 8, "on", torch.device("cpu"),
                                              batch // mesh_shape[0])
    got, mine, one, sharded, start, plan = _run(pool, mcfg, tcfg, batches, cols, mesh_shape,
                                                force)
    assert got["plan"] == plan.describe()
    _check_port(got, mine)
    if logq:
        assert got["state"]["item_counts"].sum() == len(batches) * batch
        np.testing.assert_array_equal(got["state"]["item_counts"], mine[0]["item_counts"])
        np.testing.assert_array_equal(got["state"]["item_counts"],
                                      np.asarray(one[0].item_counts))
    for want_state, want_loss in (one, sharded):
        if kernel == "off":
            np.testing.assert_allclose(got["losses"][-1], want_loss, rtol=1e-5)
            _assert_states(got["state"], want_state)
        else:
            _close(got["losses"][-1], want_loss, FUSED_REL, "loss")
            _assert_close_to_jax(got["state"], want_state, start, FUSED_REL)
    if TW in force.values():
        assert "__tw_bucket_d16__" in got["plan"]
    assert pcfg.candidate_tower.features[0] == "product_id"


def test_sharded_eval_under_the_softmax_matches_jax(pool):
    """The sharded eval of a sampled-softmax run (BCE and AUROC, whatever
    the training loss) on every rank against the JAX package's one-device
    eval over the same batches."""
    mcfg, tcfg, _, cols = _setup(batch_size=64, n_batches=3, logq=True)
    state, _ = create_train_state(jax.random.key(0), mcfg, tcfg)
    start = _with_counts(_start(state), mcfg, tcfg)
    got = pool.run("evaluate_columns", cfg=dataclasses.asdict(mcfg),
                   tcfg=dataclasses.asdict(tcfg), start=start, columns=cols,
                   mesh_shape=(4, 1), force={"t_user_id": ROW, "t_product_id": TW})
    want = jax_evaluate(state, make_eval_step(mcfg, tcfg), cols, Featurizer(mcfg))
    for metrics in got:
        for key in ("val_loss", "val_auroc"):
            np.testing.assert_allclose(metrics[key], want[key], rtol=1e-5, err_msg=key)
