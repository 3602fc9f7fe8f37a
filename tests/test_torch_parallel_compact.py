"""The compact wire on a mesh: `make_sharded_compact_multi_step` over a
stacked `CompactBatch` placed leaf by leaf (`compact_shardings`) on gloo
ranks, against the JAX package's sharded compact macro-step and its
one-device compact macro-step, and the port's one-device compact macro-step,
from the same numpy start on the same batches, with the sorted user slot
plain and delta-encoded (`tests/test_sharded_sorted.py:170`).

Each rank decodes its slice; the delta slot's cumsum spans the batch, so a
rank adds the exclusive prefix of the slices before it (an all-gather of
the slices' totals over the data group). Every rank's decoded ids, masks and
labels, gathered over data, equal the one-device decode of the whole batch
bit for bit. Tolerances: against the port's one-device compact macro-step
the loss within rtol 1e-5, tables, accumulators and towers within rtol 1e-4
/ atol 1e-6 (`test_torch_parallel_step.py`'s bars); against the JAX
package's steps the tables at atol 1e-5, as there (kernel #4 and XLA's
scatter sum a row's slots in different orders).

Four ranks (spawned processes, one gloo group) serve every case."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from test_torch_parallel_step import _assert_port_states, _assert_states, _start
from two_tower_recommender_model_tpu import config as cfg_lib
from two_tower_recommender_model_tpu.data import SyntheticClickstream
from two_tower_recommender_model_tpu.data.compact import CompactFeaturizer, CompactScheme
from two_tower_recommender_model_tpu.data.compact import batch_from_compact as jax_decode
from two_tower_recommender_model_tpu.data.device_featurizer import PackedFeaturizer
from two_tower_recommender_model_tpu.parallel import (
    compact_macro_shardings,
    make_mesh,
    make_sharded_compact_multi_step,
    plan_sharding,
    shard_train_state,
)
from two_tower_recommender_model_tpu.parallel.sharded import unshard_train_state
from two_tower_recommender_model_tpu.train.step import (
    create_train_state,
    make_multi_step,
    make_train_step,
    stack_batches,
)
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.data.compact import batch_from_compact
from two_tower_recommender_model_tpu_torch.train import step as port_step
from two_tower_recommender_model_tpu_torch.train.pipeline import map_leaves

ROW = "row_sharded"


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


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
@pytest.mark.parametrize("delta", [False, True])
def test_sharded_compact_multi_step_matches_single_device(pool, delta, mesh_shape):
    mcfg = cfg_lib.two_tower_model_config(num_users=500, num_items=200, embedding_dim=16,
                                          layer_sizes=(32, 8))
    feature = "user_id" if delta else None
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3,
                               sorted_feature=feature)
    ds = SyntheticClickstream(500, 200, seed=3)
    columns = [ds.sample(128, start=i) for i in range(3)]
    if delta:
        columns[1]["user_id"][:5] = 0  # missing ids exercise the N+1 sentinel
    scheme = CompactScheme.from_model(mcfg, pack_label=True, delta_feature=feature)
    cf = CompactFeaturizer(PackedFeaturizer(mcfg, pack_label=True, sort_feature=feature), scheme)
    macro = stack_batches([cf(c) for c in columns])

    # the JAX package: one device, then its mesh
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    core = make_train_step(mcfg, tcfg, dense_opt, donate=False, jit=False)
    ref_multi = make_multi_step(lambda s, cb: core(s, jax_decode(cb, mcfg, scheme)),
                                donate=False)
    ref_state, ref_out = ref_multi(state, jax.tree.map(jnp.asarray, macro))
    mesh = make_mesh(*mesh_shape)
    force = {"t_user_id": ROW, "t_product_id": ROW}
    plan = plan_sharding(mcfg, mesh.devices.size, force=force)
    multi = make_sharded_compact_multi_step(mcfg, tcfg, dense_opt, mesh, plan, scheme,
                                            donate=False)
    sh = compact_macro_shardings(mesh, macro)
    sh_state, sh_out = multi(shard_train_state(state, plan, mesh),
                             jax.tree.map(lambda x, s: jax.device_put(x, s), macro, sh))
    jax_sharded = unshard_train_state(sh_state, plan, mcfg)

    # the port: one device, then the ranks
    start = _start(state)
    pcfg = port_config.model_config_from_dict(dataclasses.asdict(mcfg))
    ptcfg = port_config.TrainConfig(**dataclasses.asdict(tcfg))
    pstate, popt = ranks.start_state(start, pcfg, ptcfg)
    pscheme = ranks._compact_scheme(pcfg, feature)
    pcore = port_step.make_train_step(pcfg, ptcfg, popt)
    pmulti = port_step.make_multi_step(lambda s, cb: pcore(s, batch_from_compact(cb, pcfg,
                                                                                pscheme)))
    pcf = ranks._compact_featurizer(pcfg, pscheme)
    pmacro = port_step.stack_batches([pcf(c) for c in columns])
    pstate, pout = pmulti(pstate, map_leaves(pmacro, lambda t: t))
    got = pool.run("compact_steps", cfg=dataclasses.asdict(mcfg), tcfg=dataclasses.asdict(tcfg),
                   start=start, columns=columns, mesh_shape=mesh_shape, force=force,
                   delta_feature=feature)[0]

    assert got["decoded_equal"]
    np.testing.assert_allclose(got["losses"], pout["loss"].numpy(), rtol=1e-5)
    _assert_port_states(got["state"], ranks.state_numpy(pstate))
    for want_state, want_losses in ((ref_state, ref_out["loss"]),
                                    (jax_sharded, sh_out["loss"])):
        np.testing.assert_allclose(got["losses"], np.asarray(want_losses), rtol=1e-5)
        _assert_states(got["state"], want_state)
