"""The packed macro-step path on the CPU: `stack_batches`, `make_multi_step`
(a plain loop over the K slices on CPU tensors: bitwise equal to K sequential
steps), `macro_stream`, `prefetch_to_device(num_workers=)` and
`train_one_epoch_packed`, as the JAX package's `tests/test_device_featurizer.py`
holds its own; and the port's multi-step against the JAX package's
`make_multi_step` (`lax.scan`) on the same numpy weights and batches. On the
card the multi-step is a CUDA graph: `tests/test_torch_graph_cuda.py`."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu import config as jax_config
from two_tower_recommender_model_tpu.data.device_featurizer import (
    PackedFeaturizer as JaxPackedFeaturizer,
)
from two_tower_recommender_model_tpu.data.device_featurizer import unpack_batch as jax_unpack
from two_tower_recommender_model_tpu.train import step as jax_step
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.data.device_featurizer import (
    PackedBatch,
    PackedFeaturizer,
    make_packed_eval_step,
    make_packed_train_step,
    unpack_batch,
)
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.models.two_tower import params_from_numpy
from two_tower_recommender_model_tpu_torch.ops.quantized import QuantizedTable
from two_tower_recommender_model_tpu_torch.train import optimizer as port_opt
from two_tower_recommender_model_tpu_torch.train import step as port_step
from two_tower_recommender_model_tpu_torch.train.loop import _macro_dims, train_one_epoch_packed
from two_tower_recommender_model_tpu_torch.train.pipeline import (
    device_put_batch,
    macro_stream,
    map_leaves,
    prefetch_to_device,
)


def _mcfg(lib=port_config, **kw):
    return lib.two_tower_model_config(num_users=100, num_items=60, embedding_dim=8,
                                      layer_sizes=(16, 8), **kw)


def _tensors(pb):
    return map_leaves(pb, lambda t: t)


def _state_parts(state):
    """Every tensor of a state, by name."""
    out = {}
    for name, t in state.model.tables.items():
        if isinstance(t, QuantizedTable):
            out[f"{name}.values"], out[f"{name}.scales"] = t.values, t.scales
        else:
            out[name] = t.detach()
        out[f"{name}.acc"] = state.adagrad_acc[name]
    for i, p in enumerate(port_step.tower_parameters(state.model)):
        out[f"tower{i}"] = p.detach()
        for key, v in state.dense_opt_state.state[p].items():
            out[f"tower{i}.{key}"] = v
    if state.item_counts is not None:
        out["item_counts"] = state.item_counts
    return out


def _assert_states_equal(a, b):
    pa, pb = _state_parts(a), _state_parts(b)
    assert pa.keys() == pb.keys()
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
    assert a.step == b.step


# --- stack_batches ------------------------------------------------------------------------------


def test_stack_batches_adds_a_leading_axis_to_every_leaf():
    mcfg = _mcfg()
    ds = SyntheticClickstream(100, 60, seed=2)
    pf = PackedFeaturizer(mcfg)
    host = [pf(ds.sample(64, start=i)) for i in range(5)]
    stacked = port_step.stack_batches(host)
    assert isinstance(stacked, PackedBatch)
    assert isinstance(stacked.ids_raw, np.ndarray) and stacked.ids_raw.shape == (5, 64, 2)
    assert stacked.labels.shape == (5, 64) and stacked.dense is None and stacked.weights is None
    for i, pb in enumerate(host):
        np.testing.assert_array_equal(stacked.ids_raw[i], pb.ids_raw)
        np.testing.assert_array_equal(stacked.labels[i], pb.labels)
    assert _macro_dims(stacked) == (5, 64)
    # the label packed into the ids: the per-batch label array is empty, and stays so
    packed = port_step.stack_batches(
        [PackedFeaturizer(mcfg, pack_label=True)(ds.sample(32, start=i)) for i in range(3)])
    assert packed.labels.shape == (3, 0) and packed.ids_raw.shape == (3, 32, 2)
    # nested dataclasses and dicts (a host `Batch`)
    feat = Featurizer(mcfg, device="cpu")
    batches = [map_leaves(feat(ds.sample(16, start=i)), lambda t: t.numpy()) for i in range(2)]
    nested = port_step.stack_batches(batches)
    assert nested.features["user_id"].ids.shape == (2, 16, 1)
    assert nested.labels.shape == (2, 16)


def test_stack_batches_matches_jax():
    mcfg, jcfg = _mcfg(), _mcfg(jax_config)
    ds = SyntheticClickstream(100, 60, seed=2)
    cols = [ds.sample(64, start=i) for i in range(4)]
    got = port_step.stack_batches([PackedFeaturizer(mcfg)(c) for c in cols])
    want = jax_step.stack_batches([JaxPackedFeaturizer(jcfg)(c) for c in cols])
    np.testing.assert_array_equal(got.ids_raw, want.ids_raw)
    np.testing.assert_array_equal(got.labels, want.labels)


# --- multi-step == sequential, bitwise, on the CPU ----------------------------------------------


def _softmax(t):
    return dataclasses.replace(t, loss="sampled_softmax", softmax_temperature=0.5)


MULTI_CASES = {
    # name: (model config changes, train config changes, featurizer arguments, optimizer)
    "bce": ({}, lambda t: t, {}, None),
    "bce-sorted-label-packed": (
        {}, lambda t: dataclasses.replace(t, sorted_feature="user_id"),
        {"pack_label": True, "sort_feature": "user_id"}, None),
    "sampled-softmax-logq": ({}, _softmax, {}, None),
    "int8-tables": ({"table_dtype": "int8"}, lambda t: t, {}, None),
    "bf16-tables": ({"table_dtype": "bfloat16"}, lambda t: t, {}, None),
    "cosine-schedule-with-warmup": (
        {}, lambda t: t, {},
        lambda: port_opt.dense_optimizer(3e-3, "cosine", total_steps=10, warmup_steps=2)),
    "adamw-linear-schedule": (
        {}, lambda t: t, {},
        lambda: port_opt.dense_optimizer(3e-3, "linear", total_steps=8, weight_decay=0.01)),
}


@pytest.mark.parametrize("case", list(MULTI_CASES))
def test_multi_step_matches_sequential(case):
    """K batches through one multi-step call == K sequential steps, bit for
    bit: tables, accumulators, towers, Adam's moments and step counts, the
    item counts; the K losses are the sequential losses."""
    model_changes, train_changes, feat_args, make_opt = MULTI_CASES[case]
    mcfg = dataclasses.replace(_mcfg(), **model_changes)
    tcfg = train_changes(port_config.TrainConfig())
    ds = SyntheticClickstream(100, 60, seed=2)
    pf = PackedFeaturizer(mcfg, **feat_args)
    host = [pf(ds.sample(64, start=i)) for i in range(6)]
    pack_label = feat_args.get("pack_label", False)

    state_a, dense_opt = port_step.create_train_state(torch.Generator().manual_seed(0), mcfg,
                                                      tcfg)
    if make_opt is not None:
        dense_opt = make_opt()
        state_a.dense_opt_state = dense_opt.build(port_step.tower_parameters(state_a.model))
    state_b = state_a.copy()
    core = port_step.make_train_step(mcfg, tcfg, dense_opt)
    seq_losses = []
    for pb in host:
        state_a, out_a = core(state_a, unpack_batch(_tensors(pb), mcfg, pack_label=pack_label))
        seq_losses.append(out_a["loss"])

    multi = port_step.make_multi_step(
        lambda s, pb: core(s, unpack_batch(pb, mcfg, pack_label=pack_label)))
    stacked = _tensors(port_step.stack_batches(host))
    state_b, out_b = multi(state_b, stacked)
    assert out_b["loss"].shape == (6,)
    assert torch.equal(out_b["loss"], torch.stack(seq_losses))
    assert state_b.step == 6
    _assert_states_equal(state_a, state_b)
    assert multi.captures == 0 and multi.replays == 0  # no graph on CPU tensors
    # a second macro continues from the first: the schedule and Adam's counts go on
    more = [pf(ds.sample(64, start=6 + i)) for i in range(3)]
    for pb in more:
        state_a, _ = core(state_a, unpack_batch(_tensors(pb), mcfg, pack_label=pack_label))
    state_b, _ = multi(state_b, _tensors(port_step.stack_batches(more)))
    _assert_states_equal(state_a, state_b)


def test_multi_step_with_an_update_that_returns_new_tensors():
    """`sparse_update=sparse_rowwise_adagrad` returns new tables; the
    multi-step installs them step by step like the sequential steps."""
    mcfg, tcfg = _mcfg(), port_config.TrainConfig()
    ds = SyntheticClickstream(100, 60, seed=3)
    pf = PackedFeaturizer(mcfg)
    host = [pf(ds.sample(64, start=i)) for i in range(4)]
    state_a, dense_opt = port_step.create_train_state(torch.Generator().manual_seed(0), mcfg,
                                                      tcfg)
    state_b = state_a.copy()
    core = port_step.make_train_step(mcfg, tcfg, dense_opt,
                                     sparse_update=port_opt.sparse_rowwise_adagrad)
    for pb in host:
        state_a, _ = core(state_a, unpack_batch(_tensors(pb), mcfg))
    multi = port_step.make_multi_step(lambda s, pb: core(s, unpack_batch(pb, mcfg)))
    state_b, _ = multi(state_b, _tensors(port_step.stack_batches(host)))
    _assert_states_equal(state_a, state_b)


# --- against the JAX package's multi-step --------------------------------------------------------


def _numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    params = {"tables": {t.name: rng.uniform(-0.5, 0.5, (t.num_embeddings, t.embedding_dim))
                         .astype(np.float32) for t in cfg.tables}}
    for key in ("query_tower", "candidate_tower"):
        sizes = [cfg.tables[0].embedding_dim, *getattr(cfg, key).layer_sizes]
        params[key] = {}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            bound = 1.0 / np.sqrt(a)
            params[key][f"layer_{i}"] = {
                "kernel": rng.uniform(-bound, bound, (a, b)).astype(np.float32),
                "bias": rng.uniform(-bound, bound, b).astype(np.float32)}
    return params


@pytest.mark.parametrize("kernel", ["off", "float32"])
def test_multi_step_matches_jax_multi_step(kernel):
    """The port's multi-step against the reference's (`lax.scan` over the
    stacked batches) from the same numpy weights, over the same K = 4 packed
    batches: the K losses and the end tables and accumulators within the f32
    step test's tolerance (1e-5 x the largest magnitude: f32 summation
    order)."""
    jcfg = jax_config.two_tower_model_config(300, 80, embedding_dim=128, layer_sizes=(128, 64))
    jtcfg = jax_config.TrainConfig(batch_size=256, sorted_feature="user_id",
                                   block_sorted_kernel=kernel, sparse_learning_rate=0.05,
                                   learning_rate=1e-3)
    pcfg = port_config.model_config_from_dict(dataclasses.asdict(jcfg))
    ptcfg = port_config.TrainConfig(**dataclasses.asdict(jtcfg))
    params = _numpy_params(jcfg)
    ds = SyntheticClickstream(299, 79, seed=7)
    cols = [ds.sample(256, start=i) for i in range(4)]

    jstate, jopt = jax_step.create_train_state(jax.random.key(0), jcfg, jtcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    dense = {k: jparams[k] for k in ("query_tower", "candidate_tower")}
    jstate = jstate.replace(tables=jparams["tables"], dense_params=dense,
                            dense_opt_state=jopt.init(dense))
    jcore = jax_step.make_train_step(jcfg, jtcfg, jopt, donate=False, jit=False)
    jmulti = jax_step.make_multi_step(lambda s, pb: jcore(s, jax_unpack(pb, jcfg)), donate=False)
    jfeat = JaxPackedFeaturizer(jcfg, sort_feature="user_id")
    jstate, jout = jmulti(jstate, jax.tree.map(
        jnp.asarray, jax_step.stack_batches([jfeat(c) for c in cols])))

    pstate, popt = port_step.create_train_state(torch.Generator().manual_seed(0), pcfg, ptcfg)
    model = params_from_numpy(params, pcfg, "cpu")
    pstate = port_step.TrainState(0, model, pstate.adagrad_acc,
                                  popt.build(port_step.tower_parameters(model)))
    pcore = port_step.make_train_step(pcfg, ptcfg, popt)
    pmulti = port_step.make_multi_step(lambda s, pb: pcore(s, unpack_batch(pb, pcfg)))
    pfeat = PackedFeaturizer(pcfg, sort_feature="user_id")
    pstate, pout = pmulti(pstate, _tensors(port_step.stack_batches([pfeat(c) for c in cols])))

    def close(got, want):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())

    assert pout["loss"].shape == (4,) and pstate.step == 4 == int(jstate.step)
    close(pout["loss"].numpy(), jout["loss"])
    for name, t0 in params["tables"].items():
        got, want = pstate.model.tables[name].detach().numpy(), np.asarray(jstate.tables[name])
        moved = np.any(want != t0, axis=1)
        assert moved.any()
        np.testing.assert_array_equal(got[~moved], t0[~moved])
        close(got - t0, want - t0)
        close(pstate.adagrad_acc[name].numpy(), jstate.adagrad_acc[name])


# --- macro_stream, the worker pool, the packed epoch ----------------------------------------------


def test_macro_stream_groups_and_trains():
    mcfg, tcfg = _mcfg(), port_config.TrainConfig()
    ds = SyntheticClickstream(100, 60, seed=3)
    pf = PackedFeaturizer(mcfg)
    state, dense_opt = port_step.create_train_state(torch.Generator().manual_seed(0), mcfg, tcfg)
    core = port_step.make_train_step(mcfg, tcfg, dense_opt)
    multi = port_step.make_multi_step(lambda s, pb: core(s, unpack_batch(pb, mcfg)))
    macros = list(prefetch_to_device(macro_stream(ds.batches(64, 7), pf, k=3), lambda x: x,
                                     "cpu"))
    assert len(macros) == 2  # 7 batches -> 2 full macros, the partial one dropped
    assert tuple(macros[0].ids_raw.shape) == (3, 64, 2)
    assert isinstance(macros[0].ids_raw, torch.Tensor)
    for mb in macros:
        state, out = multi(state, mb)
    assert state.step == 6
    assert torch.isfinite(out["loss"]).all() and out["loss"].shape == (3,)


def test_prefetch_multiworker_order_preserved():
    mcfg = _mcfg()
    feat = Featurizer(mcfg, device="cpu")
    ds = SyntheticClickstream(100, 60, seed=0)
    cols = [ds.sample(32, start=i) for i in range(12)]
    a = [b.labels for b in prefetch_to_device(iter(cols), feat, "cpu", num_workers=4)]
    b = [b.labels for b in prefetch_to_device(iter(cols), feat, "cpu", num_workers=1)]
    assert len(a) == len(b) == 12
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_prefetch_worker_error_reaches_the_consumer():
    def bad(cols):
        raise KeyError("no such column")

    with pytest.raises(KeyError, match="no such column"):
        list(prefetch_to_device(iter([{}, {}]), bad, "cpu", num_workers=3))


def test_device_put_batch_moves_every_leaf():
    mcfg = _mcfg()
    pb = PackedFeaturizer(mcfg)(SyntheticClickstream(100, 60, seed=0).sample(16))
    moved = device_put_batch(pb, "cpu")
    assert isinstance(moved.ids_raw, torch.Tensor) and moved.ids_raw.dtype == torch.int32
    assert moved.dense is None and moved.batch_size == 16
    np.testing.assert_array_equal(moved.ids_raw.numpy(), pb.ids_raw)


def test_train_one_epoch_packed_matches_sequential():
    """The packed epoch (worker-pool macro assembly) == sequential per-batch
    training over the same stream; without a tail step the trailing partial
    macro is dropped."""
    mcfg, tcfg = _mcfg(), port_config.TrainConfig()
    ds = SyntheticClickstream(100, 60, seed=5)
    pf = PackedFeaturizer(mcfg)
    host_cols = [ds.sample(64, start=i) for i in range(9)]  # macro=4 -> 8 used

    state_a, dense_opt = port_step.create_train_state(torch.Generator().manual_seed(0), mcfg,
                                                      tcfg)
    state_b = state_a.copy()
    core = port_step.make_train_step(mcfg, tcfg, dense_opt)
    for cols in host_cols[:8]:
        state_a, out_a = core(state_a, unpack_batch(_tensors(pf(cols)), mcfg))

    multi = port_step.make_multi_step(lambda s, pb: core(s, unpack_batch(pb, mcfg)))
    state_b, stats = train_one_epoch_packed(state_b, multi, iter(host_cols), pf, macro=4,
                                            num_workers=3)
    assert stats["train_steps"] == 8
    assert stats["train_examples"] == 8 * 64
    assert stats["examples_per_sec"] > 0 and stats["epoch_time_s"] > 0
    assert stats["train_loss"] == out_a["loss"].item()
    _assert_states_equal(state_a, state_b)


def test_train_one_epoch_packed_full_semantics():
    """`limit_train_batches` honoured, the trailing partial macro trained
    through `tail_step`, mid-epoch validation at the `validation_freq`
    cadence (checked at macro boundaries); the result equals sequential
    training over the same 9 batches."""
    mcfg = _mcfg()
    tcfg = port_config.TrainConfig(validation_freq=3, limit_train_batches=9, limit_val_batches=2)
    ds = SyntheticClickstream(100, 60, seed=6)
    pf = PackedFeaturizer(mcfg)
    feat = Featurizer(mcfg, device="cpu")
    host_cols = [ds.sample(64, start=i) for i in range(12)]  # limited to 9
    val_cols = [ds.sample(64, start=100 + i, split="val") for i in range(3)]  # limited to 2

    state_a, dense_opt = port_step.create_train_state(torch.Generator().manual_seed(0), mcfg,
                                                      tcfg)
    state_b = state_a.copy()
    core = port_step.make_train_step(mcfg, tcfg, dense_opt)
    for cols in host_cols[:9]:
        state_a, out_a = core(state_a, unpack_batch(_tensors(pf(cols)), mcfg))

    multi = port_step.make_multi_step(lambda s, pb: core(s, unpack_batch(pb, mcfg)))
    tail = make_packed_train_step(core, mcfg)
    calls = []

    class Rec:
        def log_metrics(self, m, step=None):
            calls.append((dict(m), step))

    state_b, stats = train_one_epoch_packed(
        state_b, multi, iter(host_cols), pf, macro=4, train_cfg=tcfg, tail_step=tail,
        eval_step=port_step.make_eval_step(mcfg, tcfg), val_batches_factory=lambda: iter(val_cols),
        val_featurizer=feat, logger=Rec())
    # 2 full macros (8 steps) + 1 tail batch = 9 steps
    assert stats["train_steps"] == 9 and stats["train_examples"] == 9 * 64
    # validations once step >= 3 (after macro 1: step 4), >= 6 (after macro 2: step 8) and
    # >= 9 (after the tail step)
    assert [step for _, step in calls] == [4, 8, 9]
    assert all(np.isfinite(m["val_loss"]) and 0 <= m["val_auroc"] <= 1 for m, _ in calls)
    assert stats["train_loss"] == out_a["loss"].item()
    _assert_states_equal(state_a, state_b)


def test_train_one_epoch_packed_validates_through_a_packed_eval_step():
    """Without a `val_featurizer` the validation batches go through the packed
    featurizer and a packed eval step."""
    mcfg = _mcfg()
    tcfg = port_config.TrainConfig(validation_freq=2, limit_val_batches=1)
    ds = SyntheticClickstream(100, 60, seed=8)
    pf = PackedFeaturizer(mcfg)
    state, dense_opt = port_step.create_train_state(torch.Generator().manual_seed(0), mcfg, tcfg)
    core = port_step.make_train_step(mcfg, tcfg, dense_opt)
    multi = port_step.make_multi_step(lambda s, pb: core(s, unpack_batch(pb, mcfg)))
    seen = []

    class Rec:
        def log_metrics(self, m, step=None):
            seen.append(step)

    state, stats = train_one_epoch_packed(
        state, multi, ds.batches(32, 6), pf, macro=2, num_workers=1, train_cfg=tcfg,
        eval_step=make_packed_eval_step(port_step.make_eval_step(mcfg, tcfg), mcfg),
        val_batches_factory=lambda: ds.batches(32, 2, split="val"), logger=Rec())
    assert stats["train_steps"] == 6 and seen == [2, 4, 6]


def test_train_one_epoch_packed_of_an_empty_stream():
    mcfg, tcfg = _mcfg(), port_config.TrainConfig()
    state, _ = port_step.create_train_state(torch.Generator().manual_seed(0), mcfg, tcfg)
    state, stats = train_one_epoch_packed(state, None, iter([]), PackedFeaturizer(mcfg))
    assert stats["train_steps"] == 0 and np.isnan(stats["train_loss"]) and state.step == 0


@pytest.mark.parametrize("arg", ["sharding", "tail_sharding", "val_sharding", "pad_multiple",
                                 "pad_to"])
def test_the_packed_epochs_multi_device_arguments_wait(arg):
    """The packed epoch takes the reference's mesh arguments (on a mesh:
    `test_torch_parallel_*.py`), a placement pytree too (the compact wire
    on a mesh: a `CompactBatch` of slicers); what is no placement raises."""
    state = types.SimpleNamespace(device=torch.device("cpu"), step=0)
    value = _WholeBatch() if arg.endswith("sharding") else 8
    _, stats = train_one_epoch_packed(state, None, [], None, **{arg: value})
    assert stats["train_steps"] == 0
    if arg.endswith("sharding"):
        with pytest.raises(TypeError, match="not a placement"):
            train_one_epoch_packed(state, None, [], None, **{arg: {"ids_raw": 3}})
        with pytest.raises(ValueError, match="no slicer"):
            train_one_epoch_packed(state, None, [], None, **{arg: {"ids_raw": None}})
    if arg == "sharding":  # a compact macro-batch cut leaf by leaf, whole here
        seen = []

        def multi(s, mb):
            seen.append(mb.wire.shape)
            return s, {"loss": torch.zeros(1)}

        _, stats = train_one_epoch_packed(state, multi, [{}], lambda cols: _Wire(
            np.zeros((2, 8))), macro=1, sharding=_Wire(value))
        assert seen == [(1, 2, 8)] and stats["train_examples"] == 8


class _WholeBatch:
    """A one-rank placement: each leaf whole, on the CPU."""
    device, parts = torch.device("cpu"), 1

    def __call__(self, t):
        return t


@dataclasses.dataclass
class _Wire:
    wire: np.ndarray


# --- the towers' optimizer, as the multi-step needs it -------------------------------------------


def test_the_optimizer_is_created_with_its_state_and_remembers_its_schedule():
    recipe = port_opt.dense_optimizer(3e-3, "linear", total_steps=10, warmup_steps=2)
    params = [torch.nn.Parameter(torch.ones(3, 2)), torch.nn.Parameter(torch.zeros(2))]
    opt = recipe.build(params)
    assert opt.lr_schedule is recipe.schedule
    for p in params:  # Adam's state exists before any step (a graph capture needs its addresses)
        s = opt.state[p]
        assert set(s) == {"step", "exp_avg", "exp_avg_sq"}
        assert s["step"].item() == 0 and not s["exp_avg"].any() and s["exp_avg"].shape == p.shape
    assert not opt.param_groups[0]["capturable"]  # CPU parameters: the plain optimizer
    for p in params:
        p.grad = torch.full_like(p, 0.5)
    recipe.step(opt, 1)
    assert opt.param_groups[0]["lr"] == recipe.schedule(1) == 1.5e-3
    assert opt.state[params[0]]["step"].item() == 1
    # pre-created state gives the same update as torch's own lazily created state
    ref_params = [torch.nn.Parameter(torch.ones(3, 2)), torch.nn.Parameter(torch.zeros(2))]
    ref = torch.optim.Adam(ref_params, lr=1.5e-3, betas=(0.9, 0.999), eps=1e-8)
    for p in ref_params:
        p.grad = torch.full_like(p, 0.5)
    ref.step()
    for p, q in zip(params, ref_params):
        assert torch.equal(p, q)
    with pytest.raises(ValueError, match="capturable"):
        recipe.step(opt, 2, lr=torch.tensor(1e-3))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_clone_dense_optimizer_copies_kind_schedule_and_state(weight_decay):
    recipe = port_opt.dense_optimizer(3e-3, "cosine", total_steps=10, weight_decay=weight_decay)
    params = [torch.nn.Parameter(torch.ones(4))]
    opt = recipe.build(params)
    params[0].grad = torch.arange(4.0)
    recipe.step(opt, 0)
    twin = [torch.nn.Parameter(params[0].detach().clone())]
    clone = port_opt.clone_dense_optimizer(opt, twin)
    assert type(clone) is type(opt) and clone.lr_schedule is recipe.schedule
    assert clone.param_groups[0]["weight_decay"] == opt.param_groups[0]["weight_decay"]
    for key, v in opt.state[params[0]].items():
        assert torch.equal(clone.state[twin[0]][key], v)
        assert clone.state[twin[0]][key].data_ptr() != v.data_ptr()
    params[0].grad = twin[0].grad = torch.ones(4)
    recipe.step(opt, 1)
    recipe.step(clone, 1)
    assert torch.equal(params[0], twin[0])
