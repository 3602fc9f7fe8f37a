"""Tables of any width on the CPU, against the JAX package: the plain versions
of kernels #3-#7 (what their wrappers run on CPU tensors; on the card the
kernels take every D too, `tests/test_torch_any_width_cuda.py`) at D = 30
and 1,024, against the reference's own functions (its Pallas kernels in
interpret mode where it takes them, d % 128 == 0; its plain routes at D =
30), and the port's train step at those widths, f32 and int8 tables, against
the JAX package's step from the same numpy state. Small shapes: N <= 300
rows, M <= 256 ids."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu import config as jax_config
from two_tower_recommender_model_tpu.data.device_featurizer import (
    PackedFeaturizer as JaxPackedFeaturizer,
)
from two_tower_recommender_model_tpu.data.device_featurizer import (
    make_packed_train_step as jax_make_packed_train_step,
)
from two_tower_recommender_model_tpu.ops import block_sorted as jbs
from two_tower_recommender_model_tpu.ops import pallas_update as jpu
from two_tower_recommender_model_tpu.ops import quantized as jq
from two_tower_recommender_model_tpu.train import optimizer as jax_opt
from two_tower_recommender_model_tpu.train import step as jax_step
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.data.device_featurizer import (
    PackedFeaturizer,
    make_packed_train_step,
)
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.models.two_tower import params_from_numpy
from two_tower_recommender_model_tpu_torch.ops import adagrad_kernel as ak
from two_tower_recommender_model_tpu_torch.ops import quantized as pq
from two_tower_recommender_model_tpu_torch.ops import quantized_kernel as qk
from two_tower_recommender_model_tpu_torch.ops.row_subtract import row_subtract
from two_tower_recommender_model_tpu_torch.train import optimizer as port_opt
from two_tower_recommender_model_tpu_torch.train import step as port_step
from two_tower_recommender_model_tpu_torch.train.pipeline import map_leaves


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the cases are small, and the suite runs several
    test processes on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DIMS = [30, 1024]  # D % 4 != 0; past the half-warp walk's 512 (a multiple of 128)
N, M, LR, EPS = 300, 256, 0.05, 1e-10
F32 = dict(rtol=1e-5, atol=1e-6)  # f32 summation order


def _t(a):
    return torch.from_numpy(np.array(a))


def _ids(rng, n=N, m=M) -> np.ndarray:
    """Sorted ids: duplicates, a run of 40, sentinels (n) at the end."""
    ids = rng.integers(0, n // 2, m)
    ids[:40] = 17
    ids[-20:] = n
    return np.sort(ids).astype(np.int32)


def _pallas(d: int) -> bool:
    """The reference takes its block kernels at d % 128 == 0
    (`ops/block_sorted.py`), its plain routes at every other D."""
    return d % 128 == 0


# --- #4 and #3 ----------------------------------------------------------------------------


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_rowwise_adagrad_plain_matches_jax(d, grad_dtype):
    """#4's plain version against the reference's update at D: its Pallas
    kernel in interpret mode at D = 1,024, its plain `sparse_rowwise_adagrad`
    at D = 30 (gradients rounded to bf16 first under "bfloat16"): rtol 1e-5
    / atol 1e-6, untouched rows bit for bit."""
    rng = np.random.default_rng(d)
    ids = _ids(rng)
    grads = rng.normal(size=(M, d)).astype(np.float32)
    if grad_dtype == "bfloat16":  # values a bf16 gradient holds
        grads = np.asarray(jnp.asarray(grads).astype(jnp.bfloat16).astype(jnp.float32))
    table = rng.normal(size=(N, d)).astype(np.float32)
    acc = np.abs(rng.normal(size=N)).astype(np.float32)
    args = (jnp.asarray(table), jnp.asarray(acc), jnp.asarray(ids), jnp.asarray(grads), LR, EPS)
    if _pallas(d):
        want_t, want_a = jbs.block_sorted_rowwise_adagrad_fused(
            *args, matmul_dtype=grad_dtype, interpret=True)
    else:
        want_t, want_a = jax_opt.sparse_rowwise_adagrad(*args)
    t, a = _t(table), _t(acc)
    ak.rowwise_adagrad(t, a, _t(ids), _t(grads).to(getattr(torch, grad_dtype)), LR, EPS)
    np.testing.assert_allclose(t.numpy(), np.asarray(want_t), **F32)
    np.testing.assert_allclose(a.numpy(), np.asarray(want_a), **F32)
    live = np.zeros(N, bool)
    live[ids[ids < N]] = True
    np.testing.assert_array_equal(t.numpy()[~live], table[~live])
    np.testing.assert_array_equal(a.numpy()[~live], acc[~live])


@pytest.mark.parametrize("d", DIMS)
def test_aggregate_plain_matches_jax(d):
    """#3's plain version against the reference's: its Pallas aggregate in
    interpret mode at D = 1,024, its `aggregate_grads_by_row` segment sums
    scattered to their rows at D = 30: rtol 1e-5 / atol 1e-5, rows without
    ids exact zeros."""
    rng = np.random.default_rng(d + 1)
    ids = _ids(rng)
    grads = rng.normal(size=(M, d)).astype(np.float32)
    if _pallas(d):
        want = np.asarray(jbs.block_sorted_aggregate(
            N, jnp.asarray(ids), jnp.asarray(grads), r=16, c=128, interpret=True))
    else:
        g_seg, rep, valid, _ = jax_opt.aggregate_grads_by_row(
            jnp.asarray(ids), jnp.asarray(grads), N)
        want = np.zeros((N, d), np.float32)
        live = np.asarray(valid)
        want[np.asarray(rep)[live]] = np.asarray(g_seg)[live]
    got = ak.block_sorted_aggregate(N, _t(ids), _t(grads)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    named = np.zeros(N, bool)
    named[ids[ids < N]] = True
    np.testing.assert_array_equal(got[~named], 0.0)


# --- #5 and #6 ----------------------------------------------------------------------------


def _int8_table(rng, d):
    qt = jq.quantize_table(jnp.asarray(rng.normal(size=(N, d)).astype(np.float32)))
    return np.asarray(qt.values), np.asarray(qt.scales)


@pytest.mark.parametrize("d", DIMS)
def test_quantized_gather_plain_matches_jax(d):
    """#5's plain version against the reference: its Pallas lookup in
    interpret mode at D = 1,024 (one slot, sentinel rows zero), its
    `quantized_pooled_lookup` over three weighted slots at D = 30; rtol 5e-7
    (XLA multiplies by 1/127 where the port divides by 127) and 1e-6 of the
    largest value over three slots (summation order)."""
    rng = np.random.default_rng(d + 2)
    values, scales = _int8_table(rng, d)
    if _pallas(d):
        ids = _ids(rng)
        want = np.asarray(jbs.block_sorted_lookup_quantized(
            jnp.asarray(values), jnp.asarray(scales), jnp.asarray(ids), r=16, c=128,
            interpret=True))
        got = qk.quantized_pooled_gather(_t(values), _t(scales), _t(ids)[:, None],
                                         torch.ones((M, 1))).numpy()
        np.testing.assert_allclose(got, want, rtol=5e-7, atol=0.0)
        np.testing.assert_array_equal(got[ids >= N], 0.0)
    else:
        ids = rng.integers(-1, N + 1, (64, 3)).astype(np.int32)
        w = rng.random((64, 3)).astype(np.float32)
        w[::5, 1] = 0.0
        qt = jq.QuantizedTable(values=jnp.asarray(values), scales=jnp.asarray(scales))
        live = (ids >= 0) & (ids < N)  # the reference's lookup takes in-range ids, w = 0 dead
        want = np.asarray(jq.quantized_pooled_lookup(
            qt, jnp.asarray(np.where(live, ids, 0)), jnp.asarray(np.where(live, w, 0.0))))
        got = qk.quantized_pooled_gather(_t(values), _t(scales), _t(ids), _t(w)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("d", DIMS)
def test_quantized_adagrad_plain_matches_jax(d):
    """#6's plain version against the reference: its fused Pallas kernel in
    interpret mode at D = 1,024, its plain `quantized_rowwise_adagrad` at D
    = 30. Accumulators and scales within rtol 1e-5 / atol 1e-6, int8 values
    within one step, rows no id names byte for byte."""
    rng = np.random.default_rng(d + 3)
    ids = _ids(rng)
    values, scales = _int8_table(rng, d)
    grads = rng.normal(size=(M, d)).astype(np.float32)
    acc = np.abs(rng.normal(size=N)).astype(np.float32)
    if _pallas(d):
        want_v, want_s, want_a = jbs.block_sorted_rowwise_adagrad_fused_quantized(
            jnp.asarray(values), jnp.asarray(scales), jnp.asarray(acc), jnp.asarray(ids),
            jnp.asarray(grads), lr=LR, eps=EPS, r=16, c=128, matmul_dtype="float32",
            interpret=True)
    else:
        qt = jq.QuantizedTable(values=jnp.asarray(values), scales=jnp.asarray(scales))
        new_qt, want_a = jq.quantized_rowwise_adagrad(qt, jnp.asarray(acc), jnp.asarray(ids),
                                                      jnp.asarray(grads), LR, EPS)
        want_v, want_s = new_qt.values, new_qt.scales
    v, s, a = _t(values), _t(scales), _t(acc)
    qk.quantized_rowwise_adagrad_fused(v, s, a, _t(ids), _t(grads), LR, EPS)
    np.testing.assert_allclose(a.numpy(), np.asarray(want_a), **F32)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **F32)
    assert np.abs(v.numpy().astype(np.int32) - np.asarray(want_v, np.int32)).max() <= 1
    touched = np.zeros(N, bool)
    touched[ids[ids < N]] = True
    np.testing.assert_array_equal(v.numpy()[~touched], values[~touched])
    np.testing.assert_array_equal(s.numpy()[~touched], scales[~touched])


# --- #7 -----------------------------------------------------------------------------------


@pytest.mark.parametrize("d", DIMS)
def test_row_subtract_plain_matches_pallas(d):
    """#7's plain version against `pallas_row_subtract` in interpret mode,
    which takes any D: distinct live ids among sentinels, one f32
    subtraction an element in both, bit for bit."""
    rng = np.random.default_rng(d + 4)
    ids = rng.permutation(N)[:200].astype(np.int32)
    ids[::7] = N
    table = rng.normal(size=(N, d)).astype(np.float32)
    upd = rng.normal(size=(200, d)).astype(np.float32)
    want = np.asarray(jpu.pallas_row_subtract(jnp.asarray(table), jnp.asarray(ids),
                                              jnp.asarray(upd), interpret=True))
    t = _t(table)
    row_subtract(t, _t(ids), _t(upd))
    np.testing.assert_array_equal(t.numpy(), want)


# --- the walk's route and scratch -----------------------------------------------------------


@pytest.mark.parametrize("m,split", [(1, 16), (4096, 16), (65_536, 1), (262_144, 1)])
def test_span_scratch_holds_the_general_walk(m, split):
    """The span walk's scratch, whichever walk the kernel takes: 2 rows a
    span for the pieces of long runs, and one a warp of the general walk's
    pass 1 (spans x split: 16 warps a span below 128 spans, one from 2,048
    spans), as `make_walk` in csrc/sorted_runs.cuh requires of n_slots."""
    spans = -(-m // ak.SPAN)
    assert ak.span_split(spans) == split
    part, part_id = ak.span_scratch(m, 3, "cpu")
    assert part.shape == (2 * spans + spans * split, 3) and part.dtype == torch.float32
    assert part_id.shape == (2 * spans,) and part_id.dtype == torch.int32


# --- the train step -------------------------------------------------------------------------

USERS, ITEMS, B = 300, 80, 256


def _numpy_params(cfg, int8: bool, seed=0):
    rng = np.random.default_rng(seed)
    params = {"tables": {}}
    for t in cfg.tables:
        rows = rng.uniform(-0.5, 0.5, (t.num_embeddings, t.embedding_dim)).astype(np.float32)
        if int8:
            qt = jq.quantize_table(jnp.asarray(rows))
            rows = {"values": np.array(qt.values), "scales": np.array(qt.scales)}
        params["tables"][t.name] = rows
    for key in ("query_tower", "candidate_tower"):
        sizes = [cfg.tables[0].embedding_dim, *getattr(cfg, key).layer_sizes]
        params[key] = {}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            bound = 1.0 / np.sqrt(a)
            params[key][f"layer_{i}"] = {
                "kernel": rng.uniform(-bound, bound, (a, b)).astype(np.float32),
                "bias": rng.uniform(-bound, bound, b).astype(np.float32)}
    return params


def _dense(table):
    if isinstance(table, pq.QuantizedTable):
        return pq.dequantize_table(table).numpy()
    if isinstance(table, jq.QuantizedTable):
        return np.asarray(jq.dequantize_table(table))
    return np.asarray(table.detach() if isinstance(table, torch.Tensor) else table)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("table_dtype", ["float32", "int8"])
def test_train_step_any_width_matches_jax(d, table_dtype):
    """Three packed steps (f32 compute, sorted by user id; at D = 1,024
    `block_sorted_kernel="float32"`, the reference's block kernels in
    interpret mode; at D = 30 "off", its plain updates; the port's plain
    versions of #1 / #4 or #5 / #6 either way) from the same numpy state. After
    the first step: the loss within rtol 1e-5; an f32 table's change and
    every accumulator within 1e-5 x its largest value, untouched rows bit
    for bit; an int8 table's dequantized rows within one quantization step
    plus 1e-5 x the largest update. After three: losses within rtol 1e-3
    and tables within atol 1e-2 (`test_torch_train_int8.py`'s contract: an
    int8 value one step apart feeds back through the towers)."""
    cfg = jax_config.two_tower_model_config(USERS, ITEMS, embedding_dim=d, layer_sizes=(32, 16))
    cfg = dataclasses.replace(cfg, table_dtype=table_dtype, fused_tower_backward="off")
    # the reference's sorted table takes its block kernels whenever they are on, which
    # need d % 128 == 0: at D = 30 it trains with them off (its plain updates)
    tcfg = jax_config.TrainConfig(batch_size=B, sorted_feature="user_id",
                                  block_sorted_kernel="float32" if _pallas(d) else "off",
                                  sparse_learning_rate=LR)
    pcfg = port_config.model_config_from_dict(dataclasses.asdict(cfg))
    ptcfg = port_config.TrainConfig(**dataclasses.asdict(tcfg))
    int8 = table_dtype == "int8"
    params = _numpy_params(cfg, int8)
    jstate, jopt = jax_step.create_train_state(jax.random.key(0), cfg, tcfg)
    jtables = {name: jq.QuantizedTable(values=jnp.asarray(t["values"]),
                                       scales=jnp.asarray(t["scales"]))
               if int8 else jnp.asarray(t) for name, t in params["tables"].items()}
    dense = {k: jax.tree.map(jnp.asarray, params[k]) for k in ("query_tower", "candidate_tower")}
    jstate = jstate.replace(tables=jtables, dense_params=dense, dense_opt_state=jopt.init(dense))
    pstate, popt = port_step.create_train_state(torch.Generator().manual_seed(0), pcfg, ptcfg)
    model = params_from_numpy(params, pcfg, "cpu")
    pstate = port_step.TrainState(0, model, pstate.adagrad_acc,
                                  popt.build(port_step.tower_parameters(model)),
                                  pstate.item_counts)
    jtrain = jax_make_packed_train_step(jax_step.make_train_step(cfg, tcfg, jopt, jit=False), cfg)
    ptrain = make_packed_train_step(port_step.make_train_step(pcfg, ptcfg, popt), pcfg)
    jfeat = JaxPackedFeaturizer(cfg, sort_feature="user_id")
    pfeat = PackedFeaturizer(pcfg, sort_feature="user_id")
    ds = SyntheticClickstream(USERS, ITEMS, seed=7)
    start = {name: _dense(t).copy() for name, t in pstate.model.tables.items()}  # updated in place
    jlosses, plosses = [], []
    for i in range(3):
        cols = ds.sample(B, start=i)
        cols["user_id"][::11] = 0  # missing ids: dead slots
        jstate, jout = jtrain(jstate, jax.tree.map(jnp.asarray, jfeat(cols)))
        pstate, pout = ptrain(pstate, map_leaves(pfeat(cols), lambda t: t))
        jlosses.append(float(jout["loss"]))
        plosses.append(pout["loss"].float().item())
        if i:
            continue
        for name, t in pstate.model.tables.items():
            got, want = _dense(t), _dense(jstate.tables[name])
            moved = np.abs(want - start[name]).max()
            assert moved > 0
            if int8:
                one_step = np.maximum(t.scales.numpy(),
                                      np.asarray(jstate.tables[name].scales))[:, None] / 127
                assert (np.abs(got - want) <= 1e-5 * moved + one_step).all()
            else:
                still = np.all(want == start[name], axis=1)
                assert still.any() and not still.all()
                np.testing.assert_array_equal(got[still], start[name][still])
                np.testing.assert_allclose(got - start[name], want - start[name], rtol=0,
                                           atol=1e-5 * moved)
            want_acc = np.asarray(jstate.adagrad_acc[name])
            np.testing.assert_allclose(pstate.adagrad_acc[name].numpy(), want_acc, rtol=0,
                                       atol=1e-5 * np.abs(want_acc).max())
    np.testing.assert_allclose(plosses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-3)
    for name, t in pstate.model.tables.items():
        assert isinstance(t, pq.QuantizedTable) == int8
        assert _dense(t).shape == (pcfg.table(name).num_embeddings, d)
        np.testing.assert_allclose(_dense(t), _dense(jstate.tables[name]), atol=1e-2)
    assert pstate.step == 3


def test_the_wide_tables_route_through_the_kernels_wrappers(monkeypatch):
    """At D = 30 and 1,024 the port's step updates every table through the
    wrappers of #4 / #6 (their plain versions on the CPU, the kernels on the
    card), never a plain route of its own: a wrapper call a table a step."""
    seen = []
    for wrapper in (ak.rowwise_adagrad, qk.quantized_rowwise_adagrad_fused):
        cls = type(wrapper)

        def spy(self, *args, _call=cls.__call__, **kw):
            seen.append((self.name, args[0].shape[1]))
            return _call(self, *args, **kw)

        monkeypatch.setattr(cls, "__call__", spy)
    for d in DIMS:
        for table_dtype in ("float32", "int8"):
            pcfg = port_config.two_tower_model_config(USERS, ITEMS, embedding_dim=d,
                                                      layer_sizes=(16, 8))
            pcfg = dataclasses.replace(pcfg, table_dtype=table_dtype)
            ptcfg = port_config.TrainConfig(batch_size=64, sorted_feature="user_id",
                                            sparse_learning_rate=LR)
            state, opt = port_step.create_train_state(torch.Generator().manual_seed(0), pcfg,
                                                      ptcfg)
            step = make_packed_train_step(port_step.make_train_step(pcfg, ptcfg, opt), pcfg)
            cols = SyntheticClickstream(USERS, ITEMS, seed=3).sample(64, start=0)
            seen.clear()
            step(state, map_leaves(PackedFeaturizer(pcfg, sort_feature="user_id")(cols),
                                   lambda t: t))
            want = ("quantized_rowwise_adagrad" if table_dtype == "int8" else "rowwise_adagrad")
            assert seen == [(want, d)] * len(pcfg.tables), (d, table_dtype, seen)
