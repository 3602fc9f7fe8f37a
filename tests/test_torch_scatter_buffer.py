"""`scatter_buffer_dtype="bfloat16"`: the sorted table's bf16 aggregation
buffer, against the JAX package on the same numpy inputs.

The reference sums a run of equal ids into a bf16 buffer
(`zeros((N, D), bf16).at[ids].add(g.astype(bf16), indices_are_sorted=True)`),
which XLA's CPU scatter does in position order with a rounding after every
add. The port's plain version (`ops.adagrad_kernel.bf16_buffer_sums`, the
oracle of kernels #4 and #6 in their bf16 mode) must give those bits, and
the updates built on it the reference's `dense_rowwise_adagrad` and
`quantized_dense_rowwise_adagrad`; the train step takes the buffer exactly
where the reference does."""

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
from two_tower_recommender_model_tpu_torch.ops import quantized as pq
from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import (
    bf16_buffer_sums,
    rowwise_adagrad,
)
from two_tower_recommender_model_tpu_torch.ops.quantized_kernel import (
    quantized_rowwise_adagrad_fused,
)
from two_tower_recommender_model_tpu_torch.train import optimizer as port_opt
from two_tower_recommender_model_tpu_torch.train import step as port_step
from two_tower_recommender_model_tpu_torch.train.pipeline import map_leaves


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N, D = 40, 16


def _sorted_ids(rng, m: int, longest: int, n: int = N) -> np.ndarray:
    """M non-decreasing int32 ids in [0, n) with one run of `longest`
    positions and sentinels (id n) at the end."""
    ids = np.sort(rng.integers(0, n, m - longest - 5))
    ids = np.sort(np.concatenate([ids, np.full(longest, n // 2)]))
    return np.concatenate([ids, np.full(5, n)]).astype(np.int32)


CASES = {  # name -> (positions, the longest run, gradients' dtype)
    "short-runs-f32": (200, 3, np.float32),
    "run-of-300-f32": (600, 300, np.float32),
    "run-of-300-bf16-grads": (600, 300, "bfloat16"),
    "every-position-one-id": (257, 252, np.float32),
}


def _case(name, seed=0):
    m, longest, dtype = CASES[name]
    rng = np.random.default_rng(seed)
    ids = _sorted_ids(rng, m, longest)
    g = (rng.standard_normal((m, D)) * 2.0 ** rng.integers(-6, 6, (m, 1))).astype(np.float32)
    if dtype == "bfloat16":
        g = np.array(jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32))
    return ids, g


def _jax_buffer(ids, g, n=N):
    return np.asarray(jnp.zeros((n, D), jnp.bfloat16).at[jnp.asarray(ids)]
                      .add(jnp.asarray(g).astype(jnp.bfloat16), mode="drop",
                           indices_are_sorted=True).astype(jnp.float32))


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("case", list(CASES))
def test_bf16_buffer_is_the_references_bit_for_bit(case):
    ids, g = _case(case)
    want = _jax_buffer(ids, g)
    g_t = torch.from_numpy(g)
    if CASES[case][2] == "bfloat16":
        g_t = g_t.bfloat16()  # exact: the values are bf16 already
    dense, touched = port_opt.dense_buffer(N, torch.from_numpy(ids), g_t, torch.bfloat16)
    np.testing.assert_array_equal(_bits(dense), _bits(want))
    np.testing.assert_array_equal(touched.numpy(), np.isin(np.arange(N), ids))
    rows, sums = bf16_buffer_sums(torch.from_numpy(ids), g_t, N)
    np.testing.assert_array_equal(rows.numpy(), np.unique(ids[ids < N]))
    np.testing.assert_array_equal(_bits(sums), _bits(want[rows.numpy()]))


def test_bf16_buffer_differs_from_one_f32_sum_on_a_long_run():
    """A run of 300 sums into a bf16 buffer that stalls: the f32 sum rounded
    once is not that buffer (so a test of the buffer can tell the two apart)."""
    ids, g = _case("run-of-300-f32")
    g = np.abs(g)  # a growing sum: each add below half its ulp is lost
    want = _jax_buffer(ids, g)
    once = np.asarray(jnp.zeros((N, D), jnp.float32).at[jnp.asarray(ids)]
                      .add(jnp.asarray(g), mode="drop").astype(jnp.bfloat16)
                      .astype(jnp.float32))
    assert (want != once).any()
    dense, _ = port_opt.dense_buffer(N, torch.from_numpy(ids), torch.from_numpy(g),
                                     torch.bfloat16)
    np.testing.assert_array_equal(_bits(dense), _bits(want))


def _update_close(got, want):
    """The updates on the buffer: mean(g^2) is summed in torch's order, not
    XLA's, a few f32 ulps apart (measured: 2)."""
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_dense_rowwise_adagrad_with_the_bf16_buffer_matches_jax(case):
    ids, g = _case(case)
    rng = np.random.default_rng(1)
    table = rng.uniform(-0.5, 0.5, (N, D)).astype(np.float32)
    acc = rng.uniform(0.0, 0.1, N).astype(np.float32)
    jt, ja = jax_opt.dense_rowwise_adagrad(jnp.asarray(table), jnp.asarray(acc),
                                           jnp.asarray(ids), jnp.asarray(g), 0.05,
                                           ids_sorted=True, buffer_dtype=jnp.bfloat16)
    pt, pa = port_opt.dense_rowwise_adagrad(torch.from_numpy(table), torch.from_numpy(acc),
                                            torch.from_numpy(ids), torch.from_numpy(g), 0.05,
                                            ids_sorted=True, buffer_dtype=torch.bfloat16)
    _update_close(pt, jt)
    _update_close(pa, ja)
    untouched = ~np.isin(np.arange(N), ids)
    np.testing.assert_array_equal(_bits(pt.numpy()[untouched]), _bits(table[untouched]))
    # the kernel wrapper's plain version (what a CPU train step runs), in place:
    # the same sums, the same update
    kt, ka = torch.from_numpy(table.copy()), torch.from_numpy(acc.copy())
    rowwise_adagrad(kt, ka, torch.from_numpy(ids), torch.from_numpy(g), 0.05,
                    buffer_dtype=torch.bfloat16)
    np.testing.assert_array_equal(_bits(kt), _bits(pt))
    np.testing.assert_array_equal(_bits(ka), _bits(pa))


@pytest.mark.parametrize("case", list(CASES))
def test_quantized_dense_rowwise_adagrad_with_the_bf16_buffer_matches_jax(case):
    ids, g = _case(case)
    rng = np.random.default_rng(2)
    rows = rng.uniform(-0.5, 0.5, (N, D)).astype(np.float32)
    jqt = jq.quantize_table(jnp.asarray(rows))
    values, scales = np.array(jqt.values), np.array(jqt.scales)
    acc = rng.uniform(0.0, 0.1, N).astype(np.float32)
    g[ids == ids[0]] = 0.0  # a named row whose sum is zero: requantized all the same
    jt, ja = jq.quantized_dense_rowwise_adagrad(jqt, jnp.asarray(acc), jnp.asarray(ids),
                                                jnp.asarray(g), 0.05, ids_sorted=True,
                                                buffer_dtype=jnp.bfloat16)
    pqt = pq.QuantizedTable(torch.from_numpy(values.copy()), torch.from_numpy(scales.copy()))
    pt, pa = pq.quantized_dense_rowwise_adagrad(pqt, torch.from_numpy(acc),
                                                torch.from_numpy(ids), torch.from_numpy(g),
                                                0.05, ids_sorted=True,
                                                buffer_dtype=torch.bfloat16)
    _update_close(pa, ja)
    _update_close(pt.scales, jt.scales)
    # an int8 value on a rounding boundary may land one step apart
    assert np.abs(pt.values.numpy().astype(int) - np.asarray(jt.values).astype(int)).max() <= 1
    zero = ids[0]  # requantized from its own values, as the reference does
    np.testing.assert_array_equal(pt.values[zero].numpy(), np.asarray(jt.values)[zero])
    np.testing.assert_array_equal(_bits(pt.scales[zero:zero + 1]),
                                  _bits(np.asarray(jt.scales)[zero:zero + 1]))
    # the fused kernel's plain version in its bf16 mode writes every named row too
    kv, ks, ka = (torch.from_numpy(values.copy()), torch.from_numpy(scales.copy()),
                  torch.from_numpy(acc.copy()))
    quantized_rowwise_adagrad_fused(kv, ks, ka, torch.from_numpy(ids), torch.from_numpy(g),
                                    0.05, buffer_dtype=torch.bfloat16)
    np.testing.assert_array_equal(kv.numpy(), pt.values.numpy())
    np.testing.assert_array_equal(_bits(ks), _bits(pt.scales))
    np.testing.assert_array_equal(_bits(ka), _bits(pa))


def test_a_buffer_dtype_other_than_f32_or_bf16_is_refused():
    t, a = torch.zeros((N, D)), torch.zeros(N)
    ids, g = torch.arange(4, dtype=torch.int32), torch.ones((4, D))
    with pytest.raises(ValueError, match="buffer_dtype"):
        rowwise_adagrad(t, a, ids, g, 0.1, buffer_dtype=torch.float16)


# --- the train step -------------------------------------------------------------------

USERS, ITEMS, B = 1000, 300, 512  # 1,000 user rows <= 8 x 512 slots: the bf16 buffer applies


def _configs(table_dtype=None, kernel="off", users=USERS, buffer="bfloat16"):
    cfg = jax_config.two_tower_model_config(users, ITEMS, embedding_dim=128,
                                            layer_sizes=(128, 64))
    cfg = dataclasses.replace(cfg, fused_tower_backward="off", table_dtype=table_dtype)
    tcfg = jax_config.TrainConfig(batch_size=B, sorted_feature="user_id",
                                  block_sorted_kernel=kernel, scatter_buffer_dtype=buffer,
                                  sparse_learning_rate=0.05, learning_rate=1e-3)
    return (cfg, tcfg, port_config.model_config_from_dict(dataclasses.asdict(cfg)),
            port_config.TrainConfig(**dataclasses.asdict(tcfg)))


def _numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    params = {"tables": {}}
    for t in cfg.tables:
        rows = rng.uniform(-0.5, 0.5, (t.num_embeddings, t.embedding_dim)).astype(np.float32)
        if cfg.table_dtype_of(t.name) == "int8":
            qt = jq.quantize_table(jnp.asarray(rows))
            rows = {"values": np.array(qt.values), "scales": np.array(qt.scales)}
        params["tables"][t.name] = rows
    for key in ("query_tower", "candidate_tower"):
        sizes = [128, *getattr(cfg, key).layer_sizes]
        params[key] = {}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            bound = 1.0 / np.sqrt(a)
            params[key][f"layer_{i}"] = {
                "kernel": rng.uniform(-bound, bound, (a, b)).astype(np.float32),
                "bias": rng.uniform(-bound, bound, b).astype(np.float32)}
    return params


def _jax_state(cfg, tcfg, params):
    jstate, jopt = jax_step.create_train_state(jax.random.key(0), cfg, tcfg)
    tables = {name: jq.QuantizedTable(values=jnp.asarray(t["values"]),
                                      scales=jnp.asarray(t["scales"]))
              if isinstance(t, dict) else jnp.asarray(t) for name, t in params["tables"].items()}
    dense = {k: jax.tree.map(jnp.asarray, params[k]) for k in ("query_tower", "candidate_tower")}
    return jstate.replace(tables=tables, dense_params=dense,
                          dense_opt_state=jopt.init(dense)), jopt


def _port_state(pcfg, ptcfg, params):
    pstate, popt = port_step.create_train_state(torch.Generator().manual_seed(0), pcfg, ptcfg)
    model = params_from_numpy(params, pcfg, "cpu")
    return port_step.TrainState(0, model, pstate.adagrad_acc,
                                popt.build(port_step.tower_parameters(model)),
                                pstate.item_counts), popt


def _columns(n_batches, users=USERS, seed=7):
    ds = SyntheticClickstream(users - 1, ITEMS - 1, seed=seed, popularity=1.0)
    out = []
    for cols in ds.batches(B, n_batches, split="train"):
        cols["user_id"][::13] = 0
        cols["user_id"][:60] = 5  # a run of 60 and more positions on one user row
        out.append(cols)
    return out


def _dense(t):
    if isinstance(t, pq.QuantizedTable):
        return pq.dequantize_table(t).numpy()
    if isinstance(t, jq.QuantizedTable):
        return np.asarray(jq.dequantize_table(t))
    return np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)


@pytest.mark.parametrize("table_dtype", [None, "int8"])
def test_train_steps_with_the_bf16_buffer_match_jax(table_dtype):
    """Three packed steps host-sorted by user id, f32 compute, with
    `scatter_buffer_dtype="bfloat16"`: the user table takes the bf16 buffer
    in both packages. Losses and logits within 1e-5 (f32 summation order).
    After the first step the user table's accumulators within rtol 1e-5 and
    its rows within 1e-5 x the largest update (f32 tables) or one
    quantization step (int8, as `test_torch_train_int8.py` holds them).
    After that the gradients carry the towers' f32 differences, and one
    that rounds to the other side of a bf16 value moves a row's buffer by a
    bf16 ulp: the later steps' rows within 2^-7 x the largest update (plus
    the quantization step), accumulators within rtol 2^-6."""
    cfg, tcfg, pcfg, ptcfg = _configs(table_dtype)
    params = _numpy_params(cfg)
    jstate, jopt = _jax_state(cfg, tcfg, params)
    pstate, popt = _port_state(pcfg, ptcfg, params)
    jtrain = jax_make_packed_train_step(jax_step.make_train_step(cfg, tcfg, jopt, jit=False),
                                        cfg, pack_label=True)
    ptrain = make_packed_train_step(port_step.make_train_step(pcfg, ptcfg, popt), pcfg,
                                    pack_label=True)
    jfeat = JaxPackedFeaturizer(cfg, pack_label=True, sort_feature="user_id")
    pfeat = PackedFeaturizer(pcfg, pack_label=True, sort_feature="user_id")
    start = _dense(pstate.model.tables["t_user_id"]).copy()
    for i, cols in enumerate(_columns(3)):
        rel = 1e-5 if i == 0 else 2.0 ** -7
        jstate, jout = jtrain(jstate, jfeat(cols))
        pstate, pout = ptrain(pstate, map_leaves(pfeat(cols), lambda t: t))
        np.testing.assert_allclose(pout["loss"].item(), float(jout["loss"]), rtol=1e-5)
        np.testing.assert_allclose(pout["logits"].numpy(), np.asarray(jout["logits"]),
                                   rtol=0, atol=1e-5 * np.abs(np.asarray(jout["logits"])).max())
        got, want = _dense(pstate.model.tables["t_user_id"]), _dense(jstate.tables["t_user_id"])
        tol = rel * np.abs(want - start).max()
        if table_dtype == "int8":
            tol = tol + np.maximum(pstate.model.tables["t_user_id"].scales.numpy(),
                                   np.asarray(jstate.tables["t_user_id"].scales))[:, None] / 127
        assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
        np.testing.assert_allclose(pstate.adagrad_acc["t_user_id"].numpy(),
                                   np.asarray(jstate.adagrad_acc["t_user_id"]),
                                   rtol=1e-5 if i == 0 else 2.0 ** -6, atol=1e-12)
    assert pstate.step == 3


def _buffers_taken(monkeypatch, pcfg, ptcfg, cols, sparse_update=None):
    """{table rows: buffer dtype} of the kernels one port step calls."""
    seen = {}

    def record(real):
        def call(*args, buffer_dtype=None, **kwargs):
            seen[args[0].shape[0]] = buffer_dtype
            return real(*args, buffer_dtype=buffer_dtype, **kwargs)
        return call

    for module in (port_step, port_opt):  # the sorted table's route, the device sort's
        monkeypatch.setattr(module, "rowwise_adagrad", record(rowwise_adagrad))
        monkeypatch.setattr(module, "quantized_rowwise_adagrad_fused",
                            record(quantized_rowwise_adagrad_fused))
    state, opt = port_step.create_train_state(torch.Generator().manual_seed(1), pcfg, ptcfg)
    step = make_packed_train_step(port_step.make_train_step(pcfg, ptcfg, opt, sparse_update),
                                  pcfg, pack_label=True)
    step(state, map_leaves(PackedFeaturizer(pcfg, pack_label=True, sort_feature="user_id")(cols),
                           lambda t: t))
    return seen, state


def _jax_buffer_of(cfg, tcfg, tname, n_flat, quantized, sparse_update=None):
    upd = jax_step.pick_table_update_fn(cfg, tcfg, "t_user_id", tname, n_flat, quantized,
                                        sparse_update)
    return getattr(upd, "keywords", {}).get("buffer_dtype")


ROUTES = {  # name -> (table dtype, block_sorted_kernel, user rows, bf16 buffer on the user table)
    "f32-sorted-small": (None, "off", USERS, True),
    "int8-sorted-small": ("int8", "off", USERS, True),
    "bf16-table-sorted-small": ("bfloat16", "off", USERS, True),
    "block-kernel-on": (None, "float32", USERS, False),
    "int8-block-kernel-on": ("int8", "bfloat16", USERS, False),
    "table-above-8x-the-batch": (None, "off", 8 * B + 1, False),
    "int8-table-above-8x-the-batch": ("int8", "off", 8 * B + 1, False),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_the_bf16_buffer_is_taken_where_the_reference_takes_it(route, monkeypatch):
    """Only the host-sorted table, with the block kernels off, no override,
    and at most 8 x the batch's slots in rows; never the other table."""
    table_dtype, kernel, users, want = ROUTES[route]
    cfg, tcfg, pcfg, ptcfg = _configs(table_dtype, kernel, users)
    quantized = table_dtype == "int8"
    ref = _jax_buffer_of(cfg, tcfg, "t_user_id", B, quantized)
    assert (ref == jnp.bfloat16) == want
    assert _jax_buffer_of(cfg, tcfg, "t_product_id", B, quantized) is None
    seen, _ = _buffers_taken(monkeypatch, pcfg, ptcfg, _columns(1, users)[0])
    assert seen == {users: torch.bfloat16 if want else None, ITEMS: None}


def test_an_override_keeps_the_f32_sums(monkeypatch):
    """Under `sparse_update` a float table takes the override and an int8
    table its kernel with f32 sums, as the reference's override wins over
    the buffer."""
    cfg, tcfg, pcfg, ptcfg = _configs("int8")
    cfg = dataclasses.replace(cfg, table_dtype=None, tables=(
        dataclasses.replace(cfg.tables[0], dtype="int8"), cfg.tables[1]))
    pcfg = port_config.model_config_from_dict(dataclasses.asdict(cfg))
    override = port_opt.sparse_rowwise_adagrad
    assert _jax_buffer_of(cfg, tcfg, "t_user_id", B, True, override) is None
    seen, _ = _buffers_taken(monkeypatch, pcfg, ptcfg, _columns(1)[0], override)
    assert seen == {USERS: None}  # the item table took the override


@pytest.mark.parametrize("route", ["block-kernel-on", "table-above-8x-the-batch"])
def test_where_it_does_not_apply_the_option_changes_nothing(route):
    """The same step with the option on and off ends in the same state, bit
    for bit."""
    table_dtype, kernel, users, _ = ROUTES[route]
    ends = []
    for buffer in ("bfloat16", "float32"):
        _, _, pcfg, ptcfg = _configs(table_dtype, kernel, users, buffer)
        state, opt = port_step.create_train_state(torch.Generator().manual_seed(3), pcfg, ptcfg)
        step = make_packed_train_step(port_step.make_train_step(pcfg, ptcfg, opt), pcfg,
                                      pack_label=True)
        feat = PackedFeaturizer(pcfg, pack_label=True, sort_feature="user_id")
        for cols in _columns(2, users):
            step(state, map_leaves(feat(cols), lambda t: t))
        ends.append({**{k: v.detach().clone() for k, v in state.model.tables.items()},
                     **{f"acc/{k}": v.clone() for k, v in state.adagrad_acc.items()}})
    for k in ends[0]:
        assert torch.equal(ends[0][k], ends[1][k]), k


def test_an_unknown_buffer_dtype_is_refused():
    _, _, pcfg, ptcfg = _configs(buffer="float16")
    with pytest.raises(ValueError, match="scatter_buffer_dtype"):
        port_step.make_train_step(pcfg, ptcfg, port_opt.dense_optimizer(1e-3))
