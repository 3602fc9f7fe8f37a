"""The port's int8 tables (`ops/quantized.py`) against the JAX package's, on
the same numpy inputs: the quantization scheme to the rounding point, the
dequantize, the pooled lookup, the two plain updates and the size policy; and
the `QuantizedTable` container inside a `TwoTower`."""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu.ops import quantized as jq
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.models import two_tower as port_tt
from two_tower_recommender_model_tpu_torch.ops import quantized as pq
from two_tower_recommender_model_tpu_torch.train import step as port_step


def _rows(seed, n, d, scale=0.3):
    rng = np.random.default_rng(seed)
    rows = (rng.normal(size=(n, d)) * scale).astype(np.float32)
    rows[3] = 0.0  # an all-zero row: scale 0
    rows[5, 1:] = 0.0  # one live column
    rows[7] = rows[7, 0]  # a constant row: every value is the absmax
    return rows


def _jax_qt(values, scales):
    return jq.QuantizedTable(values=jnp.asarray(values), scales=jnp.asarray(scales))


def _port_qt(values, scales):
    return pq.QuantizedTable(torch.from_numpy(np.array(values)), torch.from_numpy(np.array(scales)))


# --- the scheme ---------------------------------------------------------------------


@pytest.mark.parametrize("n,d,row_chunk", [(50, 128, 1 << 21), (70, 16, 16), (33, 8, 32),
                                           (1000, 32, 1 << 21)])
def test_quantize_table_matches_jax_bit_for_bit(n, d, row_chunk):
    """Scales and int8 values equal bit for bit, chunked or not: both
    packages divide by the row's absmax, multiply by 127 and round half to
    even, in that order. No tolerance."""
    rows = _rows(n, n, d)
    want = jq.quantize_table(jnp.asarray(rows), row_chunk=row_chunk)
    got = pq.quantize_table(torch.from_numpy(rows), row_chunk=row_chunk)
    assert got.values.dtype == torch.int8 and got.scales.dtype == torch.float32
    assert got.shape == (n, d) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.scales.numpy().view(np.int32),
                                  np.asarray(want.scales).view(np.int32))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    one_shot = pq.quantize_table(torch.from_numpy(rows))
    assert torch.equal(one_shot.values, got.values) and torch.equal(one_shot.scales, got.scales)
    assert got.scales[3] == 0 and not got.values[3].any()


def test_round_half_to_even_and_clip():
    """Values that land exactly on a rounding boundary go to the even
    integer in both packages (x / 4 * 127 with x = k / 63.5: k + 0.5)."""
    k = np.arange(-126, 126, dtype=np.float32)
    row = np.concatenate([(k + 0.5) / 127.0 * 4.0, [4.0]]).astype(np.float32)[None, :]
    want = jq.quantize_table(jnp.asarray(row))
    got = pq.quantize_table(torch.from_numpy(row))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert got.values.max() == 127 and got.values.min() >= -127


@pytest.mark.parametrize("n,d", [(50, 128), (40, 8)])
def test_dequantize_table_matches_jax(n, d):
    """rtol 5e-7: the port divides the scale by 127 (as numpy does), XLA may
    multiply by the reciprocal instead (1 ulp). Zero rows are exact zeros,
    and the round trip stays within half a quantization step."""
    rows = _rows(n + 1, n, d)
    qt = jq.quantize_table(jnp.asarray(rows))
    values, scales = np.asarray(qt.values), np.asarray(qt.scales)
    got = pq.dequantize_table(_port_qt(values, scales)).numpy()
    np.testing.assert_allclose(got, np.asarray(jq.dequantize_table(qt)), rtol=5e-7, atol=0)
    np.testing.assert_array_equal(got, values.astype(np.float32) * (scales / np.float32(127))[:, None])
    np.testing.assert_array_equal(got[3], 0.0)
    assert (np.abs(got - rows) <= scales[:, None] / 254.0 + 1e-7).all()


@pytest.mark.parametrize("slots,tol", [(1, dict(rtol=5e-7, atol=0)), (3, dict(rtol=1e-5, atol=1e-6))])
def test_quantized_pooled_lookup_matches_jax(slots, tol):
    """One slot: rtol 5e-7 (the reciprocal rewrite above, nothing summed).
    Three weighted slots: rtol 1e-5 / atol 1e-6 (f32 summation order)."""
    rng = np.random.default_rng(slots)
    rows = _rows(9, 40, 16, 0.2)
    qt = jq.quantize_table(jnp.asarray(rows))
    ids = rng.integers(0, 40, (64, slots)).astype(np.int32)
    w = rng.random((64, slots)).astype(np.float32)
    w[::5, 0] = 0.0  # dead slots
    want = np.asarray(jq.quantized_pooled_lookup(qt, jnp.asarray(ids), jnp.asarray(w)))
    got = pq.quantized_pooled_lookup(_port_qt(qt.values, qt.scales), torch.from_numpy(ids),
                                     torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **tol)


# --- the plain updates ----------------------------------------------------------------


def _update_inputs(kind, n=60, d=16, m=96):
    rng = np.random.default_rng(len(kind))
    ids = {"mixed": np.where(rng.random(m) < 0.15, n, rng.integers(0, n // 2, m)),
           "all-sentinels": np.full(m, n),
           "one-id": np.full(m, 11)}[kind].astype(np.int32)
    rows = _rows(21, n, d)
    qt = jq.quantize_table(jnp.asarray(rows))
    acc = np.abs(rng.normal(size=n)).astype(np.float32)
    grads = rng.normal(size=(m, d)).astype(np.float32)
    return qt, acc, ids, grads


@pytest.mark.parametrize("kind", ["mixed", "all-sentinels", "one-id"])
@pytest.mark.parametrize("fn", ["quantized_rowwise_adagrad", "quantized_dense_rowwise_adagrad"])
def test_plain_quantized_updates_match_jax(fn, kind):
    """The two plain int8 updates against the JAX package's on unsorted ids
    with duplicates and sentinels: accumulators and scales within rtol 1e-6
    (the per-row sums run in the same order; XLA fuses some products), int8
    values within one step (a value on a rounding boundary) and at most 1% of
    them differing, rows no id names byte-exact."""
    qt, acc, ids, grads = _update_inputs(kind)
    want_qt, want_acc = getattr(jq, fn)(qt, jnp.asarray(acc), jnp.asarray(ids),
                                        jnp.asarray(grads), 0.05, 1e-10)
    start = _port_qt(qt.values, qt.scales)
    got_qt, got_acc = getattr(pq, fn)(start, torch.from_numpy(acc), torch.from_numpy(ids),
                                      torch.from_numpy(grads), 0.05, 1e-10)
    assert isinstance(got_qt, pq.QuantizedTable) and got_qt.values.dtype == torch.int8
    np.testing.assert_allclose(got_acc.numpy(), np.asarray(want_acc), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got_qt.scales.numpy(), np.asarray(want_qt.scales), rtol=1e-6,
                               atol=1e-7)
    steps = np.abs(got_qt.values.numpy().astype(np.int32) - np.asarray(want_qt.values, np.int32))
    assert steps.max() <= 1 and (steps != 0).mean() <= 0.01
    named = np.zeros(qt.shape[0], bool)
    named[ids[ids < qt.shape[0]]] = True
    np.testing.assert_array_equal(got_qt.values.numpy()[~named], np.asarray(qt.values)[~named])
    np.testing.assert_array_equal(got_qt.scales.numpy()[~named], np.asarray(qt.scales)[~named])
    np.testing.assert_array_equal(got_acc.numpy()[~named], acc[~named])
    assert named.any() == (not torch.equal(got_qt.values, start.values))
    # functional: the inputs are untouched
    np.testing.assert_array_equal(start.values.numpy(), np.asarray(qt.values))


@pytest.mark.parametrize("rows,slots", [(100, 10), (80, 10), (81, 10), (206_209, 262_144),
                                        (20_000_000, 262_144)])
def test_pick_quantized_update_matches_jax(rows, slots):
    assert pq.pick_quantized_update(rows, slots).__name__ == \
        jq.pick_quantized_update(rows, slots).__name__


# --- init ------------------------------------------------------------------------------


@pytest.mark.parametrize("row_chunk", [1 << 21, 64])
def test_init_quantized_table(row_chunk):
    """Chunked direct init: int8 values within [-127, 127] with every row's
    absmax at +-127, scales within the init bound, and requantizing the
    dequantized table gives the same bytes back (the scale is the row's
    absmax in the dequantized domain)."""
    qt = pq.init_quantized_table(torch.Generator().manual_seed(3), 300, 16, row_chunk=row_chunk)
    assert qt.shape == (300, 16) and qt.values.dtype == torch.int8
    assert qt.values.abs().amax(dim=1).eq(127).all()
    bound = (1.0 / 300) ** 0.5
    assert (qt.scales > 0).all() and (qt.scales <= bound).all()
    again = pq.quantize_table(pq.dequantize_table(qt))
    assert torch.equal(again.values, qt.values)
    torch.testing.assert_close(again.scales, qt.scales, rtol=1e-6, atol=0)


def test_big_int8_table_is_chunk_initialized(monkeypatch):
    """Past `BIG_INT8_INIT_ROWS` a table is never drawn whole in f32: lower
    the threshold so the path runs here (the JAX package's
    `test_big_int8_table_inits_without_f32_intermediate`)."""
    monkeypatch.setattr(port_tt, "BIG_INT8_INIT_ROWS", 500)
    drawn = []
    real = port_tt.init_table
    monkeypatch.setattr(port_tt, "init_table",
                        lambda g, n, d, *a: drawn.append(n) or real(g, n, d, *a))
    mcfg = port_config.two_tower_model_config(num_users=1200, num_items=60, embedding_dim=16,
                                              layer_sizes=(16, 8))
    mcfg = dataclasses.replace(mcfg, table_dtype="int8")
    state, _ = port_step.create_train_state(torch.Generator().manual_seed(0), mcfg,
                                            port_config.TrainConfig())
    assert drawn == [60]  # only the small table took the full f32 draw
    qt = state.model.tables["t_user_id"]
    assert isinstance(qt, pq.QuantizedTable) and qt.values.shape == (1200, 16)
    assert qt.values.abs().max() == 127
    assert torch.equal(pq.quantize_table(pq.dequantize_table(qt)).values, qt.values)
    assert isinstance(state.model.tables["t_product_id"], pq.QuantizedTable)
    assert state.adagrad_acc["t_user_id"].shape == (1200,)
    assert state.adagrad_acc["t_user_id"].dtype == torch.float32
    # the same seed gives the same table, another seed another
    again, _ = port_step.create_train_state(torch.Generator().manual_seed(0), mcfg,
                                            port_config.TrainConfig())
    other, _ = port_step.create_train_state(torch.Generator().manual_seed(1), mcfg,
                                            port_config.TrainConfig())
    assert torch.equal(again.model.tables["t_user_id"].values, qt.values)
    assert not torch.equal(other.model.tables["t_user_id"].values, qt.values)


# --- the container ------------------------------------------------------------------------


def _int8_model(per_table=False):
    mcfg = port_config.two_tower_model_config(50, 30, 8, (16, 8))
    if per_table:  # only the user table is int8
        tables = (dataclasses.replace(mcfg.tables[0], dtype="int8"), mcfg.tables[1])
        mcfg = dataclasses.replace(mcfg, tables=tables)
    else:
        mcfg = dataclasses.replace(mcfg, table_dtype="int8")
    return mcfg, port_tt.init_params(mcfg, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("per_table", [False, True])
def test_quantized_table_lives_in_the_model(per_table):
    """`model.tables[name]` hands back one object with `.values` and
    `.scales`; the model survives `state_dict()` / `load_state_dict()`,
    `copy.deepcopy` and `.to()`, in the config's table order."""
    mcfg, model = _int8_model(per_table)
    qt = model.tables["t_user_id"]
    assert isinstance(qt, pq.QuantizedTable) and model.tables["t_user_id"] is qt
    assert qt.values.dtype == torch.int8 and qt.scales.dtype == torch.float32
    assert isinstance(model.tables["t_product_id"], pq.QuantizedTable) != per_table
    assert list(model.tables) == model.tables.keys() == ["t_user_id", "t_product_id"]
    assert len(model.tables) == 2 and "t_user_id" in model.tables
    assert model.device == torch.device("cpu")
    sd = model.state_dict()
    assert {"tables.t_user_id.values", "tables.t_user_id.scales"} <= set(sd)
    assert ("tables.t_product_id" in sd) == per_table
    assert all(not p.requires_grad for p in model.tables.parameters())

    fresh = port_tt.TwoTower(mcfg, device="cpu")
    fresh.load_state_dict(sd)
    clone = copy.deepcopy(model).to("cpu")
    for other in (fresh, clone):
        t = other.tables["t_user_id"]
        assert torch.equal(t.values, qt.values) and torch.equal(t.scales, qt.scales)
        assert t.values.data_ptr() != qt.values.data_ptr()
    clone.tables["t_user_id"].values.zero_()
    assert qt.values.any()


def test_int8_params_cross_as_values_and_scales():
    """`params_to_numpy` returns an int8 table's values and scales,
    `params_from_numpy` takes them back bit for bit, `dequantize=True` gives
    the f32 rows, and a plain array for an int8 table is refused."""
    mcfg, model = _int8_model()
    params = port_tt.params_to_numpy(model)
    t = params["tables"]["t_user_id"]
    assert t["values"].dtype == np.int8 and t["scales"].dtype == np.float32
    back = port_tt.params_from_numpy(params, mcfg, "cpu")
    for name, qt in model.tables.items():
        assert torch.equal(back.tables[name].values, qt.values)
        assert torch.equal(back.tables[name].scales, qt.scales)
    dense = port_tt.params_to_numpy(model, dequantize=True)["tables"]["t_user_id"]
    np.testing.assert_array_equal(dense, pq.dequantize_table(model.tables["t_user_id"]).numpy())
    with pytest.raises(ValueError, match="int8"):
        port_tt.params_from_numpy({**params, "tables": {**params["tables"], "t_user_id": dense}},
                                  mcfg, "cpu")


def test_quantized_table_checks_its_parts():
    with pytest.raises(ValueError, match="int8"):
        pq.QuantizedTable(torch.zeros((4, 8)), torch.zeros(4))
    with pytest.raises(ValueError, match="scales"):
        pq.QuantizedTable(torch.zeros((4, 8), dtype=torch.int8), torch.zeros(5))
    assert port_tt.torch_dtype("int8") == torch.int8
