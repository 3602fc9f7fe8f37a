"""The port's compact wire (`data/compact.py`) against its packed path and
against the JAX package: the encode gives the reference's bytes, the decode
gives exactly what `unpack_batch(PackedBatch)` gives (the same hashed ids,
the same `raw != 0` mask, the same labels) and what the reference's decode
gives, and training through it equals training through the packed batch.
The cases of the reference's `tests/test_compact.py`, on the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu import config as jax_config
from two_tower_recommender_model_tpu.data import compact as jax_compact
from two_tower_recommender_model_tpu.data.device_featurizer import (
    PackedFeaturizer as JaxPackedFeaturizer,
)
from two_tower_recommender_model_tpu.train import step as jax_step
from two_tower_recommender_model_tpu_torch import config as cfg_lib
from two_tower_recommender_model_tpu_torch.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model_tpu_torch.data.compact import (
    CompactBatch,
    CompactFeaturizer,
    CompactScheme,
    batch_from_compact,
    compact_from_packed,
    make_compact_eval_step,
    make_compact_train_step,
)
from two_tower_recommender_model_tpu_torch.data.device_featurizer import (
    PackedFeaturizer,
    make_packed_eval_step,
    unpack_batch,
)
from two_tower_recommender_model_tpu_torch.train import step as port_step
from two_tower_recommender_model_tpu_torch.train.pipeline import map_leaves
from two_tower_recommender_model_tpu_torch.train.step import (
    create_train_state,
    eval_state_init,
    make_eval_step,
    make_multi_step,
    make_train_step,
    stack_batches,
)
from test_torch_train_step import _check_state, _close, _columns, _configs, _numpy_params, _states

CB_FIELDS = ("wire", "rem", "labels", "dense", "weights", "delta_pos", "delta_extra")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the same
    cores, where torch's thread pools would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def mcfg():
    return cfg_lib.two_tower_model_config(num_users=100, num_items=60, embedding_dim=8,
                                          layer_sizes=(16, 8))


def flagship_cfg():
    return cfg_lib.two_tower_model_config(num_users=206_209, num_items=49_688,
                                          embedding_dim=8, layer_sizes=(16, 8))


def jax_cfg(cfg):
    """The JAX package's ModelConfig of the port's."""
    return jax_config.model_config_from_dict(dataclasses.asdict(cfg))


def on_torch(obj):
    return map_leaves(obj, lambda t: t)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_batches_equal(a, b):
    """Ids, masks, labels (and dense) equal, whichever package made each."""
    assert set(a.features) == set(b.features)
    for f in a.features:
        np.testing.assert_array_equal(_np(a.features[f].ids), _np(b.features[f].ids), err_msg=f)
        np.testing.assert_array_equal(_np(a.features[f].mask), _np(b.features[f].mask),
                                      err_msg=f)
    np.testing.assert_array_equal(_np(a.labels), _np(b.labels))
    if a.dense is not None or b.dense is not None:
        np.testing.assert_array_equal(_np(a.dense), _np(b.dense))


def decode(cb, cfg, scheme):
    return batch_from_compact(on_torch(cb), cfg, scheme)


def check_encode(cfg, scheme, pb, cb):
    """The port's scheme and encode equal to the JAX package's on the same
    packed batch, byte for byte. Returns the JAX config, scheme and batch."""
    jcfg = jax_cfg(cfg)
    jscheme = jax_compact.CompactScheme.from_model(
        jcfg, pack_label=scheme.pack_label, delta_feature=scheme.delta_feature,
        delta_segments=scheme.delta_segments)
    assert dataclasses.asdict(jscheme) == dataclasses.asdict(scheme)
    jcb = jax_compact.compact_from_packed(pb, jscheme)
    for name in CB_FIELDS:
        got, want = getattr(cb, name), getattr(jcb, name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert got.dtype == np.asarray(want).dtype and got.shape == np.shape(want), name
            assert got.tobytes() == np.asarray(want).tobytes(), name
    return jcfg, jscheme, jcb


def check_against_reference(cfg, scheme, pb, cb, pack_label):
    """`check_encode`, and the port's decode equal to the JAX decode and to
    the port's `unpack_batch`."""
    jcfg, jscheme, jcb = check_encode(cfg, scheme, pb, cb)
    got = decode(cb, cfg, scheme)
    assert_batches_equal(got, jax_compact.batch_from_compact(
        jax.tree.map(jnp.asarray, jcb), jcfg, jscheme))
    assert_batches_equal(got, unpack_batch(on_torch(pb), cfg, pack_label=pack_label))


def test_flagship_scheme_bit_widths():
    scheme = CompactScheme.from_model(flagship_cfg(), pack_label=True)
    # user: 206,209 rows -> 18 id bits + label = 19 (2 bytes + 3 rem bits)
    # item: 49,688 rows -> 16 id bits (2 bytes + 0 rem bits)
    assert [(s.bits, s.nbytes, s.rem_bits) for s in scheme.slots] == [(19, 2, 3), (16, 2, 0)]
    assert scheme.whole_bytes == 4
    assert scheme.rem_bits_total == 3
    assert scheme.wire_bytes_per_example == 4.375  # vs 8.0 packed
    want = jax_compact.CompactScheme.from_model(jax_cfg(flagship_cfg()), pack_label=True)
    assert dataclasses.asdict(scheme) == dataclasses.asdict(want)


@pytest.mark.parametrize("pack_label", [False, True])
def test_compact_matches_unpack_batch(mcfg, rng, pack_label):
    # ids include: 0 (missing), hash-to-zero (multiples of 100/60), > N raw
    cols = {
        "user_id": np.concatenate([[0, 100, 200, 300], rng.integers(1, 5000, 28)]),
        "product_id": np.concatenate([rng.integers(1, 1000, 28), [0, 60, 120, 61]]),
        "label": rng.integers(0, 2, 32),
    }
    pb = PackedFeaturizer(mcfg, pack_label=pack_label)(cols)
    scheme = CompactScheme.from_model(mcfg, pack_label=pack_label)
    check_against_reference(mcfg, scheme, pb, compact_from_packed(pb, scheme), pack_label)


def test_compact_matches_host_featurizer_full_scale(rng):
    """The flagship's table sizes take the remainder-bit path (a 19-bit slot)."""
    mcfg = flagship_cfg()
    cols = {
        "user_id": np.concatenate([[0], rng.integers(1, 2**31 - 1, 255)]),
        "product_id": rng.integers(0, 10**6, 256),
        "label": rng.integers(0, 2, 256),
    }
    host = Featurizer(mcfg, device="cpu")(cols)
    scheme = CompactScheme.from_model(mcfg, pack_label=True)
    cb = CompactFeaturizer(PackedFeaturizer(mcfg, pack_label=True), scheme)(cols)
    assert cb.wire.shape == (4, 256) and cb.rem.shape == (3, 32)
    assert_batches_equal(decode(cb, mcfg, scheme), host)


def _multi_slot_cfg(num_embeddings, bag):
    return cfg_lib.ModelConfig(
        tables=(cfg_lib.TableConfig("t", num_embeddings, 8, ("a", "b")),),
        features=(cfg_lib.FeatureConfig("a", "t"),
                  cfg_lib.FeatureConfig("b", "t", max_ids_per_sample=bag)),
        query_tower=cfg_lib.TowerConfig(("a",), (8,)),
        candidate_tower=cfg_lib.TowerConfig(("b",), (8,)),
    )


def test_compact_multi_slot_and_dense(rng):
    mcfg = _multi_slot_cfg(1000, 3)
    host_f = Featurizer(mcfg, device="cpu")
    bags = host_f.ragged("b", [[1, 2], [3, 4, 5, 6]] * 4)
    cols = {"a": np.array([7, 0] * 4), "b": bags,
            "label": np.zeros(8, np.int64), "price": rng.random(8)}
    pf = PackedFeaturizer(mcfg, dense_cols=("price",))
    # 1000 rows -> 10 bits a slot, 4 slots x 2 rem bits = 8 rem bits: 8R = 64 > 32,
    # so every slot ships as two whole bytes
    scheme = CompactScheme.from_model(mcfg, pack_label=False)
    assert (scheme.rem_bits_total, scheme.whole_bytes) == (0, 8)
    pb = pf(cols)
    check_against_reference(mcfg, scheme, pb, compact_from_packed(pb, scheme), False)


def test_compact_rem_overflow_falls_back_to_whole_bytes(rng):
    # 5 slots x 7 rem bits = 35 rem bits -> 8*35 > 32, must fall back
    mcfg = _multi_slot_cfg(100, 4)
    scheme = CompactScheme.from_model(mcfg, pack_label=False)
    assert scheme.rem_bits_total == 0
    assert all(s.nbytes == 1 for s in scheme.slots)  # 7 bits -> 1 byte each
    cols = {"a": rng.integers(0, 1000, 13), "b": rng.integers(0, 1000, (13, 4)),
            "label": rng.integers(0, 2, 13)}
    pb = PackedFeaturizer(mcfg)(cols)  # 13 rows: whole bytes need no B % 8
    check_against_reference(mcfg, scheme, pb, compact_from_packed(pb, scheme), False)


def test_compact_requires_batch_multiple_of_8():
    """(The reference's case skips on its 100 x 60 model, whose 6-bit item
    slot falls back to whole bytes; the flagship has 3 remainder bits.)"""
    mcfg = flagship_cfg()
    scheme = CompactScheme.from_model(mcfg, pack_label=True)
    assert scheme.rem_bits_total == 3
    pb = PackedFeaturizer(mcfg, pack_label=True)(
        {"user_id": np.arange(1, 6), "product_id": np.arange(1, 6),
         "label": np.zeros(5, np.int64)})
    with pytest.raises(ValueError, match="% 8"):
        compact_from_packed(pb, scheme)


def test_compact_preserves_sort_order(mcfg, rng):
    cols = {
        "user_id": np.concatenate([[0, 0], rng.integers(1, 300, 30)]),
        "product_id": rng.integers(0, 200, 32),
        "label": rng.integers(0, 2, 32),
    }
    scheme = CompactScheme.from_model(mcfg, pack_label=True)
    pf = PackedFeaturizer(mcfg, pack_label=True, sort_feature="user_id")
    got = decode(CompactFeaturizer(pf, scheme)(cols), mcfg, scheme)
    assert_batches_equal(got, unpack_batch(on_torch(pf(cols)), mcfg, pack_label=True))
    # the update key (hashed id, missing -> sentinel N) is non-decreasing
    ids = got.features["user_id"].ids[:, 0].numpy()
    mask = got.features["user_id"].mask[:, 0].numpy()
    key = np.where(mask > 0, ids, 100)
    assert (np.diff(key) >= 0).all()


def _fresh_state(cfg, tcfg):
    return create_train_state(torch.Generator().manual_seed(0), cfg, tcfg)


def _assert_tables_equal(a, b):
    for name in a.model.tables:
        assert torch.equal(a.model.tables[name], b.model.tables[name]), name


def test_compact_train_step_matches_packed(mcfg):
    """Training through CompactBatch == training through PackedBatch, exactly."""
    tcfg = cfg_lib.TrainConfig()
    ds = SyntheticClickstream(100, 60, seed=7)
    scheme = CompactScheme.from_model(mcfg, pack_label=True)
    pf = PackedFeaturizer(mcfg, pack_label=True)
    state_a, dense_opt = _fresh_state(mcfg, tcfg)
    state_b = state_a.copy()
    core = make_train_step(mcfg, tcfg, dense_opt)
    for i in range(4):
        pb = pf(ds.sample(64, start=i))
        state_a, out_a = core(state_a, unpack_batch(on_torch(pb), mcfg, pack_label=True))
        state_b, out_b = core(state_b, decode(compact_from_packed(pb, scheme), mcfg, scheme))
        assert torch.equal(out_a["loss"], out_b["loss"])
    _assert_tables_equal(state_a, state_b)


def test_compact_macro_scan_and_stack(mcfg):
    """stack_batches + make_multi_step work on CompactBatch macro payloads."""
    tcfg = cfg_lib.TrainConfig()
    ds = SyntheticClickstream(100, 60, seed=8)
    scheme = CompactScheme.from_model(mcfg, pack_label=True)
    cf = CompactFeaturizer(PackedFeaturizer(mcfg, pack_label=True), scheme)
    batches = [cf(ds.sample(64, start=i)) for i in range(4)]
    stacked = on_torch(stack_batches(batches))
    assert stacked.wire.shape == (4, scheme.whole_bytes, 64)
    assert stacked.labels.shape == (4, 0) and stacked.delta_pos is None

    state, dense_opt = _fresh_state(mcfg, tcfg)
    core = make_train_step(mcfg, tcfg, dense_opt)
    multi = make_multi_step(lambda s, cb: core(s, batch_from_compact(cb, mcfg, scheme)))
    state, out = multi(state, stacked)
    assert out["loss"].shape == (4,)
    assert torch.isfinite(out["loss"]).all()
    assert state.step == 4


def test_make_compact_train_step_wrapper(mcfg):
    tcfg = cfg_lib.TrainConfig()
    ds = SyntheticClickstream(100, 60, seed=9)
    scheme = CompactScheme.from_model(mcfg, pack_label=True)
    pf = PackedFeaturizer(mcfg, pack_label=True)
    cf = CompactFeaturizer(pf, scheme)
    state, dense_opt = _fresh_state(mcfg, tcfg)
    step = make_compact_train_step(make_train_step(mcfg, tcfg, dense_opt), mcfg, scheme)
    cols = ds.sample(64)
    state, out = step(state, on_torch(cf(cols)))
    assert np.isfinite(float(out["loss"]))
    # the eval wrapper gives the packed eval step's metrics, bit for bit
    evaluate = make_eval_step(mcfg, tcfg)
    got = make_compact_eval_step(evaluate, mcfg, scheme)(
        state, eval_state_init(device="cpu"), on_torch(cf(cols)))
    want = make_packed_eval_step(evaluate, mcfg, pack_label=True)(
        state, eval_state_init(device="cpu"), on_torch(pf(cols)))
    assert torch.equal(got.loss.total, want.loss.total)
    assert torch.equal(got.auroc.pos, want.auroc.pos)


# ---------------------------------------------------------------------------
# sorted-slot delta encoding


def _delta_scheme(mc, pack_label=True, segments=1):
    return CompactScheme.from_model(mc, pack_label=pack_label, delta_feature="user_id",
                                    delta_segments=segments)


@pytest.mark.parametrize("pack_label", [True, False])
def test_delta_roundtrip_bit_identical(pack_label):
    """A delta-encoded sorted slot decodes to exactly unpack_batch's output
    (hashed ids, missing mask, labels), and the encode is the reference's."""
    mc = flagship_cfg()
    feat = PackedFeaturizer(mc, pack_label=pack_label, sort_feature="user_id")
    scheme = _delta_scheme(mc, pack_label)
    cols = SyntheticClickstream(206_209, 49_688, seed=4).sample(2048)
    cols["user_id"][:17] = 0  # missing user ids (sort last, encode as N+1)
    pb = feat(cols)
    check_against_reference(mc, scheme, pb, compact_from_packed(pb, scheme), pack_label)


def test_delta_wire_bytes_drop():
    mc = flagship_cfg()
    plain = CompactScheme.from_model(mc, pack_label=True)
    delta = _delta_scheme(mc)
    assert plain.wire_bytes_per_example == 4.375
    # 19-bit user slot (18 id + label) -> 8 delta bits + 1 label rem bit
    assert delta.wire_bytes_per_example == 3.125
    assert delta.delta_capacity == (206_209 + 1) // 256 + 2


def test_delta_exceptions_exercised(rng):
    """Sparse batches force deltas > 255: the exception sidecar carries them
    exactly."""
    mc = flagship_cfg()
    feat = PackedFeaturizer(mc, pack_label=True, sort_feature="user_id")
    scheme = _delta_scheme(mc)
    # 64 users spread over the full 206k range -> every delta > 255
    cols = {
        "user_id": rng.integers(1, 206_209, 64).astype(np.int64),
        "product_id": rng.integers(1, 49_688, 64).astype(np.int64),
        "label": rng.integers(0, 2, 64).astype(np.int64),
    }
    pb = feat(cols)
    cb = compact_from_packed(pb, scheme)
    assert int((cb.delta_extra > 0).sum()) > 30
    check_against_reference(mc, scheme, pb, cb, True)


def test_exception_positions_outside_the_batch_are_dropped(rng):
    """The decode's scatter of the exceptions drops a position outside
    [0, B), as the reference's `mode="drop"` does (no device assert, no host
    round trip): a sidecar entry moved past the end changes nothing, the same
    in both packages."""
    mc = flagship_cfg()
    feat = PackedFeaturizer(mc, pack_label=True, sort_feature="user_id")
    scheme = _delta_scheme(mc)
    pb = feat({"user_id": rng.integers(1, 206_209, 64), "product_id": rng.integers(1, 49, 64),
               "label": rng.integers(0, 2, 64)})
    cb = compact_from_packed(pb, scheme)
    n = int((cb.delta_extra > 0).sum())
    assert n < scheme.delta_capacity
    bad = dataclasses.replace(cb, delta_pos=cb.delta_pos.copy(), delta_extra=cb.delta_extra.copy())
    bad.delta_pos[n] = 64  # one past the end, with an extra that would land if not dropped
    bad.delta_extra[n] = 1000
    got = decode(bad, mc, scheme)
    assert_batches_equal(got, decode(cb, mc, scheme))
    jbad = jax_compact.CompactBatch(**{f: getattr(bad, f) for f in CB_FIELDS})
    jscheme = jax_compact.CompactScheme.from_model(jax_cfg(mc), pack_label=True,
                                                   delta_feature="user_id")
    assert_batches_equal(got, jax_compact.batch_from_compact(
        jax.tree.map(jnp.asarray, jbad), jax_cfg(mc), jscheme))


def test_delta_rejects_unsorted_batch():
    mc = flagship_cfg()
    feat = PackedFeaturizer(mc, pack_label=True)  # no sort
    scheme = _delta_scheme(mc)
    with pytest.raises(ValueError, match="sort"):
        CompactFeaturizer(feat, scheme)
    with pytest.raises(ValueError, match="pack_label"):
        CompactFeaturizer(PackedFeaturizer(mc, pack_label=False, sort_feature="user_id"),
                          scheme)
    # a direct encode of an unsorted PackedBatch also fails loudly
    rng = np.random.default_rng(0)
    cols = {
        "user_id": rng.integers(1, 206_209, 64).astype(np.int64),
        "product_id": rng.integers(1, 49_688, 64).astype(np.int64),
        "label": rng.integers(0, 2, 64).astype(np.int64),
    }
    with pytest.raises(ValueError, match="not sorted"):
        compact_from_packed(feat(cols), scheme)


def test_delta_train_step_matches_packed():
    """Training through the delta wire == training through PackedBatch."""
    mc = flagship_cfg()
    tcfg = cfg_lib.TrainConfig(sparse_learning_rate=0.05, learning_rate=1e-3,
                               sorted_feature="user_id")
    feat = PackedFeaturizer(mc, pack_label=True, sort_feature="user_id")
    scheme = _delta_scheme(mc)
    ds = SyntheticClickstream(206_209, 49_688, seed=6)
    s_p, dense_opt = _fresh_state(mc, tcfg)
    s_c = s_p.copy()
    core = make_train_step(mc, tcfg, dense_opt)
    step_c = make_compact_train_step(core, mc, scheme)
    for i in range(3):
        pb = feat(ds.sample(1024, start=i))
        s_p, out_p = core(s_p, unpack_batch(on_torch(pb), mc, pack_label=True))
        s_c, out_c = step_c(s_c, on_torch(compact_from_packed(pb, scheme)))
        assert torch.equal(out_p["loss"], out_c["loss"])
    _assert_tables_equal(s_p, s_c)


def test_delta_macro_stacking():
    """stack_batches over CompactBatch with delta sidecars keeps each batch's
    exception arrays on the leading K axis."""
    mc = flagship_cfg()
    feat = PackedFeaturizer(mc, pack_label=True, sort_feature="user_id")
    scheme = _delta_scheme(mc)
    cfeat = CompactFeaturizer(feat, scheme)
    ds = SyntheticClickstream(206_209, 49_688, seed=8)
    cbs = [cfeat(ds.sample(512, start=i)) for i in range(3)]
    mb = on_torch(stack_batches(cbs))
    assert mb.delta_pos.shape == (3, scheme.delta_capacity)
    one = map_leaves(mb, lambda t: t[1])
    assert_batches_equal(batch_from_compact(one, mc, scheme), decode(cbs[1], mc, scheme))


@pytest.mark.parametrize("seed", range(8))
def test_compact_roundtrip_fuzz(seed):
    """Random schemes (table counts and sizes, multi-slot features, missing
    ids, both pack_label modes): the port's encode is the reference's, and
    its decode equals unpack_batch and the reference's decode on every draw."""
    r = np.random.default_rng(seed)
    n_tables = int(r.integers(1, 4))
    tables, features = [], []
    for t in range(n_tables):
        n = int(r.integers(3, 300_000))
        tables.append(cfg_lib.TableConfig(f"t{t}", n, 8, (f"f{t}",)))
        L = int(r.integers(1, 4))
        features.append(cfg_lib.FeatureConfig(f"f{t}", f"t{t}", max_ids_per_sample=L,
                                              pooling=("sum", "mean")[t % 2]))
    mc = cfg_lib.ModelConfig(
        tables=tuple(tables), features=tuple(features),
        query_tower=cfg_lib.TowerConfig((features[0].name,), (8, 4)),
        candidate_tower=cfg_lib.TowerConfig((features[-1].name,), (8, 4)),
    )
    mc.validate()
    pack_label = bool(seed % 2)
    scheme = CompactScheme.from_model(mc, pack_label=pack_label)
    b = 64
    cols = {"label": r.integers(0, 2, b).astype(np.int64)}
    for fc in features:
        if fc.max_ids_per_sample == 1:
            v = r.integers(0, 1 << 30, b).astype(np.int64)
            v[r.random(b) < 0.2] = 0  # missing
            cols[fc.name] = v
        else:
            vals = r.integers(0, 1 << 30, (b, fc.max_ids_per_sample)).astype(np.int64)
            vals[r.random(vals.shape) < 0.3] = 0
            cols[fc.name] = vals
    pb = PackedFeaturizer(mc, pack_label=pack_label)(cols)
    check_against_reference(mc, scheme, pb, compact_from_packed(pb, scheme), pack_label)


def _segments(pack_label, s=4, b_loc=512):
    """S per-slice-sorted encodes concatenated along the batch axis (the
    multi-host assembly: wire and rem on the batch axis, the sidecars and
    labels on axis 0), with the slices' packed batches."""
    mc = flagship_cfg()
    feat = PackedFeaturizer(mc, pack_label=pack_label, sort_feature="user_id")
    scheme = _delta_scheme(mc, pack_label, segments=s)
    ds = SyntheticClickstream(206_209, 49_688, seed=11)
    pbs, cbs = [], []
    for h in range(s):
        cols = ds.sample(b_loc, start=1000 * h)
        if h == 1:
            cols["user_id"][:9] = 0  # missing ids in one slice
        pbs.append(feat(cols))
        cbs.append(compact_from_packed(pbs[-1], scheme))
    glob = CompactBatch(
        wire=np.concatenate([c.wire for c in cbs], axis=-1),
        rem=np.concatenate([c.rem for c in cbs], axis=-1) if cbs[0].rem is not None else None,
        labels=np.concatenate([c.labels for c in cbs]),
        delta_pos=np.concatenate([c.delta_pos for c in cbs]),
        delta_extra=np.concatenate([c.delta_extra for c in cbs]))
    return mc, scheme, pbs, cbs, glob


@pytest.mark.parametrize("pack_label", [True, False])
def test_delta_segments_decode_bit_identical(pack_label):
    """delta_segments=S: the assembled batch decodes to exactly the concat of
    the slices' unpack_batch outputs (the cumsum resets at each segment,
    sidecar positions are segment-relative), and to the reference's decode."""
    mc, scheme, pbs, cbs, glob = _segments(pack_label)
    assert scheme.delta_capacity % 64 == 0
    got = decode(glob, mc, scheme)
    exps = [unpack_batch(on_torch(pb), mc, pack_label=pack_label) for pb in pbs]
    for name in exps[0].features:
        np.testing.assert_array_equal(
            got.features[name].ids.numpy(),
            np.concatenate([e.features[name].ids.numpy() for e in exps]))
        np.testing.assert_array_equal(
            got.features[name].mask.numpy(),
            np.concatenate([e.features[name].mask.numpy() for e in exps]))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.concatenate([e.labels.numpy() for e in exps]))
    jscheme = jax_compact.CompactScheme.from_model(
        jax_cfg(mc), pack_label=pack_label, delta_feature="user_id", delta_segments=4)
    jglob = jax_compact.CompactBatch(**{f: getattr(glob, f) for f in CB_FIELDS})
    assert_batches_equal(got, jax_compact.batch_from_compact(
        jax.tree.map(jnp.asarray, jglob), jax_cfg(mc), jscheme))


# ---------------------------------------------------------------------------
# against the JAX package


@pytest.mark.parametrize("case", ["flagship-delta", "multi-slot-dense", "whole-byte-fallback",
                                  "delta-segments-4"])
def test_encode_is_byte_equal_to_the_reference(case, rng):
    """The JAX `compact_from_packed` and the port's give byte-equal `wire`,
    `rem`, `labels`, `delta_pos` and `delta_extra` (and the decodes agree)
    for the flagship scheme with its delta slot, a multi-slot scheme with
    dense features, the whole-byte fallback and four delta segments."""
    if case == "delta-segments-4":  # each slice's encode (the assembly's decode: above)
        mc, scheme, pbs, cbs, _ = _segments(True)
        for pb, cb in zip(pbs, cbs):
            check_encode(mc, scheme, pb, cb)
        return
    if case == "flagship-delta":
        mc = flagship_cfg()
        cols = SyntheticClickstream(206_209, 49_688, seed=2).sample(4096)
        cols["user_id"][::97] = 0
        pf = PackedFeaturizer(mc, pack_label=True, sort_feature="user_id")
        scheme, pack_label = _delta_scheme(mc), True
    elif case == "multi-slot-dense":
        # 500 rows: 9 id bits; the labelled slot 10 (1 byte + 2 rem bits), the
        # bag's two slots 9 each (1 byte + 1 rem bit): R = 4 bit-packed
        mc = _multi_slot_cfg(500, 2)
        cols = {"a": rng.integers(0, 10**6, 64), "b": rng.integers(0, 10**6, (64, 2)),
                "label": rng.integers(0, 2, 64), "price": rng.random(64)}
        cols["a"][::5] = 0
        cols["b"][::3, 1] = 0
        pf = PackedFeaturizer(mc, dense_cols=("price",), pack_label=True)
        scheme, pack_label = CompactScheme.from_model(mc, pack_label=True), True
        assert (scheme.whole_bytes, scheme.rem_bits_total) == (3, 4)
    else:
        mc = _multi_slot_cfg(100, 4)
        cols = {"a": rng.integers(0, 10**6, 40), "b": rng.integers(0, 10**6, (40, 4)),
                "label": rng.integers(0, 2, 40)}
        pf = PackedFeaturizer(mc)
        scheme, pack_label = CompactScheme.from_model(mc, pack_label=False), False
        assert scheme.rem_bits_total == 0
    pb = pf(cols)
    check_against_reference(mc, scheme, pb, compact_from_packed(pb, scheme), pack_label)


def test_compact_train_steps_match_jax():
    """Three steps through the port's compact train step against the JAX
    package's, at the train-step tests' widths (1,000 x 300 users and items,
    dim 128, towers (128, 64), batch 512, sorted by user id, delta-encoded):
    loss each step and, after the first, the logits, tables, accumulators
    and tower gradients within their 1e-5 x max."""
    cfg, tcfg, pcfg, ptcfg = _configs("float32", "off", "float32")
    params = _numpy_params(cfg)
    jstate, jopt, pstate, popt = _states(cfg, tcfg, pcfg, ptcfg, params)
    jscheme = jax_compact.CompactScheme.from_model(cfg, pack_label=True,
                                                   delta_feature="user_id")
    scheme = CompactScheme.from_model(pcfg, pack_label=True, delta_feature="user_id")
    jtrain = jax_compact.make_compact_train_step(
        jax_step.make_train_step(cfg, tcfg, jopt, jit=False), cfg, jscheme)
    ptrain = make_compact_train_step(port_step.make_train_step(pcfg, ptcfg, popt), pcfg, scheme)
    jfeat = jax_compact.CompactFeaturizer(
        JaxPackedFeaturizer(cfg, pack_label=True, sort_feature="user_id"), jscheme)
    pfeat = CompactFeaturizer(PackedFeaturizer(pcfg, pack_label=True, sort_feature="user_id"),
                              scheme)
    for i, cols in enumerate(_columns(3)):
        jcb, pcb = jfeat(cols), pfeat(cols)
        assert pcb.wire.tobytes() == np.asarray(jcb.wire).tobytes()
        jstate, jout = jtrain(jstate, jax.tree.map(jnp.asarray, jcb))
        pstate, pout = ptrain(pstate, on_torch(pcb))
        _close(pout["loss"].float().item(), float(jout["loss"]), 1e-5)
        if i == 0:
            _close(pout["logits"].float(), jout["logits"].astype(jnp.float32), 1e-5)
            _check_state(params, jstate, pstate, 1e-5)
    assert pstate.step == 3
