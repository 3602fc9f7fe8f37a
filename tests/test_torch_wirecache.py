"""The port's wire cache (`data/wirecache.py`): cached batches decode as the
dynamic `CompactFeaturizer` path's do, orders are seeded and deterministic,
an epoch through the cache trains as the dynamic path does bit for bit; and
against the JAX package: a cache that either package builds from the same
replica shards has the same `meta.json` and the same `.bin` bytes, and each
package reads the other's. The cases of the reference's
`tests/test_wirecache.py`, on the port."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu.data import compact as jax_compact
from two_tower_recommender_model_tpu.data import wirecache as jax_wirecache
from two_tower_recommender_model_tpu.data.loader import StreamLoader as JaxStreamLoader
from two_tower_recommender_model_tpu.data.prepacked import (
    PrepackedFeaturizer as JaxPrepackedFeaturizer,
)
from two_tower_recommender_model_tpu_torch import config as cfg_lib
from two_tower_recommender_model_tpu_torch.cli import fetch_instacart, prepare_instacart
from two_tower_recommender_model_tpu_torch.data import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.data.compact import (
    CompactFeaturizer,
    CompactScheme,
    batch_from_compact,
    make_compact_train_step,
)
from two_tower_recommender_model_tpu_torch.data.device_featurizer import (
    PackedFeaturizer,
    make_packed_train_step,
    unpack_batch,
)
from two_tower_recommender_model_tpu_torch.data.loader import StreamLoader
from two_tower_recommender_model_tpu_torch.data.prepacked import PrepackedFeaturizer
from two_tower_recommender_model_tpu_torch.data.wirecache import WireCache, build_wire_cache
from two_tower_recommender_model_tpu_torch.train.loop import train_one_epoch_packed
from two_tower_recommender_model_tpu_torch.train.pipeline import map_leaves
from two_tower_recommender_model_tpu_torch.train.step import (
    create_train_state,
    make_multi_step,
    make_train_step,
)
from test_torch_compact import assert_batches_equal, jax_cfg


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
    return cfg_lib.two_tower_model_config(num_users=200, num_items=80, embedding_dim=8,
                                          layer_sizes=(16, 8))


def _featurizer(mcfg, delta=True):
    scheme = CompactScheme.from_model(mcfg, pack_label=True,
                                      delta_feature="user_id" if delta else None)
    inner = PackedFeaturizer(mcfg, pack_label=True, sort_feature="user_id" if delta else None)
    return CompactFeaturizer(inner, scheme), scheme


def _source(n_batches, b, seed=0):
    ds = SyntheticClickstream(num_users=200, num_items=80, seed=seed)
    return [ds.sample(b, start=i * b) for i in range(n_batches)]


def _decode(cb, mcfg, scheme):
    return batch_from_compact(map_leaves(cb, lambda t: t), mcfg, scheme)


@pytest.mark.parametrize("delta", [True, False])
def test_cache_batches_decode_identically(tmp_path, mcfg, delta):
    feat, scheme = _featurizer(mcfg, delta)
    src = _source(6, 64)
    build_wire_cache(str(tmp_path / "wc"), src, feat)
    cache = WireCache(str(tmp_path / "wc"), scheme=scheme)
    assert cache.num_batches == 6 and cache.batch_size == 64
    order = cache.order(epoch=0)  # a permutation: match each cached batch to its source
    for pos, cb in enumerate(cache.batches(epoch=0)):
        assert_batches_equal(_decode(cb, mcfg, scheme), _decode(feat(src[order[pos]]), mcfg,
                                                                scheme))


def test_epoch_shuffle_deterministic_and_distinct(tmp_path, mcfg):
    feat, scheme = _featurizer(mcfg)
    build_wire_cache(str(tmp_path / "wc"), _source(16, 8), feat)
    cache = WireCache(str(tmp_path / "wc"), scheme=scheme)
    np.testing.assert_array_equal(cache.order(0), WireCache(str(tmp_path / "wc")).order(0))
    assert not np.array_equal(cache.order(0), cache.order(1))  # reshuffles
    assert sorted(cache.order(1)) == list(range(16))  # the same multiset


def test_host_slices_disjoint_equal(tmp_path, mcfg):
    feat, scheme = _featurizer(mcfg)
    build_wire_cache(str(tmp_path / "wc"), _source(10, 8), feat)
    cache = WireCache(str(tmp_path / "wc"), scheme=scheme)
    seen = []
    for h in range(3):
        batches = list(cache.batches(epoch=2, host_index=h, host_count=3))
        assert len(batches) == 3  # 10 // 3, equal on every host
        seen.extend(b.wire.tobytes() for b in batches)
    assert len(set(seen)) == len(seen)  # disjoint
    # skip_batches resumes mid-slice; limit_batches cuts after the host slicing
    assert len(list(cache.batches(epoch=2, host_index=1, host_count=3, skip_batches=2))) == 1
    assert len(list(cache.batches(epoch=2, host_index=1, host_count=3, limit_batches=2))) == 2
    with pytest.raises(ValueError, match="out of range"):
        next(cache.batches(epoch=0, host_index=3, host_count=3))


def test_ragged_tail_dropped_and_scheme_mismatch(tmp_path, mcfg):
    feat, scheme = _featurizer(mcfg)
    src = _source(3, 64) + [_source(1, 17, seed=9)[0]]
    meta = build_wire_cache(str(tmp_path / "wc"), src, feat)
    assert meta["num_batches"] == 3 and meta["dropped_tail_rows"] == 17
    other = CompactScheme.from_model(mcfg, pack_label=True)  # no delta slot
    with pytest.raises(ValueError, match="different wire scheme"):
        WireCache(str(tmp_path / "wc"), scheme=other)
    with pytest.raises(ValueError, match="batch size changed"):
        build_wire_cache(str(tmp_path / "wc2"), src, feat, drop_ragged_tail=False)


def _state(mcfg, tcfg):
    return create_train_state(torch.Generator().manual_seed(0), mcfg, tcfg)


def test_train_through_packed_loop_matches_dynamic(tmp_path, mcfg):
    """An epoch from the cache == an epoch on the same CompactBatches fed
    dynamically in the cache's order (the same final tables, bit for bit)."""
    feat, scheme = _featurizer(mcfg)
    src = _source(8, 64)
    build_wire_cache(str(tmp_path / "wc"), src, feat)
    cache = WireCache(str(tmp_path / "wc"), scheme=scheme)
    tcfg = cfg_lib.TrainConfig(batch_size=64, sorted_feature="user_id")
    state0, dense_opt = _state(mcfg, tcfg)
    core = make_train_step(mcfg, tcfg, dense_opt)
    multi = make_multi_step(lambda s, cb: core(s, batch_from_compact(cb, mcfg, scheme)))
    s_cache, stats = train_one_epoch_packed(state0.copy(), multi, cache.batches(epoch=0),
                                            lambda cb: cb, macro=4)
    assert stats["train_steps"] == 8 and stats["train_examples"] == 8 * 64
    dynamic = [feat(src[i]) for i in cache.order(0)]
    s_dyn, _ = train_one_epoch_packed(state0.copy(), multi, iter(dynamic), lambda cb: cb, macro=4)
    for name in s_cache.model.tables:
        assert torch.equal(s_cache.model.tables[name], s_dyn.model.tables[name]), name


def test_stale_cache_rejected(tmp_path, mcfg):
    """A cache built at another batch size or from another dataset (its
    fingerprint) is refused."""
    feat, scheme = _featurizer(mcfg)
    build_wire_cache(str(tmp_path / "wc"), _source(4, 64), feat,
                     fingerprint={"data_dir": "/a", "total_rows": 256})
    WireCache(str(tmp_path / "wc"), scheme=scheme, batch_size=64,
              fingerprint={"data_dir": "/a", "total_rows": 256})  # ok
    with pytest.raises(ValueError, match="batch_size"):
        WireCache(str(tmp_path / "wc"), scheme=scheme, batch_size=128)
    with pytest.raises(ValueError, match="different dataset"):
        WireCache(str(tmp_path / "wc"), scheme=scheme,
                  fingerprint={"data_dir": "/b", "total_rows": 999})
    # caches without a stored fingerprint stay loadable
    build_wire_cache(str(tmp_path / "wc2"), _source(4, 64), feat)
    WireCache(str(tmp_path / "wc2"), scheme=scheme, fingerprint={"data_dir": "/a"})
    (tmp_path / "wc2" / "meta.json").write_text('{"format": "something-else"}')
    with pytest.raises(ValueError, match="not a wire cache"):
        WireCache(str(tmp_path / "wc2"))


def test_order_modes(tmp_path, mcfg):
    feat, scheme = _featurizer(mcfg)
    build_wire_cache(str(tmp_path / "wc"), _source(10, 8), feat)
    cache = WireCache(str(tmp_path / "wc"), scheme=scheme)
    np.testing.assert_array_equal(cache.order(3, "loader"), np.arange(10))
    rot = cache.order(3, "rotate")
    assert sorted(rot) == list(range(10))
    assert set(np.diff(rot) % 10) <= {1}  # a rotation
    assert not np.array_equal(cache.order(3, "rotate"), cache.order(4, "rotate"))
    np.testing.assert_array_equal(cache.order(3, "rotate"),
                                  WireCache(str(tmp_path / "wc")).order(3, "rotate"))
    with pytest.raises(ValueError, match="order mode"):
        cache.order(0, "bogus")
    got = [b.wire for b in cache.batches(0, order_mode="loader")]
    for g, w in zip(got, [feat(c) for c in _source(10, 8)]):
        np.testing.assert_array_equal(g, w.wire)


# ---------------------------------------------------------------------------
# against the JAX package, on replica shards


@pytest.fixture(scope="module")
def replica(tmp_path_factory):
    """Pre-packed shards of a small Instacart replica, and its model."""
    csv = str(tmp_path_factory.mktemp("csv"))
    fetch_instacart.main(["--out", csv, "--replica", "--replica-users", "300",
                          "--replica-products", "150", "--seed", "4"])
    shards = str(tmp_path_factory.mktemp("shards"))
    meta = prepare_instacart.main(["--csv-dir", csv, "--out", shards, "--rows-per-shard", "4096",
                                   "--packed"])["meta"]
    cfg = cfg_lib.two_tower_model_config(meta["num_users"], meta["num_items"], embedding_dim=16,
                                         layer_sizes=(16, 8))
    return os.path.join(shards, "train"), cfg


def _port_cache(train_dir, cfg, out, batch=256):
    loader = StreamLoader(train_dir, batch, seed=3)
    inner = PrepackedFeaturizer.for_dataset(loader.dataset, cfg, sort_feature="user_id")
    feat = CompactFeaturizer(inner, CompactScheme.from_model(cfg, pack_label=inner.pack_label,
                                                             delta_feature="user_id"))
    build_wire_cache(out, loader, feat, fingerprint={"data_dir": train_dir})
    return feat


def _jax_cache(train_dir, cfg, out, batch=256):
    jcfg = jax_cfg(cfg)
    loader = JaxStreamLoader(train_dir, batch, seed=3)
    inner = JaxPrepackedFeaturizer.for_dataset(loader.dataset, jcfg, sort_feature="user_id")
    scheme = jax_compact.CompactScheme.from_model(jcfg, pack_label=inner.pack_label,
                                                  delta_feature="user_id")
    jax_wirecache.build_wire_cache(out, loader, jax_compact.CompactFeaturizer(inner, scheme),
                                   fingerprint={"data_dir": train_dir})
    return scheme


def test_caches_of_both_packages_are_byte_equal_and_cross_readable(replica, tmp_path):
    """The same replica shards, loader seed and batch size through each
    package's `build_wire_cache`: equal `meta.json` bytes and equal `.bin` bytes; the
    port's `WireCache` reads the JAX package's cache and the JAX package's
    reads the port's, batch for batch, decoding alike."""
    train_dir, cfg = replica
    feat = _port_cache(train_dir, cfg, str(tmp_path / "port"))
    jscheme = _jax_cache(train_dir, cfg, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert {"meta.json", "wire.bin", "rem.bin", "delta_pos.bin", "delta_extra.bin"} <= set(names)
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), \
            name
    port_reads_jax = WireCache(str(tmp_path / "jax"), scheme=feat.scheme, seed=1)
    jax_reads_port = jax_wirecache.WireCache(str(tmp_path / "port"), scheme=jscheme, seed=1)
    assert port_reads_jax.num_batches == jax_reads_port.num_batches >= 10
    for mode in ("loader", "rotate", "shuffle"):
        np.testing.assert_array_equal(port_reads_jax.order(2, mode), jax_reads_port.order(2, mode))
    for cb, jcb in zip(port_reads_jax.batches(1, order_mode="shuffle"),
                       jax_reads_port.batches(1, order_mode="shuffle")):
        assert cb.wire.tobytes() == np.asarray(jcb.wire).tobytes()
        assert_batches_equal(_decode(cb, cfg, feat.scheme), jax_compact.batch_from_compact(
            jax.tree.map(jnp.asarray, jcb), jax_cfg(cfg), jscheme))


def test_cache_in_loader_order_trains_as_the_dynamic_packed_path(replica, tmp_path):
    """An epoch through the port's wire cache in "loader" order equals the
    port's dynamic packed epoch (`PackedBatch`es through `unpack_batch`, the
    loader featurizing and sorting each batch) bit for bit: tables,
    accumulators and towers."""
    train_dir, cfg = replica
    feat = _port_cache(train_dir, cfg, str(tmp_path / "wc"))
    cache = WireCache(str(tmp_path / "wc"), scheme=feat.scheme)
    tcfg = cfg_lib.TrainConfig(batch_size=256, sorted_feature="user_id",
                               sparse_learning_rate=0.1)
    state0, dense_opt = _state(cfg, tcfg)
    core = make_train_step(cfg, tcfg, dense_opt)
    scheme, pl = feat.scheme, feat.inner.pack_label
    compact = make_multi_step(lambda s, cb: core(s, batch_from_compact(cb, cfg, scheme)))
    packed = make_multi_step(lambda s, pb: core(s, unpack_batch(pb, cfg, pack_label=pl)))
    s_cache, stats = train_one_epoch_packed(
        state0.copy(), compact, cache.batches(0, order_mode="loader"), lambda cb: cb, macro=4,
        tail_step=make_compact_train_step(core, cfg, scheme))
    loader = StreamLoader(train_dir, 256, seed=3)
    s_dyn, dyn_stats = train_one_epoch_packed(
        state0.copy(), packed, loader, feat.inner, macro=4,
        tail_step=make_packed_train_step(core, cfg, pack_label=pl))
    assert stats["train_steps"] == dyn_stats["train_steps"] == cache.num_batches
    for name, t in s_dyn.model.tables.items():
        assert torch.equal(s_cache.model.tables[name], t), name
        assert torch.equal(s_cache.adagrad_acc[name], s_dyn.adagrad_acc[name]), name
    for a, b in zip(s_cache.model.parameters(), s_dyn.model.parameters()):
        assert torch.equal(a, b)
