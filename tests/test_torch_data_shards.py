"""The port's TTRS shards, streaming loader, pre-packed datasets and
`split_positives` against the JAX package's: the same columns write the same
files byte for byte, and the same datasets stream the same batches, batch by
batch (shuffled or not, `drop_last`, two hosts under both `align_hosts`
modes, several read workers, and a mid-epoch resume)."""

import os

import numpy as np
import pytest

from two_tower_recommender_model_tpu import config as ref_cfg
from two_tower_recommender_model_tpu.data import loader as ref_loader
from two_tower_recommender_model_tpu.data import prepacked as ref_pp
from two_tower_recommender_model_tpu.data import shards as ref_shards
from two_tower_recommender_model_tpu.evaluation.retrieval import (
    split_positives as ref_split_positives,
)
from two_tower_recommender_model_tpu_torch import config as port_cfg
from two_tower_recommender_model_tpu_torch.data import loader as port_loader
from two_tower_recommender_model_tpu_torch.data import prepacked as port_pp
from two_tower_recommender_model_tpu_torch.data import shards as port_shards
from two_tower_recommender_model_tpu_torch.evaluation.retrieval import split_positives

N_ROWS, N_USERS, N_ITEMS = 2_500, 97, 61


def columns(seed: int = 0, n: int = N_ROWS) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "user_id": rng.integers(1, N_USERS, n).astype(np.int64),
        "product_id": rng.integers(1, N_ITEMS, n).astype(np.int64),
        "label": rng.integers(0, 2, n).astype(np.int64),
    }


def tree_bytes(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def assert_batches_equal(got: list, want: list) -> None:
    assert len(got) == len(want) and len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k])


# --- shard files -----------------------------------------------------------

SHARD_COLS = {
    "ints": columns(),
    "mixed": {"ids": np.arange(600, dtype=np.int32).reshape(300, 2),
              "x": np.linspace(0, 1, 300, dtype=np.float32),
              # incompressible bytes: stored raw even when compress=True
              "noise": np.random.default_rng(1).integers(0, 256, 300).astype(np.uint8)},
}


@pytest.mark.parametrize("compress", [True, False], ids=["zlib", "raw"])
@pytest.mark.parametrize("case", list(SHARD_COLS))
def test_write_shard_is_byte_identical(tmp_path, case, compress):
    cols = SHARD_COLS[case]
    assert port_shards.write_shard(str(tmp_path / "p.ttrs"), cols, compress) == \
        ref_shards.write_shard(str(tmp_path / "r.ttrs"), cols, compress)
    assert (tmp_path / "p.ttrs").read_bytes() == (tmp_path / "r.ttrs").read_bytes()


@pytest.mark.parametrize("mmap", [False, True])
def test_read_shard_schema_and_rows(tmp_path, mmap):
    cols = SHARD_COLS["mixed"]
    path = str(tmp_path / "s.ttrs")
    ref_shards.write_shard(path, cols, compress=False)
    for want_cols in (None, ["x", "ids"]):
        got = port_shards.read_shard(path, want_cols, mmap=mmap)
        want = ref_shards.read_shard(path, want_cols, mmap=mmap)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert port_shards.shard_rows(path) == ref_shards.shard_rows(path) == 300
    assert port_shards.read_schema(path) == ref_shards.read_schema(path)
    (tmp_path / "bad.ttrs").write_bytes(b"NOPE\n" + bytes(20))
    with pytest.raises(ValueError, match="bad magic"):
        port_shards.read_shard(str(tmp_path / "bad.ttrs"))


@pytest.mark.parametrize("compress", [True, False], ids=["zlib", "raw"])
def test_write_dataset_is_byte_identical(tmp_path, compress):
    batches = [columns(s, n) for s, n in ((0, 700), (1, 0), (2, 1_300), (3, 55))]
    extra = {"note": "x"}
    got = port_shards.write_dataset(str(tmp_path / "p"), iter(batches), 512, compress, extra)
    want = ref_shards.write_dataset(str(tmp_path / "r"), iter(batches), 512, compress, extra)
    assert got == want and len(want["shards"]) == 5
    assert tree_bytes(tmp_path / "p") == tree_bytes(tmp_path / "r")


def test_sharded_dataset(tmp_path):
    ref_shards.write_dataset(str(tmp_path / "d"), columns(), 600)
    ds = port_shards.ShardedDataset(str(tmp_path / "d"))
    rds = ref_shards.ShardedDataset(str(tmp_path / "d"), use_native=False)
    assert (ds.total_rows, ds.num_shards, ds.shard_row_counts, ds.mmap) == (
        rds.total_rows, rds.num_shards, rds.shard_row_counts, rds.mmap)
    assert ds.schema(["label"]) == rds.schema(["label"])
    for i in range(ds.num_shards):
        got, want = ds.read_shard(i, ["user_id"]), rds.read_shard(i, ["user_id"])
        np.testing.assert_array_equal(got["user_id"], want["user_id"])
    native = port_shards.ShardedDataset(str(tmp_path / "d"), use_native=True)
    assert native.use_native and ds.use_native  # compressed shards: native when it builds
    for i in range(ds.num_shards):
        got, want = native.read_shard(i, ["user_id"]), rds.read_shard(i, ["user_id"])
        np.testing.assert_array_equal(got["user_id"], want["user_id"])
    (tmp_path / "e").mkdir()
    (tmp_path / "e" / "index.json").write_text('{"format": "other"}')
    with pytest.raises(ValueError, match="not a ttrs dataset"):
        port_shards.ShardedDataset(str(tmp_path / "e"))


# --- the streaming loader --------------------------------------------------

@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """Five shards of unequal size (600, 600, 600, 600, 100 rows)."""
    d = tmp_path_factory.mktemp("ds")
    ref_shards.write_dataset(str(d / "train"), columns(), 600)
    return str(d / "train")


LOADER_CASES = {
    "shuffled": dict(shuffle=True),
    "in-order": dict(shuffle=False),
    "keep-last": dict(shuffle=True, drop_last=False),
    "in-order-keep-last": dict(shuffle=False, drop_last=False),
    "workers": dict(shuffle=True, read_workers=3),
    "columns": dict(shuffle=True, columns=["product_id", "label"]),
    "host0-truncate": dict(num_hosts=2, host_index=0),
    "host1-truncate": dict(num_hosts=2, host_index=1),
    "host0-pad": dict(num_hosts=2, host_index=0, align_hosts="pad", drop_last=False),
    "host1-pad": dict(num_hosts=2, host_index=1, align_hosts="pad", drop_last=False),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_stream_loader_streams_equal(dataset_dir, case):
    kw = dict(LOADER_CASES[case], seed=5)
    ref = ref_loader.StreamLoader(ref_shards.ShardedDataset(dataset_dir, use_native=False),
                                  256, **kw)
    port = port_loader.StreamLoader(dataset_dir, 256, **kw)
    for epoch in (0, 1):
        ref.set_epoch(epoch)
        port.set_epoch(epoch)
        assert port.batches_per_epoch(epoch) == ref.batches_per_epoch(epoch)
        assert_batches_equal(list(port), list(ref))
        assert port.state_dict() == ref.state_dict()


def test_two_hosts_align(dataset_dir):
    """Both modes give the two hosts the same number of batches: truncated
    to the smaller count, or padded with 0-row batches to the larger."""
    for mode, drop_last in (("truncate", True), ("pad", False)):
        counts = []
        for h in (0, 1):
            batches = list(port_loader.StreamLoader(dataset_dir, 256, seed=5, num_hosts=2,
                                                    host_index=h, align_hosts=mode,
                                                    drop_last=drop_last))
            counts.append(len(batches))
            if mode == "pad":
                assert all(v.dtype == np.int64 for b in batches for v in b.values())
        assert counts[0] == counts[1]
    with pytest.raises(ValueError, match="align_hosts"):
        port_loader.StreamLoader(dataset_dir, 256, align_hosts="neither")


@pytest.mark.parametrize("stop_after", [1, 3, 7])
def test_mid_epoch_resume(dataset_dir, stop_after):
    """State taken after `stop_after` batches of epoch 1, loaded into a new
    loader: the rest of the epoch equals the reference's own resumed stream
    and the uninterrupted one."""
    def resumed(mod, ds):
        first = mod.StreamLoader(ds, 200, seed=3)
        first.set_epoch(1)
        it = iter(first)
        for _ in range(stop_after):
            next(it)
        state = first.state_dict()
        again = mod.StreamLoader(ds, 200, seed=3)
        again.load_state_dict(state)
        return state, list(again)

    state, got = resumed(port_loader, dataset_dir)
    rstate, want = resumed(ref_loader, ref_shards.ShardedDataset(dataset_dir, use_native=False))
    assert state == rstate == {"epoch": 1, "batches_yielded": stop_after, "seed": 3,
                               "host_index": 0, "num_hosts": 1}
    assert_batches_equal(got, want)
    whole = port_loader.StreamLoader(dataset_dir, 200, seed=3)
    whole.set_epoch(1)
    assert_batches_equal(got, list(whole)[stop_after:])
    with pytest.raises(ValueError, match="incompatible"):
        port_loader.StreamLoader(dataset_dir, 200, seed=4).load_state_dict(state)


# --- pre-packed datasets and split_positives -------------------------------

def model_configs():
    return (port_cfg.two_tower_model_config(N_USERS, N_ITEMS, embedding_dim=8,
                                            layer_sizes=(8, 4)),
            ref_cfg.two_tower_model_config(N_USERS, N_ITEMS, embedding_dim=8,
                                           layer_sizes=(8, 4)))


@pytest.mark.parametrize("pack_label", [True, False])
def test_pack_dataset_is_byte_identical(tmp_path, pack_label):
    pcfg, rcfg = model_configs()
    batches = [columns(0, 900), columns(1, 800)]
    got = port_pp.pack_dataset(str(tmp_path / "p"), pcfg, iter(batches), pack_label=pack_label,
                               rows_per_shard=512)
    want = ref_pp.pack_dataset(str(tmp_path / "r"), rcfg, iter(batches), pack_label=pack_label,
                               rows_per_shard=512)
    assert got == want and want["uncompressed"] is True
    assert tree_bytes(tmp_path / "p") == tree_bytes(tmp_path / "r")


@pytest.mark.parametrize("sort_feature", [None, "user_id", "product_id"])
@pytest.mark.parametrize("pack_label", [True, False])
def test_prepacked_featurizer_batches_equal(tmp_path, sort_feature, pack_label):
    pcfg, rcfg = model_configs()
    ref_pp.pack_dataset(str(tmp_path / "d"), rcfg, columns(), pack_label=pack_label,
                        rows_per_shard=700)
    pds = port_shards.ShardedDataset(str(tmp_path / "d"))
    rds = ref_shards.ShardedDataset(str(tmp_path / "d"))
    assert pds.mmap and rds.mmap
    pf = port_pp.PrepackedFeaturizer.for_dataset(pds, pcfg, sort_feature=sort_feature)
    rf = ref_pp.PrepackedFeaturizer.for_dataset(rds, rcfg, sort_feature=sort_feature)
    got = [pf(c) for c in port_loader.StreamLoader(pds, 300, seed=1, drop_last=False)]
    want = [rf(c) for c in ref_loader.StreamLoader(rds, 300, seed=1, drop_last=False)]
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        for field in ("ids_raw", "labels"):
            a, b = getattr(g, field), np.asarray(getattr(w, field))
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert g.dense is None and w.dense is None


def test_prepacked_featurizer_refuses_other_layouts(tmp_path):
    pcfg, _ = model_configs()
    port_shards.write_dataset(str(tmp_path / "raw"), columns(), 700)
    with pytest.raises(ValueError, match="not a pre-packed dataset"):
        port_pp.PrepackedFeaturizer.for_dataset(
            port_shards.ShardedDataset(str(tmp_path / "raw")), pcfg)
    port_pp.pack_dataset(str(tmp_path / "p"), pcfg, columns())
    wider = port_cfg.two_tower_model_config(N_USERS + 1, N_ITEMS, embedding_dim=8,
                                            layer_sizes=(8, 4))
    with pytest.raises(ValueError, match="slot layout"):
        port_pp.PrepackedFeaturizer.for_dataset(
            port_shards.ShardedDataset(str(tmp_path / "p")), wider)
    f = port_pp.PrepackedFeaturizer(pcfg)
    with pytest.raises(ValueError, match="packed_ids"):
        f({"packed_ids": np.zeros((4, 3), np.int32)})


@pytest.mark.parametrize("layout", ["raw", "packed", "packed-label-column"])
def test_split_positives_match(tmp_path, layout):
    pcfg, rcfg = model_configs()
    cols = columns(9, 70_000)  # past one 65,536-row read of the loader
    path = str(tmp_path / "split")
    if layout == "raw":
        ref_shards.write_dataset(path, cols, 30_000)
    else:
        ref_pp.pack_dataset(path, rcfg, cols, pack_label=layout == "packed",
                            rows_per_shard=30_000)
    got = split_positives(path)
    want = ref_split_positives(path)
    assert list(got.items()) == list(want.items())
    assert sum(map(len, got.values())) == int(cols["label"].sum())
