"""`cli.train` on a mesh: two gloo ranks under torchrun (`--device cpu`)
against the one-rank run on the same shards, at the flagship's table sizes,
where the default plan row-shards the user table (host-sorted) and puts the
item table table-wise, through the default packed path. The metrics at the
reference's loss bar (rtol 1e-5), the exports at the tables' and towers'
bars of `test_torch_parallel_step.py`, the export loadable by `load_scorer`;
a run stopped after its first epoch's checkpoint and resumed on two ranks
equals the uninterrupted one bit for bit, and one rank resumes the two
ranks' checkpoint. Two ranks also train through the all-to-all exchange and
with int8 tables (each checkpointing and exporting), and a run whose
exchange drops ids exits with the overflow error.

M12(c): on two ranks `--wire-format auto` takes the compact wire (each rank
decodes its slice, the sorted user slot delta-encoded), which trains bit for
bit as `--wire-format packed` and as `--wire-cache` (a generation an epoch,
streamed in the loader's order); `--loss sampled_softmax` trains each rank's
stripe of the score matrix and lands at the one-rank run's metrics (rtol
1e-3 after four steps; see its test); `--multi-host` runs two
torchrun nodes of one rank each on a small synthetic set
(`tests/test_multihost.py:129`, `:390`): each host streams its own shards,
the metrics are real numbers, and `--wire-cache` builds one cache a host."""

import ast
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu_torch.cli import fetch_instacart, prepare_instacart
from two_tower_recommender_model_tpu_torch.serving.scorer import load_scorer

USERS, ITEMS = 206_209, 49_688  # the flagship's tables: user row-sharded, items table-wise
TIMEOUT_S = 300


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_cli")
    fetch_instacart.main(["--out", str(d / "csv"), "--replica", "--replica-users", "300",
                          "--replica-products", "150", "--seed", "4"])
    prepare_instacart.main(["--csv-dir", str(d / "csv"), "--out", str(d / "data"),
                            "--rows-per-shard", "4096"])
    return str(d / "data")


def _train(ranks, data_dir, work, *extra):
    """`cli.train` under torchrun with `ranks` CPU ranks: (rank 0's results
    dict as printed, stdout and then stderr)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(ranks), "-m", "two_tower_recommender_model_tpu_torch.cli.train",
           "--data-dir", data_dir, "--num-users", str(USERS), "--num-items", str(ITEMS),
           "--embedding-dim", "128", "--layer-sizes", "16", "8", "--batch-size", "256",
           "--sparse-learning-rate", "0.1", "--learning-rate", "0.003", "--macro-batches", "4",
           "--runs-root", str(work / "runs"), "--device", "cpu", *extra]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=TIMEOUT_S, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{'baseline_val_loss'")]
    assert len(lines) == 1, proc.stdout[-3000:]  # rank 0 prints, the others do not
    return ast.literal_eval(lines[0]), proc.stdout + proc.stderr


@pytest.fixture(scope="module")
def runs(data_dir, tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh_runs")
    out = {}
    for name, ranks in (("two", 2), ("one", 1)):
        out[name] = _train(ranks, data_dir, work / name, "--epochs", "2",
                           "--export-dir", str(work / name / "export"))
    return work, out


def _params(path):
    with np.load(os.path.join(path, "params.npz")) as f:
        return {k: f[k] for k in f.files}


def test_two_ranks_train_like_one(runs):
    work, out = runs
    (two, stdout), (one, _) = out["two"], out["one"]
    assert "EmbeddingShardingPlan over 2 device(s)" in stdout
    plan = [ln.split() for ln in stdout.splitlines() if ln.startswith("t_")]
    assert {p[0]: p[1] for p in plan} == {"t_user_id": "row_sharded",
                                          "t_product_id": "table_wise"}
    assert two["train_steps"] == one["train_steps"] and two["train_examples"] == \
        one["train_examples"]
    for key in ("baseline_val_loss", "val_loss", "test_loss", "train_loss"):
        np.testing.assert_allclose(two[key], one[key], rtol=1e-5, err_msg=key)
    for key in ("baseline_val_auroc", "val_auroc", "test_auroc"):
        np.testing.assert_allclose(two[key], one[key], rtol=1e-4, err_msg=key)
    assert two["val_auroc"] > two["baseline_val_auroc"] + 0.1
    got, want = _params(work / "two" / "export"), _params(work / "one" / "export")
    assert sorted(got) == sorted(want)
    for k in want:
        atol = 1e-5 if k.startswith("tables/") else 1e-6
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=atol, err_msg=k)
    rng = np.random.default_rng(0)
    inputs = {"user_id": rng.integers(1, 300, 64), "product_id": rng.integers(1, 150, 64)}
    scores = [load_scorer(str(work / name / "export"), device="cpu").predict(inputs)
              for name in ("two", "one")]
    np.testing.assert_allclose(scores[0], scores[1], rtol=1e-4, atol=1e-5)


def test_two_rank_resume_equals_the_uninterrupted_run(runs, data_dir, tmp_path):
    """Two ranks stop after epoch 0's checkpoint (rank 0 saves the unsharded
    state) and two ranks resume it: the export is the uninterrupted run's,
    bit for bit. One rank resumes the same checkpoint (any mesh restores
    it) and lands at the bars of the two-rank run."""
    work, out = runs
    ckpt = tmp_path / "ckpt"
    _train(2, data_dir, tmp_path / "a", "--epochs", "1", "--checkpoint-dir", str(ckpt))
    saved = sorted(os.listdir(ckpt))
    assert saved == [str(out["two"][0]["train_steps"])]
    ckpt1 = tmp_path / "ckpt1"
    shutil.copytree(ckpt, ckpt1)
    resumed, stdout = _train(2, data_dir, tmp_path / "b", "--epochs", "2", "--checkpoint-dir",
                             str(ckpt), "--resume", "--export-dir", str(tmp_path / "b" / "export"))
    assert "resumed from step" in stdout
    want = _params(work / "two" / "export")
    got = _params(tmp_path / "b" / "export")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for key in ("val_loss", "test_loss", "val_auroc", "test_auroc"):
        assert resumed[key] == out["two"][0][key]
    _train(1, data_dir, tmp_path / "d", "--epochs", "2", "--checkpoint-dir", str(ckpt1),
           "--resume", "--export-dir", str(tmp_path / "d" / "export"))
    got = _params(tmp_path / "d" / "export")
    for k in want:
        atol = 1e-5 if k.startswith("tables/") else 1e-6
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=atol, err_msg=k)
    assert torch.load(os.path.join(ckpt1, saved[0], "state.pt"), weights_only=True)["step"] \
        == out["two"][0]["train_steps"]


def _trains(result, stdout, export, plan):
    """A run that trained, printed its plan and exported a model that
    `load_scorer` serves."""
    rows = [ln.split() for ln in stdout.splitlines() if ln.startswith("t_")]
    assert {p[0]: p[1] for p in rows} == plan
    assert result["val_auroc"] > result["baseline_val_auroc"] + 0.1
    rng = np.random.default_rng(0)
    inputs = {"user_id": rng.integers(1, 300, 64), "product_id": rng.integers(1, 150, 64)}
    assert np.isfinite(load_scorer(str(export), device="cpu").predict(inputs)).all()


def test_two_ranks_train_through_the_alltoall_exchange(runs, data_dir, tmp_path):
    """`--sharded-exchange alltoall` with the user table unsorted
    (`--sorted-feature off`), so the row-sharded user table takes the
    exchange and the item bucket the dense one: it trains, checkpoints and
    exports, and lands at the dense two-rank run's metrics (the same
    updates; only the batch rows' order differs, unsorted)."""
    ckpt = tmp_path / "ckpt"
    result, stdout = _train(2, data_dir, tmp_path, "--epochs", "2", "--sorted-feature", "off",
                            "--sharded-exchange", "alltoall", "--exchange-capacity-factor", "2",
                            "--checkpoint-dir", str(ckpt), "--export-dir",
                            str(tmp_path / "export"))
    assert "alltoall exchange: t_user_id" in stdout
    _trains(result, stdout, tmp_path / "export",
            {"t_user_id": "row_sharded", "t_product_id": "table_wise"})
    assert sorted(os.listdir(ckpt))
    dense = runs[1]["two"][0]
    for key in ("val_loss", "test_loss"):
        np.testing.assert_allclose(result[key], dense[key], rtol=1e-4, err_msg=key)


def test_two_ranks_train_int8_tables(data_dir, tmp_path):
    """`--table-dtype int8`: the planner's int8 flagship plan (user
    row-sharded, items in the int8 bucket) trains, checkpoints the unsharded
    int8 state and exports it."""
    ckpt = tmp_path / "ckpt"
    result, stdout = _train(2, data_dir, tmp_path, "--epochs", "2", "--table-dtype", "int8",
                            "--checkpoint-dir", str(ckpt), "--export-dir",
                            str(tmp_path / "export"))
    assert "__tw_bucket_d128_int8__" in stdout
    _trains(result, stdout, tmp_path / "export",
            {"t_user_id": "row_sharded", "t_product_id": "table_wise"})
    saved = sorted(os.listdir(ckpt))
    state = torch.load(os.path.join(ckpt, saved[-1], "state.pt"), weights_only=True)
    assert state["tensors"]["model/tables.t_user_id.values"].dtype == torch.int8
    assert state["tensors"]["model/tables.t_product_id.values"].shape == (ITEMS, 128)


def test_a_tiny_capacity_factor_exits_with_the_overflow_error(data_dir, tmp_path):
    """A capacity far below the batch's distinct users: the run exits with
    the reference's overflow error instead of training on dropped ids."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "two_tower_recommender_model_tpu_torch.cli.train", "--data-dir", data_dir,
           "--num-users", str(USERS), "--num-items", str(ITEMS), "--embedding-dim", "128",
           "--layer-sizes", "16", "8", "--batch-size", "256", "--epochs", "1",
           "--sorted-feature", "off", "--sharded-exchange", "alltoall",
           "--exchange-capacity-factor", "0.001", "--runs-root", str(tmp_path / "runs"),
           "--device", "cpu"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=TIMEOUT_S,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode != 0
    assert re.search(r"dropped \d+ distinct ids past", proc.stderr), proc.stderr[-3000:]


def _assert_exports_equal(got_dir, want_dir):
    got, want = _params(got_dir), _params(want_dir)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_two_ranks_compact_wire_trains_as_packed(runs, data_dir, tmp_path):
    """The two-rank run's `auto` wire is the compact one, its user slot
    delta-encoded; `--wire-format packed` ends in the same export bit for
    bit, and so does `--wire-cache` with a generation an epoch (each built
    by rank 0, streamed in the loader's order)."""
    work, out = runs
    assert "wire format: compact" in out["two"][1]
    assert re.search(r"sorted-feature auto: user_id", out["two"][1])
    packed, log = _train(2, data_dir, tmp_path / "p", "--epochs", "2", "--wire-format", "packed",
                         "--export-dir", str(tmp_path / "p" / "export"))
    assert "wire format: packed" in log
    _assert_exports_equal(tmp_path / "p" / "export", work / "two" / "export")
    cached, log = _train(2, data_dir, tmp_path / "c", "--epochs", "2", "--wire-cache",
                         str(tmp_path / "wc"), "--wire-cache-generations", "2",
                         "--export-dir", str(tmp_path / "c" / "export"))
    assert log.count("wire cache built") == 2  # rank 0 builds each generation once
    assert sorted(os.listdir(tmp_path / "wc")) == ["gen-0", "gen-1"]
    _assert_exports_equal(tmp_path / "c" / "export", work / "two" / "export")
    for key in ("val_loss", "test_loss", "train_loss"):
        assert packed[key] == cached[key] == out["two"][0][key]


def test_two_ranks_train_the_sampled_softmax_like_one(data_dir, tmp_path):
    """`--loss sampled_softmax` on two ranks (each its [128, 256] stripe of
    the score matrix, the logQ counts of the global batch) against one rank
    on the same shards, four steps. The losses within rtol 1e-3: the
    stripes' candidate gradients are summed in another f32 order than the
    one-rank softmax's, and row-wise Adagrad at the flagship's sparse rate
    0.1 moves a row whose gradients nearly cancel by lr x g / rms(g), where
    that order shows (after four steps the val loss moved 1.0e-4 relative on
    a CPU); the step itself is held at rtol 1e-5 by
    `test_torch_parallel_softmax.py`."""
    got = {}
    for ranks in (2, 1):
        got[ranks], _ = _train(ranks, data_dir, tmp_path / str(ranks), "--epochs", "1",
                               "--loss", "sampled_softmax", "--limit-train-batches", "4",
                               "--limit-val-batches", "4", "--limit-test-batches", "4")
    for key in ("baseline_val_loss", "val_loss", "test_loss", "train_loss"):
        np.testing.assert_allclose(got[2][key], got[1][key], rtol=1e-3, err_msg=key)
        assert np.isfinite(got[2][key])


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    """The reference's multi-host set: 2,000 train rows in shards of 256,
    400 val and 400 test rows (`test_multihost.py:135`)."""
    from two_tower_recommender_model_tpu_torch.data.shards import write_dataset
    from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream

    d = tmp_path_factory.mktemp("multihost")
    ds = SyntheticClickstream(60, 40, seed=1)
    for split, n in (("train", 2000), ("val", 400), ("test", 400)):
        write_dataset(str(d / split), ds.sample(n, split), rows_per_shard=256)
    return str(d)


def _two_hosts(data_dir, work, *extra):
    """`cli.train --multi-host` as two torchrun nodes of one rank each on
    one host (127.0.0.1): each node's stdout and stderr."""
    port = str(_free_port())
    procs = []
    for node in range(2):
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "2", "--node-rank",
               str(node), "--nproc-per-node", "1", "--master-addr", "127.0.0.1",
               "--master-port", port, "-m", "two_tower_recommender_model_tpu_torch.cli.train",
               "--data-dir", data_dir, "--num-users", "61", "--num-items", "41",
               "--batch-size", "64", "--embedding-dim", "8", "--layer-sizes", "16", "8",
               "--limit-val-batches", "2", "--limit-test-batches", "2", "--multi-host",
               "--runs-root", str(work / f"runs{node}"), "--device", "cpu", *extra]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, env={**os.environ, "OMP_NUM_THREADS": "1"}))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=TIMEOUT_S)
        assert p.returncode == 0, out[-3000:] + err[-6000:]
        outs.append((out, err))
    return outs


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _finite_results(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.startswith("{'baseline_val_loss'")]
    assert len(lines) == 1, stdout[-2000:]
    result = ast.literal_eval(lines[0])
    for key in ("baseline_val_auroc", "val_loss", "val_auroc", "test_loss", "test_auroc"):
        assert np.isfinite(result[key]), (key, result)
    return result


def test_cli_multihost_two_hosts(small_data, tmp_path):
    """`--multi-host` over two nodes: the hosts' disjoint streams make the
    global batches, rank 0 prints the plan and real metrics (every host's
    eval batches padded to the batch size and run to the longest host's
    count), the other rank prints nothing."""
    (out0, err0), (out1, _) = _two_hosts(small_data, tmp_path, "--epochs", "1",
                                         "--limit-train-batches", "8")
    assert "EmbeddingShardingPlan over 2 device(s)" in out0 and "EmbeddingShardingPlan" not in out1
    result = _finite_results(out0)
    assert result["train_examples"] == 8 * 2 * 64  # each step the two hosts' batches
    assert "sorted-feature auto: None" in err0 and "wire format: packed" in err0


def test_cli_multihost_wire_cache(small_data, tmp_path):
    """`--multi-host --wire-format compact --wire-cache`: each host encodes
    its own loader slice into its own cache (`host-{i}-of-2`), its user slot
    sorted and delta-encoded as one of two segments, and the epochs train
    the fewest batches of the hosts' caches."""
    (out0, err0), _ = _two_hosts(small_data, tmp_path, "--epochs", "2", "--wire-format",
                                 "compact", "--wire-cache", str(tmp_path / "wc"))
    for host in (0, 1):
        assert os.path.exists(tmp_path / "wc" / f"host-{host}-of-2" / "gen-0" / "meta.json")
    assert "wire cache built" in err0 and "multi-host delta wire" in err0
    assert _finite_results(out0)["train_steps"] > 0
