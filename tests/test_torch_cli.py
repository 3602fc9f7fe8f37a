"""The port's entry points (`cli/`): `prepare_instacart` writes what
`scripts/prepare_instacart.py` writes, byte for byte; `train` and
`evaluate_retrieval` run on the CPU with `--device cpu` and learn; `train`
checkpoints and resumes (a crashed run resumed equals an uninterrupted one
bit for bit); `evaluate_retrieval --per-user-table` writes a table that reads
back to the run's metrics; the pipeline runs end to end; the compact wire
and the wire cache train as the packed path does; every flag whose module is
not ported raises, naming its ROADMAP item."""

import dataclasses
import json
import os
import runpy
import sys
import time

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu.evaluation.retrieval import retrieval_metrics
from two_tower_recommender_model_tpu_torch import config as cfg_lib
from two_tower_recommender_model_tpu_torch.cli import (
    evaluate_retrieval,
    fetch_instacart,
    instacart_pipeline,
    prepare_instacart,
    train,
)
from two_tower_recommender_model_tpu_torch.train.resilient import resilient_fit
from two_tower_recommender_model_tpu_torch.utils.checkpoint import STATE_FILE, Checkpointer
from two_tower_recommender_model_tpu_torch.utils.tracking import latest_run, list_runs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_KEYS = {"baseline_val_loss", "baseline_val_auroc", "val_loss", "val_auroc", "train_steps",
              "train_examples", "train_loss", "examples_per_sec", "epoch_time_s", "test_loss",
              "test_auroc"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test steps are small, and the suite runs
    several test processes on the same cores, where torch's thread pools
    would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tree_bytes(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def csv_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("csv"))
    out = fetch_instacart.main(["--out", d, "--replica", "--replica-users", "300",
                                "--replica-products", "150", "--seed", "4"])
    assert out["generated"] and out["users"] == 300
    assert fetch_instacart.main(["--out", d])["generated"] is False  # present: kept
    return d


@pytest.fixture(scope="module")
def shards(csv_dir, tmp_path_factory):
    """Prepared shards, raw and pre-packed: {layout: (dir, meta)}."""
    out = {}
    for layout in ("raw", "packed"):
        d = str(tmp_path_factory.mktemp(layout))
        res = prepare_instacart.main(["--csv-dir", csv_dir, "--out", d, "--rows-per-shard",
                                      "4096"] + (["--packed"] if layout == "packed" else []))
        out[layout] = (d, res["meta"])
    return out


@pytest.mark.parametrize("extra", [[], ["--packed"], ["--max-users", "120", "--seed", "3"]],
                         ids=["raw", "packed", "max-users"])
def test_prepare_writes_what_the_reference_script_writes(csv_dir, tmp_path, monkeypatch, extra):
    """The same shard files, index.json, meta.json and id_mappings.npz, byte
    for byte (the clock is held still: an .npz's zip entries carry the time
    they were written)."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    common = ["--csv-dir", csv_dir, "--rows-per-shard", "3000"] + extra
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    monkeypatch.setattr(sys, "argv", ["prepare_instacart.py", "--out", str(tmp_path / "ref")]
                        + common)
    runpy.run_path(os.path.join(REPO, "scripts", "prepare_instacart.py"), run_name="__main__")
    prepare_instacart.main(["--out", str(tmp_path / "port")] + common)
    got, want = tree_bytes(tmp_path / "port"), tree_bytes(tmp_path / "ref")
    assert sorted(got) == sorted(want)
    assert {"meta.json", "id_mappings.npz", os.path.join("train", "index.json")} <= set(want)
    assert sum(f.endswith(".ttrs") for f in want) >= 4
    for name in want:
        assert got[name] == want[name], name


def train_argv(data_dir, meta, tmp_path, *extra):
    return ["--data-dir", data_dir, "--num-users", str(meta["num_users"]),
            "--num-items", str(meta["num_items"]), "--embedding-dim", "16",
            "--layer-sizes", "16", "8", "--batch-size", "256", "--sparse-learning-rate", "0.1",
            "--learning-rate", "0.003", "--runs-root", str(tmp_path / "runs"),
            "--device", "cpu", *extra]


def evaluate(model_dir, data_dir, tmp_path):
    return evaluate_retrieval.main(["--model-dir", model_dir, "--data-dir", data_dir,
                                    "--device", "cpu", "--json-out",
                                    str(tmp_path / "m.json")])


@pytest.mark.parametrize("layout", ["packed", "raw"])
def test_train_then_evaluate_beats_a_random_model(shards, tmp_path, layout):
    data_dir, meta = shards[layout]
    out = train.main(train_argv(data_dir, meta, tmp_path, "--epochs", "2", "--macro-batches", "4",
                                "--export-dir", str(tmp_path / "model")))
    assert set(out["metrics"]) == TRAIN_KEYS
    assert [e["train_steps"] for e in out["epochs"]] == [out["metrics"]["train_steps"]] * 2
    assert out["metrics"]["val_auroc"] > out["metrics"]["baseline_val_auroc"] + 0.1
    assert (out["captures"], out["replays"]) == (0, 0)  # CPU tensors: a plain loop
    trained = evaluate(str(tmp_path / "model"), data_dir, tmp_path)
    # the reference's metric names, computed by its own retrieval_metrics
    want_keys = set(retrieval_metrics(np.zeros((1, 100), np.int64), [[1]], ks=(10, 100)))
    assert set(trained) == want_keys | {"num_users"}
    assert json.loads((tmp_path / "m.json").read_text()) == trained

    train.main(train_argv(data_dir, meta, tmp_path, "--epochs", "0",
                          "--export-dir", str(tmp_path / "random")))
    untrained = evaluate(str(tmp_path / "random"), data_dir, tmp_path)
    assert trained["num_users"] == untrained["num_users"] > 250
    assert trained["recall_at_100"] > untrained["recall_at_100"] + 0.05

    runs = list_runs(str(tmp_path / "runs"))
    assert len(runs) == 2
    first = latest_run(str(tmp_path / "runs"))
    assert first.params["device_kind"] == "cpu" and first.params["embedding_dim"] == 16


def test_no_packed_per_batch_route(shards, tmp_path):
    data_dir, meta = shards["raw"]
    out = train.main(train_argv(data_dir, meta, tmp_path, "--epochs", "1", "--no-packed",
                                "--limit-train-batches", "8", "--limit-val-batches", "2"))
    assert out["epochs"][0]["train_steps"] == 8
    with pytest.raises(SystemExit, match="PRE-PACKED"):
        train.main(train_argv(*shards["packed"], tmp_path, "--no-packed"))
    with pytest.raises(SystemExit, match="packed path"):
        train.main(train_argv(data_dir, meta, tmp_path, "--no-packed",
                              "--sorted-feature", "user_id"))


def test_select_best_on_recall_with_the_sampled_softmax(shards, tmp_path):
    data_dir, meta = shards["packed"]
    out = train.main(train_argv(data_dir, meta, tmp_path, "--epochs", "2", "--loss",
                                "sampled_softmax", "--select-best", "val_recall_at_100",
                                "--retrieval-eval-users", "100", "--compute-dtype",
                                "bfloat16", "--table-dtype", "bfloat16",
                                "--validation-freq", "5", "--macro-batches", "3"))
    m = out["metrics"]
    assert m["best_epoch"] in (0.0, 1.0) and 0 <= m["val_recall_at_100"] <= 1
    assert "baseline_val_recall_at_100" in m


def test_block_sorted_kernel_auto():
    cfg = cfg_lib.two_tower_model_config(100, 50, embedding_dim=8, layer_sizes=(8, 4))
    assert train.block_sorted_kernel_auto(cfg, "user_id", "bfloat16") == "bfloat16"
    assert train.block_sorted_kernel_auto(cfg, None, "float32") == "float32"
    bf16 = dataclasses.replace(cfg, table_dtype="bfloat16")
    assert train.block_sorted_kernel_auto(bf16, "user_id", "bfloat16") == "off"
    assert train.block_sorted_kernel_auto(bf16, None, "bfloat16") == "bfloat16"


@pytest.mark.parametrize("flags,item", [
    (["--multi-host"], "M12"), (["--sharded-exchange", "alltoall"], "M12"),
    (["--exchange-capacity-factor", "1.5"], "M12"),
    (["--exchange-wire-dtype", "bfloat16"], "M12"), (["--wire-cache", "somewhere"], "M12"),
])
def test_unported_train_flags_raise(flags, item, monkeypatch):
    """On a mesh of two ranks every flag of M12 is ported: each passes and
    reaches the process group's start, which raises here (it needs
    torchrun's rendezvous); none names a ROADMAP item any more."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="rendezvous"):
        train.main(["--data-dir", "nowhere", "--num-users", "10", "--num-items", "10",
                    "--device", "cpu", *flags])
    del item  # every part of M12 is ported


def test_mesh_only_flags_need_a_mesh(monkeypatch):
    """`--wire-format compact` on a mesh passes and reaches the process
    group's start; `--mesh-model` above 1 without torchrun's ranks is
    refused; `--batch-size` must split over a host's ranks."""
    argv = ["--data-dir", "nowhere", "--num-users", "10", "--num-items", "10", "--device", "cpu"]
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="rendezvous"):
        train.main(argv + ["--wire-format", "compact"])
    with pytest.raises(SystemExit, match="divisible by 2 ranks"):
        train.main(argv + ["--batch-size", "5"])
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(SystemExit, match="mesh"):
        train.main(argv + ["--mesh-model", "2"])


def _last_state(directory):
    return _final_checkpoint(directory)["tensors"]


def _assert_states_equal(got, want):
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert torch.equal(got[name], t), name


@pytest.mark.parametrize("layout", ["packed", "raw"])
def test_wire_format_compact_trains_as_packed(shards, tmp_path, layout):
    """`--wire-format compact` (the sorted user slot delta-encoded) ends in the
    training state of `--wire-format packed`, bit for bit, on pre-packed and
    on raw shards."""
    data_dir, meta = shards[layout]
    runs = {}
    for wire in ("packed", "compact"):
        out = train.main(train_argv(data_dir, meta, tmp_path, "--epochs", "2", "--macro-batches",
                                    "3", "--wire-format", wire, "--checkpoint-dir",
                                    str(tmp_path / wire)))
        assert out["wire_format"] == wire and out["wire_cache"] is None
        runs[wire] = out
    _assert_states_equal(_last_state(str(tmp_path / "compact")),
                         _last_state(str(tmp_path / "packed")))
    for k in ("train_loss", "val_auroc", "test_auroc", "test_loss"):
        assert runs["compact"]["metrics"][k] == runs["packed"]["metrics"][k], k


def test_wire_format_auto_is_compact_at_a_batch_multiple_of_8(shards, tmp_path):
    """`auto` ships the compact wire when the batch size is a multiple of 8
    (the reference's rule for one device), else the packed one; the per-batch
    route has no wire."""
    data_dir, meta = shards["packed"]
    for batch, want in (("256", "compact"), ("252", "packed")):
        out = train.main(train_argv(data_dir, meta, tmp_path, "--epochs", "1", "--batch-size",
                                    batch, "--limit-train-batches", "4"))
        assert out["wire_format"] == want, batch
    raw_dir, raw_meta = shards["raw"]
    out = train.main(train_argv(raw_dir, raw_meta, tmp_path, "--epochs", "1", "--no-packed",
                                "--limit-train-batches", "2", "--limit-val-batches", "1"))
    assert out["wire_format"] is None


def test_wire_cache_trains_as_the_dynamic_path_and_is_reused(shards, tmp_path):
    """`--wire-cache DIR`: the first run builds DIR/gen-0 and trains 3 epochs
    from it (epoch 0 in the loader's order, then rotations); a second run
    reuses the cache without building and ends in the same state bit for
    bit. One epoch through a fresh cache equals one epoch of the dynamic
    path (no cache), bit for bit."""
    data_dir, meta = shards["packed"]
    wc = str(tmp_path / "wc")

    def run(name, *extra):
        return train.main(train_argv(data_dir, meta, tmp_path, "--macro-batches", "3",
                                     "--checkpoint-dir", str(tmp_path / name), *extra))

    first = run("first", "--epochs", "3", "--wire-cache", wc)
    (gen,) = first["wire_cache"]
    assert gen["built"] and gen["dir"] == os.path.join(wc, "gen-0") and gen["bytes"] > 0
    assert gen["num_batches"] == first["metrics"]["train_steps"] and gen["build_seconds"] > 0
    assert json.load(open(os.path.join(wc, "gen-0", "meta.json")))["fingerprint"]["data_dir"] \
        == os.path.abspath(data_dir)
    again = run("again", "--epochs", "3", "--wire-cache", wc)
    assert not again["wire_cache"][0]["built"] and again["wire_cache"][0]["build_seconds"] == 0
    _assert_states_equal(_last_state(str(tmp_path / "again")), _last_state(str(tmp_path / "first")))
    cached = run("cached", "--epochs", "1", "--wire-cache", str(tmp_path / "wc1"))
    dynamic = run("dynamic", "--epochs", "1")
    assert cached["metrics"]["train_steps"] == dynamic["metrics"]["train_steps"]
    _assert_states_equal(_last_state(str(tmp_path / "cached")),
                         _last_state(str(tmp_path / "dynamic")))


@pytest.mark.parametrize("order", ["loader", "rotate", "shuffle"])
def test_wire_cache_order_trains(shards, tmp_path, order):
    """Each `--wire-cache-order` trains the cache's batches and learns; only
    "loader" keeps the build's order, so only it ends where two epochs of
    the dynamic path end."""
    data_dir, meta = shards["packed"]
    out = train.main(train_argv(data_dir, meta, tmp_path, "--epochs", "2", "--macro-batches",
                                "3", "--wire-cache", str(tmp_path / "wc"), "--wire-cache-order",
                                order, "--checkpoint-dir", str(tmp_path / order)))
    m = out["metrics"]
    assert m["train_steps"] == out["wire_cache"][0]["num_batches"]
    assert m["val_auroc"] > m["baseline_val_auroc"] + 0.05
    loader = train.main(train_argv(data_dir, meta, tmp_path, "--epochs", "2", "--macro-batches",
                                   "3", "--wire-cache", str(tmp_path / "wc"), "--wire-cache-order",
                                   "loader", "--checkpoint-dir", str(tmp_path / "ref")))
    same = all(torch.equal(a, b) for a, b in zip(_last_state(str(tmp_path / order)).values(),
                                                 _last_state(str(tmp_path / "ref")).values()))
    assert same == (order == "loader")
    assert loader["wire_cache"][0]["built"] is False


def test_wire_cache_generations_build_one_cache_each(shards, tmp_path):
    """`--wire-cache-generations 2` builds gen-0 and gen-1 from the loader's
    epochs 0 and 1 (different row shuffles, so different bytes) and trains
    epoch e from gen-(e % 2): two fresh generations in the loader's order,
    then a rotation of gen-0."""
    data_dir, meta = shards["packed"]
    wc = tmp_path / "wc"
    out = train.main(train_argv(data_dir, meta, tmp_path, "--epochs", "3", "--macro-batches", "3",
                                "--wire-cache", str(wc), "--wire-cache-generations", "2"))
    assert [g["dir"] for g in out["wire_cache"]] == [str(wc / "gen-0"), str(wc / "gen-1")]
    assert all(g["built"] for g in out["wire_cache"])
    assert (wc / "gen-0" / "wire.bin").read_bytes() != (wc / "gen-1" / "wire.bin").read_bytes()
    assert [e["train_steps"] for e in out["epochs"]] == [out["wire_cache"][0]["num_batches"]] * 3
    assert out["metrics"]["val_auroc"] > out["metrics"]["baseline_val_auroc"] + 0.05


def test_wire_cache_refusals(shards, tmp_path):
    """The reference's refusals: a wire cache needs the packed path and the
    compact wire; the compact wire needs the packed path; a cache built at
    another batch size is stale and must be rebuilt."""
    data_dir, meta = shards["packed"]
    raw_dir, raw_meta = shards["raw"]
    wc = str(tmp_path / "wc")
    with pytest.raises(SystemExit, match="compact wire format"):
        train.main(train_argv(data_dir, meta, tmp_path, "--wire-cache", wc, "--wire-format",
                              "packed"))
    with pytest.raises(SystemExit, match="packed path"):
        train.main(train_argv(raw_dir, raw_meta, tmp_path, "--wire-cache", wc, "--no-packed"))
    with pytest.raises(SystemExit, match="packed path"):
        train.main(train_argv(raw_dir, raw_meta, tmp_path, "--wire-format", "compact",
                              "--no-packed"))
    train.main(train_argv(data_dir, meta, tmp_path, "--epochs", "0", "--wire-cache", wc))
    with pytest.raises(SystemExit, match="batch_size=256.*rebuild"):
        train.main(train_argv(data_dir, meta, tmp_path, "--epochs", "0", "--wire-cache", wc,
                              "--batch-size", "128"))


def test_a_crash_resumes_through_the_wire_cache(shards, tmp_path, monkeypatch):
    """A run through the wire cache crashed after epoch 0's checkpoint and
    restarted with --resume (which reuses the cache it built) ends in the
    uninterrupted run's state, bit for bit."""
    data_dir, meta = shards["packed"]

    def argv(name, *extra):
        return train_argv(data_dir, meta, tmp_path, "--epochs", "3", "--macro-batches", "4",
                          "--wire-cache", str(tmp_path / f"wc-{name}"), "--checkpoint-dir",
                          str(tmp_path / name), *extra)

    whole = train.main(argv("whole"))

    class CrashAfterEpoch0(Checkpointer):
        def save(self, step, state, loader_state=None, extra=None, wait=False):
            super().save(step, state, loader_state, extra, wait)
            if extra["completed_epoch"] == 0:
                raise OSError("injected crash after epoch 0's checkpoint")

    def attempt(restart):
        if restart == 0:
            with monkeypatch.context() as m:
                m.setattr(train, "Checkpointer", CrashAfterEpoch0)
                return train.main(argv("crashed"))
        return train.main(argv("crashed", "--resume"))

    out = resilient_fit(attempt, max_restarts=1, backoff_s=0.0)
    assert out["restarts"] == 1 and out["resumed_from"] == whole["metrics"]["train_steps"]
    assert out["wire_cache"][0]["built"] is False  # the restart reuses the first attempt's
    _assert_states_equal(_last_state(str(tmp_path / "crashed")), _last_state(str(tmp_path /
                                                                                   "whole")))


def test_pipeline_wire_cache_flag_trains(csv_dir, tmp_path):
    """`instacart_pipeline --wire-cache` (without --fast) trains through a
    cache under <work>/wirecache, which the pipeline's `--fast` also turns
    on."""
    work = tmp_path / "work"
    out = instacart_pipeline.main(["--work", str(work), "--csv-dir", csv_dir, "--packed",
                                   "--wire-cache", "--device", "cpu", "--epochs", "1",
                                   "--batch-size", "512", "--macro-batches", "4"])
    (gen,) = out["train"]["wire_cache"]
    assert gen["dir"] == str(work / "wirecache" / "gen-0") and gen["built"]
    assert out["train"]["wire_format"] == "compact"
    assert out["train"]["epochs"][0]["train_steps"] == gen["num_batches"] > 0
    assert 0 < out["retrieval"]["recall_at_100"] <= 1
    args = instacart_pipeline.argparse.Namespace(wire_cache=False, packed=False,
                                                 sorted_feature=None, block_sorted_kernel=None,
                                                 compute_dtype=None)
    instacart_pipeline.apply_fast_preset(args)
    assert args.wire_cache and args.packed


def test_entry_points_take_the_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: train.main(["--data-dir", "d", "--num-users", "10",
                                     "--num-items", "10"]),
                 lambda: evaluate_retrieval.main(["--model-dir", "m", "--data-dir", "d"]),
                 lambda: instacart_pipeline.main(["--work", str(tmp_path / "w"), "--smoke"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "w").exists()  # refused before any stage ran


def test_pipeline_end_to_end_on_the_cpu(csv_dir, tmp_path):
    work = str(tmp_path / "work")
    out = instacart_pipeline.main(["--work", work, "--csv-dir", csv_dir, "--fast",
                                   "--device", "cpu", "--epochs", "1", "--batch-size", "512",
                                   "--macro-batches", "4"])
    assert set(out["seconds"]) == {"prepare", "train", "retrieval"}
    meta = out["prepare"]["meta"]
    assert meta["distinct_users"] == 300 and meta["num_items"] == meta["distinct_items"] + 1
    assert json.load(open(os.path.join(work, "shards", "train", "index.json")))["packed"]
    assert out["train"]["epochs"][0]["train_steps"] > 0
    assert out["retrieval"]["num_users"] > 250 and 0 < out["retrieval"]["recall_at_100"] <= 1
    assert os.path.exists(os.path.join(work, "model", "params.npz"))
    # --fast trains through the wire cache, on the compact wire
    assert out["train"]["wire_format"] == "compact" and out["train"]["wire_cache"][0]["built"]


def _final_checkpoint(directory):
    ckpt = Checkpointer(directory)
    return torch.load(os.path.join(ckpt.step_dir(ckpt.latest_step()), STATE_FILE),
                      weights_only=True)


def test_resume_after_the_last_epoch_trains_none(shards, tmp_path):
    data_dir, meta = shards["packed"]
    ck = str(tmp_path / "ck")
    first = train.main(train_argv(data_dir, meta, tmp_path, "--epochs", "2", "--macro-batches",
                                  "4", "--checkpoint-dir", ck))
    assert first["resumed_from"] is None and first["restore_seconds"] is None
    saves = first["checkpoints"]
    steps = first["metrics"]["train_steps"]
    assert [(c["step"], c["epoch"]) for c in saves] == [(steps, 0), (2 * steps, 1)]
    assert all(c["bytes"] > 0 and c["seconds"] >= 0 for c in saves)
    again = train.main(train_argv(data_dir, meta, tmp_path, "--epochs", "2", "--macro-batches",
                                  "4", "--checkpoint-dir", ck, "--resume"))
    assert again["resumed_from"] == 2 * steps and again["epochs"] == [] == again["checkpoints"]
    assert again["restore_seconds"] >= 0
    assert again["metrics"]["test_auroc"] == first["metrics"]["test_auroc"]
    # --resume with nothing to resume from starts from scratch
    fresh = train.main(train_argv(data_dir, meta, tmp_path, "--epochs", "1", "--checkpoint-dir",
                                  str(tmp_path / "empty"), "--resume"))
    assert fresh["resumed_from"] is None and len(fresh["epochs"]) == 1


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
def test_a_crash_after_epoch_0_resumes_to_the_uninterrupted_run(shards, tmp_path, monkeypatch,
                                                                table_dtype):
    """An OSError right after epoch 0's checkpoint; `resilient_fit` restarts
    the run with --resume, which trains epochs 1 and 2. The last checkpoint
    (the whole training state) equals an uninterrupted run's bit for bit."""
    data_dir, meta = shards["packed"]

    def argv(ck, *extra):
        return train_argv(data_dir, meta, tmp_path, "--epochs", "3", "--macro-batches", "4",
                          "--table-dtype", table_dtype, "--checkpoint-dir", ck, *extra)

    whole = train.main(argv(str(tmp_path / "whole")))

    class CrashAfterEpoch0(Checkpointer):
        def save(self, step, state, loader_state=None, extra=None, wait=False):
            super().save(step, state, loader_state, extra, wait)
            if extra["completed_epoch"] == 0:
                raise OSError("injected crash after epoch 0's checkpoint")

    def attempt(restart):
        if restart == 0:
            with monkeypatch.context() as m:
                m.setattr(train, "Checkpointer", CrashAfterEpoch0)
                return train.main(argv(str(tmp_path / "crashed")))
        return train.main(argv(str(tmp_path / "crashed"), "--resume"))

    out = resilient_fit(attempt, max_restarts=1, backoff_s=0.0)
    steps = whole["metrics"]["train_steps"]
    assert out["restarts"] == 1 and out["resumed_from"] == steps
    assert len(out["epochs"]) == 2 and [c["epoch"] for c in out["checkpoints"]] == [1, 2]
    got, want = _final_checkpoint(str(tmp_path / "crashed")), _final_checkpoint(
        str(tmp_path / "whole"))
    assert got["step"] == want["step"] == 3 * steps
    assert got["tensors"].keys() == want["tensors"].keys()
    for name, t in want["tensors"].items():
        assert torch.equal(got["tensors"][name], t), name
    assert out["metrics"]["test_auroc"] == whole["metrics"]["test_auroc"]


def test_per_user_table_reads_back_to_the_run_metrics(shards, tmp_path):
    import pandas as pd

    data_dir, meta = shards["packed"]
    train.main(train_argv(data_dir, meta, tmp_path, "--epochs", "1", "--export-dir",
                          str(tmp_path / "model")))
    table = str(tmp_path / "users.csv")
    metrics = evaluate_retrieval.main(["--model-dir", str(tmp_path / "model"), "--data-dir",
                                       data_dir, "--device", "cpu", "--per-user-table", table])
    df = pd.read_csv(table)
    assert len(df) == metrics["num_users"] > 250
    assert list(df.columns[:3]) == ["user_id", "product_id_list", "product_id_pred"]
    assert df["user_id"].is_monotonic_increasing
    for name in ("recall_at_100", "ndcg_at_100", "mrr"):
        assert abs(df[name].mean() - metrics[name]) <= 1e-6, name


def test_full_scale_quality_tool_runs_at_a_small_scale(tmp_path):
    """The full-scale quality tool's whole path at 300 users on the CPU: the
    replica, the packed shards, the BCE run with its checkpoints, the
    retrieval eval, and its JSON record. The run's own directory inside
    `--work` is removed after, and what was there before is left alone."""
    from two_tower_recommender_model_tpu_torch.tools import full_scale_quality

    work, record = tmp_path / "work", tmp_path / "out" / "full_scale.json"
    work.mkdir()
    (work / "keep.txt").write_text("not the tool's")
    out = full_scale_quality.main(["--work", str(work), "--users", "300", "--products", "150",
                                   "--runs", "bce", "--device", "cpu", "--json-out", str(record)])
    assert [p.name for p in work.iterdir()] == ["keep.txt"]
    assert json.loads(record.read_text()) == out
    run = out["runs"]["bce"]
    assert set(out["seconds"]) == {"fetch", "prepare"} and out["rows"]["train"] > 16384
    assert [c["epoch"] for c in run["checkpoints"]] == [0, 1, 2]
    assert all(c["bytes"] > 0 for c in run["checkpoints"])
    assert len(run["epochs"]) == 3 and run["epochs"][0]["train_steps"] >= 1
    assert run["retrieval"]["num_users"] > 250 and 0 < run["retrieval"]["recall_at_100"] <= 1
    assert 0 <= run["val_auroc"] <= 1


def test_full_scale_quality_tool_runs_bce_through_a_wire_cache(tmp_path):
    """The tool's "bce-wirecache" run at 300 users on the CPU: the "bce"
    flags through a wire cache of one generation built in the run (its build
    seconds and bytes in the record), 3 epochs of the cache's batches."""
    from two_tower_recommender_model_tpu_torch.tools import full_scale_quality

    out = full_scale_quality.main(["--work", str(tmp_path / "work"), "--users", "300",
                                   "--products", "150", "--runs", "bce-wirecache", "--device",
                                   "cpu"])
    run = out["runs"]["bce-wirecache"]
    (gen,) = run["wire_cache"]
    assert run["wire_format"] == "compact" and gen["built"] and gen["bytes"] > 0
    assert [e["train_steps"] for e in run["epochs"]] == [gen["num_batches"]] * 3
    assert run["retrieval"]["num_users"] > 250 and 0 < run["retrieval"]["recall_at_100"] <= 1


def test_full_scale_quality_tool_keeps_a_failed_runs_checkpoints(tmp_path, monkeypatch):
    """A run that fails after training keeps its directory (shards,
    checkpoints, export), so `cli.train --resume` can pick it up; nothing
    else in `--work` is touched."""
    from two_tower_recommender_model_tpu_torch.cli import evaluate_retrieval
    from two_tower_recommender_model_tpu_torch.tools import full_scale_quality
    from two_tower_recommender_model_tpu_torch.utils import Checkpointer

    def fail(argv):
        raise OSError("eval host lost")

    monkeypatch.setattr(evaluate_retrieval, "main", fail)
    work = tmp_path / "work"
    with pytest.raises(OSError, match="eval host lost"):
        full_scale_quality.main(["--work", str(work), "--users", "300", "--products", "150",
                                 "--runs", "bce", "--device", "cpu"])
    (kept,) = work.iterdir()
    assert kept.name.startswith("full_scale_")
    assert (kept / "shards").is_dir() and (kept / "bce" / "model").is_dir()
    assert Checkpointer(str(kept / "bce" / "ckpt")).latest_step() is not None
