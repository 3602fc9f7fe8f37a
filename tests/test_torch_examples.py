"""The port's examples (`two_tower_recommender_model_tpu_torch/examples/`)
run end to end on the CPU at tiny sizes, through their `main` functions, and
their command lines parse."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu_torch.examples import (
    end_to_end_instacart_style,
    full_scale_synthetic,
    sweep_example,
    text_side_features,
    tune_retrieval_smoke,
    workshop_ratings_style,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_end_to_end_instacart_style(tmp_path):
    out = end_to_end_instacart_style.main(str(tmp_path), "cpu", num_users=300, num_items=120,
                                          rows=12_000, epochs=2)
    for key in ("baseline_val_auroc", "val_auroc", "test_auroc", "recall_at_10",
                "recall_at_100"):
        assert np.isfinite(out[key]), key
    assert out["test_auroc"] > 0.55 and out["recall_at_100"] > 0.3
    assert (tmp_path / "model" / "model_config.json").exists()
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir() if p.name.isdigit())


def test_full_scale_synthetic_at_a_cut_scale(tmp_path):
    out = full_scale_synthetic.main(str(tmp_path), "cpu", num_users=400, num_items=120,
                                    rows=30_000, epochs=1, batch_size=1024, macro=2)
    assert out["train_examples"] > 0 and out["val_auroc"] > 0.55
    assert out["num_users"] > 0 and out["recall_at_100"] > 0.1


def test_first_pairs_keeps_the_first_occurrence():
    cols = {"user_id": np.array([1, 1, 2, 1, 2]), "product_id": np.array([5, 5, 5, 6, 5]),
            "label": np.array([1, 0, 1, 1, 0])}
    got = full_scale_synthetic.first_pairs(cols)
    np.testing.assert_array_equal(got["user_id"], [1, 2, 1])
    np.testing.assert_array_equal(got["label"], [1, 1, 1])


def test_sweep_example():
    out = sweep_example.main("cpu", num_trials=3, users=120, items=60, batches=12, seeds=2)
    assert np.isfinite(out["best"]["val_loss"]) and out["asha_resource"] > 0
    ms = out["multi_seed"]
    assert ms["eval_auroc"].shape == (2,) and np.isfinite(ms["final_train_loss"]).all()


@pytest.mark.parametrize("source", ["ngrams", "npz", "parquet"])
def test_text_side_features(tmp_path, source):
    path = None
    if source != "ngrams":
        from two_tower_recommender_model_tpu_torch.data.text_features import (
            embed_text,
            save_precomputed_embeddings,
        )

        path = str(tmp_path / f"emb.{source}")
        save_precomputed_embeddings(path, np.arange(1, 121),
                                    embed_text([f"organic product {i} pack"
                                                for i in range(1, 121)], dim=16))
    out = text_side_features.main(num_users=300, num_items=120, text_dim=16, steps=40,
                                  precomputed_path=path, device="cpu")
    assert np.isfinite(out["loss"]) and out["num_users"] == 300
    assert out["recall_at_10"] > 10 / 120  # above a random ranking


def test_tune_retrieval_smoke(tmp_path):
    res, test_m = tune_retrieval_smoke.main(str(tmp_path), "cpu", num_trials=2, users=200,
                                            products=100, epochs=1, batch_size=512, macro=2)
    assert len(res.completed()) == 2
    assert 0.0 < res.best().metrics["recall_at_100"] <= 1.0
    assert 0.0 < test_m["recall_at_100"] <= 1.0
    # the shards are built once a work directory
    assert (tmp_path / "shards" / "meta.json").exists()
    shards, meta = tune_retrieval_smoke.prepare_smoke(str(tmp_path), 200, 100)
    assert meta["distinct_users"] == 200


def test_workshop_ratings_style():
    out = workshop_ratings_style.main("cpu", train_batches=60)
    assert out["test_auroc"] > 0.6
    assert len(out["predictions"]) == 2 and all(0.0 < p < 1.0 for p in out["predictions"])


@pytest.mark.parametrize("name", ["end_to_end_instacart_style", "full_scale_synthetic",
                                  "sweep_example", "text_side_features", "tune_retrieval_smoke",
                                  "workshop_ratings_style"])
def test_the_command_line_parses(name):
    proc = subprocess.run([sys.executable, "-m",
                           f"two_tower_recommender_model_tpu_torch.examples.{name}", "--help"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout
