"""The portable export between the packages: a model the port trained loads
in the JAX package, and a model the JAX package exported loads in the port,
array for array; the port's `Scorer` serves what the port exported."""

import dataclasses
import json

import jax
import numpy as np
import torch

from two_tower_recommender_model_tpu import config as jax_config
from two_tower_recommender_model_tpu.train.step import create_train_state as jax_create
from two_tower_recommender_model_tpu.utils.checkpoint import export_model as jax_export
from two_tower_recommender_model_tpu.utils.checkpoint import load_model as jax_load
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.models.two_tower import params_to_numpy, score
from two_tower_recommender_model_tpu_torch.serving import load_scorer
from two_tower_recommender_model_tpu_torch.train import step as port_step
from two_tower_recommender_model_tpu_torch.utils.checkpoint import export_model, load_model


def _cfg(lib):
    cfg = lib.two_tower_model_config(300, 80, embedding_dim=16, layer_sizes=(32, 8),
                                     compute_dtype="bfloat16")
    return dataclasses.replace(cfg, fused_tower_backward="off")


def _flat(params):
    out = {f"tables/{k}": v for k, v in params["tables"].items()}
    for tower in ("query_tower", "candidate_tower"):
        for ln, layer in params[tower].items():
            for p, a in layer.items():
                out[f"{tower}/{ln}/{p}"] = np.asarray(a)
    return out


def test_port_export_loads_in_jax_and_serves_in_the_port(tmp_path):
    pcfg = _cfg(port_config)
    tcfg = port_config.TrainConfig(sparse_learning_rate=0.1)
    state, opt = port_step.create_train_state(torch.Generator().manual_seed(0), pcfg, tcfg)
    step = port_step.make_train_step(pcfg, tcfg, opt)
    ds = SyntheticClickstream(299, 79, seed=2)
    feat = Featurizer(pcfg, device="cpu")
    for cols in ds.batches(256, 3):
        state, _ = step(state, feat(cols))
    export_model(str(tmp_path), pcfg, state)
    jcfg, jparams = jax_load(str(tmp_path))
    assert jcfg == _cfg(jax_config)
    want = _flat(params_to_numpy(state.model))
    got = _flat(jparams)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    scorer = load_scorer(str(tmp_path), device="cpu")
    cols = ds.sample(50, split="serve")
    with torch.no_grad():
        direct = torch.sigmoid(score(state.model, feat(cols))).float().numpy()
    np.testing.assert_array_equal(scorer.predict(cols), direct)


def test_jax_export_loads_in_the_port(tmp_path):
    jcfg = _cfg(jax_config)
    state, _ = jax_create(jax.random.key(3), jcfg, jax_config.TrainConfig())
    jax_export(str(tmp_path), jcfg, state)
    pcfg, params = load_model(str(tmp_path))
    assert pcfg == _cfg(port_config)
    with open(tmp_path / "model_config.json") as f:
        assert json.load(f)["table_dtype"] is None
    want = _flat({"tables": state.tables, **state.dense_params})
    got = _flat(params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
