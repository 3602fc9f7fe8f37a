"""The port's device default: an entry point that takes a `device` runs on
the card when given none, and where there is no card it raises and says to
pass `device="cpu"`; it never lands on the CPU on its own. This file imports
no JAX, so the `cuda`-marked half runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_device_default.py
"""

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu_torch import config as cfg_lib
from two_tower_recommender_model_tpu_torch import default_device
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.device import resolve_device
from two_tower_recommender_model_tpu_torch.models import metrics
from two_tower_recommender_model_tpu_torch.models.mlp import MLP
from two_tower_recommender_model_tpu_torch.models.two_tower import (
    TwoTower,
    init_params,
    params_from_numpy,
    params_to_numpy,
)
from two_tower_recommender_model_tpu_torch.serving.scorer import load_scorer
from two_tower_recommender_model_tpu_torch.train.pipeline import prefetch_to_device
from two_tower_recommender_model_tpu_torch.train.step import TrainState, eval_state_init
from two_tower_recommender_model_tpu_torch.utils.checkpoint import export_model

CFG = cfg_lib.two_tower_model_config(50, 40, embedding_dim=8, layer_sizes=(8, 4))
COLS = {"user_id": np.arange(1, 9), "product_id": np.arange(1, 9), "label": np.ones(8)}


def _cpu_model():
    return init_params(CFG, torch.Generator().manual_seed(0))


def _exported(tmp_path):
    export_model(str(tmp_path), CFG, TrainState(0, _cpu_model(), {}, None))
    return str(tmp_path)


ENTRY_POINTS = {  # name -> call(device keyword arguments, tmp_path) -> a tensor it made
    "load_scorer": lambda kw, tmp: next(iter(
        load_scorer(_exported(tmp), **kw).model.tables.values())),
    "params_from_numpy": lambda kw, tmp: next(iter(
        params_from_numpy(params_to_numpy(_cpu_model()), CFG, **kw).tables.values())),
    "TwoTower": lambda kw, tmp: next(iter(TwoTower(CFG, **kw).tables.values())),
    "Featurizer": lambda kw, tmp: Featurizer(CFG, **kw)(COLS).labels,
    "prefetch_to_device": lambda kw, tmp: next(iter(prefetch_to_device(
        iter([COLS]), Featurizer(CFG, device="cpu"), **kw))).labels,
    "eval_state_init": lambda kw, tmp: eval_state_init(**kw).loss.total,
    "auroc_init": lambda kw, tmp: metrics.auroc_init(**kw).pos,
    "mean_init": lambda kw, tmp: metrics.mean_init(**kw).count,
    "MLP": lambda kw, tmp: next(MLP(8, (8, 4), **kw).parameters()),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_without_a_device_raises_where_there_is_no_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("there is a card: the entry point lands on it (the cuda-marked test)")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]({}, tmp_path)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_without_a_device_lands_on_the_card(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert default_device().type == "cuda"
    assert ENTRY_POINTS[name]({}, tmp_path).device.type == "cuda"


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_takes_the_cpu_when_asked(name, tmp_path):
    assert ENTRY_POINTS[name]({"device": "cpu"}, tmp_path).device.type == "cpu"


def test_default_device_never_returns_the_cpu():
    if torch.cuda.is_available():
        assert default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default_device()
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"


def test_generator_driven_entry_points_follow_the_generator():
    assert _cpu_model().device.type == "cpu"
