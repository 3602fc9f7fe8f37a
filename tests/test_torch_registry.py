"""The port's model registry (`utils.registry`): numbered versions, the stage
lifecycle, registration from a run, serving by stage
(`load_scorer_from_registry`), and a model the JAX package registered served
by the port."""

import jax
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu import config as jax_config
from two_tower_recommender_model_tpu.serving.scorer import (
    load_scorer_from_registry as jax_load_scorer_from_registry,
)
from two_tower_recommender_model_tpu.train.step import create_train_state as jax_create
from two_tower_recommender_model_tpu.utils.registry import ModelRegistry as JaxModelRegistry
from two_tower_recommender_model_tpu_torch import config as cfg_lib
from two_tower_recommender_model_tpu_torch.serving import load_scorer_from_registry
from two_tower_recommender_model_tpu_torch.train.step import create_train_state
from two_tower_recommender_model_tpu_torch.utils import registry as registry_lib
from two_tower_recommender_model_tpu_torch.utils.registry import (
    STAGES,
    ModelRegistry,
    register_from_run,
)
from two_tower_recommender_model_tpu_torch.utils.tracking import ExperimentLogger


@pytest.fixture
def setup(tmp_path):
    mcfg = cfg_lib.two_tower_model_config(num_users=20, num_items=10, embedding_dim=4,
                                          layer_sizes=(8, 4))
    state, _ = create_train_state(torch.Generator().manual_seed(0), mcfg, cfg_lib.TrainConfig())
    return ModelRegistry(str(tmp_path / "registry")), mcfg, state


def test_register_versions_and_stages(setup):
    reg, mcfg, state = setup
    v1 = reg.register("two_tower", mcfg, state, description="first")
    v2 = reg.register("two_tower", mcfg, state, description="second")
    assert (v1, v2) == (1, 2)
    assert reg.list_models() == ["two_tower"]
    assert reg.get_version("two_tower", "latest")["version"] == 2

    reg.set_stage("two_tower", 1, "Production")
    assert reg.get_version("two_tower", "Production")["version"] == 1
    # promoting v2 archives v1 (mlflow's archive_existing_versions)
    reg.set_stage("two_tower", 2, "Production")
    assert reg.get_version("two_tower", "Production")["version"] == 2
    assert reg.get_version("two_tower", 1)["stage"] == "Archived"

    cfg2, params = reg.load("two_tower", "Production")
    assert cfg2.tower_out_dim == mcfg.tower_out_dim
    np.testing.assert_array_equal(params["tables"]["t_user_id"],
                                  state.model.tables["t_user_id"].detach().numpy())

    with pytest.raises(ValueError):
        reg.set_stage("two_tower", 2, "NotAStage")
    with pytest.raises(FileNotFoundError):
        reg.get_version("two_tower", 99)

    reg.delete_version("two_tower", 1)
    with pytest.raises(FileNotFoundError):
        reg.get_version("two_tower", 1)


def test_register_from_run_carries_metrics(setup, tmp_path):
    reg, mcfg, state = setup
    logger = ExperimentLogger(str(tmp_path / "runs"))
    logger.log_params({"lr": 1e-3})
    logger.log_metrics({"val_auroc": 0.91, "note": "x"}, step=10)
    v = register_from_run(reg, "m", logger, mcfg, state, description="from run")
    e = reg.get_version("m", v)
    assert e["run_id"] == logger.run_id
    assert e["metrics"]["val_auroc"] == 0.91
    assert "note" not in e["metrics"]  # non-numeric values dropped


def test_serve_from_registry_by_stage(setup):
    reg, mcfg, state = setup
    v = reg.register("serveme", mcfg, state)
    reg.set_stage("serveme", v, "Production")
    scorer = load_scorer_from_registry(reg.root, "serveme", "Production", device="cpu")
    p = scorer.predict({"user_id": [1, 2], "product_id": [3, 4]})
    assert p.shape == (2,) and np.isfinite(p).all()
    with pytest.raises(FileNotFoundError, match="Staging"):
        load_scorer_from_registry(reg.root, "serveme", "Staging", device="cpu")


def test_stages_and_layout_match_the_reference(setup, tmp_path):
    """The same stages; a version the port registered reads in the JAX
    package's registry, array for array."""
    from two_tower_recommender_model_tpu.utils import registry as jax_registry

    assert STAGES == jax_registry.STAGES
    reg, mcfg, state = setup
    for name in ("register", "set_stage", "delete_version", "list_models", "versions",
                 "get_version", "model_dir", "load"):
        assert hasattr(registry_lib.ModelRegistry, name), name
    v = reg.register("m", mcfg, state)
    reg.set_stage("m", v, "Staging")
    jreg = JaxModelRegistry(reg.root)
    assert jreg.get_version("m", "Staging")["version"] == v
    _, jparams = jreg.load("m", "Staging")
    _, params = reg.load("m", "Staging")
    np.testing.assert_array_equal(jparams["tables"]["t_product_id"],
                                  params["tables"]["t_product_id"])


def test_a_model_the_jax_package_registered_serves_in_the_port(tmp_path):
    """The JAX package registers and promotes a model; the port's
    `load_scorer_from_registry` serves it by stage on the CPU, within 1e-6
    of the JAX package's own scorer."""
    jcfg = jax_config.two_tower_model_config(num_users=300, num_items=80, embedding_dim=16,
                                             layer_sizes=(32, 8))
    jstate, _ = jax_create(jax.random.key(3), jcfg, jax_config.TrainConfig())
    jreg = JaxModelRegistry(str(tmp_path / "registry"))
    jreg.register("jax_model", jcfg, jstate)
    v = jreg.register("jax_model", jcfg, jstate, description="promoted")
    jreg.set_stage("jax_model", v, "Production")

    rng = np.random.default_rng(5)
    inputs = {"user_id": rng.integers(0, 400, 64), "product_id": rng.integers(0, 100, 64)}
    inputs["user_id"][::7] = 0
    want = jax_load_scorer_from_registry(jreg.root, "jax_model").predict(inputs)
    scorer = load_scorer_from_registry(jreg.root, "jax_model", device="cpu")
    assert ModelRegistry(jreg.root).get_version("jax_model", "Production")["version"] == v
    np.testing.assert_allclose(scorer.predict(inputs), want, rtol=0, atol=1e-6)
