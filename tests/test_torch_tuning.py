"""The port's hyperparameter search against the JAX package's: the space
primitives, random / grid / TPE sweeps and ASHA give the reference's
configurations, results and order for the same seeds; failures are recorded;
a sweep runs its trials in two spawned worker processes; and
`multi_seed_train`, started from the JAX package's states, trains each seed
as the reference does."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu import config as jax_config
from two_tower_recommender_model_tpu.data import SyntheticClickstream as JaxClickstream
from two_tower_recommender_model_tpu.train import step as jax_step
from two_tower_recommender_model_tpu.tuning import adaptive as jax_adaptive
from two_tower_recommender_model_tpu.tuning import multi_seed as jax_multi_seed
from two_tower_recommender_model_tpu.tuning import sweep as jax_sweep
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch import tuning as port_tuning
from two_tower_recommender_model_tpu_torch.data import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.train import step as port_step
from two_tower_recommender_model_tpu_torch.tuning import adaptive as port_adaptive
from two_tower_recommender_model_tpu_torch.tuning import multi_seed as port_multi_seed
from two_tower_recommender_model_tpu_torch.tuning import sweep as port_sweep
from two_tower_recommender_model_tpu_torch.utils.tracking import list_runs

import torch_tuning_trials


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _space(lib):
    return {
        "layer_sizes": lib.Choice(((128, 64), (128, 64, 32))),
        "mlp_lr": lib.LogUniform(1e-4, 1e-2),
        "dropout": lib.Uniform(0.0, 0.5),
        "batch_size": lib.Choice((128, 256)),
        "fixed": "constant",
    }


def _objective(cfg):
    """Minimum near lr = 0.03, width = 0.5, arch "b" (the reference tests')."""
    val = ((np.log10(cfg["lr"]) - np.log10(0.03)) ** 2 + (cfg["width"] - 0.5) ** 2
           + (0.0 if cfg["arch"] == "b" else 0.6))
    return {"val_loss": float(val)}


def _adaptive_space(lib):
    return {"lr": lib.LogUniform(1e-4, 1.0), "width": lib.Uniform(-2.0, 2.0),
            "arch": lib.Choice(("a", "b", "c"))}


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_space_sampling_matches_jax(seed):
    for i in range(5):
        rng = np.random.SeedSequence([seed, i])
        assert (port_sweep.sample_space(_space(port_sweep), np.random.default_rng(rng))
                == jax_sweep.sample_space(_space(jax_sweep), np.random.default_rng(rng)))
    assert (port_sweep.grid_space(_space(port_sweep))
            == jax_sweep.grid_space(_space(jax_sweep)))
    assert port_sweep.LogUniform(1e-3, 1.0).grid(4) == jax_sweep.LogUniform(1e-3, 1.0).grid(4)
    assert port_sweep.Uniform(-1.0, 2.0).grid() == jax_sweep.Uniform(-1.0, 2.0).grid()


def _trials(res):
    return [(t.index, t.config, t.metrics, t.error) for t in res.trials]


@pytest.mark.parametrize("search,num_trials", [("random", 12), ("grid", None), ("grid", 3),
                                               ("tpe", 14)])
def test_sweeps_match_jax(search, num_trials):
    lib_results = []
    for lib in (port_sweep, jax_sweep):
        res = lib.run_sweep(_objective, _adaptive_space(lib), num_trials=num_trials,
                            metric="val_loss", seed=3, search=search)
        lib_results.append(res)
    port, ref = lib_results
    assert _trials(port) == _trials(ref)
    assert [t.index for t in port.ranked()] == [t.index for t in ref.ranked()]
    assert port.best().config == ref.best().config
    assert port.table() == ref.table()


def test_tpe_suggestions_match_jax():
    """The same observations in the same order give the same suggestions."""
    samplers = [port_adaptive.TPESampler(_adaptive_space(port_sweep), seed=5, n_startup=3),
                jax_adaptive.TPESampler(_adaptive_space(jax_sweep), seed=5, n_startup=3)]
    for _ in range(15):
        cfgs = [s.suggest() for s in samplers]
        assert cfgs[0] == cfgs[1]
        for s in samplers:
            s.observe(cfgs[0], _objective(cfgs[0])["val_loss"])


def test_failures_are_recorded_and_logged(tmp_path):
    for lib, root in ((port_sweep, tmp_path / "port"), (jax_sweep, tmp_path / "jax")):
        res = lib.run_sweep(torch_tuning_trials.failing_trial, {"x": lib.Uniform(0, 1)},
                            num_trials=10, seed=3, logger_root=str(root))
        failed = [t for t in res.trials if t.error]
        assert failed and len(res.completed()) + len(failed) == 10
        assert "FAILED" in res.table()
        assert len(list_runs(str(root))) == 10
    with pytest.raises(RuntimeError, match="boom"):
        port_sweep.run_sweep(torch_tuning_trials.failing_trial, {"x": port_sweep.Uniform(0, 1)},
                             num_trials=10, seed=3, raise_on_failure=True)
    with pytest.raises(ValueError, match="num_trials"):
        port_sweep.run_sweep(_objective, _adaptive_space(port_sweep))


def test_sweep_mode_max_and_reproducible():
    res = port_sweep.run_sweep(lambda c: {"auroc": c["x"]}, {"x": port_sweep.Uniform(0, 1)},
                               num_trials=5, metric="auroc", mode="max", seed=0)
    assert res.best().metrics["auroc"] == max(t.metrics["auroc"] for t in res.trials)
    again = port_sweep.run_sweep(lambda c: {"auroc": c["x"]}, {"x": port_sweep.Uniform(0, 1)},
                                 num_trials=5, metric="auroc", mode="max", seed=0)
    assert _trials(res) == _trials(again)


def _make_trial(config, grow, state):
    """An ASHA trial: `state` is the units trained so far; the metric falls
    with training, faster for configs near the objective's minimum."""
    done = (state or 0) + grow
    return done, {"val_loss": _objective(config)["val_loss"] + 1.0 / done}


@pytest.mark.parametrize("with_sampler", [False, True])
def test_asha_matches_jax(with_sampler):
    out = []
    for lib, slib in ((port_adaptive, port_sweep), (jax_adaptive, jax_sweep)):
        space = _adaptive_space(slib)
        sampler = lib.TPESampler(space, seed=2, n_startup=3) if with_sampler else None
        trials = lib.run_asha(_make_trial, space, num_trials=10, min_resource=1,
                              max_resource=8, eta=2, seed=4, sampler=sampler)
        out.append((trials, lib.asha_best(trials), lib.asha_total_resource(trials)))
    (pt, pbest, ptotal), (jt, jbest, jtotal) = out
    assert [(t.index, t.config, t.rung, t.resource, t.metric_value, t.stopped, t.history)
            for t in pt] == [(t.index, t.config, t.rung, t.resource, t.metric_value, t.stopped,
                              t.history) for t in jt]
    assert pbest.index == jbest.index and ptotal == jtotal
    assert ptotal < 10 * 8  # early stopping saved resource


def test_asha_stops_a_failing_or_diverged_trial():
    def make(config, grow, state):
        if config["arch"] == "a":
            raise RuntimeError("diverged")
        return None, {"val_loss": float("nan") if config["arch"] == "c" else 1.0}

    trials = port_adaptive.run_asha(make, _adaptive_space(port_sweep), num_trials=8, seed=1)
    for t in trials:
        assert t.stopped == (t.config["arch"] != "b")
        assert (t.error is not None) == (t.config["arch"] != "b")
    with pytest.raises(RuntimeError, match="no completed"):
        port_adaptive.asha_best([t for t in trials if t.config["arch"] != "b"])


def test_a_two_worker_spawned_sweep_runs(tmp_path):
    """Random and TPE sweeps over two worker processes started by spawn:
    every trial completes, in the reference's order and configurations, in
    processes other than this one, and each trial logs its directory."""
    space = {"x": port_sweep.Uniform(0, 1)}
    res = port_sweep.run_sweep(torch_tuning_trials.quadratic_trial, space, num_trials=4,
                               seed=2, max_workers=2, logger_root=str(tmp_path / "r"))
    ref = jax_sweep.run_sweep(lambda c: {"val_loss": (c["x"] - 0.3) ** 2},
                              {"x": jax_sweep.Uniform(0, 1)}, num_trials=4, seed=2)
    assert len(res.completed()) == 4
    assert [t.config for t in res.trials] == [t.config for t in ref.trials]
    assert [t.metrics["val_loss"] for t in res.trials] == [t.metrics["val_loss"]
                                                           for t in ref.trials]
    pids = {t.metrics["pid"] for t in res.trials}
    assert 1 <= len(pids) <= 2 and torch_tuning_trials.os.getpid() not in pids
    assert len(list(tmp_path.glob("r/trial_*"))) == 4
    tpe = port_adaptive.run_adaptive_sweep(torch_tuning_trials.quadratic_trial, space,
                                           num_trials=3, max_workers=2, n_startup=2)
    assert len(tpe.completed()) == 3
    assert sorted(t.index for t in tpe.trials) == [0, 1, 2]


USERS, ITEMS = 40, 25


def _multi_seed_configs():
    cfg = jax_config.two_tower_model_config(num_users=USERS, num_items=ITEMS, embedding_dim=8,
                                            layer_sizes=(16, 8))
    tcfg = jax_config.TrainConfig()
    return (cfg, tcfg, port_config.model_config_from_dict(dataclasses.asdict(cfg)),
            port_config.TrainConfig(**dataclasses.asdict(tcfg)))


def _numpy_state(jstate):
    """A fresh JAX `TrainState` in `train_state_from_numpy`'s layout."""
    dense = jax.tree.map(np.array, jstate.dense_params)
    zeros = jax.tree.map(np.zeros_like, dense)
    return {"step": 0, "tables": {k: np.array(v) for k, v in jstate.tables.items()},
            **dense, "adagrad_acc": {k: np.array(v) for k, v in jstate.adagrad_acc.items()},
            "adam": {"count": 0, "mu": zeros, "nu": zeros}}


def test_multi_seed_train_matches_jax_per_seed(monkeypatch):
    """Each seed's port state is the JAX package's for that seed (the port's
    state creation patched to carry it across): the final train losses
    within rtol 1e-5 (f32 summation order over 8 steps) and the eval AUROCs
    within 1e-3, per seed; different seeds give different models."""
    cfg, tcfg, pcfg, ptcfg = _multi_seed_configs()

    def from_jax(generator, model_cfg, train_cfg):
        jstate, _ = jax_step.create_train_state(jax.random.key(generator.initial_seed()), cfg,
                                                tcfg)
        return port_step.train_state_from_numpy(_numpy_state(jstate), model_cfg, train_cfg,
                                                generator.device)

    monkeypatch.setattr(port_multi_seed, "create_train_state", from_jax)
    seeds = [0, 1, 2]
    ref = jax_multi_seed.multi_seed_train(cfg, tcfg, seeds,
                                          JaxClickstream(USERS, ITEMS, seed=0).batches(64, 8),
                                          JaxClickstream(USERS, ITEMS, seed=0).sample(256, "val"))
    ds = SyntheticClickstream(USERS, ITEMS, seed=0)
    out = port_tuning.multi_seed_train(pcfg, ptcfg, seeds, ds.batches(64, 8),
                                       ds.sample(256, "val"), device="cpu")
    np.testing.assert_array_equal(out["seeds"], ref["seeds"])
    assert out["final_train_loss"].shape == out["eval_auroc"].shape == (3,)
    np.testing.assert_allclose(out["final_train_loss"], ref["final_train_loss"], rtol=1e-5)
    np.testing.assert_allclose(out["eval_auroc"], ref["eval_auroc"], atol=1e-3)
    assert len(np.unique(out["final_train_loss"].round(8))) > 1


def test_multi_seed_train_with_no_batches_reports_nan():
    _, _, pcfg, ptcfg = _multi_seed_configs()
    ds = SyntheticClickstream(USERS, ITEMS, seed=0)
    out = port_tuning.multi_seed_train(pcfg, ptcfg, [3, 4], [], ds.sample(128, "val"),
                                       device="cpu")
    assert np.isnan(out["final_train_loss"]).all() and out["eval_auroc"].shape == (2,)
