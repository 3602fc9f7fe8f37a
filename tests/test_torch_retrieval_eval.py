"""The port's retrieval evaluation and best-epoch selection against the JAX
package's: `retrieval_metrics` and `evaluate_retrieval` on the same numpy
inputs and weights, `train_val_test(select_best=..., retrieval_eval_fn=...)`,
and the sampled-softmax quality drive of `tests/test_quality.py` at a step
count that runs in seconds."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu import config as jax_config
from two_tower_recommender_model_tpu.evaluation import retrieval as jax_retrieval
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.evaluation import retrieval
from two_tower_recommender_model_tpu_torch.models.two_tower import params_from_numpy
from two_tower_recommender_model_tpu_torch.ops import softmax_kernel as sk
from two_tower_recommender_model_tpu_torch.train import step as port_step
from two_tower_recommender_model_tpu_torch.train.loop import train_val_test


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test steps are small, and the suite runs
    several test processes on the same cores, where torch's thread pools
    would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(cfg):
    return port_config.model_config_from_dict(dataclasses.asdict(cfg))


@pytest.mark.parametrize("ks", [(10, 100), (1, 5), (100,)])
def test_retrieval_metrics_match_jax(ks):
    """Random predictions and targets: users with no targets (skipped), with
    more than k targets (recall below 1 by the protocol), with none hit."""
    rng = np.random.default_rng(0)
    pred = np.stack([rng.permutation(500)[:100] for _ in range(40)])
    targets = [rng.integers(0, 500, rng.integers(1, 30)).tolist() for _ in range(40)]
    targets[3] = []  # no targets: not counted
    targets[5] = list(range(150))  # more than k targets
    targets[7] = [10_000]  # never retrieved
    got = retrieval.retrieval_metrics(pred, targets, ks=ks)
    want = jax_retrieval.retrieval_metrics(pred, targets, ks=ks)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == pytest.approx(want[name], rel=1e-12), name
    assert any(name.startswith("recall_at_") for name in got)


def test_retrieval_metrics_refuse_k_beyond_the_retrieved():
    with pytest.raises(ValueError, match="k=200 > retrieved 100"):
        retrieval.retrieval_metrics(np.zeros((2, 100), np.int64), [[1], [2]], ks=(10, 200))
    with pytest.raises(ValueError, match="empty"):
        retrieval.evaluate_retrieval(None, {})


def _numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    params = {"tables": {t.name: rng.normal(size=(t.num_embeddings, t.embedding_dim))
                         .astype(np.float32) for t in cfg.tables}}
    for key in ("query_tower", "candidate_tower"):
        tower = getattr(cfg, key)
        sizes = [sum(cfg.feature_table(f).embedding_dim for f in tower.features),
                 *tower.layer_sizes]
        params[key] = {f"layer_{i}": {
            "kernel": (rng.normal(size=(a, b)) / np.sqrt(a)).astype(np.float32),
            "bias": (rng.normal(size=b) * 0.1).astype(np.float32)}
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}
    return params


@pytest.mark.parametrize("exclude_item_zero", [True, False])
def test_evaluate_retrieval_matches_jax(exclude_item_zero):
    """The same weights in both packages (`params_from_numpy`), the same
    held-out positives: every metric equal. The embeddings agree to f32
    rounding, so a near-tie could swap two neighbours: the metrics are held
    to 1e-6, and the seed gives none here."""
    cfg = jax_config.two_tower_model_config(300, 200, embedding_dim=16, layer_sizes=(32, 16))
    cfg = dataclasses.replace(
        cfg, query_tower=dataclasses.replace(cfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(cfg.candidate_tower, final_activation=False))
    params = _numpy_params(cfg)
    rng = np.random.default_rng(1)
    positives = {int(u): rng.integers(0, 200, rng.integers(1, 12)).tolist()
                 for u in rng.choice(np.arange(1, 300), 120, replace=False)}
    kw = dict(k=50, ks=(10, 50), max_users=100, exclude_item_zero=exclude_item_zero)
    want = jax_retrieval.evaluate_retrieval(
        {k: ({n: jnp.asarray(a) for n, a in v.items()} if k == "tables" else
             {ln: {p: jnp.asarray(a) for p, a in lp.items()} for ln, lp in v.items()})
         for k, v in params.items()}, cfg, positives, **kw)
    got = retrieval.evaluate_retrieval(params_from_numpy(params, _port(cfg), "cpu"), positives,
                                       **kw)
    assert got.keys() == want.keys() and got["num_users"] == 100.0
    for name in want:
        assert got[name] == pytest.approx(want[name], abs=1e-6), name


def _learnable(loss="sampled_softmax", **train_kw):
    mcfg = port_config.two_tower_model_config(120, 60, embedding_dim=16, layer_sizes=(32, 16))
    mcfg = dataclasses.replace(
        mcfg, query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(mcfg.candidate_tower, final_activation=False))
    tcfg = port_config.TrainConfig(loss=loss, sparse_learning_rate=0.1, learning_rate=3e-3,
                                   limit_val_batches=2, limit_test_batches=2, **train_kw)
    ds = SyntheticClickstream(120, 60, seed=4, noise=0.05, latent_dim=4)
    users = np.arange(1, 121)
    truth = ds.ground_truth_topk(users, k=10)
    positives = {int(u): truth[i].tolist() for i, u in enumerate(users)}
    return mcfg, tcfg, ds, positives


def _drive(mcfg, tcfg, ds, steps_per_epoch, **loop_kw):
    state, opt = port_step.create_train_state(torch.Generator().manual_seed(0), mcfg, tcfg)
    return train_val_test(
        state, port_step.make_train_step(mcfg, tcfg, opt), port_step.make_eval_step(mcfg, tcfg),
        mcfg, tcfg, Featurizer(mcfg, device="cpu"),
        train_batches_factory=lambda ep: ds.batches(512, steps_per_epoch, split=f"t{ep}"),
        val_batches_factory=lambda: ds.batches(512, 2, split="val"),
        test_batches_factory=lambda: ds.batches(512, 2, split="test"), **loop_kw)


def test_sampled_softmax_learns_to_retrieve():
    """The drive of `tests/test_quality.py` through the port's loop: the
    (32, 16) linear-head model on the learnable synthetic set, sampled
    softmax with logQ through the fused route (its plain versions here),
    batch 512, 250 steps as the reference's run. recall@10 against the
    ground-truth top-10 must pass the reference's bar of 0.35, and the
    fused wrappers must have been the route (they count no launch on the
    CPU, so the route is read from the loss's own choice)."""
    mcfg, tcfg, ds, positives = _learnable(epochs=5, softmax_kernel="on")
    from two_tower_recommender_model_tpu_torch.models.losses import _use_fused_softmax

    assert _use_fused_softmax(512, 16, "on", torch.device("cpu"))
    fn = retrieval.make_retrieval_eval_fn(mcfg, positives, k=20, ks=(10,), max_users=120)
    before = sk.softmax_lse_fwd.launches
    state, res = _drive(mcfg, tcfg, ds, 50, retrieval_eval_fn=fn,
                        select_best="val_recall_at_10")
    assert sk.softmax_lse_fwd.launches == before  # CPU tensors: plain versions
    assert res["baseline_val_recall_at_10"] < 0.3  # random weights
    assert res["val_recall_at_10"] > 0.35, res
    assert 0 <= res["best_epoch"] <= 4
    assert state.item_counts.sum().item() == (res["best_epoch"] + 1) * 50 * 512
    # the returned state is the best epoch's: its recall is the best seen
    assert fn(state)["val_recall_at_10"] >= res["val_recall_at_10"]


class _Recorder:
    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step):
        self.rows.append((step, dict(metrics)))


@pytest.mark.parametrize("metric,values,best", [
    ("val_recall_at_10", [0.2, 0.6, 0.4], 1),  # higher is better
    ("val_loss", [0.9, 0.7, 0.8], 1),  # a name with "loss": lower is better
    ("val_recall_at_10", [0.5, 0.5, 0.5], 0),  # ties keep the earlier epoch
])
def test_select_best_returns_the_best_epochs_state(metric, values, best):
    """The metric is scripted per epoch, so the best epoch is known: the
    returned state must be that epoch's (its step count and its weights), not
    the last one's, and the test eval must run on it."""
    mcfg, tcfg, ds, _ = _learnable(loss="bce", epochs=3)
    calls = {"n": -1}
    snapshots = []

    def scripted(state):
        calls["n"] += 1
        if calls["n"] == 0:
            return {metric: -1.0 if "loss" not in metric else 99.0}  # the baseline eval
        snapshots.append((state.step, next(iter(state.model.tables.values())).clone()))
        return {metric: values[calls["n"] - 1]}

    rec = _Recorder()
    state, res = _drive(mcfg, tcfg, ds, 4, retrieval_eval_fn=scripted, select_best=metric,
                        logger=rec)
    assert res["best_epoch"] == float(best)
    assert state.step == 4 * (best + 1)
    step, table = snapshots[best]
    assert step == state.step
    assert torch.equal(next(iter(state.model.tables.values())), table)
    assert not torch.equal(snapshots[-1][1], table)  # training went on after the best epoch
    assert res[metric] == values[-1]  # the results keep the last epoch's metrics
    assert rec.rows[-1][0] == state.step and "test_loss" in rec.rows[-1][1]


def test_train_epoch_fn_replaces_the_inner_epoch():
    mcfg, tcfg, ds, _ = _learnable(loss="bce", epochs=2)
    seen = []

    def epoch_fn(state, epoch):
        seen.append(epoch)
        state.step += 10
        return state, {"train_steps": 10, "custom": float(epoch)}

    state, res = _drive(mcfg, tcfg, ds, 4, train_epoch_fn=epoch_fn)
    assert seen == [0, 1] and state.step == 20 and res["custom"] == 1.0
    assert "best_epoch" not in res
