"""The port's train and eval steps against the JAX package's, on the same
numpy weights and packed batches (JAX's Pallas kernels in interpret mode):
the flagship's path at 1,000 users x 300 items, dim 128, towers (128, 64),
batch 512, host-sorted by user_id, with the label packed into the ids."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu import config as jax_config
from two_tower_recommender_model_tpu.data.device_featurizer import (
    PackedFeaturizer as JaxPackedFeaturizer,
)
from two_tower_recommender_model_tpu.data.device_featurizer import (
    make_packed_train_step as jax_make_packed_train_step,
)
from two_tower_recommender_model_tpu.data.featurizer import Featurizer as JaxFeaturizer
from two_tower_recommender_model_tpu.models.metrics import auroc_compute as jax_auroc_compute
from two_tower_recommender_model_tpu.train import step as jax_step
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.data.device_featurizer import (
    PackedFeaturizer,
    make_packed_train_step,
)
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.models import losses as port_losses
from two_tower_recommender_model_tpu_torch.models.metrics import auroc_compute, mean_compute
from two_tower_recommender_model_tpu_torch.models.two_tower import params_from_numpy
from two_tower_recommender_model_tpu_torch.train import optimizer as port_opt
from two_tower_recommender_model_tpu_torch.train import step as port_step
from two_tower_recommender_model_tpu_torch.train.loop import train_one_epoch_packed, train_val_test
from two_tower_recommender_model_tpu_torch.train.pipeline import device_put_batch, map_leaves


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test steps are small, and the suite runs
    several test processes on the same cores, where torch's thread pools
    would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


USERS, ITEMS, B = 1000, 300, 512


def _configs(compute_dtype, fused, kernel, sorted_feature="user_id"):
    cfg = jax_config.two_tower_model_config(USERS, ITEMS, embedding_dim=128,
                                            layer_sizes=(128, 64), compute_dtype=compute_dtype)
    cfg = dataclasses.replace(cfg, fused_tower_backward=fused)
    tcfg = jax_config.TrainConfig(batch_size=B, sorted_feature=sorted_feature,
                                  block_sorted_kernel=kernel, sparse_learning_rate=0.05,
                                  learning_rate=1e-3)
    return (cfg, tcfg, port_config.model_config_from_dict(dataclasses.asdict(cfg)),
            port_config.TrainConfig(**dataclasses.asdict(tcfg)))


def _numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    params = {"tables": {t.name: rng.uniform(-0.5, 0.5, (t.num_embeddings, t.embedding_dim))
                         .astype(np.float32) for t in cfg.tables}}
    for key in ("query_tower", "candidate_tower"):
        sizes = [128, *getattr(cfg, key).layer_sizes]
        params[key] = {}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            bound = 1.0 / np.sqrt(a)
            params[key][f"layer_{i}"] = {
                "kernel": rng.uniform(-bound, bound, (a, b)).astype(np.float32),
                "bias": rng.uniform(-bound, bound, b).astype(np.float32)}
    return params


def _states(cfg, tcfg, pcfg, ptcfg, params):
    jstate, jopt = jax_step.create_train_state(jax.random.key(0), cfg, tcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    dense = {k: jparams[k] for k in ("query_tower", "candidate_tower")}
    jstate = jstate.replace(tables=jparams["tables"], dense_params=dense,
                            dense_opt_state=jopt.init(dense))
    pstate, popt = port_step.create_train_state(torch.Generator().manual_seed(0), pcfg, ptcfg)
    model = params_from_numpy(params, pcfg, "cpu")
    pstate = port_step.TrainState(0, model, pstate.adagrad_acc,
                                  popt.build(port_step.tower_parameters(model)),
                                  pstate.item_counts)
    return jstate, jopt, pstate, popt


def _columns(n_batches, seed=7):
    """Synthetic interactions with some missing (0) user ids."""
    ds = SyntheticClickstream(USERS - 1, ITEMS - 1, seed=seed)
    out = []
    for cols in ds.batches(B, n_batches, split="train"):
        cols["user_id"][::13] = 0
        out.append(cols)
    return out


def _as_tensors(pb):
    return map_leaves(pb, lambda t: t)


# (compute dtype, fused tower backward, block_sorted_kernel) -> the relative
# tolerance `rel`: each quantity within rel x its largest magnitude. f32
# compute: f32 summation order (1e-5; measured here at most 1.9e-6, with the
# fused backward too, whose bf16 operands both packages round alike). bf16
# compute: the logits, loss and pooled gradients are bf16 values, and a sum
# on a bf16 rounding boundary rounds either way in the two packages: two bf16
# ulps, 2^-7 (measured at most 4.5e-3).
CASES = {
    "f32-unfused-f32kernel": ("float32", "off", "float32", 1e-5),
    "f32-unfused-off": ("float32", "off", "off", 1e-5),
    "f32-fused-f32kernel": ("float32", "on", "float32", 1e-5),
    "bf16-fused-bf16kernel": ("bfloat16", "on", "bfloat16", 2.0 ** -7),
}


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case):
    compute_dtype, fused, kernel, rel = CASES[case]
    cfg, tcfg, pcfg, ptcfg = _configs(compute_dtype, fused, kernel)
    params = _numpy_params(cfg)
    jstate, jopt, pstate, popt = _states(cfg, tcfg, pcfg, ptcfg, params)
    jtrain = jax_make_packed_train_step(
        jax_step.make_train_step(cfg, tcfg, jopt, jit=False), cfg, pack_label=True)
    ptrain = make_packed_train_step(port_step.make_train_step(pcfg, ptcfg, popt), pcfg,
                                    pack_label=True)
    jfeat = JaxPackedFeaturizer(cfg, pack_label=True, sort_feature="user_id")
    pfeat = PackedFeaturizer(pcfg, pack_label=True, sort_feature="user_id")
    for i, cols in enumerate(_columns(3)):
        jpb, ppb = jfeat(cols), pfeat(cols)
        np.testing.assert_array_equal(ppb.ids_raw, jpb.ids_raw)
        jstate, jout = jtrain(jstate, jpb)
        pstate, pout = ptrain(pstate, _as_tensors(ppb))
        _close(pout["loss"].float().item(), float(jout["loss"]), rel)
        if i == 0:  # after one step: logits, tables, accumulators, tower grads
            _close(pout["logits"].float(), jout["logits"].astype(jnp.float32), rel)
            _check_state(params, jstate, pstate, rel)
    assert pstate.step == 3


def _check_state(params, jstate, pstate, rel):
    for name, t0 in params["tables"].items():
        got, want = pstate.model.tables[name].detach().numpy(), np.asarray(jstate.tables[name])
        # the update moves each touched row by about the learning rate: hold
        # the change against the change, and untouched rows to their bits
        moved = np.any(want != t0, axis=1)
        assert moved.any() and not moved.all()
        np.testing.assert_array_equal(got[~moved], t0[~moved])
        _close(got - t0, want - t0, rel)
        _close(pstate.adagrad_acc[name], jstate.adagrad_acc[name], rel)
    # the towers' gradients, as Adam's first moment after one step (0.1 x
    # the gradient in both packages). The weights themselves are not
    # compared: Adam's first step moves every weight by +-lr whatever its
    # gradient's size, so a near-zero gradient rounding differently flips it.
    mu = jstate.dense_opt_state[0].mu
    for key in ("query_tower", "candidate_tower"):
        for i, layer in enumerate(getattr(pstate.model, key).layers):
            m = pstate.dense_opt_state.state
            _close(m[layer.weight]["exp_avg"].T, mu[key][f"layer_{i}"]["kernel"], rel)
            _close(m[layer.bias]["exp_avg"], mu[key][f"layer_{i}"]["bias"], rel)


# The sampled-softmax step. "off": the plain dense route in f32 on both sides
# (b = 512), f32 summation order, 1e-5 x max. "on": the fused route, the JAX
# kernels in interpret mode against the port's plain versions; p is rounded to
# bf16 in both, and a p on a rounding boundary goes either way, which moves
# single rows of the pooled gradients by one bf16 ulp: two ulps, 2^-7 x max.
SOFTMAX_CASES = {
    "logq-kernel-on": (True, "on", 2.0 ** -7),
    "nologq-kernel-on": (False, "on", 2.0 ** -7),
    "logq-kernel-off": (True, "off", 1e-5),
    "nologq-kernel-off": (False, "off", 1e-5),
}


@pytest.mark.parametrize("case", list(SOFTMAX_CASES))
def test_sampled_softmax_train_steps_match_jax(case):
    """Three sampled-softmax steps on the same numpy state and batches: loss,
    logits, tables, towers and the streaming `item_counts` (300 items in
    batches of 512: every batch repeats items, and each repeat must count)."""
    logq, kernel, rel = SOFTMAX_CASES[case]
    cfg, tcfg, _, _ = _configs("float32", "off", "float32")
    tcfg = dataclasses.replace(tcfg, loss="sampled_softmax", logq_correction=logq,
                               softmax_kernel=kernel, softmax_temperature=0.5)
    pcfg = port_config.model_config_from_dict(dataclasses.asdict(cfg))
    ptcfg = port_config.TrainConfig(**dataclasses.asdict(tcfg))
    params = _numpy_params(cfg)
    jstate, jopt, pstate, popt = _states(cfg, tcfg, pcfg, ptcfg, params)
    assert (pstate.item_counts is not None) == logq == (jstate.item_counts is not None)
    jtrain = jax_make_packed_train_step(
        jax_step.make_train_step(cfg, tcfg, jopt, jit=False), cfg, pack_label=True)
    ptrain = make_packed_train_step(port_step.make_train_step(pcfg, ptcfg, popt), pcfg,
                                    pack_label=True)
    jfeat = JaxPackedFeaturizer(cfg, pack_label=True, sort_feature="user_id")
    pfeat = PackedFeaturizer(pcfg, pack_label=True, sort_feature="user_id")
    for i, cols in enumerate(_columns(3)):
        assert len(np.unique(cols["product_id"])) < B  # duplicates in the batch
        jstate, jout = jtrain(jstate, jfeat(cols))
        pstate, pout = ptrain(pstate, _as_tensors(pfeat(cols)))
        _close(pout["loss"].item(), float(jout["loss"]), rel)
        _close(pout["logits"], jout["logits"], rel)
        if logq:
            np.testing.assert_array_equal(pstate.item_counts.numpy(),
                                          np.asarray(jstate.item_counts))
            assert pstate.item_counts.sum().item() == (i + 1) * B
        if i == 0:
            _check_state(params, jstate, pstate, rel)
    copied = pstate.copy()
    if logq:
        assert torch.equal(copied.item_counts, pstate.item_counts)
        assert copied.item_counts.data_ptr() != pstate.item_counts.data_ptr()
    assert port_step.full_params(pstate) is pstate.model


def test_eval_step_matches_jax():
    cfg, tcfg, pcfg, ptcfg = _configs("float32", "off", "float32")
    params = _numpy_params(cfg)
    jstate, _, pstate, _ = _states(cfg, tcfg, pcfg, ptcfg, params)
    jeval, peval = jax_step.make_eval_step(cfg, tcfg), port_step.make_eval_step(pcfg, ptcfg)
    jes, pes = jax_step.eval_state_init(), port_step.eval_state_init(device="cpu")
    for j, cols in enumerate(_columns(3, seed=9)):
        jb = JaxFeaturizer(cfg)(cols)
        pb = Featurizer(pcfg, device="cpu")(cols)
        if j == 2:  # a padded batch: zero-weight rows leave the metrics alone
            from two_tower_recommender_model_tpu.data.featurizer import pad_batch as jax_pad
            from two_tower_recommender_model_tpu_torch.data.featurizer import pad_batch
            jb, pb = jax_pad(jb, 640), pad_batch(pb, 640)
        jes = jeval(jstate, jes, jb)
        pes = peval(pstate, pes, pb)
    np.testing.assert_allclose(float(mean_compute(pes.loss)),
                               float(jes.loss.total / jes.loss.count), rtol=1e-5)
    # a logit within f32 rounding of a bin edge may land in the next bin
    assert np.abs(pes.auroc.pos.numpy() - np.asarray(jes.auroc.pos)).sum() <= 2
    np.testing.assert_allclose(float(auroc_compute(pes.auroc)),
                               float(jax_auroc_compute(jes.auroc)), atol=1e-4)


def test_every_unsorted_table_goes_through_the_device_sort(monkeypatch):
    """Kernel #4 needs sorted ids: the host-sorted table's pass straight in,
    every other table's are sorted on the device first (its call carries the
    sort's permutation)."""
    calls = []
    real = port_opt.rowwise_adagrad

    def record(table, acc, ids, grads, lr, eps, perm=None):
        calls.append((table.shape[0], perm is not None, bool(torch.all(ids[1:] >= ids[:-1]))))
        return real(table, acc, ids, grads, lr, eps, perm=perm)

    monkeypatch.setattr(port_opt, "rowwise_adagrad", record)
    monkeypatch.setattr(port_step, "rowwise_adagrad", record)
    for sorted_feature, want in (("user_id", [(USERS, False, True), (ITEMS, True, True)]),
                                 (None, [(USERS, True, True), (ITEMS, True, True)])):
        calls.clear()
        cfg, tcfg, pcfg, ptcfg = _configs("float32", "off", "float32", sorted_feature)
        state, opt = port_step.create_train_state(torch.Generator().manual_seed(1), pcfg, ptcfg)
        step = make_packed_train_step(port_step.make_train_step(pcfg, ptcfg, opt), pcfg,
                                      pack_label=True)
        pfeat = PackedFeaturizer(pcfg, pack_label=True, sort_feature=sorted_feature)
        step(state, _as_tensors(pfeat(_columns(1)[0])))
        assert sorted(calls) == sorted(want)


def test_unsorted_ids_for_the_sorted_table_are_refused():
    _, _, pcfg, ptcfg = _configs("float32", "off", "float32")
    state, opt = port_step.create_train_state(torch.Generator().manual_seed(1), pcfg, ptcfg)
    step = make_packed_train_step(port_step.make_train_step(pcfg, ptcfg, opt), pcfg,
                                  pack_label=True)
    unsorted = PackedFeaturizer(pcfg, pack_label=True)(_columns(1)[0])  # no sort_feature
    with pytest.raises(RuntimeError, match="not sorted"):
        step(state, _as_tensors(unsorted))


@pytest.mark.parametrize("make", [
    lambda m, t: ({}, "packed sharding"),
    lambda m, t: ({"t": dataclasses.replace(t, device_sorted_gather=True)}, "step"),
    lambda m, t: ({"t": dataclasses.replace(t, loss="sampled_softmax")}, "sharded loss"),
])
def test_features_not_ported_raise(make):
    """`device_sorted_gather` still waits (ROADMAP); the packed epoch's
    multi-device placement and the data-parallel softmax are ported: a
    placement must be a slicer or a pytree of them, and the sharded loss
    builds (its collectives run at the call)."""
    _, _, pcfg, ptcfg = _configs("float32", "off", "float32")
    change, where = make(pcfg, ptcfg)
    mcfg, tcfg = change.get("m", pcfg), change.get("t", ptcfg)
    if where == "packed sharding":  # the packed epoch's multi-device placement
        with pytest.raises(TypeError, match="not a placement"):
            train_one_epoch_packed(None, None, [], None, sharding=object())
    elif where == "sharded loss":  # the data-parallel softmax, built for a mesh
        assert callable(port_losses.loss_fn_from_config(tcfg, mcfg, sharded=True,
                                                        mesh=object()))
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port_step.make_train_step(mcfg, tcfg, port_opt.dense_optimizer(1e-3))
    with pytest.raises(TypeError, match="not a placement"):
        device_put_batch({}, "cpu", sharding=object())


def test_sorted_feature_resolution_matches_jax():
    rich = jax_config.two_tower_model_config(50, 40)
    items = dataclasses.replace(rich.tables[1], feature_names=("product_id", "history"))
    rich = dataclasses.replace(
        rich, tables=(rich.tables[0], items),
        features=rich.features + (jax_config.FeatureConfig("history", items.name, 3),),
        query_tower=dataclasses.replace(rich.query_tower, features=("user_id", "history")))
    for cfg in (jax_config.two_tower_model_config(50, 40),
                jax_config.two_tower_model_config(50, 400), rich):
        pcfg = port_config.model_config_from_dict(dataclasses.asdict(cfg))
        assert port_step.auto_sorted_feature(pcfg) == jax_step.auto_sorted_feature(cfg)
        for feat in ("user_id", "product_id", "history", "nope", None):
            tcfg = jax_config.TrainConfig(sorted_feature=feat)
            ptcfg = port_config.TrainConfig(sorted_feature=feat)
            try:
                want = jax_step.validate_sorted_feature(cfg, tcfg)
            except ValueError:
                with pytest.raises(ValueError):
                    port_step.validate_sorted_feature(pcfg, ptcfg)
            else:
                assert port_step.validate_sorted_feature(pcfg, ptcfg) == want


def test_train_val_test_learns_on_the_cpu():
    """The verify drive on the CPU: 2 epochs x 120 batches x 1,024 on the
    learnable synthetic set (about two seconds here); val AUROC starts near
    0.5 and ends at 0.70 or above."""
    mcfg = port_config.two_tower_model_config(2000, 500, embedding_dim=32, layer_sizes=(64, 32))
    mcfg = dataclasses.replace(
        mcfg, query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(mcfg.candidate_tower, final_activation=False))
    tcfg = port_config.TrainConfig(epochs=2, sparse_learning_rate=0.1, learning_rate=3e-3,
                                   limit_val_batches=4, limit_test_batches=4)
    ds = SyntheticClickstream(2000, 500, seed=11, noise=0.05, latent_dim=4)
    state, opt = port_step.create_train_state(torch.Generator().manual_seed(0), mcfg, tcfg)
    state, res = train_val_test(
        state, port_step.make_train_step(mcfg, tcfg, opt), port_step.make_eval_step(mcfg, tcfg),
        mcfg, tcfg, Featurizer(mcfg, device="cpu"),
        train_batches_factory=lambda ep: ds.batches(1024, 120, split=f"t{ep}"),
        val_batches_factory=lambda: ds.batches(1024, 4, split="val"),
        test_batches_factory=lambda: ds.batches(1024, 4, split="test"))
    assert 0.45 <= res["baseline_val_auroc"] <= 0.55
    assert res["val_auroc"] >= 0.70 and res["test_auroc"] >= 0.70
    assert res["train_steps"] == 120 and np.isfinite(res["train_loss"])
    assert state.step == 240
