"""The port's losses and eval metrics against the JAX package's, on the same
numpy inputs."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu.models import losses as jax_losses
from two_tower_recommender_model_tpu.models import metrics as jax_metrics
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.models import losses, metrics

# f32: exp, log1p and the mean in another order
F32 = dict(rtol=1e-6, atol=1e-6)


def _logits(n=500, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=n) * 4).astype(np.float32)
    logits[:3] = [0.0, 40.0, -40.0]  # the stable form's edges
    return logits, rng.integers(0, 2, n).astype(np.int32), rng.random(n).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
def test_bce_matches_jax(weighted):
    logits, labels, w = _logits()
    got = losses.bce_with_logits(torch.from_numpy(logits), torch.from_numpy(labels),
                                 torch.from_numpy(w) if weighted else None)
    want = jax_losses.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels),
                                      jnp.asarray(w) if weighted else None)
    np.testing.assert_allclose(got.item(), float(want), **F32)
    per = losses.bce_per_example(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(per.numpy(), np.asarray(jax_losses.bce_per_example(
        jnp.asarray(logits), jnp.asarray(labels))), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bce_gradient_matches_jax_at_a_zero_logit(dtype):
    """The gradient of the mean BCE, with some logits exactly 0 (frequent in
    bf16): the reference's there, bit for bit (its `jnp.maximum(logits, 0)`
    passes no gradient at the tie); the rest within the dtype's rounding."""
    import jax

    logits, labels, _ = _logits(64, seed=1)
    logits[::5] = 0.0
    jl = jnp.asarray(logits).astype(dtype)
    want = jax.grad(lambda x: jax_losses.bce_with_logits(x, jnp.asarray(labels)))(jl)
    want = np.asarray(want.astype(jnp.float32))
    x = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_(True)
    losses.bce_with_logits(x, torch.from_numpy(labels)).backward()
    got = x.grad.float().numpy()
    zero = logits == 0.0
    np.testing.assert_array_equal(got[zero], want[zero])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=(1e-7 if dtype == "float32" else 2.0 ** -8) / 64)


def test_weighted_bce_and_loss_fns_match_jax():
    rng = np.random.default_rng(1)
    n, d = 64, 8
    q, c = rng.normal(size=(n, d)).astype(np.float32), rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.integers(0, 2, n).astype(np.int32)
    dense = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    dense = np.concatenate([rng.normal(size=(n, 1)).astype(np.float32), dense], axis=1)
    tw = (1.0, 0.5, 2.0)
    for name, kw in (("bce", {}), ("weighted_bce", dict(type_weights=tw, type_onehot_start=1))):
        tb = SimpleNamespace(labels=torch.from_numpy(labels), dense=torch.from_numpy(dense))
        jb = SimpleNamespace(labels=jnp.asarray(labels), dense=jnp.asarray(dense))
        got_loss, got_logits = losses.make_loss_fn(name, **kw)(
            torch.from_numpy(q), torch.from_numpy(c), tb)
        want_loss, want_logits = jax_losses.make_loss_fn(name, **kw)(
            jnp.asarray(q), jnp.asarray(c), jb)
        np.testing.assert_allclose(got_loss.item(), float(want_loss), **F32)
        np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=1e-5,
                                   atol=1e-5)


def test_loss_fn_from_config_and_refusals():
    tcfg = port_config.TrainConfig(loss="weighted_bce", loss_type_weights=(1.0, 2.0))
    mcfg = port_config.two_tower_model_config(50, 40)
    assert callable(losses.loss_fn_from_config(tcfg, mcfg))
    with pytest.raises(ValueError, match="type_weights"):
        losses.make_loss_fn("weighted_bce")
    assert callable(losses.make_loss_fn("sampled_softmax"))
    # the data-parallel softmax: built here, its collectives run at the call
    assert callable(losses.make_loss_fn("sampled_softmax", mesh=object()))
    assert callable(losses.loss_fn_from_config(port_config.TrainConfig(loss="sampled_softmax"),
                                               mcfg, sharded=True, mesh=object()))
    with pytest.raises(ValueError, match="unknown loss"):
        losses.make_loss_fn("hinge")


@pytest.mark.parametrize("weighted", [False, True])
def test_auroc_matches_jax_and_the_exact_auroc(weighted):
    logits, labels, w = _logits(4000, seed=2)
    logits = logits + labels * 1.5  # some signal
    st = metrics.auroc_init(device="cpu")
    jst = jax_metrics.auroc_init()
    for part in np.array_split(np.arange(len(logits)), 3):  # streamed in three updates
        st = metrics.auroc_update(st, torch.from_numpy(logits[part]),
                                  torch.from_numpy(labels[part]),
                                  torch.from_numpy(w[part]) if weighted else None)
        jst = jax_metrics.auroc_update(jst, jnp.asarray(logits[part]), jnp.asarray(labels[part]),
                                       jnp.asarray(w[part]) if weighted else None)
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(jst.pos), rtol=1e-6)
    np.testing.assert_allclose(st.neg.numpy(), np.asarray(jst.neg), rtol=1e-6)
    got = float(metrics.auroc_compute(st))
    np.testing.assert_allclose(got, float(jax_metrics.auroc_compute(jst)), rtol=1e-6)
    if not weighted:  # 8,192 bins: within ~1e-4 of the exact statistic
        assert abs(got - metrics.exact_auroc(logits, labels)) < 1e-3
        assert metrics.exact_auroc(logits, labels) == jax_metrics.exact_auroc(logits, labels)
    merged = metrics.auroc_merge(st, metrics.auroc_init(device="cpu"))
    assert torch.equal(merged.pos, st.pos)
    assert float(metrics.auroc_compute(metrics.auroc_init(device="cpu"))) == 0.5


def test_mean_state_matches_jax():
    st, jst = metrics.mean_init(device="cpu"), jax_metrics.mean_init()
    assert float(metrics.mean_compute(st)) == 0.0
    for v, n in ((0.5, 10.0), (0.25, 30.0)):
        st = metrics.mean_update(st, torch.tensor(v), n)
        jst = jax_metrics.mean_update(jst, jnp.asarray(v), n)
    np.testing.assert_allclose(float(metrics.mean_compute(st)),
                               float(jax_metrics.mean_compute(jst)), rtol=1e-7)
