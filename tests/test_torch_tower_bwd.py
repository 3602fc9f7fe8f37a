"""The port's fused tower backward (kernel #8's plain version and wrapper,
the `Mlp2Relu` route of `apply_mlp`) against the JAX package's, on the same
numpy inputs. JAX's Pallas kernel runs in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu.models.mlp import apply_mlp as jax_apply_mlp
from two_tower_recommender_model_tpu.ops.tower_bwd import fits as jax_fits
from two_tower_recommender_model_tpu.ops.tower_bwd import tower_backward_fused
from two_tower_recommender_model_tpu_torch.models.mlp import MLP, apply_mlp
from two_tower_recommender_model_tpu_torch.ops.tower_bwd import (
    fits,
    tower_backward,
    tower_backward_reference,
)

B, D = 1024, 128


def _bf16_np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _inputs(h2, seed=0):
    """bf16 x, dq and a saved output with zeros (the final ReLU), weights
    holding bf16 values (the tower's weights after the compute-dtype cast)."""
    rng = np.random.default_rng(seed)
    x = _bf16_np(rng.normal(size=(B, D)))
    dq = _bf16_np(rng.normal(size=(B, h2)))
    out = _bf16_np(np.maximum(rng.normal(size=(B, h2)), 0))
    w1 = _bf16_np(rng.normal(size=(D, D), scale=0.1))
    b1 = _bf16_np(rng.normal(size=D, scale=0.1))
    w2 = _bf16_np(rng.normal(size=(D, h2), scale=0.1))
    return x, dq, out, w1, b1, w2


@pytest.mark.parametrize("shape", [(128, 128, 64, 1024), (128, 128, 128, 512),
                                   (128, 128, 64, 1000), (256, 128, 64, 1024),
                                   (128, 128, 256, 1024), (128, 64, 64, 1024),
                                   (128, 128, 0, 1024)])
def test_fits_is_the_reference_gate(shape):
    assert fits(*shape) == jax_fits(*shape)


@pytest.mark.parametrize("h2", [64, 128])
def test_plain_version_matches_pallas_kernel(h2):
    """dx, dW1 and dW2 within one bf16 ulp of their largest magnitude
    (2^-8 x max|.|): the f32 sums differ in order, and where a sum lands on
    a bf16 rounding boundary (dx itself, or the pre1 and d1 that feed the
    weight-gradient products) the two versions round it to neighbouring
    bf16 values, which moves the terms that use it by one bf16 ulp (measured
    here: up to 2.4e-3 x max for dx, 5.4e-4 x max for dW). db1 and db2 sum
    unrounded f32 values: within 1e-5 x max|.| (summation order)."""
    x, dq, out, w1, b1, w2 = _inputs(h2)
    bf = jnp.bfloat16
    want = tower_backward_fused(jnp.asarray(x, bf), jnp.asarray(dq, bf), jnp.asarray(out, bf),
                                jnp.asarray(w1, bf), jnp.asarray(b1, bf), jnp.asarray(w2, bf),
                                out_dtype=bf, interpret=True)
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    got = tower_backward_reference(t(x), t(dq), t(out), t(w1), t(b1), t(w2))
    assert got[0].dtype == torch.bfloat16
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        scale = np.abs(w).max()
        tol = 2.0 ** -8 * scale if i in (0, 1, 3) else 1e-5 * scale
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    x, dq, out, w1, b1, w2 = (torch.from_numpy(a) for a in _inputs(64))
    x, dq, out = (a.to(torch.bfloat16) for a in (x, dq, out))
    before = tower_backward.launches
    got = tower_backward(x, dq, out, w1, b1, w2)
    want = tower_backward_reference(x, dq, out, w1, b1, w2)
    assert tower_backward.launches == before and tower_backward._built is None
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bad", ["x_width", "dq_shape", "dtype_mix", "w2_wide", "strided"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x, dq, out = torch.zeros(B, D), torch.zeros(B, 64), torch.zeros(B, 64)
    w1, b1, w2 = torch.zeros(D, D), torch.zeros(D), torch.zeros(D, 64)
    if bad == "x_width":
        x = torch.zeros(B, 64)
    elif bad == "dq_shape":
        dq = torch.zeros(B, 32)
    elif bad == "dtype_mix":
        dq = dq.to(torch.bfloat16)
    elif bad == "w2_wide":
        w2 = torch.zeros(D, 256)
    elif bad == "strided":
        x = torch.zeros(D, B).T
    with pytest.raises((ValueError, TypeError)):
        tower_backward(x, dq, out, w1, b1, w2)


def _towers(h2, seed=1):
    """The same two-layer tower in both packages: (JAX params, port MLP)."""
    rng = np.random.default_rng(seed)
    shapes = ((D, D), (D, h2))
    jparams, mlp = {}, MLP(D, (D, h2), device="cpu")
    with torch.no_grad():
        for i, (s, layer) in enumerate(zip(shapes, mlp.layers)):
            k = rng.normal(size=s, scale=0.1).astype(np.float32)
            b = rng.normal(size=s[1], scale=0.1).astype(np.float32)
            jparams[f"layer_{i}"] = {"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}
            layer.weight.copy_(torch.from_numpy(k.T.copy()))
            layer.bias.copy_(torch.from_numpy(b))
    return jparams, mlp


def _cos_weights(shape):
    return np.cos(np.arange(np.prod(shape), dtype=np.float32).reshape(shape))


@pytest.mark.parametrize("h2", [64, 128])
def test_fused_apply_mlp_matches_jax(h2):
    """Value and gradients of `sum(out * cos)` through the fused route, port
    against JAX: the forward is the same bf16 rule (equal up to f32
    summation order), the gradients at the reference's own tolerances for
    its fused route (tests/test_tower_bwd.py)."""
    jparams, mlp = _towers(h2)
    x = _bf16_np(np.random.default_rng(3).normal(size=(B, D)))
    cw = _cos_weights((B, h2))

    def jloss(p, xx):
        out = jax_apply_mlp(p, xx, "relu", True, jnp.bfloat16, fused_backward=True)
        return jnp.sum(out.astype(jnp.float32) * cw)

    jv, (jdp, jdx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jparams, jnp.asarray(x, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    out = apply_mlp(mlp.layers, xt, "relu", True, torch.bfloat16, fused_backward=True)
    assert out.grad_fn is not None and "Mlp2Relu" in type(out.grad_fn).__name__
    value = torch.sum(out.float() * torch.from_numpy(cw))
    value.backward()
    np.testing.assert_allclose(value.item(), float(jv), rtol=1e-3)
    np.testing.assert_allclose(xt.grad.float().numpy(), np.asarray(jdx, np.float32),
                               atol=2e-2, rtol=2e-2)
    for i, layer in enumerate(mlp.layers):
        for got, want in ((layer.weight.grad.T, jdp[f"layer_{i}"]["kernel"]),
                          (layer.bias.grad, jdp[f"layer_{i}"]["bias"])):
            g, e = got.numpy(), np.asarray(want, np.float32)
            np.testing.assert_allclose(g, e, atol=2e-1, rtol=2e-2)
            cos = (g * e).sum() / max(np.linalg.norm(g) * np.linalg.norm(e), 1e-9)
            assert cos > 0.9999, cos


def test_fused_route_keeps_the_forward_and_rounds_weight_grads_to_bf16():
    """The fused route's forward equals the plain tower's bitwise, and its
    weight gradients are bf16 values widened to f32, as the reference's
    `_mlp2_relu_bwd` casts them."""
    _, mlp = _towers(64)
    x = torch.from_numpy(_bf16_np(np.random.default_rng(4).normal(size=(B, D))))
    x = x.to(torch.bfloat16)
    fused = apply_mlp(mlp.layers, x, "relu", True, torch.bfloat16, fused_backward=True)
    with torch.no_grad():
        plain = apply_mlp(mlp.layers, x, "relu", True, torch.bfloat16)
    assert torch.equal(fused.detach(), plain)
    fused.float().sum().backward()
    for p in mlp.parameters():
        assert p.grad.dtype == torch.float32
        assert torch.equal(p.grad, p.grad.to(torch.bfloat16).float())


@pytest.mark.parametrize("case", ["unfit_batch", "tanh", "no_final_relu"])
def test_off_route_shapes_and_activations_use_autograd(case):
    """fused_backward=True off the kernel's gate gives exactly the plain
    route's values and gradients."""
    _, mlp = _towers(64)
    n = 1000 if case == "unfit_batch" else B
    act = "tanh" if case == "tanh" else "relu"
    final = case != "no_final_relu"
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(n, D)).astype(np.float32))
    grads = []
    for fused_backward in (True, False):
        mlp.zero_grad()
        out = apply_mlp(mlp.layers, x, act, final, torch.bfloat16, fused_backward=fused_backward)
        assert "Mlp2Relu" not in type(out.grad_fn).__name__
        out.float().sum().backward()
        grads.append([p.grad.clone() for p in mlp.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
