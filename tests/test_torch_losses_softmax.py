"""The port's in-batch sampled softmax against the JAX package's, route by
route, on the same numpy inputs: the dense route (b = 64), the chunked route
(`_chunked_sampled_softmax` with r = 128 at b = 512 in both: the automatic
route starts above 4,096 rows, too slow here), the padded route's `n_valid`,
the fused route ("on": the JAX kernels in interpret mode, the port's plain
versions), the gradients through each, `item_log_q_from_counts` and
`make_loss_fn("sampled_softmax")`.

Tolerances: the plain routes are f32 on both sides, so losses agree within
rtol 1e-5 and gradients within rtol 1e-4 / atol 1e-7 (sums in another order).
The fused route rounds q, c and p to bf16: "on" against "off" is held to the
reference's own atol 2e-4 / rtol 2e-2 for gradients (`tests/
test_softmax_kernel.py:119`) and rtol 1e-5 for the loss on bf16-valued
inputs."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu.models import losses as jax_losses
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.models import losses

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)


def _setup(b, d=32, seed=0, bf16_values=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, d)).astype(np.float32)
    c = rng.normal(size=(b, d)).astype(np.float32)
    if bf16_values:
        q = torch.from_numpy(q).bfloat16().float().numpy()
        c = torch.from_numpy(c).bfloat16().float().numpy()
    labels = rng.integers(0, 2, b).astype(np.int32)
    ids = rng.integers(1, 40, b).astype(np.int32)
    log_q = (rng.normal(size=b) * 0.1).astype(np.float32)
    return q, c, labels, ids, log_q


def _torch_value_and_grad(fn, q, c):
    qt = torch.from_numpy(q).requires_grad_(True)
    ct = torch.from_numpy(c).requires_grad_(True)
    loss = fn(qt, ct)
    loss.backward()
    return loss.item(), qt.grad.numpy(), ct.grad.numpy()


def _jax_value_and_grad(fn, q, c):
    loss, (dq, dc) = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(c))
    return float(loss), np.asarray(dq), np.asarray(dc)


def _assert_same(got, want, grad_tol=GRAD_TOL, loss_tol=LOSS_TOL):
    np.testing.assert_allclose(got[0], want[0], **loss_tol)
    np.testing.assert_allclose(got[1], want[1], **grad_tol)
    np.testing.assert_allclose(got[2], want[2], **grad_tol)


@pytest.mark.parametrize("use_ids,use_logq", [(False, False), (True, False), (True, True)])
def test_dense_route_matches_jax(use_ids, use_logq):
    q, c, labels, ids, log_q = _setup(64)
    got = _torch_value_and_grad(lambda qt, ct: losses.in_batch_sampled_softmax(
        qt, ct, torch.from_numpy(labels), torch.from_numpy(ids) if use_ids else None,
        torch.from_numpy(log_q) if use_logq else None, temperature=0.7), q, c)
    want = _jax_value_and_grad(lambda qa, ca: jax_losses.in_batch_sampled_softmax(
        qa, ca, jnp.asarray(labels), jnp.asarray(ids) if use_ids else None,
        jnp.asarray(log_q) if use_logq else None, temperature=0.7), q, c)
    _assert_same(got, want)


@pytest.mark.parametrize("use_ids,use_logq,n_valid", [
    (False, False, None), (True, True, None), (True, True, 400)])
def test_chunked_route_matches_jax_and_the_dense_route(use_ids, use_logq, n_valid):
    b = 512
    q, c, labels, ids, log_q = _setup(b, seed=1)
    if n_valid is not None:
        labels = labels * (np.arange(b) < n_valid)
    got = _torch_value_and_grad(lambda qt, ct: losses._chunked_sampled_softmax(
        qt, ct, torch.from_numpy(labels), torch.from_numpy(ids) if use_ids else None,
        torch.from_numpy(log_q) if use_logq else None, 0.9, 128, n_valid=n_valid), q, c)
    want = _jax_value_and_grad(lambda qa, ca: jax_losses._chunked_sampled_softmax(
        qa, ca, jnp.asarray(labels), jnp.asarray(ids) if use_ids else None,
        jnp.asarray(log_q) if use_logq else None, 0.9, 128, n_valid=n_valid), q, c)
    _assert_same(got, want)
    if n_valid is None:  # the blocks' math is the dense route's
        dense = _torch_value_and_grad(lambda qt, ct: losses.in_batch_sampled_softmax(
            qt, ct, torch.from_numpy(labels), torch.from_numpy(ids) if use_ids else None,
            torch.from_numpy(log_q) if use_logq else None, temperature=0.9,
            implementation="off"), q, c)
        _assert_same(got, dense)


def test_chunked_route_keeps_no_score_block_for_backward():
    """Each block is checkpointed: what autograd saves for the backward stays
    far below the [B, B] scores (here 512 x 512 x 4 B = 1 MB)."""
    b = 512
    q, c, labels, ids, log_q = _setup(b, seed=2)
    saved = []
    qt = torch.from_numpy(q).requires_grad_(True)
    ct = torch.from_numpy(c).requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.numel()) or t,
                                                  lambda t: t):
        loss = losses._chunked_sampled_softmax(qt, ct, torch.from_numpy(labels),
                                               torch.from_numpy(ids), torch.from_numpy(log_q),
                                               1.0, 128)
    assert max(saved) < 128 * b  # no [R, B] block is among the saved tensors
    loss.backward()
    assert torch.isfinite(qt.grad).all() and torch.isfinite(ct.grad).all()


def test_pad_route_masks_its_pad_columns(monkeypatch):
    """Above 4,096 rows a batch that no power of two divides is padded to a
    multiple of 512 with `n_valid`. The route's size rule is checked against
    the reference's; its arithmetic is checked at b = 500 by calling the
    padded form directly in both packages."""
    for b in (4097, 5000, 8192, 65536, 4096, 6144, 12000):
        assert losses._auto_row_chunk(b) == jax_losses._auto_row_chunk(b)
    b, r = 500, 128
    q, c, labels, ids, log_q = _setup(b, seed=3)
    pad = (-b) % r

    def padded_torch(qt, ct):
        zp = lambda x, v=0: torch.nn.functional.pad(  # noqa: E731
            x, (0, 0) * (x.dim() - 1) + (0, pad), value=v)
        return losses._chunked_sampled_softmax(
            zp(qt), zp(ct), zp(torch.from_numpy(labels)), zp(torch.from_numpy(ids), -1),
            zp(torch.from_numpy(log_q)), 0.8, r, n_valid=b)

    def padded_jax(qa, ca):
        zp = lambda x, v=0: jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1),  # noqa: E731
                                    constant_values=v)
        return jax_losses._chunked_sampled_softmax(
            zp(qa), zp(ca), zp(jnp.asarray(labels)), zp(jnp.asarray(ids), -1),
            zp(jnp.asarray(log_q)), 0.8, r, n_valid=b)

    got = _torch_value_and_grad(padded_torch, q, c)
    _assert_same(got, _jax_value_and_grad(padded_jax, q, c))
    # the pad columns change nothing: the unpadded dense route gives the same loss
    dense = _torch_value_and_grad(lambda qt, ct: losses.in_batch_sampled_softmax(
        qt, ct, torch.from_numpy(labels), torch.from_numpy(ids), torch.from_numpy(log_q),
        temperature=0.8, implementation="off"), q, c)
    _assert_same(got, dense)


def test_pad_route_is_taken_for_an_odd_large_batch(monkeypatch):
    """b = 4,099 (prime) has no divisor: `in_batch_sampled_softmax` pads it to
    4,608 and hands `_chunked_sampled_softmax` n_valid = 4,099."""
    seen = {}

    def record(q, c, labels, item_ids, log_q, temperature, r, n_valid=None):
        seen.update(b=q.shape[0], r=r, n_valid=n_valid, last_id=int(item_ids[-1]),
                    last_lq=float(log_q[-1]))
        return q.sum() * 0

    monkeypatch.setattr(losses, "_chunked_sampled_softmax", record)
    b = 4099
    q, c, labels, ids, log_q = _setup(b, d=4, seed=4)
    losses.in_batch_sampled_softmax(torch.from_numpy(q), torch.from_numpy(c),
                                    torch.from_numpy(labels), torch.from_numpy(ids),
                                    torch.from_numpy(log_q), implementation="off")
    assert seen == dict(b=4608, r=512, n_valid=b, last_id=-1, last_lq=0.0)


@pytest.mark.parametrize("use_ids,use_logq", [(False, False), (True, True)])
def test_fused_route_on_equals_off_and_the_reference(use_ids, use_logq):
    b = 512
    q, c, labels, ids, log_q = _setup(b, d=64, seed=5, bf16_values=True)
    args = (torch.from_numpy(labels), torch.from_numpy(ids) if use_ids else None,
            torch.from_numpy(log_q) if use_logq else None)
    on = _torch_value_and_grad(lambda qt, ct: losses.in_batch_sampled_softmax(
        qt, ct, *args, temperature=0.9, implementation="on"), q, c)
    off = _torch_value_and_grad(lambda qt, ct: losses.in_batch_sampled_softmax(
        qt, ct, *args, temperature=0.9, implementation="off"), q, c)
    kernel_tol = dict(atol=2e-4, rtol=2e-2)  # p is a bf16 operand in the fused backward
    _assert_same(on, off, grad_tol=kernel_tol)
    want = _jax_value_and_grad(lambda qa, ca: jax_losses.in_batch_sampled_softmax(
        qa, ca, jnp.asarray(labels), jnp.asarray(ids) if use_ids else None,
        jnp.asarray(log_q) if use_logq else None, temperature=0.9, implementation="on"), q, c)
    _assert_same(on, want, grad_tol=kernel_tol)


def test_routing_of_the_softmax_kernel_option():
    cpu, card = torch.device("cpu"), torch.device("cuda")
    use = losses._use_fused_softmax
    assert not use(8192, 64, "off", card)
    assert use(8192, 64, "on", cpu) and use(8192, 64, "on", card)
    assert use(8192, 64, "auto", card) and use(65536, 64, "auto", card)
    assert not use(8192, 64, "auto", cpu)  # the plain routes, on the CPU
    assert not use(8200, 64, "on", card)  # the shapes' gate holds under "on" too
    assert not use(8192, 256, "on", card)  # the port's cap on D
    with pytest.raises(ValueError, match="auto|on|off"):
        use(8192, 64, "yes", card)


def test_item_log_q_from_counts_matches_jax():
    rng = np.random.default_rng(6)
    counts = rng.integers(0, 50, 300).astype(np.float32)
    counts[:5] = 0  # clamped to 1
    ids = rng.integers(0, 300, 128).astype(np.int32)
    got = losses.item_log_q_from_counts(torch.from_numpy(counts), torch.from_numpy(ids))
    want = jax_losses.item_log_q_from_counts(jnp.asarray(counts), jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    zero = losses.item_log_q_from_counts(torch.zeros(10), torch.arange(4))
    np.testing.assert_array_equal(zero.numpy(), np.zeros(4, np.float32))


@pytest.mark.parametrize("with_id_feature", [False, True])
def test_make_loss_fn_sampled_softmax_matches_jax(with_id_feature):
    q, c, labels, ids, log_q = _setup(64, seed=7)
    feats_t = {"product_id": SimpleNamespace(ids=torch.from_numpy(ids[:, None]))}
    feats_j = {"product_id": SimpleNamespace(ids=jnp.asarray(ids[:, None]))}
    kw = dict(candidate_id_feature="product_id" if with_id_feature else None, temperature=0.5)
    got_loss, got_logits = losses.make_loss_fn("sampled_softmax", **kw)(
        torch.from_numpy(q), torch.from_numpy(c),
        SimpleNamespace(labels=torch.from_numpy(labels), features=feats_t),
        log_q=torch.from_numpy(log_q))
    want_loss, want_logits = jax_losses.make_loss_fn("sampled_softmax", **kw)(
        jnp.asarray(q), jnp.asarray(c),
        SimpleNamespace(labels=jnp.asarray(labels), features=feats_j), log_q=jnp.asarray(log_q))
    np.testing.assert_allclose(got_loss.item(), float(want_loss), **LOSS_TOL)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=1e-5, atol=1e-5)
    # the id feature switches the accidental-hit mask on: the two losses differ
    other = losses.make_loss_fn("sampled_softmax", temperature=0.5, candidate_id_feature=(
        None if with_id_feature else "product_id"))(
        torch.from_numpy(q), torch.from_numpy(c),
        SimpleNamespace(labels=torch.from_numpy(labels), features=feats_t),
        log_q=torch.from_numpy(log_q))[0]
    assert abs(other.item() - got_loss.item()) > 1e-4


def test_loss_fn_from_config_reads_the_softmax_fields():
    mcfg = port_config.two_tower_model_config(50, 40)
    tcfg = port_config.TrainConfig(loss="sampled_softmax", softmax_temperature=0.5,
                                   softmax_kernel="off")
    q, c, labels, ids, log_q = _setup(64, seed=7)
    batch = SimpleNamespace(labels=torch.from_numpy(labels), features={
        "product_id": SimpleNamespace(ids=torch.from_numpy(ids[:, None]))})
    got = losses.loss_fn_from_config(tcfg, mcfg)(torch.from_numpy(q), torch.from_numpy(c), batch,
                                                 log_q=torch.from_numpy(log_q))[0]
    want = losses.in_batch_sampled_softmax(
        torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(labels), torch.from_numpy(ids),
        torch.from_numpy(log_q), temperature=0.5, implementation="off")
    assert got.item() == want.item()
    # on a one-rank group the data-parallel softmax's stripe is the whole batch
    from two_tower_recommender_model_tpu_torch.parallel import launch
    from two_tower_recommender_model_tpu_torch.parallel.mesh import make_mesh

    launch.initialize_distributed("cpu", 1, 0)
    try:
        loss = losses.sharded_in_batch_sampled_softmax(
            make_mesh(1, 1), torch.from_numpy(q), torch.from_numpy(c),
            torch.from_numpy(labels), torch.from_numpy(ids), torch.from_numpy(log_q),
            temperature=0.5, implementation="off")
    finally:
        torch.distributed.destroy_process_group()
    np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-6)
