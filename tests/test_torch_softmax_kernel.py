"""The port's fused sampled softmax on the CPU (its wrappers run the kernels'
plain versions there) against the JAX package's fused Pallas kernels in
interpret mode, on the same numpy inputs, at B = 512 with D = 128 and D = 64.

Inputs are pre-rounded to bf16 values, as `tests/test_softmax_kernel.py`
does, so both versions multiply identical operands.

Tolerances. lse, pos and the loss: rtol 2e-5 / atol 1e-5, the reference's
own against its dense oracle (f32 sums in another order: the reference's
online recurrence over 512-column tiles, the plain version's one pass). dq
and dc: one bf16 ulp (2^-8) of the largest magnitude and cosine > 0.99999: p
is rounded to bf16 per score, and two versions whose lse or score differ in
the last f32 bit round a p that sits on a bf16 boundary either way. At
B = 512 a single p can carry most of a row's gradient, so one such flip
moves one dq row and one dc row by up to 2^-8 of their size (seen: 2.5e-3 x
max in one row of 512, every other row within 1e-5 x max). The reference
holds its own kernel to atol 2e-4, rtol 2e-2 against the scan path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu.ops import softmax_kernel as jax_sk
from two_tower_recommender_model_tpu_torch.ops import softmax_kernel as sk

B = 512
LSE_TOL = dict(rtol=2e-5, atol=1e-5)
MASKS = [  # use_ids, use_logq, n_valid: the reference's mask surface
    (False, False, None),
    (True, False, None),
    (True, True, None),
    (True, True, 400),
    (True, True, 384),
]


def _setup(seed=0, d=128, b=B):
    rng = np.random.default_rng(seed)
    rnd = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()  # noqa: E731
    q = rnd(rng.normal(size=(b, d)).astype(np.float32))
    c = rnd(rng.normal(size=(b, d)).astype(np.float32))
    labels = rng.integers(0, 2, b).astype(np.int32)
    ids = rng.integers(1, 40, b).astype(np.int32)  # duplicates
    log_q = (rng.normal(size=b) * 0.1).astype(np.float32)
    return q, c, labels, ids, log_q


def _assert_grad_close(got, want, label):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= 2.0 ** -8 * scale, f"{label}: max abs diff {err} > 2^-8 x {scale}"
    cos = (got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos > 0.99999, f"{label}: cosine {cos}"


@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("use_ids,use_logq,n_valid", MASKS[:4])
def test_lse_and_pos_match_the_pallas_kernel(use_ids, use_logq, n_valid, d):
    q, c, _, ids, log_q = _setup(d=d)
    ids_f = jnp.asarray(ids).astype(jnp.float32)
    # the reference pads D to 128 lanes in `sampled_softmax_fused_parts`; `lse_and_pos`
    # itself takes the padded operands
    pad = lambda a: jnp.asarray(np.pad(a, ((0, 0), (0, 128 - d))))  # noqa: E731
    want_lse, want_pos = jax_sk.lse_and_pos(
        pad(q), pad(c), ids_f, ids_f, jnp.asarray(log_q), jnp.arange(B, dtype=jnp.float32),
        0.7, n_valid, (use_ids, use_logq), True)
    t_ids = torch.from_numpy(ids) if use_ids else None
    got_lse, got_pos = sk.lse_and_pos(
        torch.from_numpy(q), torch.from_numpy(c), t_ids, t_ids,
        torch.from_numpy(log_q) if use_logq else None, 0, 0.7, n_valid)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **LSE_TOL)
    np.testing.assert_allclose(got_pos.numpy(), np.asarray(want_pos), **LSE_TOL)


@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("use_ids,use_logq,n_valid", [MASKS[0], MASKS[2], MASKS[4]])
def test_fused_loss_and_grads_match_the_pallas_kernels(use_ids, use_logq, n_valid, d):
    q, c, labels, ids, log_q = _setup(seed=3, d=d)
    if n_valid is not None:
        labels = labels * (np.arange(B) < n_valid)

    def jax_loss(qa, ca):
        return jax_sk.sampled_softmax_fused(
            qa, ca, jnp.asarray(labels), jnp.asarray(ids) if use_ids else None,
            jnp.asarray(log_q) if use_logq else None, 0.9, n_valid=n_valid, interpret=True)

    want, (want_dq, want_dc) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(c))
    qt = torch.from_numpy(q).requires_grad_(True)
    ct = torch.from_numpy(c).requires_grad_(True)
    got = sk.sampled_softmax_fused(
        qt, ct, torch.from_numpy(labels), torch.from_numpy(ids) if use_ids else None,
        torch.from_numpy(log_q) if use_logq else None, 0.9, n_valid=n_valid)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **LSE_TOL)
    assert qt.grad.shape == (B, d) and ct.grad.shape == (B, d)
    _assert_grad_close(qt.grad.numpy(), want_dq, "dq")
    _assert_grad_close(ct.grad.numpy(), want_dc, "dc")


@pytest.mark.parametrize("use_ids,use_logq", [(False, False), (True, True)])
def test_rectangular_stripes_sum_to_square(use_ids, use_logq):
    """Four [B/4, B] stripes with `row_offset`: their (num, den) sum to the
    square loss, the stripes' dq rows and summed dc are the square's, and
    each stripe's parts equal the reference's stripe."""
    q, c, labels, ids, log_q = _setup(seed=11)
    lab = torch.from_numpy(labels)
    ids_t = torch.from_numpy(ids) if use_ids else None
    lq_t = torch.from_numpy(log_q) if use_logq else None
    bl = B // 4

    def run(striped):
        qt = torch.from_numpy(q).requires_grad_(True)
        ct = torch.from_numpy(c).requires_grad_(True)
        parts = []
        for s in (range(4) if striped else [None]):
            sl = slice(None) if s is None else slice(s * bl, (s + 1) * bl)
            parts.append(sk.sampled_softmax_fused_parts(
                qt[sl], ct, lab[sl], None if ids_t is None else ids_t[sl], ids_t, lq_t,
                temperature=0.8, row_offset=0 if s is None else s * bl))
        loss = sum(p[0] for p in parts) / torch.clamp(sum(p[1] for p in parts), min=1.0)
        loss.backward()
        return loss.item(), qt.grad.numpy(), ct.grad.numpy(), parts

    lsq, dq_sq, dc_sq, _ = run(False)
    lst, dq_st, dc_st, parts = run(True)
    np.testing.assert_allclose(lst, lsq, rtol=1e-6)
    np.testing.assert_allclose(dq_st, dq_sq, atol=1e-6, rtol=1e-4)  # the reference's own
    _assert_grad_close(dc_st, dc_sq, "dc")  # p rounds to bf16 before sums of other lengths
    jids = jnp.asarray(ids) if use_ids else None
    for s, (num, den) in enumerate(parts):
        sl = slice(s * bl, (s + 1) * bl)
        wnum, wden = jax_sk.sampled_softmax_fused_parts(
            jnp.asarray(q[sl]), jnp.asarray(c), jnp.asarray(labels[sl]),
            None if jids is None else jids[sl], jids,
            jnp.asarray(log_q) if use_logq else None, 0.8, row_offset=s * bl, interpret=True)
        np.testing.assert_allclose(num.item(), float(wnum), rtol=2e-5)
        assert den.item() == float(wden)


def test_shapes_gate_matches_the_reference_up_to_the_dim_cap():
    """The reference's rule for the batch dims; D at most 128 here (2,048
    there): the CUDA kernels keep a [rows, D] accumulator in registers."""
    assert sk.MAX_DIM == 128
    cases = [(65536, 128, None), (65536, 64, None), (65536, 4096, None), (1000, 128, None),
             (128, 128, None), (65536, 64, 8192), (65536, 64, 96), (512, 64, 384),
             (512, 1, None), (512, 0, None), (256, 128, 128)]
    for bk, d, bq in cases:
        assert sk.softmax_kernel_shapes_ok(bk, d, bq) == jax_sk.softmax_kernel_shapes_ok(bk, d, bq)
    assert sk.softmax_kernel_shapes_ok(8192, 128)
    assert not sk.softmax_kernel_shapes_ok(8192, 129)  # the port's cap
    assert jax_sk.softmax_kernel_shapes_ok(8192, 129)


def test_wrappers_on_cpu_are_the_plain_versions_and_count_nothing():
    q, c, _, ids, log_q = _setup(seed=5, d=64)
    q16, c16 = torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(c).to(torch.bfloat16)
    ids_t, adj = torch.from_numpy(ids), torch.from_numpy(log_q)
    wrappers = (sk.softmax_lse_fwd, sk.softmax_lse_dq, sk.softmax_lse_dc)
    before = [w.launches for w in wrappers]
    args = (q16, c16, adj, ids_t, ids_t, 0, 1.25)
    lse = sk.softmax_lse_fwd(*args)
    assert torch.equal(lse, sk.lse_forward_reference(*args))
    g = torch.linspace(-1, 1, B)
    dq, dc = sk.lse_backward_reference(*args, lse, g)
    assert torch.equal(sk.softmax_lse_dq(*args, lse, g), dq)
    assert torch.equal(sk.softmax_lse_dc(*args, lse, g), dc)
    assert [w.launches for w in wrappers] == before
    with pytest.raises(TypeError, match="bfloat16"):
        sk.softmax_lse_fwd(q16.float(), c16, adj, ids_t, ids_t, 0, 1.0)
    with pytest.raises(ValueError, match="both"):
        sk.softmax_lse_fwd(q16, c16, adj, ids_t, None, 0, 1.0)
    with pytest.raises(ValueError, match="row_offset"):
        sk.softmax_lse_fwd(q16[:128], c16, adj, ids_t[:128].contiguous(), ids_t, 400, 1.0)


def test_a_fully_masked_row_gives_the_reference_finite_lse():
    """Every item id equal and the last 128 columns padded: a row at or past
    `n_valid` has no live column. lse stays finite (the running max starts at
    -1e9) and equals the reference's; such rows carry no weight in the loss."""
    q, c, labels, _, _ = _setup(seed=9, d=64)
    ids = np.full(B, 7, np.int32)
    n_valid = B - 128
    ids_f = jnp.asarray(ids).astype(jnp.float32)
    pad = lambda a: jnp.asarray(np.pad(a, ((0, 0), (0, 64))))  # noqa: E731
    want, _ = jax_sk.lse_and_pos(pad(q), pad(c), ids_f, ids_f, jnp.zeros(B),
                                 jnp.arange(B, dtype=jnp.float32), 1.0, n_valid, (True, False),
                                 True)
    ids_t = torch.from_numpy(ids)
    got, _ = sk.lse_and_pos(torch.from_numpy(q), torch.from_numpy(c), ids_t, ids_t, None, 0, 1.0,
                            n_valid)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LSE_TOL)
    assert (got[n_valid:] < -9e8).all()


def test_plain_versions_block_the_rows(monkeypatch):
    """The plain versions never hold more than `_PLAIN_BLOCK` scores: with a
    small block they walk the rows in pieces and give the one-piece result."""
    q, c, _, ids, log_q = _setup(seed=2, d=64)
    q16, c16 = torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(c).to(torch.bfloat16)
    ids_t, adj = torch.from_numpy(ids), torch.from_numpy(log_q)
    args = (q16, c16, adj, ids_t, ids_t, 0, 1.0)
    lse = sk.lse_forward_reference(*args)
    g = torch.ones(B)
    dq, dc = sk.lse_backward_reference(*args, lse, g)
    monkeypatch.setattr(sk, "_PLAIN_BLOCK", 100 * B)
    assert len(sk._row_blocks(B, B)) == 6
    torch.testing.assert_close(sk.lse_forward_reference(*args), lse, rtol=1e-6, atol=1e-6)
    dq2, dc2 = sk.lse_backward_reference(*args, lse, g)
    torch.testing.assert_close(dq2, dq, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dc2, dc, rtol=1e-4, atol=1e-5)  # summed over blocks
