"""The port's fused sampled softmax on the CPU (its wrappers run the kernels'
plain versions there) against the JAX package's fused Pallas kernels in
interpret mode, on the same numpy inputs, at B = 512 with D = 64, 128 and the
wide 192 and 256.

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


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tests are small, and the suite runs several
    test processes on the same cores, where torch's thread pools would
    contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
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
    """The reference's rule, its cap on D (2,048) included: the CUDA kernels
    take a wide D in depth slices (`csrc/softmax_lse.cu`, "wide D"). The
    wrappers pad D to 64, 128 or a multiple of 128."""
    assert sk.MAX_DIM == 2048
    cases = [(65536, 128, None), (65536, 64, None), (65536, 4096, None), (1000, 128, None),
             (128, 128, None), (65536, 64, 8192), (65536, 64, 96), (512, 64, 384),
             (512, 1, None), (512, 0, None), (256, 128, 128), (8192, 129, None),
             (8192, 256, None), (8192, 2048, None), (8192, 2049, None), (8192, 2048, 2048),
             (8192, 192, 1024)]
    for bk, d, bq in cases:
        assert sk.softmax_kernel_shapes_ok(bk, d, bq) == jax_sk.softmax_kernel_shapes_ok(bk, d, bq)
    assert sk.softmax_kernel_shapes_ok(8192, 129) and sk.softmax_kernel_shapes_ok(8192, 2048)
    assert not sk.softmax_kernel_shapes_ok(8192, 2049)
    assert [sk._padded_dim(d) for d in (1, 64, 65, 128, 129, 192, 256, 2000, 2048)] == [
        64, 64, 128, 128, 256, 256, 256, 2048, 2048]


WIDE = [192, 256]  # past 128: the kernels' depth slices; 192 pads to 256


@pytest.mark.parametrize("d", WIDE)
@pytest.mark.parametrize("use_ids,use_logq,n_valid", [MASKS[2], MASKS[3]])
def test_wide_dims_match_the_pallas_kernels(use_ids, use_logq, n_valid, d):
    """At D = 192 and 256 (the reference pads D to a multiple of 128 and
    runs its kernels; the port pads to 256 and takes the wide kernels on the
    card, their plain versions here): `lse_and_pos` at LSE_TOL, and the
    fused loss at LSE_TOL with dq and dc within one bf16 ulp of the largest
    magnitude and cosine > 0.99999, against the JAX kernels in interpret
    mode."""
    q, c, labels, ids, log_q = _setup(seed=21 + d, d=d)
    if n_valid is not None:
        labels = labels * (np.arange(B) < n_valid)
    ids_f = jnp.asarray(ids).astype(jnp.float32)
    pad = lambda a: jnp.asarray(np.pad(a, ((0, 0), (0, 256 - d))))  # noqa: E731
    want_lse, want_pos = jax_sk.lse_and_pos(
        pad(q), pad(c), ids_f, ids_f, jnp.asarray(log_q), jnp.arange(B, dtype=jnp.float32),
        0.7, n_valid, (use_ids, use_logq), True)
    t_ids = torch.from_numpy(ids) if use_ids else None
    t_lq = torch.from_numpy(log_q) if use_logq else None
    got_lse, got_pos = sk.lse_and_pos(torch.from_numpy(q), torch.from_numpy(c), t_ids, t_ids,
                                      t_lq, 0, 0.7, n_valid)
    np.testing.assert_allclose(got_lse.detach().numpy(), np.asarray(want_lse), **LSE_TOL)
    np.testing.assert_allclose(got_pos.detach().numpy(), np.asarray(want_pos), **LSE_TOL)

    def jax_loss(qa, ca):
        return jax_sk.sampled_softmax_fused(
            qa, ca, jnp.asarray(labels), jnp.asarray(ids) if use_ids else None,
            jnp.asarray(log_q) if use_logq else None, 0.7, n_valid=n_valid, interpret=True)

    want, (want_dq, want_dc) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(c))
    qt = torch.from_numpy(q).requires_grad_(True)
    ct = torch.from_numpy(c).requires_grad_(True)
    got = sk.sampled_softmax_fused(qt, ct, torch.from_numpy(labels), t_ids, t_lq, 0.7,
                                   n_valid=n_valid)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **LSE_TOL)
    assert qt.grad.shape == (B, d) and ct.grad.shape == (B, d)
    _assert_grad_close(qt.grad.numpy(), want_dq, "dq")
    _assert_grad_close(ct.grad.numpy(), want_dc, "dc")


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


def _scores_in_kernel_order(dots, d):
    """The f32 scores from their 16-deep chunk sums `dots` [.., D / 16]
    (float64, each exact) as the kernels add them: at D <= 128 in order into
    one accumulator, each add one rounding to f32 (an mma adds 16 products to
    its accumulator in one step); above 128, per 64-deep slice its 4 chunks
    from zero that way, then the slices' partials added in f32 in order
    (#9's `score_slice`; the p kernel's slices on wgmma)."""
    def chunked(chunks):
        acc = torch.zeros(chunks.shape[:-1])
        for k in range(chunks.shape[-1]):
            acc = (acc.double() + chunks[..., k]).float()
        return acc

    if d <= 128:
        return chunked(dots)
    s = torch.zeros(dots.shape[:-1])
    for k in range(0, d // 16, 4):
        s = s + chunked(dots[..., k:k + 4])
    return s


def _tensor_core_order_backward(q16, c16, adj, row_ids, col_ids, inv_t, lse, g,
                                panel_rows=None, row_offset=0):
    """(dq, dc) of the square case summed in the order of kernels #10 and
    #11 on the tensor cores. An mma or a wgmma adds 16 products to its f32
    accumulator in one step (modelled here exactly, in float64, with one
    rounding to f32), and the 16-deep chunks follow in order: the depth for a
    score (as `_scores_in_kernel_order` adds them), the streamed rows for the
    second product. A p of weight (exp(s - lse) >= 2^-10) whose f32 value
    lies within 0x2000 ulps of a bf16 rounding midpoint takes its score
    summed in k order instead (the kernels' `near_tie` / `ordered_dot`;
    above D = 128 summed in f64 and rounded, `rounded_dot_group`). The exp is
    torch's; the kernels' ex2.approx lies a few f32 ulps from it, far inside
    that window. At D <= 128 the streamed rows (c rows for dq, q rows for dc)
    are cut in `bwd_chunks` chunks of 128-row tiles; in each chunk NW
    warpgroups (3 at D = 64, 2 at 128) take its tiles in turn (warpgroup w
    the tiles w, w + NW, ...), each into its own f32 sum from zero, the sums
    added in warpgroup order, the chunks' sums in chunk order; then times
    1/T.
    Above (the p kernel and the two products), p once, then dq's sum over all
    columns and dc's over a panel's rows each in one chain of 16-deep
    chunks; dc's panels (`panel_rows` q rows each, all of them when None)
    added in f32 in panel order; then times 1/T. The q rows may be a stripe
    of the columns at `row_offset` (global row row_offset + i)."""
    b, d = q16.shape
    bk = c16.shape[0]
    qd, cd = q16.double(), c16.double()

    def chunked(acc, chunks):  # add [.., n] chunk sums to an f32 accumulator in order
        for k in range(chunks.shape[-1]):
            acc = (acc.double() + chunks[..., k]).float()
        return acc

    def p_of(dots):  # p in f32 before its bf16 rounding, and exp(s - lse)
        s = dots * inv_t
        if adj is not None:
            s = s - adj[None, :]
        if row_ids is not None:
            rows, cols = torch.arange(b) + row_offset, torch.arange(bk)
            s = s.masked_fill((row_ids[:, None] == col_ids[None, :]) & (rows[:, None] != cols),
                              sk.NEG)
        ex = torch.exp(s - lse[:, None])
        return ex * g[:, None], ex

    dots = torch.einsum("ikc,jkc->ijk", qd.reshape(b, d // 16, 16), cd.reshape(bk, d // 16, 16))
    p, ex = p_of(_scores_in_kernel_order(dots, d))
    # the tie score: at D <= 128 one fmaf a product in k order (products of
    # bf16 values are exact in f32, so each step below is one fmaf); above,
    # summed in f64 and rounded once (the p kernel's `rounded_dot_group`)
    if d > 128:
        ordered = (qd @ cd.T).float()
    else:
        ordered = torch.zeros(b, bk)
        for k in range(d):
            ordered = ordered + q16[:, k, None].float() * c16[None, :, k].float()
    low = p.view(torch.int32) & 0xFFFF
    tie = (ex >= 2.0 ** -10) & ((low - 0x8000).abs() <= 0x2000)
    p = torch.where(tie, p_of(ordered)[0], p).to(torch.bfloat16).double()

    def chunk_sums(pm, other):  # pm [own, streamed] @ other [streamed, D]: 16-deep chunks
        return torch.einsum("ick,ckd->idc", pm.reshape(pm.shape[0], -1, 16),
                            other.reshape(-1, 16, d))

    def second(pm, other):  # the narrow kernels' order: chunks, tiles over warpgroups
        sums = chunk_sums(pm, other)  # [own, D, streamed / 16]: 8 k steps a 128-row tile
        nw = 3 if d == 64 else 2
        total = None
        for first, end in sk.bwd_chunk_tiles(pm.shape[1]):
            part = [torch.zeros(pm.shape[0], d) for _ in range(nw)]
            for w in range(nw):
                for tile in range(first + w, end, nw):
                    part[w] = chunked(part[w], sums[:, :, 8 * tile:8 * tile + 8])
            v = part[0]
            for w in range(1, nw):
                v = v + part[w]
            total = v if total is None else total + v
        return total * inv_t

    if d <= 128:
        return second(p, cd), second(p.T, qd)
    dq = chunked(torch.zeros(b, d), chunk_sums(p, cd)) * inv_t
    rows = panel_rows or b
    dc = None
    for lo in range(0, b, rows):
        part = chunked(torch.zeros(bk, d), chunk_sums(p[lo:lo + rows].T, qd[lo:lo + rows]))
        dc = part if dc is None else dc + part
    return dq, dc * inv_t


@pytest.mark.parametrize("d,use_ids,use_logq,n_valid", [
    (64, True, True, None), (64, True, True, 384), (16, True, False, None),
    (128, False, True, 400), (256, True, True, 384), (192, True, False, None)])
def test_tensor_core_summation_order_stays_within_the_card_tolerances(d, use_ids, use_logq,
                                                                      n_valid):
    """The backward kernels sum each score in 16-deep chunks (and the
    scores of weighty p near a bf16 rounding tie in k order) and the second
    products in 16-row chunks split over warp groups, where the plain
    version sums in another order. Recomputed here in that order, dq and dc
    stay within the card tests' tolerances (2^-8 x max, cosine > 0.99999)
    of the reference's `_lse_bwd` in interpret mode: the new order moves a
    p by at most one bf16 ulp where its score lies on a rounding boundary."""
    q, c, _, ids, log_q = _setup(seed=13, d=d)
    g = (np.random.default_rng(14).normal(size=B) / B).astype(np.float32)
    ids_f = jnp.asarray(ids).astype(jnp.float32)
    pad = lambda a: jnp.asarray(np.pad(a, ((0, 0), (0, -d % 128))))  # noqa: E731
    _, vjp = jax.vjp(
        lambda qa, ca: jax_sk._lse_fused(qa, ca, ids_f, ids_f, jnp.asarray(log_q),
                                         jnp.arange(B, dtype=jnp.float32), 0.7, n_valid,
                                         (use_ids, use_logq), True), pad(q), pad(c))
    want_dq, want_dc = (np.asarray(x)[:, :d] for x in vjp(jnp.asarray(g)))
    # the kernels see D zero-padded to 64, 128 or a multiple of 128, as the wrapper pads it
    q16, c16 = (sk._pad_dim(torch.from_numpy(x).to(torch.bfloat16)) for x in (q, c))
    ids_t = torch.from_numpy(ids) if use_ids else None
    adj = sk._merged_adj(torch.from_numpy(log_q) if use_logq else None, n_valid, B,
                         torch.device("cpu"))
    args = (q16, c16, adj, ids_t, ids_t, 0, 1 / 0.7)
    lse = sk.lse_forward_reference(*args)
    dq, dc = _tensor_core_order_backward(q16, c16, adj, ids_t, ids_t, 1 / 0.7, lse,
                                         torch.from_numpy(g))
    _assert_grad_close(dq[:, :d].numpy(), want_dq, "dq")
    _assert_grad_close(dc[:, :d].numpy(), want_dc, "dc")


@pytest.mark.parametrize("d,use_logq,n_valid", [(64, True, 4000), (128, False, None)])
def test_tensor_core_order_of_a_stripe_stays_within_the_card_tolerances(d, use_logq, n_valid):
    """A data-parallel stripe at D <= 128: 256 q rows at row offset 1,024
    of 4,096 columns, whose dq sums meet two chunks of c tiles (`bwd_chunks`)
    and each chunk's tiles over the warpgroups, summed in the kernels' order,
    stay within the card tests' tolerances (2^-8 x max, cosine > 0.99999) of the
    reference's `_lse_bwd` in interpret mode on the same stripe."""
    bq, bk, off = 256, 4096, 1024
    assert sk.bwd_chunks(bk) == 2 and sk.bwd_chunks(bq) == 1
    q, c, _, ids, log_q = _setup(seed=31, d=d, b=bk)
    g = (np.random.default_rng(32).normal(size=bq) / bq).astype(np.float32)
    ids_f = jnp.asarray(ids).astype(jnp.float32)
    rows = slice(off, off + bq)
    pad = lambda a: jnp.asarray(np.pad(a, ((0, 0), (0, -d % 128))))  # noqa: E731
    _, vjp = jax.vjp(
        lambda qa, ca: jax_sk._lse_fused(qa, ca, ids_f[rows], ids_f, jnp.asarray(log_q),
                                         jnp.arange(off, off + bq, dtype=jnp.float32), 0.7,
                                         n_valid, (True, use_logq), True), pad(q[rows]), pad(c))
    want_dq, want_dc = (np.asarray(x)[:, :d] for x in vjp(jnp.asarray(g)))
    q16, c16 = (sk._pad_dim(torch.from_numpy(x).to(torch.bfloat16)) for x in (q[rows], c))
    ids_t = torch.from_numpy(ids)
    adj = sk._merged_adj(torch.from_numpy(log_q) if use_logq else None, n_valid, bk,
                         torch.device("cpu"))
    args = (q16, c16, adj, ids_t[rows].contiguous(), ids_t, off, 1 / 0.7)
    lse = sk.lse_forward_reference(*args)
    dq, dc = _tensor_core_order_backward(q16, c16, adj, ids_t[rows].contiguous(), ids_t,
                                         1 / 0.7, lse, torch.from_numpy(g), row_offset=off)
    _assert_grad_close(dq[:, :d].numpy(), want_dq, "dq")
    _assert_grad_close(dc[:, :d].numpy(), want_dc, "dc")


def test_backward_chunks_follow_the_streamed_length_alone():
    """The chunk rule of #10 and #11 at D <= 128 (`bwd_chunks`, a block
    each): a function of the streamed length alone, N / 2,048 clamped to
    1..4 chunks of whole 128-row tiles that cover the range in order, 16
    tiles at least each where there are several; 4 at the flagship's 8,192,
    so a [2,048 x 8,192] stripe's dq rows meet the square's chunks."""
    for n in range(128, 70_000, 128):
        tiles = sk.bwd_chunk_tiles(n)
        assert len(tiles) == sk.bwd_chunks(n) == min(4, max(1, n // 2048))
        assert tiles[0][0] == 0 and tiles[-1][1] == n // 128
        assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
        assert all(end - first >= (16 if len(tiles) > 1 else 1) for first, end in tiles)
    assert [sk.bwd_chunks(n) for n in (128, 2048, 4096, 6144, 8192, 65_536)] == [1, 1, 2, 3, 4, 4]


@pytest.mark.parametrize("d,use_ids,use_logq,n_valid,panel_rows", [
    (256, True, True, None, 128), (192, True, True, 400, 256), (256, False, True, 384, 128)])
def test_wide_panel_order_stays_within_the_card_tolerances(d, use_ids, use_logq, n_valid,
                                                          panel_rows):
    """The wide backward walked in panels of q rows (as a batch wider than
    one panel is): p once, dq's sum over the columns in one chain of 16-deep
    chunks, dc's over each panel's rows, the panels' dc added in f32 in panel
    order. Recomputed in that order, dq and dc stay within the card tests'
    tolerances (2^-8 x max, cosine > 0.99999) of the reference's `_lse_bwd`
    in interpret mode."""
    q, c, _, ids, log_q = _setup(seed=19, d=d)
    g = (np.random.default_rng(20).normal(size=B) / B).astype(np.float32)
    ids_f = jnp.asarray(ids).astype(jnp.float32)
    pad = lambda a: jnp.asarray(np.pad(a, ((0, 0), (0, -d % 128))))  # noqa: E731
    _, vjp = jax.vjp(
        lambda qa, ca: jax_sk._lse_fused(qa, ca, ids_f, ids_f, jnp.asarray(log_q),
                                         jnp.arange(B, dtype=jnp.float32), 0.7, n_valid,
                                         (use_ids, use_logq), True), pad(q), pad(c))
    want_dq, want_dc = (np.asarray(x)[:, :d] for x in vjp(jnp.asarray(g)))
    q16, c16 = (sk._pad_dim(torch.from_numpy(x).to(torch.bfloat16)) for x in (q, c))
    ids_t = torch.from_numpy(ids) if use_ids else None
    adj = sk._merged_adj(torch.from_numpy(log_q) if use_logq else None, n_valid, B,
                         torch.device("cpu"))
    args = (q16, c16, adj, ids_t, ids_t, 0, 1 / 0.7)
    lse = sk.lse_forward_reference(*args)
    dq, dc = _tensor_core_order_backward(q16, c16, adj, ids_t, ids_t, 1 / 0.7, lse,
                                         torch.from_numpy(g), panel_rows=panel_rows)
    _assert_grad_close(dq[:, :d].numpy(), want_dq, "dq")
    _assert_grad_close(dc[:, :d].numpy(), want_dc, "dc")


def _wide_args(seed, d, bq=B, row_offset=0, n_valid=None, use_ids=True, use_logq=True):
    """The wide backward's inputs on the CPU: a stripe of `bq` rows at
    `row_offset` of the square draws, bf16 operands, the merged adj, the
    plain lse and a cotangent."""
    q, c, _, ids, log_q = _setup(seed=seed, d=d)
    g = (np.random.default_rng(seed + 1).normal(size=B) / B).astype(np.float32)
    q16, c16 = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, c))
    ids_t = torch.from_numpy(ids) if use_ids else None
    adj = sk._merged_adj(torch.from_numpy(log_q) if use_logq else None, n_valid, B,
                         torch.device("cpu"))
    rows = slice(row_offset, row_offset + bq)
    args = (q16[rows].contiguous(), c16, adj, None if ids_t is None else ids_t[rows].contiguous(),
            ids_t, row_offset, 1 / 0.7)
    lse = sk.lse_forward_reference(*args)
    return (*args, lse, torch.from_numpy(g[rows]).contiguous())


@pytest.mark.parametrize("d,panel_rows,n_valid", [(256, 128, None), (256, 256, 400),
                                                  (192, 384, None), (2048, 128, 384)])
def test_panel_route_matches_the_plain_backward(d, panel_rows, n_valid, monkeypatch):
    """The wide backward's plain steps walked in panels (`wide_backward` on
    CPU tensors, a small PANEL_BYTES forcing `panel_rows` rows a panel): the
    panels' p are the one-panel p bit for bit, and dq / dc equal
    `lse_backward_reference` within rtol 1e-5 / 1e-4 (dc is summed over the
    panels, as the plain version sums its row blocks). `softmax_lse_grads`
    takes the same route on the CPU."""
    args = _wide_args(7 + d, d, n_valid=n_valid)
    whole = sk.p_panel_reference(*args, 0, B)
    want_dq, want_dc = sk.lse_backward_reference(*args)
    monkeypatch.setattr(sk, "PANEL_BYTES", panel_rows * 2 * B)
    assert sk.panel_rows(B, B) == panel_rows
    pieces = [sk.softmax_lse_p(*args, lo, min(lo + panel_rows, B))
              for lo in range(0, B, panel_rows)]
    assert torch.equal(torch.cat(pieces).view(torch.int16), whole.view(torch.int16))
    for dq, dc in (sk.wide_backward(*args), sk.softmax_lse_grads(*args)):
        assert dq.shape == (B, d) and dc.shape == (B, d)
        torch.testing.assert_close(dq, want_dq, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(dc, want_dc, rtol=1e-4, atol=1e-6)
    if n_valid is not None:
        assert (whole[:, n_valid:] == 0).all() and (dc[n_valid:] == 0).all()
    dq_only, none = sk.wide_backward(*args, need_dc=False)
    assert none is None and torch.equal(dq_only, dq)


@pytest.mark.parametrize("use_ids,use_logq,n_valid", [MASKS[2], MASKS[3]])
def test_wide_panels_match_the_pallas_kernels(use_ids, use_logq, n_valid, monkeypatch):
    """D = 256 in four panels of 128 q rows (a small PANEL_BYTES): the plain
    steps of the wide backward (`softmax_lse_grads` on the CPU) against the
    JAX package's `_lse_bwd` in interpret mode, reached through the fused
    loss's custom VJP, at `test_wide_dims_match_the_pallas_kernels`'s
    tolerances (one bf16 ulp of the largest magnitude, cosine > 0.99999)."""
    d = 256
    q, c, _, ids, log_q = _setup(seed=31, d=d)
    g = (np.random.default_rng(32).normal(size=B) / B).astype(np.float32)
    ids_f = jnp.asarray(ids).astype(jnp.float32)
    _, vjp = jax.vjp(
        lambda qa, ca: jax_sk._lse_fused(qa, ca, ids_f, ids_f, jnp.asarray(log_q),
                                         jnp.arange(B, dtype=jnp.float32), 0.7, n_valid,
                                         (use_ids, use_logq), True), jnp.asarray(q),
        jnp.asarray(c))
    want_dq, want_dc = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    monkeypatch.setattr(sk, "PANEL_BYTES", 128 * 2 * B)
    assert sk.panel_rows(B, B) == 128
    q16, c16 = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, c))
    ids_t = torch.from_numpy(ids) if use_ids else None
    adj = sk._merged_adj(torch.from_numpy(log_q) if use_logq else None, n_valid, B,
                         torch.device("cpu"))
    args = (q16, c16, adj, ids_t, ids_t, 0, 1 / 0.7)
    dq, dc = sk.softmax_lse_grads(*args, sk.lse_forward_reference(*args), torch.from_numpy(g))
    _assert_grad_close(dq.numpy(), want_dq, "dq")
    _assert_grad_close(dc.numpy(), want_dc, "dc")


@pytest.mark.parametrize("d", [192, 256])
def test_a_stripes_panel_rows_are_the_square_rows(d, monkeypatch):
    """A stripe of 128 q rows at row offset 256: its p panel is bit for bit
    the square's rows, and its dq rows are the square's (the same p rows
    against the same columns), with the square walked in panels of 128
    rows."""
    square = _wide_args(41 + d, d)
    stripe = _wide_args(41 + d, d, bq=128, row_offset=256)
    rows = slice(256, 384)
    assert torch.equal(stripe[7], square[7][rows])
    p_square = sk.p_panel_reference(*square, 0, B)
    p_stripe = sk.p_panel_reference(*stripe, 0, 128)
    assert torch.equal(p_stripe.view(torch.int16), p_square[rows].view(torch.int16))
    monkeypatch.setattr(sk, "PANEL_BYTES", 128 * 2 * B)
    dq_square, _ = sk.wide_backward(*square)
    dq_stripe, _ = sk.wide_backward(*stripe)
    torch.testing.assert_close(dq_stripe, dq_square[rows], rtol=1e-6, atol=0)


def test_the_wide_wrappers_check_their_panels():
    """The p wrapper takes rows on 128-row boundaries and a workspace of the
    panel's shape; the products take the panel's p and operands of matching
    shapes. On CPU tensors nothing is counted."""
    args = _wide_args(3, 256)
    before = [w.launches for w in (sk.softmax_lse_p, sk.softmax_lse_dq, sk.softmax_lse_dc)]
    with pytest.raises(ValueError, match="128-row boundaries"):
        sk.softmax_lse_p(*args, 64, 256)
    with pytest.raises(ValueError, match="out must be"):
        sk.softmax_lse_p(*args, 0, 128, out=torch.empty(128, 256, dtype=torch.bfloat16))
    p = sk.softmax_lse_p(*args, 0, 128)
    with pytest.raises(ValueError, match="other must be"):
        sk.softmax_lse_dq.product(p, args[1][:128].contiguous(), torch.empty(128, 256), 1.0)
    with pytest.raises(ValueError, match="out must be"):
        sk.softmax_lse_dc.product(p, args[0][:128].contiguous(), torch.empty(128, 256), 1.0)
    dc = torch.full((B, 256), 7.0)
    sk.softmax_lse_dc.product(p, args[0][:128].contiguous(), dc, 2.0, first=True, last=False)
    torch.testing.assert_close(dc, p.float().T @ args[0][:128].float())
    assert [w.launches for w in (sk.softmax_lse_p, sk.softmax_lse_dq, sk.softmax_lse_dc)] == before


def _tensor_core_order_forward(q16, c16, adj, row_ids, col_ids, inv_t):
    """lse of the square case in the order of kernel #9 on the tensor cores.
    Each score: the 16-deep chunks of the depth added as
    `_scores_in_kernel_order` adds them, times 1/T, minus adj, the mask. The
    64-column tiles are split over the 4 warp groups (group k takes the tiles
    k, k + 4, ...). A thread holds columns 8n + 2t and 8n + 2t + 1 (n = 0..7)
    of each tile of a row: per tile the row's max over the 64 columns (the
    quad's), the running max from -1e9, l times exp(m_old - m_new) plus the
    thread's 16 exps added in column order. At the end the quad's four l are
    added as (l0 + l1) + (l2 + l3), and the groups' (m, l) merged in group
    order: M = max m_k, L = sum_k l_k exp(m_k - M), lse = M + log(L). The
    exp is torch's; the kernel's ex2.approx lies a few f32 ulps from it."""
    b, d = q16.shape
    bk = c16.shape[0]
    dots = torch.einsum("ikc,jkc->ijk", q16.double().reshape(b, d // 16, 16),
                        c16.double().reshape(bk, d // 16, 16))
    s = _scores_in_kernel_order(dots, d) * inv_t
    if adj is not None:
        s = s - adj[None, :]
    if row_ids is not None:
        rows, cols = torch.arange(b), torch.arange(bk)
        s = s.masked_fill((row_ids[:, None] == col_ids[None, :]) & (rows[:, None] != cols),
                          sk.NEG)
    groups, tiles = 4, bk // 64
    s = s.reshape(b, tiles, 8, 4, 2)  # [row, tile, n, t, j]: column 64 tile + 8n + 2t + j
    ms, ls = [], []
    for k in range(groups):
        m, lt = torch.full((b,), sk.NEG), torch.zeros(b, 4)
        for tile in range(k, tiles, groups):
            st = s[:, tile]
            m_new = torch.maximum(m, st.amax(dim=(1, 2, 3)))
            part = torch.zeros(b, 4)
            for n in range(8):
                for j in range(2):
                    part = part + torch.exp(st[:, n, :, j] - m_new[:, None])
            lt = lt * torch.exp(m - m_new)[:, None] + part
            m = m_new
        ms.append(m)
        ls.append((lt[:, 0] + lt[:, 1]) + (lt[:, 2] + lt[:, 3]))
    big = ms[0]
    for m in ms[1:]:
        big = torch.maximum(big, m)
    total = torch.zeros(b)
    for m, lt in zip(ms, ls):
        total = total + lt * torch.exp(m - big)
    return big + torch.log(total)


@pytest.mark.parametrize("d,use_ids,use_logq,n_valid", [
    (64, True, True, None), (64, True, True, 384), (16, True, False, None),
    (128, False, True, 400), (128, True, True, None), (256, True, True, None),
    (192, True, True, 384)])
def test_forward_tensor_core_order_stays_within_the_card_tolerance(d, use_ids, use_logq,
                                                                   n_valid):
    """Kernel #9 sums each score in 16-deep chunks on the tensor cores and
    runs the online max and sum per thread over 16 columns of each 64-column
    tile, the tiles split over 4 warp groups whose (m, l) merge in group
    order, where the plain version takes one pass over a row. Recomputed
    here in that order, lse stays within the card tests' tolerance (rtol
    2e-5, atol 1e-5) of the reference's `_lse_fused` in interpret mode."""
    q, c, _, ids, log_q = _setup(seed=17, d=d)
    ids_f = jnp.asarray(ids).astype(jnp.float32)
    pad = lambda a: jnp.asarray(np.pad(a, ((0, 0), (0, -d % 128))))  # noqa: E731
    want = jax_sk._lse_fused(pad(q), pad(c), ids_f, ids_f, jnp.asarray(log_q),
                             jnp.arange(B, dtype=jnp.float32), 0.7, n_valid,
                             (use_ids, use_logq), True)
    # the kernel sees D zero-padded to 64, 128 or a multiple of 128, as the wrapper pads it
    q16, c16 = (sk._pad_dim(torch.from_numpy(x).to(torch.bfloat16)) for x in (q, c))
    ids_t = torch.from_numpy(ids) if use_ids else None
    adj = sk._merged_adj(torch.from_numpy(log_q) if use_logq else None, n_valid, B,
                         torch.device("cpu"))
    got = _tensor_core_order_forward(q16, c16, adj, ids_t, ids_t, 1 / 0.7)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LSE_TOL)
