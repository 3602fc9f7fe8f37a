"""The concat-MLP ranker (`models/concat_mlp.py`) against the JAX package's
on the same numpy weights and batches: the forward, the gradients (the
tables' through the lookup's backward: the slot rows summed by id with
kernel #3's plain version), three Adam steps, in f32 and bf16 compute; and
dropout, which draws from an explicit torch generator."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu import config as jax_config
from two_tower_recommender_model_tpu.data.featurizer import Featurizer as JaxFeaturizer
from two_tower_recommender_model_tpu.models import concat_mlp as jax_ranker
from two_tower_recommender_model_tpu.models.losses import bce_with_logits as jax_bce
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.models import concat_mlp as port_ranker
from two_tower_recommender_model_tpu_torch.models.losses import bce_with_logits
from two_tower_recommender_model_tpu_torch.ops import adagrad_kernel
from two_tower_recommender_model_tpu_torch.ops.relu_ties import tie_mask


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


USERS, ITEMS, D, B = 300, 120, 32, 256


def _configs(compute_dtype, history=False, dense_dim=0):
    cfg = jax_config.two_tower_model_config(USERS, ITEMS, embedding_dim=D,
                                            compute_dtype=compute_dtype)
    if history:  # a 4-slot mean-pooled feature on the item table: runs of many slots an id
        cfg = dataclasses.replace(
            cfg, tables=(cfg.tables[0], dataclasses.replace(
                cfg.tables[1], feature_names=("product_id", "history"))),
            features=cfg.features + (jax_config.FeatureConfig("history", "t_product_id", 4,
                                                              "mean"),),
            query_tower=dataclasses.replace(cfg.query_tower,
                                            features=("user_id", "history"),
                                            dense_dim=dense_dim))
    cfg.validate()
    return cfg, port_config.model_config_from_dict(dataclasses.asdict(cfg))


def _numpy_params(cfg, hidden=(32, 16), seed=0):
    rng = np.random.default_rng(seed)
    tables = {t.name: rng.uniform(-0.5, 0.5, (t.num_embeddings, t.embedding_dim))
              .astype(np.float32) for t in cfg.tables}
    in_dim = sum(cfg.feature_table(f.name).embedding_dim for f in cfg.features)
    in_dim += cfg.query_tower.dense_dim + cfg.candidate_tower.dense_dim
    sizes, mlp = [in_dim, *hidden, 1], {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        bound = 1.0 / np.sqrt(a)
        mlp[f"layer_{i}"] = {"kernel": rng.uniform(-bound, bound, (a, b)).astype(np.float32),
                             "bias": rng.uniform(-bound, bound, b).astype(np.float32)}
    return {"tables": tables, "mlp": mlp}


def _columns(n, history=False, dense_dim=0, seed=3):
    rng = np.random.default_rng(seed)
    ds = SyntheticClickstream(USERS - 1, ITEMS - 1, seed=seed, popularity=1.0)
    cols = ds.sample(n)
    cols["user_id"][::17] = 0
    if history:
        hist = rng.integers(1, ITEMS, (n, 4))
        hist[rng.random((n, 4)) < 0.4] = 0  # missing slots, some bags empty
        cols["history"] = hist
    if dense_dim:
        cols["dense"] = rng.normal(size=(n, dense_dim)).astype(np.float32)
    return cols


def _batches(cfg, pcfg, cols):
    jb = JaxFeaturizer(cfg)(cols)
    pb = Featurizer(pcfg, device="cpu")(cols)
    if "dense" in cols:
        jb = jb.replace(dense=jnp.asarray(cols["dense"]))
        pb = dataclasses.replace(pb, dense=torch.from_numpy(cols["dense"]))
    return jax.tree.map(jnp.asarray, jb), pb


def _close(got, want, rel):
    """Within rel x max|want|."""
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


# (compute dtype) -> rel: f32 summation order (1e-5); bf16 compute: the
# activations and the pooled rows are bf16, and a value on a rounding boundary
# goes either way in the two packages: two bf16 ulps, 2^-7 x max
REL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# Under bf16 compute the MLP's products are torch's f32 sums in another order
# than XLA's (the reference leaves them to XLA; the port to `_mm`), rounded to
# bf16: a pre-activation whose bf16 sum sits at a rounding tie against -bias
# (`tie_mask`) may take the other ReLU decision in one package, and a flipped
# unit moves every gradient its sample reaches. The towers' rule holds here:
# a decision may differ only where `tie_mask` flags the port's pre-activation.
# A sample with a flagged pre-activation in any hidden layer is "tied"; every
# other sample's decisions must equal JAX's, its logit and the gradients of
# the loss over those samples (the tied ones weighted 0, in both packages)
# hold at 2^-7 x max on every element. A mean-pooled bag's input rounds as
# the reference's does (`ops/embedding_ops.py:pooled_lookup`), so the MLP's
# inputs are the reference's bit for bit and no other sample is exempt.
MAX_TIED_SHARE = 0.1  # the rule must leave the comparison most of the batch


def _hidden_pre_activations(model, pb, pcfg, monkeypatch):
    """The port's MLP input x [B, K] and its hidden layers' bf16 products y
    and biases b, recorded at `_mm`: (x, [(y [B, H], b [H])])."""
    calls = []
    real_mm = port_ranker._mm

    def mm(a, w):
        calls.append((a, real_mm(a, w)))
        return calls[-1][1]

    with monkeypatch.context() as m:
        m.setattr(port_ranker, "_mm", mm)
        with torch.no_grad():
            port_ranker.ranker_forward(model, pb, pcfg)
    return calls[0][0], [(y, layer.bias.detach().to(y.dtype))
                         for (_, y), layer in zip(calls[:-1], model.mlp.layers)]


def _jax_hidden_decisions(params, jb, cfg):
    """The reference's MLP input x and hidden ReLU decisions [B, H] a layer,
    the layers of `ranker_forward` written out (dropout 0)."""
    from two_tower_recommender_model_tpu.models.two_tower import pooled_embeddings

    p = jax.tree.map(jnp.asarray, params)
    pooled = pooled_embeddings(p["tables"], jb, cfg)
    xs = [pooled[f.name] for f in cfg.features]
    if jb.dense is not None:
        xs.append(jb.dense.astype(xs[0].dtype))
    dt = jnp.dtype(cfg.compute_dtype)
    x = x0 = jnp.concatenate(xs, axis=1).astype(dt)
    out = []
    for i in range(len(p["mlp"]) - 1):
        layer = p["mlp"][f"layer_{i}"]
        x = jnp.dot(x, layer["kernel"].astype(dt),
                    preferred_element_type=jnp.float32).astype(dt) + layer["bias"].astype(dt)
        out.append(np.asarray(x > 0))
        x = jax.nn.relu(x)
    return np.asarray(x0.astype(jnp.float32)), out


def _tied_samples(model, pb, pcfg, params, jb, cfg, monkeypatch):
    """[B] bool: the samples exempt from the comparison (none in f32
    compute): those with a `tie_mask`-flagged hidden pre-activation. Checks
    the rule: every other sample decides each hidden ReLU as JAX does."""
    b = pb.labels.shape[0]
    if cfg.compute_dtype != "bfloat16":
        return np.zeros(b, bool)
    x, layers = _hidden_pre_activations(model, pb, pcfg, monkeypatch)
    jx, decisions = _jax_hidden_decisions(params, jb, cfg)
    tied = np.zeros(b, bool)
    for y, bias in layers:
        tied |= tie_mask(y, bias.expand_as(y)).numpy().any(axis=1)
    other_input = (x.float().numpy() != jx).any(axis=1)
    assert not other_input.any(), f"MLP inputs differ: samples {np.flatnonzero(other_input)}"
    flipped = np.zeros(b, bool)
    for (y, bias), want in zip(layers, decisions):
        flipped |= (((y + bias) > 0).numpy() != want).any(axis=1)
    away = flipped & ~tied
    assert not away.any(), f"ReLU decisions away from a tie differ: samples {np.flatnonzero(away)}"
    assert tied.mean() <= MAX_TIED_SHARE, tied.mean()
    return tied


CASES = {"f32": ("float32", False, 0), "bf16": ("bfloat16", False, 0),
         "f32-multislot-dense": ("float32", True, 8), "bf16-multislot-dense": ("bfloat16", True, 8)}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_gradients_match_jax(case, monkeypatch):
    compute_dtype, history, dense_dim = CASES[case]
    cfg, pcfg = _configs(compute_dtype, history, dense_dim)
    params = _numpy_params(cfg)
    jb, pb = _batches(cfg, pcfg, _columns(B, history, dense_dim))
    jparams = jax.tree.map(jnp.asarray, params)
    model = port_ranker.ranker_params_from_numpy(params, pcfg, "cpu")
    tied = _tied_samples(model, pb, pcfg, params, jb, cfg, monkeypatch)
    weights = (~tied).astype(np.float32)

    def loss_of(p):
        logits = jax_ranker.ranker_forward(p, jb, cfg)
        return jax_bce(logits, jb.labels, jnp.asarray(weights)), logits

    (jloss, jlogits), jgrads = jax.value_and_grad(loss_of, has_aux=True)(jparams)
    cotangents = []  # each layer's output gradient [B, H], last layer first
    real_mm = port_ranker._mm

    def mm(a, w):
        out = real_mm(a, w)
        out.register_hook(cotangents.append)
        return out

    monkeypatch.setattr(port_ranker, "_mm", mm)
    logits = port_ranker.ranker_forward(model, pb, pcfg)
    loss = bce_with_logits(logits, pb.labels, torch.from_numpy(weights))
    loss.backward()
    rel = REL[compute_dtype]
    assert logits.dtype == torch.float32 if compute_dtype == "float32" else torch.bfloat16
    _close(logits[torch.from_numpy(~tied)], np.asarray(jlogits.astype(jnp.float32))[~tied], rel)
    _close(loss, float(jloss), rel)
    for name in params["tables"]:
        g = model.tables[name].grad
        assert g.dtype == torch.float32 and g.shape == model.tables[name].shape
        _close(g, jgrads["tables"][name], rel)
    for i, layer in enumerate(model.mlp.layers):
        _close(layer.weight.grad.T, jgrads["mlp"][f"layer_{i}"]["kernel"], rel)
        want = np.asarray(jgrads["mlp"][f"layer_{i}"]["bias"], np.float32)
        if compute_dtype == "float32":
            _close(layer.bias.grad, want, rel)
        else:  # a sum over the batch in bf16 (see bf16_sum_bound)
            bound = bf16_sum_bound(cotangents[len(model.mlp.layers) - 1 - i])
            assert (np.abs(layer.bias.grad.numpy() - want) <= bound).all()


def bf16_sum_bound(terms: torch.Tensor) -> np.ndarray:
    """A bias's gradient sums its layer's output gradient `terms` [B, H] over
    the batch. Under bf16 compute JAX's transpose of the broadcast add
    reduces in bf16 (lax.reduce_sum in the compute dtype, in XLA's order),
    torch in f32 with one rounding; where the sum cancels the two part by
    many of its ulps. Bound: log2(B) roundings of half a bf16 ulp (2^-9) of
    the column's sum of magnitudes, and one of the result."""
    mags = terms.float().abs().sum(dim=0).numpy()
    return np.log2(terms.shape[0]) * 2.0 ** -9 * mags + 2.0 ** -8 * mags


# Adam's moments of the biases: the f32 forward's 1e-5; bf16 as the weights
BIAS_REL = {"float32": 1e-5, "bfloat16": 2.0 ** -4}


def test_table_gradient_sums_each_id_in_slot_order():
    """f32 compute, one slot a feature: each table row's gradient is XLA's
    scatter of the transpose, bit for bit (an id's rows summed in (b, l)
    order, which the stable device sort keeps)."""
    cfg, pcfg = _configs("float32")
    params = _numpy_params(cfg)
    jb, pb = _batches(cfg, pcfg, _columns(B))
    jg = jax.grad(lambda p: jax_bce(jax_ranker.ranker_forward(p, jb, cfg), jb.labels))(
        jax.tree.map(jnp.asarray, params))
    model = port_ranker.ranker_params_from_numpy(params, pcfg, "cpu")
    bce_with_logits(port_ranker.ranker_forward(model, pb, pcfg), pb.labels).backward()
    for name in params["tables"]:
        got = model.tables[name].grad.numpy()
        want = np.asarray(jg["tables"][name])
        # the same rows summed in the same order; only the pooled gradients' own
        # f32 differences (the MLP's backward) remain
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    rows = torch.from_numpy(np.random.default_rng(0).normal(size=(B, 1, D)).astype(np.float32))
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 40, (B, 1)).astype(np.int32))
    mask = torch.ones((B, 1))
    mask[::9] = 0
    got = port_ranker.table_grad(40, ids, mask, rows)
    want = jnp.zeros((40, D)).at[jnp.asarray(ids.numpy().reshape(-1))].add(
        jnp.asarray((rows * mask[..., None]).reshape(-1, D).numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _carry(jstate, pcfg, learning_rate):
    """The JAX ranker state (params, optax Adam's moments and count) as the
    port's: a Ranker and a torch Adam holding the same moments."""
    params = jax.tree.map(np.array, jstate["params"])
    model = port_ranker.ranker_params_from_numpy(params, pcfg, "cpu")
    opt = port_ranker.dense_optimizer(learning_rate).build(model.parameters())
    adam = jstate["opt_state"][0]
    pairs = [(model.tables[k], ("tables", k), None) for k in params["tables"]]
    for i, layer in enumerate(model.mlp.layers):
        pairs += [(layer.weight, ("mlp", f"layer_{i}", "kernel"), "T"),
                  (layer.bias, ("mlp", f"layer_{i}", "bias"), None)]
    for p, path, transpose in pairs:
        for moment, name in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
            v = moment
            for key in path:
                v = v[key]
            v = np.array(v, np.float32)
            opt.state[p][name].copy_(torch.from_numpy(np.ascontiguousarray(
                v.T if transpose else v)))
        opt.state[p]["step"].fill_(int(adam.count))
    return model, opt, pairs


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_three_adam_steps_match_jax(compute_dtype, monkeypatch):
    """`make_ranker_train_step` at dropout 0 over three batches. Before each
    step the JAX package's state (params, Adam's moments and count) is
    carried into the port, then both step on the same batch: the loss and
    logits, and the step's gradients as Adam's new first moments (the
    tables' dense ones included) and second moments, at the forward's
    tolerance. (Without the carry the states part: Adam's first steps move
    each weight by about +-lr whatever its gradient's size, so a near-zero
    gradient that rounds differently flips it.) Under bf16 compute each step
    trains on the batch's untied samples (`_tied_samples` on the carried
    weights; the step's loss takes no weights), so every element holds."""
    cfg, pcfg = _configs(compute_dtype)
    lr = 1e-2
    jstep, jinit = jax_ranker.make_ranker_train_step(cfg, learning_rate=lr, donate=False)
    jstate = jinit(jax.random.key(0), hidden_sizes=(32, 16))
    jparams = jax.tree.map(jnp.asarray, _numpy_params(cfg))
    jstate = {**jstate, "params": jparams, "opt_state": jax_ranker_opt_init(jparams, lr)}
    pstep, pinit = port_ranker.make_ranker_train_step(pcfg, learning_rate=lr)
    pstate = pinit(torch.Generator().manual_seed(0), hidden_sizes=(32, 16))
    rel = REL[compute_dtype]
    for i in range(3):
        model, opt, pairs = _carry(jstate, pcfg, lr)
        pstate = {**pstate, "params": model, "opt": opt, "step": i}
        cols = _columns(B, seed=10 + i)
        jb, pb = _batches(cfg, pcfg, cols)
        tied = _tied_samples(model, pb, pcfg, jax.tree.map(np.asarray, jstate["params"]), jb,
                             cfg, monkeypatch)
        jb, pb = _batches(cfg, pcfg, {k: v[~tied] for k, v in cols.items()})
        jstate, jout = jstep(jstate, jb)
        pstate, pout = pstep(pstate, pb)
        _close(pout["loss"], float(jout["loss"]), rel)
        _close(pout["logits"], jout["logits"].astype(jnp.float32), rel)
        adam = jstate["opt_state"][0]
        assert int(adam.count) == i + 1
        for p, path, transpose in pairs:
            for moment, name, tol in ((adam.mu, "exp_avg", rel), (adam.nu, "exp_avg_sq", 2 * rel)):
                want = moment
                for key in path:
                    want = want[key]
                got = opt.state[p][name]
                tol = BIAS_REL[compute_dtype] * (1 + (name == "exp_avg_sq")) \
                    if path[-1] == "bias" else tol
                _close(got.T if transpose else got, want, tol)
    assert pstate["step"] == 3 and int(jstate["step"]) == 3


def jax_ranker_opt_init(params, lr):
    import optax

    return optax.adam(lr).init(params)


def test_init_and_shapes():
    cfg, pcfg = _configs("float32", history=True, dense_dim=8)
    model = port_ranker.init_ranker_params(torch.Generator().manual_seed(0), pcfg, (32, 16))
    ref = jax_ranker.init_ranker_params(jax.random.key(0), cfg, (32, 16))
    for name, t in model.tables.items():
        assert t.shape == ref["tables"][name].shape
        bound = (1.0 / t.shape[0]) ** 0.5
        assert t.abs().max().item() <= bound
    assert [tuple(layer.weight.T.shape) for layer in model.mlp.layers] == [
        ref["mlp"][f"layer_{i}"]["kernel"].shape for i in range(3)]
    bf16 = port_ranker.Ranker(dataclasses.replace(pcfg, param_dtype="bfloat16"), (8,), "cpu")
    assert {p.dtype for p in bf16.tables.values()} == {torch.bfloat16}
    assert {p.dtype for p in bf16.mlp.parameters()} == {torch.bfloat16}


def test_dropout_is_deterministic_given_the_generator():
    """The same generator seed gives the same mask and logits, another seed
    others; the keep share of 200,000 draws at rate 0.3 lies within five
    binomial standard deviations of 0.7; kept values are scaled by 1/0.7;
    at rate 0 nothing is drawn."""
    x = torch.rand((400, 500)) + 0.5
    a = port_ranker.dropout(x, 0.3, torch.Generator().manual_seed(1))
    b = port_ranker.dropout(x, 0.3, torch.Generator().manual_seed(1))
    c = port_ranker.dropout(x, 0.3, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = a != 0
    n, p = x.numel(), 0.7
    assert abs(kept.sum().item() - n * p) <= 5 * (n * p * (1 - p)) ** 0.5
    torch.testing.assert_close(a[kept], x[kept] / 0.7, rtol=1e-6, atol=0)

    cfg, pcfg = _configs("float32")
    model = port_ranker.ranker_params_from_numpy(_numpy_params(cfg), pcfg, "cpu")
    _, pb = _batches(cfg, pcfg, _columns(B))
    runs = [port_ranker.ranker_forward(model, pb, pcfg, 0.3, torch.Generator().manual_seed(s))
            for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    gen = torch.Generator().manual_seed(5)
    before = gen.get_state()
    plain = port_ranker.ranker_forward(model, pb, pcfg, 0.0, gen)
    assert torch.equal(gen.get_state(), before)
    assert not torch.equal(plain, runs[0])
    # the train step draws from its state's generator: two runs from one seed agree
    step, init = port_ranker.make_ranker_train_step(pcfg, 1e-2, dropout_rate=0.3)
    losses = []
    for _ in range(2):
        state = init(torch.Generator().manual_seed(9), (16,))
        losses.append([step(state, pb)[1]["loss"].item() for _ in range(2)])
    assert losses[0] == losses[1]


def test_the_lookup_gradient_goes_through_the_aggregate(monkeypatch):
    """The table gradient is one call of kernel #3's wrapper a feature, with
    the stable sort's permutation; the forward one pooled gather."""
    calls = []
    real = adagrad_kernel.block_sorted_aggregate

    def record(n, sids, grads, perm=None):
        calls.append((n, perm is not None, bool(torch.all(sids[1:] >= sids[:-1]))))
        return real(n, sids, grads, perm=perm)

    monkeypatch.setattr(port_ranker, "block_sorted_aggregate", record)
    cfg, pcfg = _configs("float32")
    model = port_ranker.ranker_params_from_numpy(_numpy_params(cfg), pcfg, "cpu")
    _, pb = _batches(cfg, pcfg, _columns(B))
    bce_with_logits(port_ranker.ranker_forward(model, pb, pcfg), pb.labels).backward()
    assert sorted(calls) == [(ITEMS, True, True), (USERS, True, True)]
