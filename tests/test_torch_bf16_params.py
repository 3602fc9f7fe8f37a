"""bf16 parameters (`param_dtype="bfloat16"`): the towers' Adam in optax's
arithmetic (`train/optimizer.py:OptaxAdam`) bit for bit `optax.adam` /
`optax.adamw` over 20 steps, at a constant rate and under schedules; the
roundings it rests on (the bias corrections, the Python constants); and the
two-tower train step against the JAX package's over 3 steps, in f32 and bf16
compute. f32 parameters keep `torch.optim.Adam`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from two_tower_recommender_model_tpu import config as jax_config
from two_tower_recommender_model_tpu.data.device_featurizer import (
    PackedFeaturizer as JaxPackedFeaturizer,
)
from two_tower_recommender_model_tpu.data.device_featurizer import (
    make_packed_train_step as jax_make_packed_train_step,
)
from two_tower_recommender_model_tpu.train import optimizer as jax_opt
from two_tower_recommender_model_tpu.train import step as jax_step
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.data.device_featurizer import (
    PackedFeaturizer,
    make_packed_train_step,
)
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.models.two_tower import params_from_numpy
from two_tower_recommender_model_tpu_torch.train import optimizer as port_opt
from two_tower_recommender_model_tpu_torch.train import step as port_step
from two_tower_recommender_model_tpu_torch.train.pipeline import map_leaves


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_param(a: np.ndarray) -> torch.nn.Parameter:
    return torch.nn.Parameter(torch.from_numpy(a).to(torch.bfloat16))


RECIPES = {
    "adam-constant": dict(learning_rate=1e-3),
    "adamw-constant": dict(learning_rate=3e-3, weight_decay=0.01),
    "adam-warmup-cosine": dict(learning_rate=1e-3, schedule="cosine", total_steps=20,
                               warmup_steps=5),
    "adamw-warmup-linear": dict(learning_rate=1e-2, schedule="linear", total_steps=20,
                                warmup_steps=3, end_factor=0.1, weight_decay=1e-4),
}


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("recipe", list(RECIPES))
def test_optax_adam_on_bf16_parameters_bit_for_bit(recipe, jit):
    """20 updates of bf16 weights by the JAX package's `dense_optimizer`
    (optax) and the port's (`OptaxAdam`) from the same bf16 gradients: every
    weight and both moments bit for bit after every step (jit and eager
    optax agree bit for bit, so per-operation rounding is the reference)."""
    kw = RECIPES[recipe]
    rng = np.random.default_rng(len(recipe))
    shapes = [(64, 32), (32,), (32, 16), (16,)]
    p0 = [rng.normal(0, 0.1, s).astype(np.float32) for s in shapes]
    tx = jax_opt.dense_optimizer(**kw)
    jp = [jnp.asarray(a, jnp.bfloat16) for a in p0]
    jstate = tx.init(jp)

    def update(g, state, p):
        u, state = tx.update(g, state, p)
        return optax.apply_updates(p, u), state

    if jit:
        update = jax.jit(update)
    tp = [_bf16_param(a) for a in p0]
    recipe_ = port_opt.dense_optimizer(**kw)
    opt = recipe_.build(tp)
    assert type(opt) is port_opt.OptaxAdam
    for t in range(20):
        grads = [rng.normal(0, 1e-2, s).astype(np.float32) for s in shapes]
        jp, jstate = update([jnp.asarray(g, jnp.bfloat16) for g in grads], jstate, jp)
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g).to(torch.bfloat16)
        recipe_.step(opt, t)
        adam = jstate[0]
        for j, p in enumerate(tp):
            assert p.dtype == torch.bfloat16
            np.testing.assert_array_equal(p.detach().float().numpy(), _f32(jp[j]))
            np.testing.assert_array_equal(opt.state[p]["exp_avg"].float().numpy(),
                                          _f32(adam.mu[j]))
            np.testing.assert_array_equal(opt.state[p]["exp_avg_sq"].float().numpy(),
                                          _f32(adam.nu[j]))
            assert opt.state[p]["step"].item() == t + 1 == int(adam.count)


def test_bias_corrections_round_as_optax_for_ten_thousand_counts():
    """optax's `1 - decay**count`: an f32 power of f32(decay) by the count,
    then rounded to bf16. The port's torch.pow on the same f32 operands gives
    the same bf16 value for counts 1 to 12,000 (b1 0.9, b2 0.999; their f32
    values differ in 0.01% / 0.2% of counts, never across a bf16 rounding
    boundary: the nearest lies 9 f32 ulps away, at b2 and count 6,235)."""
    counts = np.arange(1, 12_001, dtype=np.int32)
    for b in (0.9, 0.999):
        want = jax.jit(jax.vmap(lambda c: (1 - b ** c).astype(jnp.bfloat16)))(
            jnp.asarray(counts))
        step = torch.from_numpy(counts).float()
        got = (1 - torch.pow(torch.full_like(step, b), step)).to(torch.bfloat16)
        np.testing.assert_array_equal(got.float().numpy(), _f32(want))


def test_python_constants_round_through_f32():
    """JAX rounds a Python number to bf16 through f32 (two roundings), and so
    does the port: at a double just above a bf16 midpoint whose f32 rounding
    is the midpoint, both give the even neighbour below, not the nearest
    value above. As a learning rate, one update moves each weight alike."""
    x = 1 + 2.0 ** -8 + 2.0 ** -30  # f32(x) is the midpoint 1 + 2^-8
    assert np.float32(x) == 1 + 2.0 ** -8
    ones = jnp.ones((4,), jnp.bfloat16)
    assert _f32(x * ones)[0] == 1.0 == _f32(jax.jit(lambda a: x * a)(ones))[0]
    assert torch.tensor(x, dtype=torch.float32).to(torch.bfloat16).item() == 1.0
    p0 = np.full((8,), 0.5, np.float32)
    g = np.linspace(-1, 1, 8).astype(np.float32)
    tx = optax.adam(x)
    jp = [jnp.asarray(p0, jnp.bfloat16)]
    u, _ = tx.update([jnp.asarray(g, jnp.bfloat16)], tx.init(jp), jp)
    tp = [_bf16_param(p0)]
    opt = port_opt.dense_optimizer(x).build(tp)
    tp[0].grad = torch.from_numpy(g).to(torch.bfloat16)
    opt.step()
    np.testing.assert_array_equal(tp[0].detach().float().numpy(),
                                  _f32(optax.apply_updates(jp, u)[0]))


def test_scheduled_bf16_rate_matches_optax_over_the_schedule():
    """optax evaluates a schedule in f32 and rounds the rate to bf16; the
    port evaluates it in doubles, holds it in f32 and rounds it to bf16. The
    bf16 rates of a warmup + cosine schedule of 1,000 steps agree at every
    count but the last decaying one (999, a rate of 2.5e-9 at lr 1e-3, where
    1 + cos is tiny and an f32 ulp of cos moves the rate by half a percent)
    and, at lr 0.01, count 918 as well (1.688e-4 against 1.678e-4: one bf16
    ulp); under the linear and the constant-after-warmup schedules at every
    count."""
    for lr, sched, port, apart in [
        (1e-3, optax.join_schedules([optax.linear_schedule(0.0, 1e-3, 10),
                                     optax.cosine_decay_schedule(1e-3, 990)], [10]),
         port_opt.dense_optimizer(1e-3, "cosine", 1000, 10), [999]),
        (1e-2, optax.join_schedules([optax.linear_schedule(0.0, 1e-2, 10),
                                     optax.cosine_decay_schedule(1e-2, 990)], [10]),
         port_opt.dense_optimizer(1e-2, "cosine", 1000, 10), [918, 999]),
        (1e-3, optax.linear_schedule(1e-3, 5e-5, 1000),
         port_opt.dense_optimizer(1e-3, "linear", 1000, end_factor=0.05), []),
        (3e-3, optax.join_schedules([optax.linear_schedule(0.0, 3e-3, 50),
                                     optax.constant_schedule(3e-3)], [50]),
         port_opt.dense_optimizer(3e-3, warmup_steps=50), []),
    ]:
        rate = jax.jit(lambda c, sched=sched: jnp.array(-1 * sched(c), dtype=jnp.bfloat16))
        # one count a call, as optax's scale_by_schedule evaluates it
        want = np.array([_f32(rate(jnp.int32(c))) for c in range(1050)])
        got = torch.tensor([-port.schedule(t) for t in range(1050)],
                           dtype=torch.float32).to(torch.bfloat16).float().numpy()
        assert np.flatnonzero(got != want).tolist() == apart, lr


def test_f32_parameters_keep_torch_adam():
    p = [torch.nn.Parameter(torch.zeros(3))]
    assert type(port_opt.dense_optimizer(1e-3).build(p)) is torch.optim.Adam
    assert type(port_opt.dense_optimizer(1e-3, weight_decay=0.1).build(p)) is torch.optim.AdamW
    q = [torch.nn.Parameter(torch.zeros(3, dtype=torch.bfloat16))]
    opt = port_opt.dense_optimizer(1e-3, weight_decay=0.1).build(q)
    assert type(opt) is port_opt.OptaxAdam
    clone = port_opt.clone_dense_optimizer(opt, [torch.nn.Parameter(q[0].detach().clone())])
    assert type(clone) is port_opt.OptaxAdam and clone.param_groups[0]["weight_decay"] == 0.1


# --- the two-tower step at param_dtype="bfloat16" ------------------------------------

USERS, ITEMS, B = 1000, 300, 512


def _configs(compute_dtype):
    cfg = jax_config.two_tower_model_config(USERS, ITEMS, embedding_dim=128,
                                            layer_sizes=(128, 64), compute_dtype=compute_dtype)
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    tcfg = jax_config.TrainConfig(batch_size=B, sorted_feature="user_id",
                                  block_sorted_kernel="off", sparse_learning_rate=0.05,
                                  learning_rate=1e-3)
    return (cfg, tcfg, port_config.model_config_from_dict(dataclasses.asdict(cfg)),
            port_config.TrainConfig(**dataclasses.asdict(tcfg)))


def _bf16_numpy_params(cfg, seed=0):
    """Uniform draws rounded to bf16 (as `ml_dtypes` arrays: each package
    takes their bits)."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a.astype(np.float32), jnp.bfloat16))  # noqa: E731
    params = {"tables": {t.name: bf(rng.uniform(-0.5, 0.5, (t.num_embeddings, t.embedding_dim)))
                         for t in cfg.tables}}
    for key in ("query_tower", "candidate_tower"):
        sizes = [128, *getattr(cfg, key).layer_sizes]
        params[key] = {}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            bound = 1.0 / np.sqrt(a)
            params[key][f"layer_{i}"] = {"kernel": bf(rng.uniform(-bound, bound, (a, b))),
                                         "bias": bf(rng.uniform(-bound, bound, b))}
    return params


def _columns(n_batches, seed=7):
    ds = SyntheticClickstream(USERS - 1, ITEMS - 1, seed=seed)
    out = []
    for cols in ds.batches(B, n_batches, split="train"):
        cols["user_id"][::13] = 0
        out.append(cols)
    return out


def _tower_weights(jstate, pstate):
    """(port, JAX) f32 copies of every tower kernel and bias."""
    out = []
    for key in ("query_tower", "candidate_tower"):
        for i, layer in enumerate(getattr(pstate.model, key).layers):
            j = jstate.dense_params[key][f"layer_{i}"]
            out.append((layer.weight.detach().float().numpy().T, _f32(j["kernel"])))
            out.append((layer.bias.detach().float().numpy(), _f32(j["bias"])))
    return out


def _ulps_apart(got, want):
    """|got - want| in bf16 ulps of want (2^-7 relative: 8 significant bits)."""
    exp = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
    return np.abs(got - want) / 2.0 ** (exp - 7)


# The bars. f32 compute: the gradients are f32 sums in another order, then
# rounded to bf16 in both packages, so after one step the tables are bit for
# bit and a tower weight differs only where its bf16 gradient sits on the
# other side of a rounding boundary: at most 0.1% of them (measured 1 of
# 16,384 in one layer), each by one ulp. Three steps compound those: the
# losses within 1e-5, at most 1% of the table elements and 0.5% of the tower
# weights apart (measured 0.8% and 0.2%), each table element within 2^-7,
# four bf16 ulps of the values at 0.25-0.5 (measured 0.0059). bf16 compute:
# the logits, the pooled
# and the tower gradients are bf16 values whose sums on a rounding boundary
# go either way (test_torch_train_step.py's 2^-7), and Adam moves a weight
# by the rate whatever its gradient's size, so a gradient on a boundary
# moves a weight by ~lr: after one step the loss and logits within 2^-7 x
# max, the tables (moved ~0.05 by Adagrad) within one bf16 ulp of 0.5, and
# Adam's first moments (0.1 x the gradient) of the kernels within 2^-7 x
# max, as test_torch_train_step.py holds them (measured 0.0032), of the
# biases within 2^-4 x max (measured 0.0131: the reference sums a bias's
# gradient over the batch in bf16, the port in f32, test_torch_ranker.py's
# BIAS_REL); the losses of steps 2 and 3 within 2^-7.
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_two_tower_steps_at_bf16_params_match_jax(compute_dtype):
    cfg, tcfg, pcfg, ptcfg = _configs(compute_dtype)
    params = _bf16_numpy_params(cfg)
    jstate, jopt = jax_step.create_train_state(jax.random.key(0), cfg, tcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    dense = {k: jparams[k] for k in ("query_tower", "candidate_tower")}
    jstate = jstate.replace(tables=jparams["tables"], dense_params=dense,
                            dense_opt_state=jopt.init(dense))
    _, popt = port_step.create_train_state(torch.Generator().manual_seed(0), pcfg, ptcfg)
    model = params_from_numpy(params, pcfg, "cpu")
    opt = popt.build(port_step.tower_parameters(model))
    assert type(opt) is port_opt.OptaxAdam
    pstate = port_step.TrainState(0, model, {
        name: torch.zeros(t.shape[0]) for name, t in model.tables.items()}, opt)
    assert {t.dtype for t in model.tables.values()} == {torch.bfloat16}
    jtrain = jax_make_packed_train_step(
        jax_step.make_train_step(cfg, tcfg, jopt, jit=False), cfg, pack_label=True)
    ptrain = make_packed_train_step(port_step.make_train_step(pcfg, ptcfg, popt), pcfg,
                                    pack_label=True)
    jfeat = JaxPackedFeaturizer(cfg, pack_label=True, sort_feature="user_id")
    pfeat = PackedFeaturizer(pcfg, pack_label=True, sort_feature="user_id")
    f32 = compute_dtype == "float32"
    for i, cols in enumerate(_columns(3)):
        jstate, jout = jtrain(jstate, jfeat(cols))
        pstate, pout = ptrain(pstate, map_leaves(pfeat(cols), lambda t: t))
        loss, jloss = pout["loss"].float().item(), float(jout["loss"])
        assert abs(loss - jloss) <= (1e-5 if f32 else 2.0 ** -7) * abs(jloss)
        tables = [(pstate.model.tables[n].detach().float().numpy(), _f32(jstate.tables[n]))
                  for n in params["tables"]]
        if i == 0 and f32:
            for got, want in tables:
                np.testing.assert_array_equal(got, want)
            weights = _tower_weights(jstate, pstate)
            differ = sum(int((g != w).sum()) for g, w in weights)
            assert differ <= 1e-3 * sum(w.size for _, w in weights), differ
            for g, w in weights:
                assert (_ulps_apart(g, w) <= 1).all()
        elif i == 0:
            logits, jlogits = pout["logits"].float().numpy(), _f32(jout["logits"])
            np.testing.assert_allclose(logits, jlogits, rtol=0,
                                       atol=2.0 ** -7 * np.abs(jlogits).max())
            for got, want in tables:
                np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -9)
            mu = jstate.dense_opt_state[0].mu
            for key in ("query_tower", "candidate_tower"):
                for li, layer in enumerate(getattr(pstate.model, key).layers):
                    for p, name, t in ((layer.weight, "kernel", True), (layer.bias, "bias", False)):
                        got = pstate.dense_opt_state.state[p]["exp_avg"].float().numpy()
                        want = _f32(mu[key][f"layer_{li}"][name])
                        rel = 2.0 ** -7 if t else 2.0 ** -4
                        np.testing.assert_allclose(got.T if t else got, want, rtol=0,
                                                   atol=rel * np.abs(want).max())
        elif f32 and i == 2:
            for got, want in tables:
                assert (got != want).mean() <= 0.01
                np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -7)
            weights = _tower_weights(jstate, pstate)
            differ = sum(int((g != w).sum()) for g, w in weights)
            assert differ <= 5e-3 * sum(w.size for _, w in weights), differ
    assert pstate.step == 3


def test_bf16_state_copies_and_multi_step_on_the_cpu():
    """A bf16 state's copy carries OptaxAdam and its moments; the multi-step
    (a plain loop on CPU tensors) is the sequential steps bit for bit."""
    _, _, pcfg, ptcfg = _configs("float32")
    state, opt_recipe = port_step.create_train_state(torch.Generator().manual_seed(3), pcfg,
                                                     ptcfg)
    assert type(state.dense_opt_state) is port_opt.OptaxAdam
    step = make_packed_train_step(port_step.make_train_step(pcfg, ptcfg, opt_recipe), pcfg,
                                  pack_label=True)
    feat = PackedFeaturizer(pcfg, pack_label=True, sort_feature="user_id")
    batches = [map_leaves(feat(c), lambda t: t) for c in _columns(2, seed=5)]
    step(state, batches[0])
    twin = state.copy()
    assert type(twin.dense_opt_state) is port_opt.OptaxAdam
    for p, q in zip(port_step.tower_parameters(state.model),
                    port_step.tower_parameters(twin.model)):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(state.dense_opt_state.state[p][key],
                               twin.dense_opt_state.state[q][key])
    step(state, batches[1])
    multi = port_step.make_multi_step(step)
    multi(twin, port_step.stack_batches([batches[1]]))
    for a, b in zip(port_step.tower_parameters(state.model),
                    port_step.tower_parameters(twin.model)):
        assert torch.equal(a, b)
    for name in state.model.tables:
        assert torch.equal(state.model.tables[name], twin.model.tables[name])
