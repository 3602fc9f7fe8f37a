"""The concat-MLP ranker at `param_dtype="bfloat16"` against the JAX
package's: the tables' gradient of plain autodiff (the reference's bf16
scatter-add, the port's #3 in its bf16 mode, the plain version here) bit for
bit `jax.vjp` of the pooled lookup on the same cotangent, and the plain bf16
mode bit for bit `zeros(bf16).at[ids].add(rows)`; then
`make_ranker_train_step` against `jax_ranker.make_ranker_train_step` (one
Adam in optax's bf16 arithmetic over the tables and the MLP)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from two_tower_recommender_model_tpu import config as jax_config
from two_tower_recommender_model_tpu.data.featurizer import Featurizer as JaxFeaturizer
from two_tower_recommender_model_tpu.models import concat_mlp as jax_ranker
from two_tower_recommender_model_tpu.ops.embedding_ops import pooled_lookup as jax_pooled_lookup
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.models import concat_mlp as port_ranker
from two_tower_recommender_model_tpu_torch.ops.adagrad_kernel import (
    block_sorted_aggregate,
    block_sorted_aggregate_reference,
)
from two_tower_recommender_model_tpu_torch.train.optimizer import OptaxAdam


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a) -> np.ndarray:
    """The raw 16 bits of a bf16 tensor or JAX array."""
    if isinstance(a, torch.Tensor):
        return a.detach().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _to_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jnp.asarray(a, jnp.bfloat16)).view(np.int16)).view(
        torch.bfloat16)


@pytest.mark.parametrize("slots", [1, 4, 7])
@pytest.mark.parametrize("pooling", ["mean", "sum"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_table_gradient_is_jax_grad_bit_for_bit(compute_dtype, pooling, slots):
    """A bf16 table [50, 16] pooled over 512 bags (dead slots, empty bags,
    a skewed first slot: runs of up to ~150 rows an id), the compute dtype
    f32 (rows widened, the cotangent's rows rounded back) or bf16: the
    port's `PooledLookup` forward and its table gradient on the same
    cotangent are the reference's `pooled_lookup` and its `jax.vjp`, bit for
    bit."""
    rng = np.random.default_rng(slots * 7 + len(pooling))
    n, d, b = 50, 16, 512
    table = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(0, n, (b, slots)).astype(np.int32)
    ids[:, 0] = (rng.zipf(1.3, b) - 1) % n
    mask = (rng.random((b, slots)) < 0.7).astype(np.float32)
    mask[::11] = 0  # empty bags
    cast = None if compute_dtype == "bfloat16" else jnp.float32

    def lookup(t):
        return jax_pooled_lookup(t, jnp.asarray(ids), jnp.asarray(mask), pooling, cast)

    out, vjp = jax.vjp(lookup, jnp.asarray(table, jnp.bfloat16))
    cot = rng.normal(size=(b, d)).astype(np.float32)
    (want,) = vjp(jnp.asarray(cot).astype(out.dtype))
    param = torch.nn.Parameter(_to_bf16(table))
    got = port_ranker.PooledLookup.apply(param, torch.from_numpy(ids), torch.from_numpy(mask),
                                         pooling, None if cast is None else torch.float32)
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(out.astype(jnp.float32)))
    got.backward(torch.from_numpy(cot).to(got.dtype))
    assert param.grad.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(param.grad), _bits(want))


@pytest.mark.parametrize("case", ["uniform", "rank-1", "perm-sentinels", "d30"])
def test_plain_bf16_mode_is_jax_bf16_scatter(case):
    """#3's plain bf16 mode (`block_sorted_aggregate(..., buffer_dtype=bf16)`
    on CPU tensors) against XLA's bf16 scatter-add `zeros((n, D), bf16)
    .at[ids].add(rows.astype(bf16))` on the same rows in the same order: bit
    for bit. Cases: uniform ids; rank^-1 ids (one run of ~2,000 of 4,096);
    unsorted ids through the stable sort's permutation with sentinels >= n
    (dropped, as JAX's scatter drops out-of-bounds rows); D = 30."""
    rng = np.random.default_rng(len(case))
    n, m, d = 300, 4096, 30 if case == "d30" else 64
    ids = rng.integers(0, n, m)
    if case == "rank-1":
        ids = np.minimum(rng.zipf(1.2, m) - 1, n - 1)
    rows = rng.normal(size=(m, d)).astype(np.float32)
    if case == "perm-sentinels":
        ids[rng.random(m) < 0.1] = n
        sids, perm = torch.sort(torch.from_numpy(ids.astype(np.int32)), stable=True)
        got = block_sorted_aggregate(n, sids, torch.from_numpy(rows), perm=perm.to(torch.int32),
                                     buffer_dtype=torch.bfloat16)
    else:
        ids = np.sort(ids)
        got = block_sorted_aggregate(n, torch.from_numpy(ids.astype(np.int32)),
                                     torch.from_numpy(rows), buffer_dtype=torch.bfloat16)
    want = jnp.zeros((n, d), jnp.bfloat16).at[jnp.asarray(ids)].add(
        jnp.asarray(rows).astype(jnp.bfloat16), mode="drop")
    assert got.dtype == torch.bfloat16 and got.shape == (n, d)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # bf16 gradients in: the same sums (the rows are bf16 values already)
    again = block_sorted_aggregate_reference(
        n, torch.from_numpy(np.sort(ids).astype(np.int32)),
        torch.from_numpy(rows[np.argsort(ids, kind="stable")]).to(torch.bfloat16),
        buffer_dtype=torch.bfloat16)
    np.testing.assert_array_equal(_bits(again), _bits(got))


USERS, ITEMS, D, B = 300, 120, 32, 256


def _configs(compute_dtype, history=False):
    cfg = jax_config.two_tower_model_config(USERS, ITEMS, embedding_dim=D,
                                            compute_dtype=compute_dtype)
    if history:  # a 4-slot mean-pooled feature on the item table, and a dense input
        cfg = dataclasses.replace(
            cfg, tables=(cfg.tables[0], dataclasses.replace(
                cfg.tables[1], feature_names=("product_id", "history"))),
            features=cfg.features + (jax_config.FeatureConfig("history", "t_product_id", 4,
                                                              "mean"),),
            query_tower=dataclasses.replace(cfg.query_tower,
                                            features=("user_id", "history"), dense_dim=8))
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    cfg.validate()
    return cfg, port_config.model_config_from_dict(dataclasses.asdict(cfg))


def _bf16_params(cfg, hidden=(32, 16), seed=0):
    """Uniform draws rounded to bf16, as `ml_dtypes` arrays."""
    rng = np.random.default_rng(seed)
    bf = lambda a: np.asarray(jnp.asarray(a.astype(np.float32), jnp.bfloat16))  # noqa: E731
    tables = {t.name: bf(rng.uniform(-0.5, 0.5, (t.num_embeddings, t.embedding_dim)))
              for t in cfg.tables}
    in_dim = sum(cfg.feature_table(f.name).embedding_dim for f in cfg.features)
    in_dim += cfg.query_tower.dense_dim + cfg.candidate_tower.dense_dim
    sizes, mlp = [in_dim, *hidden, 1], {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        bound = 1.0 / np.sqrt(a)
        mlp[f"layer_{i}"] = {"kernel": bf(rng.uniform(-bound, bound, (a, b))),
                             "bias": bf(rng.uniform(-bound, bound, b))}
    return {"tables": tables, "mlp": mlp}


def _batches(cfg, pcfg, history, seed):
    rng = np.random.default_rng(seed)
    cols = SyntheticClickstream(USERS - 1, ITEMS - 1, seed=seed, popularity=1.0).sample(B)
    cols["user_id"][::17] = 0
    if history:
        hist = rng.integers(1, ITEMS, (B, 4))
        hist[rng.random((B, 4)) < 0.4] = 0
        cols["history"] = hist
    jb, pb = JaxFeaturizer(cfg)(cols), Featurizer(pcfg, device="cpu")(cols)
    if history:
        dense = rng.normal(size=(B, 8)).astype(np.float32)
        jb, pb = jb.replace(dense=jnp.asarray(dense)), dataclasses.replace(
            pb, dense=torch.from_numpy(dense))
    return jax.tree.map(jnp.asarray, jb), pb


def _states(cfg, pcfg, lr):
    params = _bf16_params(cfg)
    jstep, jinit = jax_ranker.make_ranker_train_step(cfg, learning_rate=lr, donate=False)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = {**jinit(jax.random.key(0), hidden_sizes=(32, 16)), "params": jp,
              "opt_state": optax.adam(lr).init(jp)}
    pstep, pinit = port_ranker.make_ranker_train_step(pcfg, learning_rate=lr)
    model = port_ranker.ranker_params_from_numpy(params, pcfg, "cpu")
    pstate = {**pinit(torch.Generator().manual_seed(0), hidden_sizes=(32, 16)),
              "params": model, "opt": port_ranker.dense_optimizer(lr).build(model.parameters())}
    return jstep, jstate, pstep, pstate


def _pairs(pstate, jstate):
    """(port parameter, its path in the JAX pytrees, transposed) for every
    parameter."""
    model = pstate["params"]
    out = [(model.tables[k], ("tables", k), False) for k in jstate["params"]["tables"]]
    for i, layer in enumerate(model.mlp.layers):
        out += [(layer.weight, ("mlp", f"layer_{i}", "kernel"), True),
                (layer.bias, ("mlp", f"layer_{i}", "bias"), False)]
    return out


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _ulps_apart(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in bf16 ulps of want (8 significant bits)."""
    exp = np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
    return np.abs(got - want) / 2.0 ** (exp - 7)


@pytest.mark.parametrize("history", [False, True], ids=["one-slot", "multislot-dense"])
def test_three_f32_compute_steps_match_jax(history):
    """f32 compute: three steps from the same bf16 parameters and batches.
    The table gradient is the reference's scatter (held bit for bit above);
    the pooled and the MLP's gradients are f32 sums in another order than
    XLA's, so a gradient element near a bf16 rounding boundary rounds to the
    other neighbour in one package. After every step each table, weight,
    bias and Adam moment equals the reference's but at most 0.1% of its
    elements (measured at most 3 of 9,600), each within 2 bf16 ulps, the
    second moments (the squares of such gradients) within 8 (measured 2 and
    5); the f32 losses within 1e-5 (their summation order)."""
    cfg, pcfg = _configs("float32", history)
    jstep, jstate, pstep, pstate = _states(cfg, pcfg, 1e-2)
    assert type(pstate["opt"]) is OptaxAdam
    for i in range(3):
        jb, pb = _batches(cfg, pcfg, history, seed=10 + i)
        jstate, jout = jstep(jstate, jb)
        pstate, pout = pstep(pstate, pb)
        np.testing.assert_allclose(pout["loss"].item(), float(jout["loss"]), rtol=1e-5)
        adam = jstate["opt_state"][0]
        for p, path, t in _pairs(pstate, jstate):
            assert p.dtype == torch.bfloat16
            state = pstate["opt"].state[p]
            for got, w, ulps in ((p, jstate["params"], 2), (state["exp_avg"], adam.mu, 2),
                                 (state["exp_avg_sq"], adam.nu, 8)):
                got = got.detach().float().numpy()
                got = got.T if t else got
                want = np.asarray(_at(w, path).astype(jnp.float32))
                apart = got != want
                assert apart.sum() <= 1e-3 * want.size, (path, i, int(apart.sum()))
                assert (_ulps_apart(got, want)[apart] <= ulps).all(), (path, i)


def test_a_bf16_compute_step_matches_jax():
    """bf16 compute, one step: the loss and logits, the tables and the MLP's
    weights bit for bit the reference's; a bias's gradient is summed over
    the batch in bf16 by the reference and in f32 by the port, so the
    biases' Adam first moments (0.1 x the gradient) hold within 2^-4 x max
    (test_torch_ranker.py's BIAS_REL; measured 2 of 32 elements apart)."""
    cfg, pcfg = _configs("bfloat16")
    jstep, jstate, pstep, pstate = _states(cfg, pcfg, 1e-2)
    jb, pb = _batches(cfg, pcfg, False, seed=10)
    jstate, jout = jstep(jstate, jb)
    pstate, pout = pstep(pstate, pb)
    np.testing.assert_array_equal(_bits(pout["loss"]), _bits(jout["loss"]))
    np.testing.assert_array_equal(_bits(pout["logits"]), _bits(jout["logits"]))
    adam = jstate["opt_state"][0]
    for p, path, t in _pairs(pstate, jstate):
        if p.dim() == 2:
            np.testing.assert_array_equal(_bits(p.T.contiguous() if t else p),
                                          _bits(_at(jstate["params"], path)))
        else:
            got = pstate["opt"].state[p]["exp_avg"].float().numpy()
            mu = np.asarray(_at(adam.mu, path).astype(jnp.float32))
            np.testing.assert_allclose(got, mu, rtol=0, atol=2.0 ** -4 * np.abs(mu).max())


def test_bf16_parameters_load_from_bits_and_values():
    """`ranker_params_from_numpy` takes bf16 bits (`ml_dtypes` arrays or
    their uint16 view) exactly and f32 values rounded once; bf16 bits into
    an f32 ranker are refused."""
    cfg, pcfg = _configs("float32")
    params = _bf16_params(cfg)
    a = port_ranker.ranker_params_from_numpy(params, pcfg, "cpu")
    as_u16 = jax.tree.map(lambda x: np.asarray(x).view(np.uint16), params)
    as_f32 = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    for other in (as_u16, as_f32):
        b = port_ranker.ranker_params_from_numpy(other, pcfg, "cpu")
        for p, q in zip(a.parameters(), b.parameters()):
            assert p.dtype == q.dtype == torch.bfloat16 and torch.equal(p, q)
    with pytest.raises(ValueError, match="bf16 bits"):
        port_ranker.ranker_params_from_numpy(
            as_u16, dataclasses.replace(pcfg, param_dtype="float32"), "cpu")
