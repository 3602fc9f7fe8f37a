"""Resilient training in the port: `resilient_fit`'s restart policy (the
reference's six behaviour tests), a crash-resumed run equal bit for bit to
an uninterrupted one (f32, bf16 and int8 tables) and within the train-step
tolerances of the JAX package's run for each table dtype, and a JAX
mid-training state carried into the port (`train_state_from_numpy`) that
continues to the JAX package's result."""

import dataclasses
import logging

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
from two_tower_recommender_model_tpu.ops import quantized as jq
from two_tower_recommender_model_tpu.train import step as jax_step
from two_tower_recommender_model_tpu_torch import config as port_config
from two_tower_recommender_model_tpu_torch.data.device_featurizer import (
    PackedFeaturizer,
    make_packed_train_step,
)
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.ops.quantized import (
    QuantizedTable,
    dequantize_table,
    quantize_table,
)
from two_tower_recommender_model_tpu_torch.train import resilient_fit
from two_tower_recommender_model_tpu_torch.train import step as port_step
from two_tower_recommender_model_tpu_torch.train.pipeline import map_leaves
from two_tower_recommender_model_tpu_torch.train.resilient import (
    TrainingFailure,
    transient_error_types,
)
from two_tower_recommender_model_tpu_torch.utils import Checkpointer
from two_tower_recommender_model_tpu_torch.utils.checkpoint import train_state_tensors


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test steps are small, and the suite runs
    several test processes on the same cores, where torch's thread pools
    would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the restart policy --------------------------------------------------------


def test_resilient_fit_retries_and_reports():
    calls = []

    def attempt(restart):
        calls.append(restart)
        if restart < 2:
            raise OSError(f"boom {restart}")  # transient class: retried
        return {"ok": 1.0}

    out = resilient_fit(attempt, max_restarts=3, backoff_s=0.0)
    assert out["ok"] == 1.0 and out["restarts"] == 2
    assert len(out["failures"]) == 2
    assert calls == [0, 1, 2]


def test_resilient_fit_exhausts():
    with pytest.raises(TrainingFailure, match="after 2 restarts"):
        resilient_fit(lambda r: (_ for _ in ()).throw(ConnectionError("x")),
                      max_restarts=2, backoff_s=0.0)


def test_resilient_fit_bug_raises_immediately():
    """A programming error is not transient: it surfaces on the first
    attempt."""
    calls = []

    def buggy(restart):
        calls.append(restart)
        raise ValueError("shape mismatch")

    with pytest.raises(ValueError, match="shape mismatch"):
        resilient_fit(buggy, max_restarts=3, backoff_s=0.0)
    assert calls == [0]


def test_resilient_fit_transient_types_cover_device_faults():
    types = transient_error_types()
    assert OSError in types and TimeoutError in types
    assert torch.AcceleratorError in types  # what a CUDA device fault raises
    # neither a plain RuntimeError (the bug class) nor running out of device
    # memory (the same program on the same shapes runs out again) is retried
    assert not issubclass(RuntimeError, types)
    assert not issubclass(torch.cuda.OutOfMemoryError, types)


def test_resilient_fit_optin_retry_everything():
    calls = []

    def attempt(restart):
        calls.append(restart)
        if restart == 0:
            raise RuntimeError("flaky bug")
        return {"ok": 1.0}

    out = resilient_fit(attempt, max_restarts=1, backoff_s=0.0, retry_on=(Exception,))
    assert out["restarts"] == 1 and calls == [0, 1]


def test_resilient_fit_logs_traceback(caplog):
    def attempt(restart):
        if restart == 0:
            raise OSError("shard read failed")
        return {"ok": 1.0}

    with caplog.at_level(logging.WARNING,
                         logger="two_tower_recommender_model_tpu_torch.train.resilient"):
        resilient_fit(attempt, max_restarts=1, backoff_s=0.0)
    joined = "\n".join(r.getMessage() for r in caplog.records)
    assert "Traceback" in joined and "shard read failed" in joined


# --- crash and resume against an uninterrupted run and the JAX package ----------

# the widths and sizes of `tests/test_torch_train_step.py`; f32 compute, the
# block kernel off on both sides: f32 summation order, that file's tolerance
# for its f32 cases (each quantity within 1e-5 x its largest magnitude). At
# narrower towers a final-ReLU input within an f32 rounding of zero opens in
# one package only, and a table row's update moves by more.
USERS, ITEMS, DIM, B, STEPS = 1000, 300, 128, 512, 6
REL = 1e-5


def _configs(table_dtype=None, loss="bce"):
    cfg = jax_config.two_tower_model_config(USERS, ITEMS, embedding_dim=DIM,
                                            layer_sizes=(128, 64))
    cfg = dataclasses.replace(cfg, fused_tower_backward="off", table_dtype=table_dtype)
    tcfg = jax_config.TrainConfig(batch_size=B, sorted_feature="user_id", block_sorted_kernel="off",
                                  sparse_learning_rate=0.05, learning_rate=1e-3, loss=loss,
                                  softmax_kernel="off", softmax_temperature=0.5)
    return (cfg, tcfg, port_config.model_config_from_dict(dataclasses.asdict(cfg)),
            port_config.TrainConfig(**dataclasses.asdict(tcfg)))


def _numpy_state(cfg, seed=0):
    """A fresh training state in `train_state_from_numpy`'s layout: random
    f32 tables and towers, zero accumulators and Adam moments."""
    rng = np.random.default_rng(seed)
    state = {"step": 0, "tables": {}, "adagrad_acc": {}}
    for t in cfg.tables:
        state["tables"][t.name] = rng.uniform(-0.5, 0.5, (t.num_embeddings, t.embedding_dim)
                                              ).astype(np.float32)
        state["adagrad_acc"][t.name] = np.zeros(t.num_embeddings, np.float32)
    moments = {}
    for key in ("query_tower", "candidate_tower"):
        sizes = [DIM, *getattr(cfg, key).layer_sizes]
        state[key], moments[key] = {}, {}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            bound = 1.0 / np.sqrt(a)
            state[key][f"layer_{i}"] = {
                "kernel": rng.uniform(-bound, bound, (a, b)).astype(np.float32),
                "bias": rng.uniform(-bound, bound, b).astype(np.float32)}
            moments[key][f"layer_{i}"] = {"kernel": np.zeros((a, b), np.float32),
                                          "bias": np.zeros(b, np.float32)}
    state["adam"] = {"count": 0, "mu": moments, "nu": moments}
    return state


def _port_start(state, pcfg, ptcfg):
    """`state` with its tables in the model's storage dtype (an int8 table
    as the values and scales its f32 rows quantize to)."""
    tables = {}
    for name, t in state["tables"].items():
        if pcfg.table_dtype_of(name) == "int8":
            q = quantize_table(torch.from_numpy(t))
            t = {"values": q.values.numpy(), "scales": q.scales.numpy()}
        tables[name] = t
    item_counts = None
    if ptcfg.loss == "sampled_softmax" and ptcfg.logq_correction:
        item_counts = np.zeros(ITEMS, np.float32)
    return {**state, "tables": tables, "item_counts": item_counts}


def _batches(cfg, n, seed=7):
    """The same packed batches for both packages (some user ids missing)."""
    ds = SyntheticClickstream(USERS - 1, ITEMS - 1, seed=seed)
    jfeat = JaxPackedFeaturizer(cfg, pack_label=True, sort_feature="user_id")
    pfeat = PackedFeaturizer(port_config.model_config_from_dict(dataclasses.asdict(cfg)),
                             pack_label=True, sort_feature="user_id")
    out = []
    for cols in ds.batches(B, n, split="train"):
        cols["user_id"][::13] = 0
        out.append((jfeat(cols), map_leaves(pfeat(cols), lambda t: t)))
    return out


def _port_step(pcfg, ptcfg, opt):
    return make_packed_train_step(port_step.make_train_step(pcfg, ptcfg, opt), pcfg,
                                  pack_label=True)


def _jax_tables(cfg, tables):
    """`tables` (f32 rows, or an int8 table's values and scales) in the JAX
    package's storage: a bf16 table rounded to bf16 as the port rounds it."""
    out = {}
    for name, t in tables.items():
        if isinstance(t, dict):
            out[name] = jq.QuantizedTable(values=jnp.asarray(t["values"]),
                                          scales=jnp.asarray(t["scales"]))
        else:
            out[name] = jnp.asarray(t, jnp.bfloat16 if cfg.table_dtype_of(name) == "bfloat16"
                                    else jnp.float32)
    return out


def _jax_run(cfg, tcfg, start, batches):
    """The JAX package's run from `start` over `batches`: its end state and
    each step's loss."""
    jstate, jopt = jax_step.create_train_state(jax.random.key(0), cfg, tcfg)
    dense = {k: jax.tree.map(jnp.asarray, start[k]) for k in ("query_tower", "candidate_tower")}
    jstate = jstate.replace(tables=_jax_tables(cfg, start["tables"]), dense_params=dense,
                            dense_opt_state=jopt.init(dense))
    step = jax_make_packed_train_step(jax_step.make_train_step(cfg, tcfg, jopt, jit=False), cfg,
                                      pack_label=True)
    losses = []
    for jpb in batches:
        jstate, out = step(jstate, jpb)
        losses.append(float(out["loss"]))
    return jstate, losses


def _jax_state_to_numpy(js) -> dict:
    host = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    adam = js.dense_opt_state[0]  # optax.adam: (ScaleByAdamState, the rate's state)
    return {"step": int(js.step), "tables": host(js.tables), "adagrad_acc": host(js.adagrad_acc),
            **host(js.dense_params),
            "adam": {"count": int(adam.count), "mu": host(adam.mu), "nu": host(adam.nu)},
            "item_counts": None if js.item_counts is None else np.asarray(js.item_counts)}


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _check_against_jax(start, pstate, jstate):
    """Tables (the change against the change, untouched rows to their bits),
    accumulators, the towers' weights and biases, Adam's moments and count,
    the step and the item counts."""
    want = _jax_state_to_numpy(jstate)
    for name, t0 in start["tables"].items():
        got = pstate.model.tables[name].detach().numpy()
        moved = np.any(want["tables"][name] != t0, axis=1)
        assert moved.any() and not moved.all()
        np.testing.assert_array_equal(got[~moved], t0[~moved])
        _close(got - t0, want["tables"][name] - t0)
        _close(pstate.adagrad_acc[name], want["adagrad_acc"][name])
    opt = pstate.dense_opt_state
    for key in ("query_tower", "candidate_tower"):
        for i, layer in enumerate(getattr(pstate.model, key).layers):
            for pname, p in (("kernel", layer.weight), ("bias", layer.bias)):
                got = p.detach().numpy()
                _close(got.T if pname == "kernel" else got, want[key][f"layer_{i}"][pname])
                for moment, name in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                    got = opt.state[p][name].numpy()
                    _close(got.T if pname == "kernel" else got,
                           want["adam"][moment][key][f"layer_{i}"][pname])
                assert opt.state[p]["step"].item() == want["adam"]["count"]
    assert pstate.step == want["step"]
    if want["item_counts"] is not None:
        np.testing.assert_array_equal(pstate.item_counts.numpy(), want["item_counts"])


@pytest.mark.parametrize("table_dtype", [None, "bfloat16", "int8"])
def test_crash_resume_equals_uninterrupted(table_dtype, tmp_path):
    """Training crashes (an injected OSError) after step 3 of 6; the
    restarted attempt restores the latest checkpoint and continues. Its end
    state equals an uninterrupted run's bit for bit: tables in their storage
    dtype, accumulators, towers, Adam's moments and counts, the step, and
    each step's loss. It also matches the JAX package's uninterrupted run at
    the bars its train-step tests hold for the same table dtype: in f32 the
    whole state within 1e-5 x max (`_check_against_jax`); with bf16 tables
    the first loss within rtol 1e-5 and every loss within 5e-3
    (`test_bf16_run_of_25_batches_tracks_jax_and_f32`); with int8 tables the
    first loss within rtol 1e-5, every loss within rtol 1e-3 and the
    dequantized tables within 1e-2 (`test_int8_train_steps_match_jax` after
    several steps, f32 compute)."""
    cfg, tcfg, pcfg, ptcfg = _configs(table_dtype)
    start = _numpy_state(cfg)
    batches = _batches(cfg, STEPS)
    port_start = _port_start(start, pcfg, ptcfg)

    def fresh():
        state, opt = port_step.train_state_from_numpy(port_start, pcfg, ptcfg, "cpu")
        return state, _port_step(pcfg, ptcfg, opt)

    ref, step = fresh()
    ref_losses = []
    for _, ppb in batches:
        ref, out = step(ref, ppb)
        ref_losses.append(out["loss"].item())

    ckpt = Checkpointer(str(tmp_path / "c"))
    crash_at, finals, losses = 3, [], [None] * STEPS

    def attempt(restart):
        state, step = fresh()
        first = 0
        if ckpt.latest_step() is not None:
            state, loader_state, _ = ckpt.restore(state)
            first = loader_state["batches_yielded"]
        for i in range(first, STEPS):
            state, out = step(state, batches[i][1])
            losses[i] = out["loss"].item()
            ckpt.save(state.step, state, loader_state={"batches_yielded": i + 1})
            if restart == 0 and i + 1 == crash_at:
                raise OSError("injected crash")
        finals.append(state)
        return {"done": 1.0}

    out = resilient_fit(attempt, max_restarts=1, backoff_s=0.0)
    assert out["restarts"] == 1 and ckpt.all_steps() == [4, 5, 6]  # max_to_keep=3
    got = finals[0]
    assert got.step == ref.step == STEPS and losses == ref_losses
    want_tensors = train_state_tensors(ref)
    for name, t in train_state_tensors(got).items():
        assert t.dtype == want_tensors[name].dtype
        assert torch.equal(t, want_tensors[name]), name
    jstate, jlosses = _jax_run(cfg, tcfg, port_start, [jb for jb, _ in batches])
    if table_dtype is None:
        _check_against_jax(start, got, jstate)
        return
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-5)
    if table_dtype == "bfloat16":
        assert all(t.dtype == torch.bfloat16 for t in got.model.tables.values())
        np.testing.assert_allclose(losses, jlosses, rtol=0, atol=5e-3)
    else:
        np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
        for name, t in got.model.tables.items():
            assert isinstance(t, QuantizedTable)
            np.testing.assert_allclose(dequantize_table(t).numpy(),
                                       np.asarray(jq.dequantize_table(jstate.tables[name])),
                                       atol=1e-2)


@pytest.mark.parametrize("loss", ["bce", "sampled_softmax"])
def test_jax_state_carried_mid_run_continues_to_the_jax_result(loss):
    """The JAX package takes 3 steps; `train_state_from_numpy` carries its
    whole state (tables, accumulators, towers, Adam's mu / nu / count, step,
    the softmax's item counts) into the port, which takes 3 more. The end
    state matches the JAX package's after 6 steps."""
    cfg, tcfg, pcfg, ptcfg = _configs(loss=loss)
    start = _numpy_state(cfg)
    batches = _batches(cfg, STEPS)
    jbatches = [jb for jb, _ in batches]
    mid = _jax_state_to_numpy(_jax_run(cfg, tcfg, start, jbatches[:3])[0])
    assert mid["step"] == mid["adam"]["count"] == 3
    assert (mid["item_counts"] is not None) == (loss == "sampled_softmax")
    pstate, opt = port_step.train_state_from_numpy(mid, pcfg, ptcfg, "cpu")
    step = _port_step(pcfg, ptcfg, opt)
    for _, ppb in batches[3:]:
        pstate, _ = step(pstate, ppb)
    _check_against_jax(start, pstate, _jax_run(cfg, tcfg, start, jbatches)[0])


def test_train_state_from_numpy_refuses_item_counts_the_config_does_not_take():
    cfg, _, pcfg, ptcfg = _configs()
    with pytest.raises(ValueError, match="item_counts"):
        port_step.train_state_from_numpy({**_numpy_state(cfg), "item_counts": np.zeros(ITEMS)},
                                         pcfg, ptcfg, "cpu")
