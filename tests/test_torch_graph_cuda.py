"""The multi-step on the card: K train steps captured into one CUDA graph and
replayed, against K eager steps from a copy of the same state. This file
imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graph_cuda.py

Without a CUDA device the tests skip (a CUDA graph has no CPU mode; the CPU
path of the multi-step is `tests/test_torch_multi_step.py`).

Eager and captured steps launch the same kernels in the same order on the
same inputs, and the towers' optimizer is the capturable one in both, so the
end states are compared bit for bit."""

import dataclasses

import pytest
import torch

from two_tower_recommender_model_tpu_torch import config as cfg_lib
from two_tower_recommender_model_tpu_torch.data.device_featurizer import (
    PackedFeaturizer,
    make_packed_train_step,
)
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.ops.quantized import QuantizedTable
from two_tower_recommender_model_tpu_torch.train import optimizer as opt_lib
from two_tower_recommender_model_tpu_torch.train import step as step_lib
from two_tower_recommender_model_tpu_torch.train.loop import train_one_epoch_packed
from two_tower_recommender_model_tpu_torch.train.pipeline import device_put_batch

USERS, ITEMS, B, K = 1000, 300, 512, 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _state_parts(state):
    out = {}
    for name, t in state.model.tables.items():
        if isinstance(t, QuantizedTable):
            out[f"{name}.values"], out[f"{name}.scales"] = t.values, t.scales
        else:
            out[name] = t.detach()
        out[f"{name}.acc"] = state.adagrad_acc[name]
    for i, p in enumerate(step_lib.tower_parameters(state.model)):
        out[f"tower{i}"] = p.detach()
        for key, v in state.dense_opt_state.state[p].items():
            out[f"tower{i}.{key}"] = v
    if state.item_counts is not None:
        out["item_counts"] = state.item_counts
    return out


def _assert_states_equal(a, b):
    torch.cuda.synchronize()
    pa, pb = _state_parts(a), _state_parts(b)
    assert pa.keys() == pb.keys()
    differ = [name for name in pa if not torch.equal(pa[name], pb[name])]
    assert not differ, {n: (pa[n].float() - pb[n].float()).abs().max().item() for n in differ}
    assert a.step == b.step


CASES = {
    # name: (model config changes, train config changes, optimizer recipe)
    "f32": ({}, {}, None),
    "bf16-compute-bf16-kernel": ({"compute_dtype": "bfloat16"},
                                 {"block_sorted_kernel": "bfloat16"}, None),
    "int8-tables": ({"compute_dtype": "bfloat16", "table_dtype": "int8"},
                    {"block_sorted_kernel": "bfloat16"}, None),
    "bf16-tables": ({"table_dtype": "bfloat16"}, {"block_sorted_kernel": "off"}, None),
    "sampled-softmax": ({}, {"loss": "sampled_softmax", "softmax_kernel": "on"}, None),
    "cosine-warmup-adamw": (
        {}, {}, lambda: opt_lib.dense_optimizer(3e-3, "cosine", total_steps=10, warmup_steps=3,
                                                weight_decay=0.01)),
}


def _setup(dev, case, sparse_update=None):
    model_changes, train_changes, make_opt = CASES[case]
    cfg = cfg_lib.two_tower_model_config(USERS, ITEMS, embedding_dim=128, layer_sizes=(128, 64))
    cfg = dataclasses.replace(cfg, **model_changes)
    tcfg = cfg_lib.TrainConfig(**{"batch_size": B, "sorted_feature": "user_id",
                                  "block_sorted_kernel": "float32", "sparse_learning_rate": 0.05,
                                  **train_changes})
    state, dense_opt = step_lib.create_train_state(torch.Generator(device=dev).manual_seed(0),
                                                   cfg, tcfg)
    if make_opt is not None:
        dense_opt = make_opt()
        state.dense_opt_state = dense_opt.build(step_lib.tower_parameters(state.model))
    core = step_lib.make_train_step(cfg, tcfg, dense_opt, sparse_update=sparse_update)
    step = make_packed_train_step(core, cfg, pack_label=True)
    feat = PackedFeaturizer(cfg, pack_label=True, sort_feature="user_id")
    ds = SyntheticClickstream(USERS - 1, ITEMS - 1, seed=3)
    host = [feat(cols) for cols in ds.batches(B, 3 * K, split="train")]
    return cfg, tcfg, state, step, feat, host


def _macro(host, dev):
    return device_put_batch(step_lib.stack_batches(host), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_graph_multi_step_equals_eager_steps(dev, case):
    """Two macros of K steps through the graph == 2 K eager steps: every
    tensor of the state bit for bit, the K losses, the step count. The second
    macro is a replay with another payload and the next K learning rates."""
    cfg, tcfg, state_a, step, feat, host = _setup(dev, case)
    state_b = state_a.copy()
    start = {k: v.clone() for k, v in _state_parts(state_b).items()}
    eager_losses = []
    for pb in host[:2 * K]:
        state_a, out = step(state_a, device_put_batch(pb, dev))
        eager_losses.append(out["loss"].float())
    multi = step_lib.make_multi_step(step)
    state_b, out1 = multi(state_b, _macro(host[:K], dev))
    assert (multi.captures, multi.replays) == (1, 1) and state_b.step == K
    after_one = {k: v.clone() for k, v in _state_parts(state_b).items()}
    assert any(not torch.equal(after_one[k], start[k]) for k in start)  # the replay ran
    state_b, out2 = multi(state_b, _macro(host[K:2 * K], dev))
    assert (multi.captures, multi.replays) == (1, 2) and state_b.step == 2 * K
    # the first macro's losses are a copy: the second replay did not overwrite them
    assert torch.equal(out1["loss"], torch.stack(eager_losses[:K]))
    assert torch.equal(out2["loss"], torch.stack(eager_losses[K:]))
    assert out1["loss"].shape == (K,) and torch.isfinite(out2["loss"]).all()
    _assert_states_equal(state_a, state_b)
    if state_b.item_counts is not None:
        assert state_b.item_counts.sum().item() == 2 * K * B
    # an eager step on the same state after replays, then another replay
    state_a, _ = step(state_a, device_put_batch(host[2 * K], dev))
    state_b, _ = step(state_b, device_put_batch(host[2 * K], dev))
    last = host[2 * K + 1:3 * K] + host[:1]
    for pb in last:
        state_a, _ = step(state_a, device_put_batch(pb, dev))
    state_b, _ = multi(state_b, _macro(last, dev))
    assert multi.captures == 1
    _assert_states_equal(state_a, state_b)


@pytest.mark.cuda
def test_a_second_state_and_a_second_shape_are_captured_anew(dev):
    cfg, tcfg, state_a, step, feat, host = _setup(dev, "f32")
    state_b = state_a.copy()
    ref_a, ref_b = state_a.copy(), state_b.copy()
    multi = step_lib.make_multi_step(step)
    state_a, _ = multi(state_a, _macro(host[:K], dev))
    state_b, _ = multi(state_b, _macro(host[K:2 * K], dev))  # never replayed into state_a
    assert (multi.captures, multi.replays) == (2, 2)
    state_a, _ = multi(state_a, _macro(host[2 * K:2 * K + 2], dev))  # K = 2: a new shape
    assert (multi.captures, multi.replays) == (3, 3) and state_a.step == K + 2
    for pb in host[:K] + host[2 * K:2 * K + 2]:
        ref_a, _ = step(ref_a, device_put_batch(pb, dev))
    for pb in host[K:2 * K]:
        ref_b, _ = step(ref_b, device_put_batch(pb, dev))
    _assert_states_equal(ref_a, state_a)
    _assert_states_equal(ref_b, state_b)


@pytest.mark.cuda
def test_an_update_that_returns_new_tensors_is_copied_back_under_the_graph(dev):
    """`block_sorted_rowwise_adagrad` returns new tables and accumulators;
    while the graph is captured the step copies them back into the state's
    own tensors, so a replay updates the live table, not a dead one."""
    def sorted_first(table, acc, fids, fgrads, lr, eps):
        sids, perm = torch.sort(fids, stable=True)
        return opt_lib.block_sorted_rowwise_adagrad(table, acc, sids, fgrads[perm], lr, eps)

    cfg, tcfg, state_a, step, feat, host = _setup(dev, "f32", sparse_update=sorted_first)
    state_b = state_a.copy()
    tables = {name: t.data_ptr() for name, t in state_b.model.tables.items()}
    for pb in host[:2 * K]:
        state_a, _ = step(state_a, device_put_batch(pb, dev))
    multi = step_lib.make_multi_step(step)
    state_b, _ = multi(state_b, _macro(host[:K], dev))
    state_b, _ = multi(state_b, _macro(host[K:2 * K], dev))
    assert {name: t.data_ptr() for name, t in state_b.model.tables.items()} == tables
    _assert_states_equal(state_a, state_b)


@pytest.mark.cuda
def test_packed_epoch_on_the_card_equals_eager_steps(dev):
    """`train_one_epoch_packed` with the graph multi-step, the pipeline's
    worker threads pinning and copying while the first macro is captured, a
    tail step and mid-epoch validation: the state equals eager steps over the
    same batches."""
    from two_tower_recommender_model_tpu_torch.data.device_featurizer import make_packed_eval_step

    cfg, _, state_a, step, feat, _ = _setup(dev, "f32")
    tcfg = cfg_lib.TrainConfig(batch_size=B, validation_freq=5, limit_train_batches=14,
                               limit_val_batches=1)
    ds = SyntheticClickstream(USERS - 1, ITEMS - 1, seed=9)
    cols = list(ds.batches(B, 16, split="train"))
    state_b = state_a.copy()
    for c in cols[:14]:
        state_a, out_a = step(state_a, device_put_batch(feat(c), dev))
    multi = step_lib.make_multi_step(step)
    seen = []

    class Rec:
        def log_metrics(self, m, step=None):
            seen.append(step)

    eval_step = make_packed_eval_step(step_lib.make_eval_step(cfg, tcfg), cfg, pack_label=True)
    state_b, stats = train_one_epoch_packed(
        state_b, multi, iter(cols), feat, macro=K, num_workers=3, train_cfg=tcfg, tail_step=step,
        eval_step=eval_step, val_batches_factory=lambda: ds.batches(B, 2, split="val"),
        logger=Rec())
    assert stats["train_steps"] == 14 and stats["train_examples"] == 14 * B
    assert (multi.captures, multi.replays) == (1, 3)  # 3 macros of 4, then 2 tail steps
    assert seen == [8, 12]  # at the macro boundaries past 5 and 10; the tail ends at 14 < 15
    assert stats["train_loss"] == out_a["loss"].float().item()
    _assert_states_equal(state_a, state_b)


@pytest.mark.cuda
def test_eager_steps_use_the_capturable_optimizer(dev):
    cfg, _, state, step, feat, host = _setup(dev, "f32")
    group = state.dense_opt_state.param_groups[0]
    assert group["capturable"] and torch.is_tensor(group["lr"]) and group["lr"].is_cuda
    p = step_lib.tower_parameters(state.model)[0]
    assert state.dense_opt_state.state[p]["step"].is_cuda
    host_state = state.copy("cpu")
    hgroup = host_state.dense_opt_state.param_groups[0]
    assert not hgroup["capturable"] and isinstance(hgroup["lr"], float)
    hp = step_lib.tower_parameters(host_state.model)[0]
    assert host_state.dense_opt_state.state[hp]["step"].device.type == "cpu"
