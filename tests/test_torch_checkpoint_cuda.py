"""Training checkpoints on the card. This file imports no JAX, so it runs
where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_checkpoint_cuda.py

Without a CUDA device the tests skip (the CPU round trip is
`tests/test_torch_checkpointer.py`).

A restore copies into the template's own tensors, so a multi-step that has
already captured a CUDA graph over the state replays the restored values:
the run from the restored checkpoint equals an uninterrupted run bit for
bit, with no second capture. A checkpoint written on the card restores into
a template on the CPU."""

import dataclasses

import pytest
import torch

from two_tower_recommender_model_tpu_torch import config as cfg_lib
from two_tower_recommender_model_tpu_torch.data.device_featurizer import (
    PackedFeaturizer,
    make_packed_train_step,
)
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.train import step as step_lib
from two_tower_recommender_model_tpu_torch.train.pipeline import device_put_batch
from two_tower_recommender_model_tpu_torch.utils.checkpoint import Checkpointer, train_state_tensors

USERS, ITEMS, B, K = 1000, 300, 512, 4
CASES = {
    # name: (model config changes, train config changes)
    "f32": ({}, {}),
    "int8-tables": ({"compute_dtype": "bfloat16", "table_dtype": "int8"},
                    {"block_sorted_kernel": "bfloat16"}),
    "bf16-tables": ({"table_dtype": "bfloat16"}, {"block_sorted_kernel": "off"}),
    "sampled-softmax": ({}, {"loss": "sampled_softmax", "softmax_kernel": "on"}),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _setup(case, device, seed=0):
    model_changes, train_changes = CASES[case]
    cfg = cfg_lib.two_tower_model_config(USERS, ITEMS, embedding_dim=128, layer_sizes=(128, 64))
    cfg = dataclasses.replace(cfg, **model_changes)
    tcfg = cfg_lib.TrainConfig(**{"batch_size": B, "sorted_feature": "user_id",
                                  "block_sorted_kernel": "float32", "sparse_learning_rate": 0.05,
                                  **train_changes})
    state, dense_opt = step_lib.create_train_state(
        torch.Generator(device=device).manual_seed(seed), cfg, tcfg)
    step = make_packed_train_step(step_lib.make_train_step(cfg, tcfg, dense_opt), cfg,
                                  pack_label=True)
    return cfg, state, step


def _macros(cfg, dev, n):
    feat = PackedFeaturizer(cfg, pack_label=True, sort_feature="user_id")
    ds = SyntheticClickstream(USERS - 1, ITEMS - 1, seed=3)
    host = [feat(cols) for cols in ds.batches(B, n * K, split="train")]
    return [device_put_batch(step_lib.stack_batches(host[i * K:(i + 1) * K]), dev)
            for i in range(n)]


def _assert_equal(a, b):
    torch.cuda.synchronize()
    ta, tb = train_state_tensors(a), train_state_tensors(b)
    assert ta.keys() == tb.keys() and a.step == b.step
    differ = [n for n in ta if not torch.equal(ta[n].cpu(), tb[n].cpu())]
    assert not differ, {n: (ta[n].float().cpu() - tb[n].float().cpu()).abs().max().item()
                        for n in differ}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_restore_into_a_captured_state_replays_the_restored_values(dev, case, tmp_path):
    """A multi-step captures its graph over the state and replays macro 1;
    the state is checkpointed, trains on through macro 2, and is restored
    from the checkpoint in place. Macro 2 replayed again from there equals
    an uninterrupted run of macros 1 and 2 bit for bit, and the multi-step
    never captured a second graph."""
    cfg, state, step = _setup(case, dev)
    reference = state.copy()
    m1, m2 = _macros(cfg, dev, 2)
    multi = step_lib.make_multi_step(step)
    state, _ = multi(state, m1)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(state.step, state, extra={"macro": 1})
    state, _ = multi(state, m2)
    assert state.step == 2 * K
    state, _, extra = ckpt.restore(state)
    assert extra == {"macro": 1} and state.step == K
    state, _ = multi(state, m2)
    assert (multi.captures, multi.replays) == (1, 3)

    uninterrupted = step_lib.make_multi_step(step)
    for m in (m1, m2):
        reference, _ = uninterrupted(reference, m)
    _assert_equal(state, reference)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_a_checkpoint_written_on_the_card_restores_on_the_cpu(dev, case, tmp_path):
    cfg, state, step = _setup(case, dev)
    for pb in _macros(cfg, dev, 1):
        state, _ = step_lib.make_multi_step(step)(state, pb)
    Checkpointer(str(tmp_path)).save(state.step, state)
    _, template, _ = _setup(case, "cpu", seed=1)
    restored, _, _ = Checkpointer(str(tmp_path)).restore(template)
    assert restored.device.type == "cpu" and restored.step == K
    got, want = train_state_tensors(restored), train_state_tensors(state)
    for name, t in got.items():
        assert t.device.type == "cpu" and t.dtype == want[name].dtype
        assert torch.equal(t, want[name].cpu()), name
