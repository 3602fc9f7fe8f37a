"""The port's training checkpoints (`utils.checkpoint.Checkpointer`): a whole
train state round-trips bit for bit (f32, bf16 and int8 tables, the
accumulators, the towers, Adam's moments and counts, the sampled softmax's
item counts, the step) into a template on its own device; retention, an empty
directory, a mismatched template and a half-written step."""

import dataclasses
import os

import pytest
import torch

from two_tower_recommender_model_tpu_torch import config as cfg_lib
from two_tower_recommender_model_tpu_torch.data.featurizer import Featurizer
from two_tower_recommender_model_tpu_torch.data.synthetic import SyntheticClickstream
from two_tower_recommender_model_tpu_torch.ops.quantized import QuantizedTable
from two_tower_recommender_model_tpu_torch.train import step as step_lib
from two_tower_recommender_model_tpu_torch.utils import Checkpointer
from two_tower_recommender_model_tpu_torch.utils.checkpoint import (
    EXTRA_FILE,
    STATE_FILE,
    train_state_tensors,
)

USERS, ITEMS = 200, 60


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test steps are small, and the suite runs
    several test processes on the same cores, where torch's thread pools
    would contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(table_dtype=None, users=USERS):
    mcfg = cfg_lib.two_tower_model_config(users, ITEMS, embedding_dim=16, layer_sizes=(16, 8))
    mcfg = dataclasses.replace(mcfg, table_dtype=table_dtype)
    tcfg = cfg_lib.TrainConfig(loss="sampled_softmax", sparse_learning_rate=0.1)
    return mcfg, tcfg


def _trained(table_dtype=None, steps=3, seed=0):
    """A state after `steps` steps: every tensor has moved from its start."""
    mcfg, tcfg = _configs(table_dtype)
    state, opt = step_lib.create_train_state(torch.Generator().manual_seed(seed), mcfg, tcfg)
    step = step_lib.make_train_step(mcfg, tcfg, opt)
    feat = Featurizer(mcfg, device="cpu")
    for cols in SyntheticClickstream(USERS - 1, ITEMS - 1, seed=seed).batches(128, steps):
        state, _ = step(state, feat(cols))
    return state


def _template(table_dtype=None, users=USERS):
    mcfg, tcfg = _configs(table_dtype, users)
    return step_lib.create_train_state(torch.Generator().manual_seed(99), mcfg, tcfg)[0]


@pytest.mark.parametrize("table_dtype", [None, "bfloat16", "int8"])
def test_a_train_state_round_trips_bit_for_bit(table_dtype, tmp_path):
    state = _trained(table_dtype)
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(state.step, state, loader_state={"epoch": 1, "batches_yielded": 3},
              extra={"completed_epoch": 0})
    template = _template(table_dtype)
    before = {k: v.data_ptr() for k, v in train_state_tensors(template).items()}
    restored, loader_state, extra = ckpt.restore(template)
    assert restored is template and restored.step == state.step == 3
    assert loader_state == {"epoch": 1, "batches_yielded": 3}
    assert extra == {"completed_epoch": 0}
    got, want = train_state_tensors(restored), train_state_tensors(state)
    assert got.keys() == want.keys()
    # everything a step reads: tables in their storage dtype, accumulators,
    # towers, Adam's moments and per-parameter counts, item counts
    assert {k.split("/")[0] for k in got} == {"model", "adagrad_acc", "dense_opt", "item_counts"}
    assert any(k.endswith("/step") for k in got) and any(k.endswith("/exp_avg_sq") for k in got)
    for name, t in got.items():
        assert t.dtype == want[name].dtype and t.device == want[name].device
        assert torch.equal(t, want[name]), name
        assert t.data_ptr() == before[name], f"{name} was replaced, not copied into"
    if table_dtype == "int8":
        assert isinstance(restored.model.tables["t_user_id"], QuantizedTable)
        assert restored.model.tables["t_user_id"].values.dtype == torch.int8
    elif table_dtype == "bfloat16":
        assert restored.model.tables["t_user_id"].dtype == torch.bfloat16


def test_restore_takes_a_given_step_and_keeps_max_to_keep(tmp_path):
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2)
    states = {}
    for steps in (1, 2, 3):
        states[steps] = _trained(steps=steps)
        ckpt.save(steps, states[steps], extra={"n": steps})
    assert ckpt.all_steps() == [2, 3] and ckpt.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == ["2", "3"]  # no temporary directory is left
    restored, _, extra = ckpt.restore(_template(), step=2)
    assert extra == {"n": 2} and restored.step == 2
    for name, t in train_state_tensors(restored).items():
        assert torch.equal(t, train_state_tensors(states[2])[name]), name
    # a step saved again is replaced whole
    ckpt.save(3, states[1], extra={"n": 1})
    assert ckpt.all_steps() == [2, 3] and ckpt.restore(_template())[2] == {"n": 1}


def test_an_empty_directory_has_no_latest_step(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "new"))
    assert os.path.isdir(tmp_path / "new") and ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ckpt.restore(_template())


def test_a_half_written_step_is_not_seen(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, _trained(steps=1))
    # a save that died before its rename: a temporary directory with a partial file
    partial = tmp_path / ".tmp-2-crashed"
    partial.mkdir()
    (partial / STATE_FILE).write_bytes(b"\x80\x02partial")
    assert ckpt.latest_step() == 1 and ckpt.all_steps() == [1]
    assert ckpt.restore(_template())[0].step == 1
    assert sorted(os.listdir(tmp_path / "1")) == sorted([STATE_FILE, EXTRA_FILE])


@pytest.mark.parametrize("template_kind", ["shape", "dtype", "int8 values"])
def test_a_mismatched_template_raises_and_stays_as_it_was(template_kind, tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(3, _trained())
    template = {"shape": lambda: _template(users=USERS + 1),
                "dtype": lambda: _template("bfloat16"),
                "int8 values": lambda: _template("int8")}[template_kind]()
    before = {k: v.clone() for k, v in train_state_tensors(template).items()}
    with pytest.raises(ValueError, match="checkpoint"):
        ckpt.restore(template)
    assert template.step == 0
    for name, t in train_state_tensors(template).items():
        assert torch.equal(t, before[name]), name


def test_the_context_manager_closes(tmp_path):
    with Checkpointer(str(tmp_path)) as ckpt:
        ckpt.save(1, _trained(steps=1), wait=True)
    assert Checkpointer(str(tmp_path)).latest_step() == 1
