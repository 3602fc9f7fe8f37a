"""The port's profiling helpers (`utils.profiling`): `StepTimer` equal to the
reference's under the same clock, `profile_trace` writing a Chrome trace on
the CPU, and `device_memory_stats` on the CPU and without a card."""

import json
import os

import pytest
import torch

from two_tower_recommender_model_tpu.utils import profiling as jax_profiling
from two_tower_recommender_model_tpu_torch.utils import profiling
from two_tower_recommender_model_tpu_torch.utils.profiling import (
    StepTimer,
    device_memory_stats,
    profile_trace,
)


class _Clock:
    """A `time.perf_counter` that advances by a fixed schedule."""

    def __init__(self, steps):
        self.now, self.steps = 100.0, iter(steps)

    def __call__(self):
        self.now += next(self.steps, 0.25)
        return self.now


@pytest.mark.parametrize("window", [3, 50])
def test_step_timer_matches_the_reference(window, monkeypatch):
    deltas = [0.0, 0.5, 0.25, 0.125, 1.0, 0.5, 0.75, 0.0625]
    summaries = []
    for module, timer_cls in ((profiling, StepTimer), (jax_profiling, jax_profiling.StepTimer)):
        monkeypatch.setattr(module.time, "perf_counter", _Clock(deltas))
        timer = timer_cls(window=window)
        assert timer.examples_per_sec == 0.0 and timer.step_time_ms == 0.0
        for b in (128, 256, 64, 512, 32, 1024):
            timer.update(b)
        summaries.append(timer.summary())
        monkeypatch.undo()
    assert summaries[0] == summaries[1]
    assert summaries[0]["total_steps"] == 6.0 and summaries[0]["total_examples"] == 2016.0


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace")) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum()
    assert any(e.key == "aten::matmul" for e in prof.key_averages())
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)


def test_profile_trace_writes_its_trace_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError, match="inside"):
        with profile_trace(str(tmp_path)):
            torch.ones(3).sum()
            raise ValueError("inside")
    assert len(os.listdir(tmp_path)) == 1


def test_device_memory_stats_on_the_cpu_and_without_a_card():
    assert device_memory_stats("cpu") == {"cpu": {"bytes_in_use": -1.0, "bytes_limit": -1.0}}
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_memory_stats()
