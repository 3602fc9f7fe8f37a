"""Profiling and step-rate observability.

Port of `two_tower_recommender_model_tpu/utils/profiling.py`:
`profile_trace` traces the enclosed block with `torch.profiler` (host and,
where there is a card, CUDA activities: each kernel by name, graph replays
included) and writes a Chrome trace (Perfetto, `chrome://tracing`);
`StepTimer` keeps a rolling examples/s; `device_memory_stats` reads the
card's allocator.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time

import torch

from two_tower_recommender_model_tpu_torch.device import resolve_device


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the enclosed block; on exit, also by an exception, write
    `trace_<pid>_<ns>.json` (Chrome trace format) into `log_dir`. Yields the
    `torch.profiler` profile, whose `key_averages()` sum the block by
    operation and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir,
                                              f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Rolling examples/s and step-time stats. `update(batch_size)` per step;
    a window keeps warm-up and capture steps from weighing forever."""

    def __init__(self, window: int = 50):
        self._times = collections.deque(maxlen=window + 1)
        self._examples = collections.deque(maxlen=window)
        self.total_steps = 0
        self.total_examples = 0
        self._t0 = time.perf_counter()
        self._times.append(self._t0)

    def update(self, batch_size: int) -> None:
        self._times.append(time.perf_counter())
        self._examples.append(batch_size)
        self.total_steps += 1
        self.total_examples += batch_size

    @property
    def examples_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return sum(self._examples) / dt if dt > 0 else 0.0

    @property
    def step_time_ms(self) -> float:
        if len(self._times) < 2:
            return 0.0
        return (self._times[-1] - self._times[0]) / (len(self._times) - 1) * 1e3

    def summary(self) -> dict[str, float]:
        wall = time.perf_counter() - self._t0
        return {
            "examples_per_sec": self.examples_per_sec,
            "step_time_ms": self.step_time_ms,
            "total_steps": float(self.total_steps),
            "total_examples": float(self.total_examples),
            "wall_time_s": wall,
        }


def device_memory_stats(device: torch.device | str | None = None) -> dict[str, dict[str, float]]:
    """`{device index: {"bytes_in_use", "bytes_limit"}}` of the card (the
    default device, which raises without one): the allocator's live bytes
    and the card's total memory. On the CPU, which reports neither, both are
    -1, as the reference gives a backend without memory stats."""
    device = resolve_device(device)
    if device.type != "cuda":
        return {str(device): {"bytes_in_use": -1.0, "bytes_limit": -1.0}}
    index = device.index if device.index is not None else torch.cuda.current_device()
    stats = torch.cuda.memory_stats(index)
    return {str(index): {
        "bytes_in_use": float(stats.get("allocated_bytes.all.current", -1)),
        "bytes_limit": float(torch.cuda.mem_get_info(index)[1]),
    }}
