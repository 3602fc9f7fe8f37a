"""Hyperparameter sweeps: random, grid or TPE search with ranked results.

The port's own copy of `two_tower_recommender_model_tpu/tuning/sweep.py`
(framework-free: numpy and the standard library). A search space of
categorical choices and (log-)uniform ranges, `num_trials` trials of
`trial_fn(config) -> metrics`, ranked by one metric; a failed trial is
recorded, not fatal. The space primitives are deterministic in (seed,
trial index), so a sweep reproduces.

`max_workers > 1` runs trials in worker processes started by the **spawn**
method: a forked child cannot use CUDA once its parent has started it, so
the reference's default fork would break trials that train on the card.
`trial_fn` must then be importable by name (a module-level function), and
the results and their order are the reference's.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import multiprocessing
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Callable, Mapping

import numpy as np

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class Choice:
    options: tuple

    def sample(self, rng):
        return self.options[rng.integers(len(self.options))]

    def grid(self):
        return list(self.options)


@dataclasses.dataclass(frozen=True)
class LogUniform:
    low: float
    high: float

    def sample(self, rng):
        return float(np.exp(rng.uniform(np.log(self.low), np.log(self.high))))

    def grid(self, n: int = 3):
        return list(np.exp(np.linspace(np.log(self.low), np.log(self.high), n)))


@dataclasses.dataclass(frozen=True)
class Uniform:
    low: float
    high: float

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))

    def grid(self, n: int = 3):
        return list(np.linspace(self.low, self.high, n))


def sample_space(space: Mapping[str, Any], rng) -> dict:
    out = {}
    for k, v in space.items():
        out[k] = v.sample(rng) if hasattr(v, "sample") else v
    return out


def grid_space(space: Mapping[str, Any]) -> list[dict]:
    keys, axes = [], []
    for k, v in space.items():
        keys.append(k)
        axes.append(v.grid() if hasattr(v, "grid") else [v])
    return [dict(zip(keys, combo)) for combo in itertools.product(*axes)]


@dataclasses.dataclass
class TrialResult:
    index: int
    config: dict
    metrics: dict
    error: str | None = None


@dataclasses.dataclass
class SweepResult:
    trials: list[TrialResult]
    metric: str
    mode: str

    def completed(self) -> list[TrialResult]:
        return [t for t in self.trials if t.error is None and self.metric in t.metrics]

    def ranked(self) -> list[TrialResult]:
        sign = 1.0 if self.mode == "min" else -1.0
        return sorted(self.completed(), key=lambda t: sign * t.metrics[self.metric])

    def best(self) -> TrialResult:
        ranked = self.ranked()
        if not ranked:
            raise RuntimeError("no completed trials")
        return ranked[0]

    def table(self) -> str:
        lines = [f"{'#':<4}{self.metric:>14}  config"]
        for t in self.ranked():
            lines.append(f"{t.index:<4}{t.metrics[self.metric]:>14.5f}  {t.config}")
        for t in self.trials:
            if t.error is not None:
                lines.append(f"{t.index:<4}{'FAILED':>14}  {t.config}  ({t.error.splitlines()[-1]})")
        return "\n".join(lines)


def spawn_pool(max_workers: int) -> ProcessPoolExecutor:
    """A process pool whose workers start by spawn (a fresh interpreter),
    never fork: a forked child of a process that has used CUDA cannot."""
    return ProcessPoolExecutor(max_workers=max_workers,
                               mp_context=multiprocessing.get_context("spawn"))


def call_trial(trial_fn, config, trial_index, logger_root):
    """One trial invocation + per-trial logger dir; top-level so it pickles
    into worker processes."""
    try:
        metrics = dict(trial_fn(dict(config)))
        err = None
    except Exception:
        metrics, err = {}, traceback.format_exc()
    if logger_root is not None:
        from two_tower_recommender_model_tpu_torch.utils.tracking import ExperimentLogger

        tl = ExperimentLogger(logger_root, run_id=f"trial_{trial_index:04d}")
        tl.log_params(config)
        if err is None:
            tl.log_metrics(metrics)
    return trial_index, config, metrics, err


def run_sweep(
    trial_fn: Callable[[dict], Mapping[str, float]],
    space: Mapping[str, Any],
    num_trials: int | None = None,
    metric: str = "val_loss",
    mode: str = "min",
    seed: int = 0,
    search: str = "random",  # "random" | "grid" | "tpe"
    logger_root: str | None = None,
    raise_on_failure: bool = False,
    max_workers: int = 1,
) -> SweepResult:
    """Run trials of `trial_fn(config) -> metrics`. Failures are recorded, not
    fatal. `search="tpe"` routes to the adaptive sampler
    (`tuning/adaptive.py`); `max_workers > 1` runs trials concurrently in
    spawned worker processes (`spawn_pool`; trial_fn must be picklable)."""
    if search == "tpe":
        from two_tower_recommender_model_tpu_torch.tuning.adaptive import run_adaptive_sweep

        if num_trials is None:
            raise ValueError("tpe search requires num_trials")
        return run_adaptive_sweep(
            trial_fn, space, num_trials, metric=metric, mode=mode, seed=seed,
            max_workers=max_workers, logger_root=logger_root,
        )
    if search == "grid":
        configs = grid_space(space)
        if num_trials is not None:
            configs = configs[:num_trials]
    else:
        if num_trials is None:
            raise ValueError("random search requires num_trials")
        configs = [
            sample_space(space, np.random.default_rng(np.random.SeedSequence([seed, i])))
            for i in range(num_trials)
        ]

    results: list[TrialResult] = []
    if max_workers > 1:
        with spawn_pool(max_workers) as pool:
            futs = [
                pool.submit(call_trial, trial_fn, cfg, i, logger_root)
                for i, cfg in enumerate(configs)
            ]
            for fut in futs:
                i, config, metrics, err = fut.result()
                if err is not None and raise_on_failure:
                    raise RuntimeError(err)
                results.append(TrialResult(i, config, metrics, error=err))
        results.sort(key=lambda t: t.index)
        return SweepResult(results, metric, mode)
    for i, config in enumerate(configs):
        i, config, metrics, err = call_trial(trial_fn, config, i, logger_root)
        if err is not None:
            if raise_on_failure:
                raise RuntimeError(err)
            log.warning("trial %d failed: %s", i, err.splitlines()[-1])
        else:
            log.info("trial %d: %s -> %s", i, config, metrics.get(metric))
        results.append(TrialResult(i, config, metrics, error=err))
    return SweepResult(results, metric, mode)
