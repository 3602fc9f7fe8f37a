"""Failure-resilient training: checkpoint-backed auto-restart.

Port of `two_tower_recommender_model_tpu/train/resilient.py`. `resilient_fit`
runs a training callable, and on a transient failure calls it again, up to
`max_restarts` times; the callable restores its own latest checkpoint (model,
optimizers, loader position) and continues (`cli.train --resume` is the
pattern).

What counts as transient: by default only what a restart can plausibly cure
— IO and network (`OSError` and its subclasses: `ConnectionError`,
filesystem hiccups), `TimeoutError`, and `torch.AcceleratorError`, which is
what a CUDA device fault raises (the counterpart of the JAX package's
`jax.errors.JaxRuntimeError`). Programming errors (`ValueError`,
`TypeError`, a plain `RuntimeError`, shape errors) and
`torch.cuda.OutOfMemoryError` re-raise at once: a restart runs the same
program on the same shapes again. Pass `retry_on=(Exception,)` to retry
everything.
"""

from __future__ import annotations

import logging
import time
import traceback
from typing import Callable

import torch

log = logging.getLogger(__name__)


class TrainingFailure(RuntimeError):
    """Raised by resilient_fit when max_restarts is exhausted."""


def transient_error_types() -> tuple[type[BaseException], ...]:
    """Error classes a checkpoint-restore restart can plausibly cure:
    `OSError` (IO and network), `TimeoutError` and `torch.AcceleratorError`
    (a device fault)."""
    return (OSError, TimeoutError, torch.AcceleratorError)


def resilient_fit(
    attempt: Callable[[int], dict],
    max_restarts: int = 3,
    retry_on: tuple[type[BaseException], ...] | None = None,
    backoff_s: float = 1.0,
) -> dict:
    """Run `attempt(restart_index)` until it returns; restart on failure.

    `attempt` must be resumable: it should restore from its own checkpoint
    store when one exists. Only `retry_on` errors restart (default:
    `transient_error_types()`); anything else propagates on the first raise.
    Returns the attempt's result dict, with `restarts` (the attempts that
    failed) and `failures` (their messages) added."""
    if retry_on is None:
        retry_on = transient_error_types()
    failures: list[str] = []
    for restart in range(max_restarts + 1):
        try:
            result = dict(attempt(restart))
            result["restarts"] = restart
            result["failures"] = failures
            return result
        except retry_on as e:  # noqa: PERF203
            failures.append(f"{type(e).__name__}: {e}")
            # the whole traceback: only the message survives in `failures`, and a
            # transient that keeps recurring needs its stack to be diagnosed
            log.warning("training attempt %d failed; restarting\n%s", restart,
                        traceback.format_exc())
            if restart == max_restarts:
                raise TrainingFailure(
                    f"training failed after {max_restarts} restarts: {failures}") from e
            time.sleep(backoff_s * (restart + 1))
    raise AssertionError("unreachable")
