"""Trial functions for the port's process-pool sweep tests. A worker process
started by spawn imports a trial by its module path, so they live here, in a
module that imports nothing but numpy and the standard library."""

import os
import time


def quadratic_trial(config: dict) -> dict:
    """A fast objective that records when and where it ran."""
    t0 = time.time()
    time.sleep(0.2)
    return {"val_loss": (config["x"] - 0.3) ** 2, "pid": os.getpid(), "t_start": t0,
            "t_end": time.time()}


def failing_trial(config: dict) -> dict:
    if config["x"] > 0.5:
        raise RuntimeError("boom")
    return {"val_loss": config["x"]}
