"""File-based experiment tracking.

The port's own copy of `two_tower_recommender_model_tpu/utils/tracking.py`
(framework-free: json and the standard library). Layout:

    runs_root/
      <run_id>/
        params.json        # logged once
        metrics.jsonl      # one {"step", "ts", ...metrics} line per log call
        artifacts/         # anything (checkpoints, exports)

Run ids are time-ordered, so `latest_run` is a directory sort.
"""

from __future__ import annotations

import datetime
import json
import os
import time
import uuid
from typing import Any, Mapping


class ExperimentLogger:
    """One run's directory: params, per-call metric lines, artifacts."""

    def __init__(self, runs_root: str, run_id: str | None = None):
        self.runs_root = runs_root
        if run_id is None:
            stamp = datetime.datetime.now(datetime.timezone.utc).strftime("%Y%m%d-%H%M%S")
            run_id = f"{stamp}-{uuid.uuid4().hex[:8]}"
        self.run_id = run_id
        self.run_dir = os.path.join(runs_root, run_id)
        self.artifact_dir = os.path.join(self.run_dir, "artifacts")
        os.makedirs(self.artifact_dir, exist_ok=True)
        self._metrics_path = os.path.join(self.run_dir, "metrics.jsonl")

    def log_params(self, params: Mapping[str, Any]) -> None:
        path = os.path.join(self.run_dir, "params.json")
        existing = {}
        if os.path.exists(path):
            with open(path) as f:
                existing = json.load(f)
        existing.update({k: _jsonable(v) for k, v in params.items()})
        with open(path, "w") as f:
            json.dump(existing, f, indent=1)

    def log_metrics(self, metrics: Mapping[str, Any], step: int | None = None) -> None:
        rec = {"step": step, "ts": time.time()}
        rec.update({k: _jsonable(v) for k, v in metrics.items()})
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def artifact_path(self, name: str) -> str:
        return os.path.join(self.artifact_dir, name)

    # -- read side ---------------------------------------------------------

    @property
    def params(self) -> dict:
        with open(os.path.join(self.run_dir, "params.json")) as f:
            return json.load(f)

    def metrics(self) -> list[dict]:
        if not os.path.exists(self._metrics_path):
            return []
        with open(self._metrics_path) as f:
            return [json.loads(line) for line in f if line.strip()]


def list_runs(runs_root: str) -> list[str]:
    if not os.path.isdir(runs_root):
        return []
    return sorted(d for d in os.listdir(runs_root) if os.path.isdir(os.path.join(runs_root, d)))


def latest_run(runs_root: str) -> ExperimentLogger:
    """The newest run under `runs_root`."""
    runs = list_runs(runs_root)
    if not runs:
        raise FileNotFoundError(f"no runs under {runs_root}")
    return ExperimentLogger(runs_root, runs[-1])


def _jsonable(v: Any) -> Any:
    try:
        json.dumps(v)
        return v
    except TypeError:
        try:
            import numpy as np

            if isinstance(v, (np.integer,)):
                return int(v)
            if isinstance(v, (np.floating,)):
                return float(v)
            if isinstance(v, np.ndarray):
                return v.tolist()
        except ImportError:
            pass
        return str(v)
