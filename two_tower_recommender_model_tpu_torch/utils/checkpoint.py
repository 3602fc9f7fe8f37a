"""Training checkpoints with true mid-training resume, and the portable
model export.

`Checkpointer` is the port of the JAX package's orbax-backed
`utils/checkpoint.py:Checkpointer`, with the same surface. A step is a
directory `<directory>/<step>/` holding

- `state.pt`: one `torch.save` of the whole `train.step.TrainState` as CPU
  tensors by name (`train_state_tensors`): every table in its storage dtype
  (an int8 table's int8 values and f32 scales, a bf16 table in bf16), the
  Adagrad accumulators, the towers, Adam's `exp_avg`, `exp_avg_sq` and its
  per-parameter `step` counts, `item_counts`, and the state's `step`;
- `extra.json`: the data loader's position (`StreamLoader.state_dict()`) and
  the caller's `extra` dict.

A save is written into a temporary directory and renamed into place with
`os.replace`, as orbax finalises a step, so a crash mid-save leaves the
earlier steps whole and `latest_step()` never sees a half-written one. The
newest `max_to_keep` steps are kept. `restore(template)` reads a step back
with `torch.load(weights_only=True)` and copies it into the template's own
tensors (`copy_`), after checking every name, shape and dtype: the state
lands on the template's device, and the tensors keep their addresses, so a
CUDA graph captured over the template replays the restored values.

`export_model` writes what the JAX package's `export_model` writes:
`model_config.json` and `params.npz`, f32 arrays in the JAX pytree layout
(`params_to_numpy`; an int8 table is written as the f32 rows it dequantizes
to). `load_model` reads such a directory with json and numpy only. So either
package serves a model the other trained (`params_from_numpy`,
`serving.scorer.load_scorer`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from two_tower_recommender_model_tpu_torch.config import ModelConfig, model_config_from_dict
from two_tower_recommender_model_tpu_torch.models.two_tower import params_to_numpy

STATE_FILE, EXTRA_FILE = "state.pt", "extra.json"


def train_state_tensors(state) -> dict[str, torch.Tensor]:
    """Every tensor of a `TrainState` by name, sharing the state's storage:
    `model/<state_dict key>` (tables, an int8 table's `.values` and
    `.scales`, towers), `adagrad_acc/<table>`, `dense_opt/<parameter>/<key>`
    (Adam's moments and step count) and `item_counts`. The learning rate is
    not state: the towers' optimizer takes it from its schedule each step."""
    out = {f"model/{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"adagrad_acc/{k}": v for k, v in state.adagrad_acc.items()})
    names = {p: n for n, p in state.model.named_parameters()}
    opt = state.dense_opt_state
    for group in opt.param_groups:
        for p in group["params"]:
            for key, value in opt.state[p].items():
                if torch.is_tensor(value):
                    out[f"dense_opt/{names[p]}/{key}"] = value
    if state.item_counts is not None:
        out["item_counts"] = state.item_counts
    return out


def _fsync_write(path: str, write) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


class Checkpointer:
    """`save(step, state, loader_state, extra)` / `restore(template)` of
    whole training states under `directory`, keeping the newest
    `max_to_keep` steps (all of them when None)."""

    def __init__(self, directory: str, max_to_keep: int | None = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list[int]:
        """The finished steps, oldest first (a temporary directory of a save
        that did not finish is not one)."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isdir(os.path.join(self.directory, name)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state, loader_state: dict | None = None,
             extra: dict | None = None, wait: bool = False) -> None:
        """Write `state` as step `step` (replacing a step of that number).
        Saves are synchronous: the step is finished when this returns, so
        `wait` has nothing to wait for (the reference's orbax saves may run
        in the background)."""
        del wait
        payload = {"step": int(state.step),
                   "tensors": {k: v.detach().cpu() for k, v in train_state_tensors(state).items()}}
        tmp = tempfile.mkdtemp(prefix=f".tmp-{int(step)}-", dir=self.directory)
        try:
            _fsync_write(os.path.join(tmp, STATE_FILE), lambda f: torch.save(payload, f))
            meta = {"loader_state": loader_state, "extra": extra or {}}
            _fsync_write(os.path.join(tmp, EXTRA_FILE),
                         lambda f: f.write(json.dumps(meta).encode()))
            final = self.step_dir(step)
            if os.path.exists(final):  # a directory is replaced only when empty: move it aside
                old = tempfile.mkdtemp(prefix=f".old-{int(step)}-", dir=self.directory)
                os.replace(final, os.path.join(old, "step"))
                os.replace(tmp, final)
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if self.max_to_keep is not None:
            for old_step in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.step_dir(old_step), ignore_errors=True)

    def restore(self, template, step: int | None = None) -> tuple[Any, dict | None, dict]:
        """(state, loader_state, extra) of `step` (default the latest): the
        checkpoint copied into `template`'s tensors, which keep their device
        and addresses, and `template.step` set. Raises `FileNotFoundError`
        when there is no checkpoint, and `ValueError`, leaving the template
        untouched, when a tensor's name, shape or dtype does not match."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = self.step_dir(step)
        saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
        src, dst = saved["tensors"], train_state_tensors(template)
        if src.keys() != dst.keys():
            raise ValueError(f"checkpoint {path} does not match the template: missing "
                             f"{sorted(dst.keys() - src.keys())}, unexpected "
                             f"{sorted(src.keys() - dst.keys())}")
        for name, want in dst.items():
            got = src[name]
            if got.shape != want.shape or got.dtype != want.dtype:
                raise ValueError(f"checkpoint {path}: {name} is {got.dtype} "
                                 f"{tuple(got.shape)}, the template's {want.dtype} "
                                 f"{tuple(want.shape)}")
        with torch.no_grad():
            for name, want in dst.items():
                want.copy_(src[name])
        template.step = int(saved["step"])
        with open(os.path.join(path, EXTRA_FILE)) as f:
            meta = json.load(f)
        return template, meta.get("loader_state"), meta.get("extra", {})

    def close(self) -> None:
        """Nothing is pending: every save finished when it returned."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def export_model(path: str, model_cfg: ModelConfig, state) -> None:
    """Write `state.model` (a `train.step.TrainState`) as a portable export.
    The arrays are f32 whatever the storage dtype, so the stored config
    names no table dtype."""
    os.makedirs(path, exist_ok=True)
    cfg_dict = dataclasses.asdict(model_cfg)
    cfg_dict["table_dtype"] = None
    for t in cfg_dict.get("tables", []):
        t["dtype"] = None
    with open(os.path.join(path, "model_config.json"), "w") as f:
        json.dump(cfg_dict, f, indent=1)
    params = params_to_numpy(state.model, dequantize=True)
    flat = {f"tables/{name}": arr for name, arr in params["tables"].items()}
    for tower in ("query_tower", "candidate_tower"):
        for lname, layer in params[tower].items():
            for p, arr in layer.items():
                flat[f"{tower}/{lname}/{p}"] = arr
    np.savez(os.path.join(path, "params.npz"), **flat)


def load_model(path: str) -> tuple[ModelConfig, dict]:
    """(model_cfg, params) from an export directory; params are numpy arrays
    in the JAX pytree layout."""
    with open(os.path.join(path, "model_config.json")) as f:
        model_cfg = model_config_from_dict(json.load(f))
    params: dict[str, Any] = {"tables": {}, "query_tower": {}, "candidate_tower": {}}
    with np.load(os.path.join(path, "params.npz")) as data:
        for key in data.files:
            parts = key.split("/")
            if parts[0] == "tables":
                params["tables"][parts[1]] = data[key]
            else:
                params[parts[0]].setdefault(parts[1], {})[parts[2]] = data[key]
    return model_cfg, params
