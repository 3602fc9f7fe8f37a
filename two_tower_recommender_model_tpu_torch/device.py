"""The device an entry point runs on when the caller names none.

The port is written for the card: `default_device()` is the CUDA device when
there is one, and otherwise it raises rather than hand back the CPU, so that
nothing runs on the CPU unless the caller asked for it with `device="cpu"`
(or gave a CPU generator or CPU tensors, which entry points follow).
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise RuntimeError(
        "no CUDA device: this package runs on the card unless told otherwise; "
        'pass device="cpu" to run on the CPU')


def resolve_device(device: torch.device | str | None) -> torch.device:
    """`device` as a `torch.device`; None means `default_device()`."""
    return default_device() if device is None else torch.device(device)
