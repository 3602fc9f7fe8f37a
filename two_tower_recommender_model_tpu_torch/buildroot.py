"""Compile a source once into the package's build root, and load it once.

Both the CUDA kernels (`ops/_build.py`, nvcc) and the native TTRS reader
(`native/build.py`, g++) build here, at first use and never at import. The
build root is `$TTRM_TORCH_BUILD_DIR` when set, else `build/torch_kernels/`
at the root of the checkout (listed in `.gitignore`). In an installed copy
that default lands beside the `site-packages` directory, which may not be
writable: set `TTRM_TORCH_BUILD_DIR` there.

A library goes to `<root>/<name>-<hash>/lib<name>.so`, keyed by a hash of
what its build reads (sources and flags), so a changed source rebuilds and an
unchanged one loads what is there. Standard library only.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, TypeVar

DEFAULT_BUILD_ROOT = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"

T = TypeVar("T")


def build_root() -> Path:
    return Path(os.environ.get("TTRM_TORCH_BUILD_DIR") or DEFAULT_BUILD_ROOT)


def compile_once(name: str, inputs: bytes,
                 command: Callable[[Path], list[str]]) -> tuple[Path, float, str]:
    """The path of `<root>/<name>-<hash of inputs>/lib<name>.so`, running
    `command(output)` first if it is not there; with the build's seconds
    (0.0 when a built library was found) and its log (the command and what it
    printed, kept beside the library as `<tool>.log`). The command writes to a
    temporary file that is renamed into place, so a concurrent build sees all
    or nothing. Raises RuntimeError with the log when the command fails, and
    FileNotFoundError when its tool is missing."""
    key = hashlib.sha256(inputs).hexdigest()[:16]
    out_dir = build_root() / f"{name}-{key}"
    lib_path = out_dir / f"lib{name}.so"
    seconds = 0.0
    log_path = None
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = command(tmp)
        log_path = out_dir / f"{Path(cmd[0]).name}.log"
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{Path(cmd[0]).name} failed (exit {proc.returncode}) "
                               f"building {name}:\n{log}")
        log_path.write_text(log)
        os.replace(tmp, lib_path)
    logs = [log_path] if log_path else sorted(out_dir.glob("*.log"))
    return lib_path, seconds, logs[0].read_text() if logs else ""


class PerProcess:
    """What `make()` gives for a key, made at most once per process: callers
    of one key wait for each other, callers of different keys do not. A
    failure is remembered and raised again, so a build that failed is not
    retried at every call."""

    def __init__(self):
        self._lock = threading.Lock()
        self._slots: dict[str, list] = {}  # key -> [its lock, its value, its error]

    def get(self, key: str, make: Callable[[], T]) -> T:
        with self._lock:
            slot = self._slots.setdefault(key, [threading.Lock(), None, None])
        with slot[0]:
            if slot[1] is None and slot[2] is None:
                try:
                    slot[1] = make()
                except Exception as e:
                    slot[2] = e
            if slot[2] is not None:
                raise slot[2]
            return slot[1]
