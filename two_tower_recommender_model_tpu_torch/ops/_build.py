"""Build a CUDA source of `csrc/` into a shared library and load it.

Plain `nvcc` into a shared library with a C interface, loaded with `ctypes`:
no PyTorch headers, so a build takes seconds. The library goes to the
package's build root (`buildroot.py`: `$TTRM_TORCH_BUILD_DIR`, else
`build/torch_kernels/` at the root of the checkout) as `<name>-<hash>/`,
keyed by the source, the shared headers and the flags.

Nothing here runs at import: a `KernelLibrary` builds its library at its
first launch on a CUDA tensor. A failed build raises with nvcc's output;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path

import torch

from two_tower_recommender_model_tpu_torch.buildroot import PerProcess, compile_once

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH): "
        "the CUDA kernels of this package are built from source with nvcc"
    )


class BuiltLibrary:
    """A loaded kernel library, with what its build said and took."""

    def __init__(self, lib: ctypes.CDLL, path: Path, seconds: float, log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = seconds  # 0.0 when an earlier build was reused
        self.log = log


def load_library(name: str, source: str) -> BuiltLibrary:
    """Compile `csrc/<source>` (if not built yet) and `ctypes`-load it."""
    src = CSRC / source
    # the shared headers are part of every source's key: a changed header rebuilds them all
    code = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    path, seconds, log = compile_once(
        name, code + " ".join(NVCC_FLAGS).encode(),
        lambda out: [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)])
    return BuiltLibrary(ctypes.CDLL(str(path)), path, seconds, log)


_SHARED = PerProcess()  # source -> its BuiltLibrary


def shared_library(source: str) -> BuiltLibrary:
    """The library of `csrc/<source>`, built once per process however many
    kernels (entry points) it holds; builds of different sources do not wait
    for each other."""
    return _SHARED.get(source, lambda: load_library(Path(source).stem, source))


class KernelLibrary:
    """One kernel: its source's library, built at the first `load`, and its C
    entry point. `launch` calls the entry point on the current stream of a
    device, raises if it returns a CUDA error, and counts the launch in
    `launches` (a kernel wrapper's count: it moves only where the kernel is
    launched). `source` names the file under `csrc/` when it holds several
    kernels and so is not `<name>.cu`. `extra` maps further entry points of
    the same kernel (another launch shape of it, counted in the same
    `launches`) to their argtypes; `launch(..., entry=name)` calls one."""

    def __init__(self, name: str, entry: str, argtypes: list, source: str | None = None,
                 extra: dict[str, list] | None = None):
        self.name = name
        self.source = source or f"{name}.cu"
        self.launches = 0
        self._entry = entry
        # the stream comes last
        self._entries = {entry: [*argtypes, ctypes.c_void_p],
                         **{e: [*a, ctypes.c_void_p] for e, a in (extra or {}).items()}}
        self._built: BuiltLibrary | None = None
        self._lock = threading.Lock()

    def load(self) -> BuiltLibrary:
        """Build (if needed) and load the library of `csrc/<source>`."""
        with self._lock:
            if self._built is None:
                built = shared_library(self.source)
                for entry, argtypes in self._entries.items():
                    fn = getattr(built.lib, entry)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                built.lib.ttrm_error_string.argtypes = [ctypes.c_int]
                built.lib.ttrm_error_string.restype = ctypes.c_char_p
                self._built = built
            return self._built

    def launch(self, device: torch.device, *args, entry: str | None = None) -> None:
        lib = self.load().lib
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, entry or self._entry)(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name} launch failed: {lib.ttrm_error_string(err).decode()} ({err})")
        with self._lock:
            self.launches += 1
