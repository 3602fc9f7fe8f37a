"""Build-on-first-use for the native TTRS reader.

Compiles `ttrs_reader.cpp` with the system g++ (`-O3 -std=c++17 -shared
-fPIC -pthread ... -lz`, as the JAX package builds its copy) into the
package's build root (`buildroot.py`, shared with the CUDA kernels), never
into the source tree, as `ttrs_reader-<hash>/`. Plain C ABI and ctypes.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

from two_tower_recommender_model_tpu_torch.buildroot import PerProcess, compile_once

SOURCE = Path(__file__).resolve().parent / "ttrs_reader.cpp"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_LOADED = PerProcess()
build_seconds = 0.0  # the last build's g++ time in this process; 0.0 when a built library was loaded


def build_ttrs_reader() -> str:
    """The path of the built library, compiling it first if it is not built.
    Raises RuntimeError with g++'s output when the build fails, and
    FileNotFoundError when there is no g++."""
    global build_seconds
    path, build_seconds, _ = compile_once(
        "ttrs_reader", SOURCE.read_bytes() + " ".join(FLAGS).encode(),
        lambda out: ["g++", *FLAGS, str(SOURCE), "-o", str(out), "-lz"])
    return str(path)


def load_ttrs_reader(required: bool = False) -> ctypes.CDLL | None:
    """The loaded library, built if needed. Where it cannot be built or
    loaded (no g++, no zlib) it returns None, or with `required` raises
    RuntimeError saying why; a failure is remembered for the process."""
    try:
        return _LOADED.get("ttrs_reader", lambda: _bind(ctypes.CDLL(build_ttrs_reader())))
    except (OSError, RuntimeError) as e:  # FileNotFoundError: no g++
        if required:
            raise RuntimeError(f"the native TTRS reader is unavailable: {e}") from e
        return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ttrs_open.restype = ctypes.c_void_p
    lib.ttrs_open.argtypes = [ctypes.c_char_p]
    lib.ttrs_close.argtypes = [ctypes.c_void_p]
    lib.ttrs_rows.restype = ctypes.c_int64
    lib.ttrs_rows.argtypes = [ctypes.c_void_p]
    lib.ttrs_num_columns.restype = ctypes.c_int
    lib.ttrs_num_columns.argtypes = [ctypes.c_void_p]
    for fn in (lib.ttrs_column_name, lib.ttrs_column_dtype):
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ttrs_column_ndim.restype = ctypes.c_int
    lib.ttrs_column_ndim.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ttrs_column_dim.restype = ctypes.c_int64
    lib.ttrs_column_dim.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ttrs_column_nbytes.restype = ctypes.c_int64
    lib.ttrs_column_nbytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ttrs_read_column.restype = ctypes.c_int
    lib.ttrs_read_column.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_int64]
    lib.ttrs_read_columns_parallel.restype = ctypes.c_int
    lib.ttrs_read_columns_parallel.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64)]
    return lib
