"""ctypes bindings for the native (C++) host components.

The reference's host runtime is C++ (worldgen Scene.cpp:44-147, streaming
staging Scene.cpp:200-252); this build keeps the host-side compute-bound
loops native too.  The library is built on demand with g++ (no pybind11 in the
image — plain ``extern "C"`` + ctypes) and every entry point has a NumPy
fallback, so the package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_LIB_PATH = os.path.join(_CSRC, "build", "libbrickmap_native.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    src = os.path.join(_CSRC, "worldgen.cpp")
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-pthread", src, "-o", _LIB_PATH]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        print(f"[brickmap_tpu.native] build failed: {e}", file=sys.stderr)
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        src = os.path.join(_CSRC, "worldgen.cpp")
        stale = (not os.path.exists(_LIB_PATH)
                 or os.path.getmtime(_LIB_PATH) < os.path.getmtime(src))
        if stale and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            print(f"[brickmap_tpu.native] load failed: {e}", file=sys.stderr)
            return None
        lib.terrain_heights.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.terrain_heights.restype = None
        lib.simplex2_at.argtypes = [ctypes.c_float, ctypes.c_float]
        lib.simplex2_at.restype = ctypes.c_float
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def terrain_heights(grid_size: int, grid_height: int, octaves: int = 8,
                    feature_scale: float = 2048.0) -> np.ndarray | None:
    """[grid_size, grid_size] float32 heights (heights[y, x]), or None if the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((grid_size, grid_size), np.float32)
    lib.terrain_heights(
        grid_size, grid_height, octaves, ctypes.c_float(feature_scale),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def simplex2_at(x: float, y: float) -> float | None:
    lib = _load()
    if lib is None:
        return None
    return float(lib.simplex2_at(ctypes.c_float(x), ctypes.c_float(y)))
