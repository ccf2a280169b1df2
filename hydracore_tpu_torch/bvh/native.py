"""ctypes bridge to the native C++ SAH builder (csrc/bvh_builder.cpp).

Compiled on first use with g++ -O2 -march=native into the port's
git-ignored build directory (utils/build.py); falls back to the numpy
builder when no compiler is available. The output ABI is identical to
builder.FlatBVH, so scene assembly is builder-agnostic.
"""
from __future__ import annotations

import ctypes

import numpy as np

from hydracore_tpu_torch.bvh.builder import FlatBVH, build_bvh
from hydracore_tpu_torch.utils import build as _build

_SRC = "bvh_builder.cpp"
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_build.build(_SRC))
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.hydra_build_bvh.argtypes = [f32p, f32p, f32p, ctypes.c_int32,
                                    f32p, f32p, i32p, i32p, i32p, i32p]
    lib.hydra_build_bvh.restype = ctypes.c_int32
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except (OSError, RuntimeError):  # no g++, a failed build, a bad .so
        return False


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray) -> FlatBVH:
    lib = _load()
    T = v0.shape[0]
    if T == 0:
        z = np.zeros((1, 3), np.float32)
        return FlatBVH(z, z, np.array([0], np.int32), np.array([-1], np.int32),
                       np.array([0], np.int32), np.zeros(0, np.int32))
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    cap = 2 * T
    bmin = np.empty((cap, 3), np.float32)
    bmax = np.empty((cap, 3), np.float32)
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    perm = np.empty(T, np.int32)
    n = lib.hydra_build_bvh(v0, v1, v2, T, bmin, bmax, left, right, count, perm)
    return FlatBVH(bmin[:n].copy(), bmax[:n].copy(), left[:n].copy(),
                   right[:n].copy(), count[:n].copy(), perm)


def build_bvh_auto(v0, v1, v2) -> FlatBVH:
    """Native builder when compilable, numpy otherwise."""
    if native_available():
        return build_bvh_native(v0, v1, v2)
    return build_bvh(v0, v1, v2)
