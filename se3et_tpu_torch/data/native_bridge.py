r"""ctypes bridge to the native (C++) data-pipeline kernels.

Loads ``native/libse3et_native.so`` (built by ``make -C native``) and exposes
the grid-subsample / radius-search / knn kernels with the same signatures as
the numpy fallbacks in :mod:`se3et_tpu_torch.data.host_ops`.  The numpy versions
remain the golden reference; :func:`available` gates usage.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "libse3et_native.so",
    )
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.se3et_grid_subsample.argtypes = [f32p, ctypes.c_int, ctypes.c_float, i64p]
    lib.se3et_grid_subsample.restype = ctypes.c_int
    lib.se3et_radius_search.argtypes = [
        f32p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_float, ctypes.c_int, i64p,
    ]
    lib.se3et_radius_search.restype = None
    lib.se3et_knn.argtypes = [
        f32p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float, i64p,
    ]
    lib.se3et_knn.restype = None
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def grid_subsample_indices(points: np.ndarray, voxel_size: float) -> np.ndarray:
    lib = _load()
    points = np.ascontiguousarray(points, np.float32)
    out = np.empty(points.shape[0], np.int64)
    m = lib.se3et_grid_subsample(points, points.shape[0], voxel_size, out)
    return out[:m]


def radius_search(
    q_points: np.ndarray, s_points: np.ndarray, radius: float, limit: int
) -> np.ndarray:
    lib = _load()
    q = np.ascontiguousarray(q_points, np.float32)
    s = np.ascontiguousarray(s_points, np.float32)
    out = np.empty((q.shape[0], limit), np.int64)
    lib.se3et_radius_search(q, q.shape[0], s, s.shape[0], radius, limit, out)
    return out


def knn(
    q_points: np.ndarray, s_points: np.ndarray, k: int, cell_hint: float = 0.0
) -> np.ndarray:
    lib = _load()
    q = np.ascontiguousarray(q_points, np.float32)
    s = np.ascontiguousarray(s_points, np.float32)
    out = np.empty((q.shape[0], k), np.int64)
    lib.se3et_knn(q, q.shape[0], s, s.shape[0], k, cell_hint, out)
    return out
