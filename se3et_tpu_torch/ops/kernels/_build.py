r"""Build and load the hand-written CUDA kernels of ``se3et_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface (pointers, ints and the
stream as ``void*``; every entry point returns ``cudaGetLastError()``), is
compiled on first use with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``se3et_tpu_torch/_build/`` and is loaded with :mod:`ctypes`.
The library name carries a hash of its source and of the shared headers
``csrc/*.cuh``, so an edited kernel is rebuilt and a stale one is never
loaded.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
KERNEL_SOURCES = ("gather_wf", "neighbor_max", "geometric_embedding", "sinkhorn",
                  "rpe_attention", "eq_attention", "gather_wf_bwd", "neighbor_max_bwd",
                  "rpe_attention_bwd", "gather_wf_mm", "gather_wf_max", "influence",
                  "rpe_attention_femb")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> str:
    """Library of ``csrc/<name>.cu``, named by a hash of that source, the
    shared headers ``csrc/*.cuh`` and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=KERNEL_SOURCES) -> dict[str, str]:
    """Compile every missing library of ``names`` (in parallel); returns
    ``{name: library path}``.  Raises with nvcc's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = []
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, path, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, path)
        else:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu (rc={proc.returncode}):\n{log}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(build((name,))[name])


@functools.lru_cache(maxsize=None)
def function(name: str, symbol: str, num_pointers: int, num_ints: int,
             num_floats: int = 0):
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, typed as
    ``(void* x num_pointers, int x num_ints, float x num_floats, void* stream)
    -> int``."""
    fn = getattr(_library(name), symbol)
    fn.argtypes = (
        [ctypes.c_void_p] * num_pointers + [ctypes.c_int] * num_ints
        + [ctypes.c_float] * num_floats + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def check(status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
