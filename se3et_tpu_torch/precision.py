r"""Feature/geometry precision policy of the PyTorch port.

Mirrors :mod:`se3et_tpu.precision`:

* **Geometry math** (transforms, Procrustes, influence, embeddings' index
  math) always runs in float32.
* **Feature math** (conv contractions, attention, linears) runs in the
  model's compute dtype — bfloat16 for serving, float32 for the parity
  tests.  Parameters stay float32 and are cast at use; normalisation
  statistics and softmax run in float32.

The compute dtype is scoped to one forward call with
:func:`compute_dtype_scope` (a context variable, so concurrent callers in
other threads or tasks do not see each other's setting).

float32 matrix products must be full float32 on the card: PyTorch's
default keeps matmuls in full precision but lets cuDNN use TF32, which
keeps about three decimal digits.  :func:`compute_dtype_scope` sets both
switches off explicitly.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_COMPUTE_DTYPE: contextvars.ContextVar = contextvars.ContextVar(
    "se3et_compute_dtype", default=None
)

_DTYPES = {
    None: None, "float32": None, "fp32": None,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
}


def compute_dtype():
    """Activation dtype for feature math (None -> float32)."""
    return _COMPUTE_DTYPE.get()


@contextlib.contextmanager
def compute_dtype_scope(dtype_name):
    """Run the enclosed feature math in ``dtype_name`` ('float32' | 'bfloat16')."""
    if dtype_name not in _DTYPES:
        raise ValueError(f"unknown compute dtype {dtype_name!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    token = _COMPUTE_DTYPE.set(_DTYPES[dtype_name])
    try:
        yield
    finally:
        _COMPUTE_DTYPE.reset(token)


def cast_feature(x: torch.Tensor) -> torch.Tensor:
    """Cast an activation tensor to the compute dtype (no-op in fp32 mode)."""
    dtype = _COMPUTE_DTYPE.get()
    return x if dtype is None else x.to(dtype)
