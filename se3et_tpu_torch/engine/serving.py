r"""The compiled serving forward of the port: the counterpart of the JAX
package's jitted forward (``bench.py`` and ``Tester.build`` wrap
``model.apply(..., train=False, with_registration=True)`` in ``jax.jit``).

:func:`capture_forward` records :func:`~se3et_tpu_torch.engine.steps.make_forward`
once into a ``torch.cuda.CUDAGraph`` over static input buffers, and every
later pair is copied into those buffers and replayed: one launch of the
whole graph instead of thousands of kernels dispatched from Python.  The
pyramid's stage caps and neighbour limits fix every shape, so one capture
serves every pair of a configuration.

    from se3et_tpu_torch.engine.serving import capture_forward
    served = capture_forward(model, pyramid_to_tensors(pair0, "cuda"))
    out = served(pyramid_to_tensors(pair, "cuda"))   # fresh tensors

With an ``eval_cfg`` (:class:`~se3et_tpu_torch.nn.loss.EvalConfig`) the
graph records ``make_forward(model, eval_cfg)``: the forward with the
ground-truth overlaps and the in-graph metrics, which the replay returns
under ``out["metrics"]`` with no read-back to the host.

The graph runs on the card only: there is no CPU or eager fallback, and a
capture that fails raises.
"""

from __future__ import annotations

import time

import torch

from se3et_tpu_torch.engine.steps import make_forward
from se3et_tpu_torch.ops.kernels.selfcheck import WRAPPERS


def input_spec(data: dict) -> dict:
    """``{key: (shape, dtype)}`` of a pair's tensors: what a captured graph
    was recorded for."""
    return {k: (tuple(v.shape), v.dtype) for k, v in data.items()}


def check_inputs(spec: dict, data: dict) -> None:
    """Raise ``ValueError`` unless ``data`` has exactly the keys of ``spec``,
    each with its shape and dtype.  A pair that carries host influence
    cannot meet a graph captured without it, or the reverse."""
    missing = sorted(set(spec) - set(data))
    extra = sorted(set(data) - set(spec))
    if missing or extra:
        raise ValueError(f"the pair's keys differ from the captured example's: missing "
                         f"{missing}, extra {extra}")
    for key, (shape, dtype) in spec.items():
        got = (tuple(data[key].shape), data[key].dtype)
        if got != (shape, dtype):
            raise ValueError(f"{key}: shape and dtype {got}, captured with {(shape, dtype)}")


class CapturedForward:
    """The serving forward captured into one CUDA graph (see
    :func:`capture_forward`).  ``capture_ms`` is the capture's host time,
    ``launches`` what each kernel wrapper counted while the graph was
    recorded: a replay runs no Python, so it counts nothing."""

    def __init__(self, graph, static_inputs, static_outputs, capture_ms, launches):
        self.graph = graph
        self.static_inputs = static_inputs
        self.static_outputs = static_outputs
        self.spec = input_spec(static_inputs)
        self.capture_ms = capture_ms
        self.launches = launches

    def __call__(self, data: dict) -> dict:
        """Copy ``data`` into the static buffers, replay, and return the
        outputs as fresh tensors, which a later replay leaves alone."""
        check_inputs(self.spec, data)
        for key, buf in self.static_inputs.items():
            buf.copy_(data[key])
        self.graph.replay()
        return _clone(self.static_outputs)


def _clone(out):
    if torch.is_tensor(out):
        return out.clone()
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    return out


def capture_forward(model, example: dict, eval_cfg=None, *,
                    warmup: int = 3) -> CapturedForward:
    """Capture ``make_forward(model, eval_cfg)`` on static copies of
    ``example`` (the pair dict of ``pyramid_to_tensors``) into a CUDA graph
    with its own memory pool.

    ``warmup`` eager forwards run first on a side stream, as PyTorch's
    CUDA-graph recipe asks: they build every kernel library, set every
    kernel attribute and create the library handles, which capture cannot
    do.  Raises ``RuntimeError`` for a model that is not on a CUDA device."""
    device = next(model.parameters()).device
    if device.type != "cuda":
        raise RuntimeError(f"capture_forward: the model is on {device}; a CUDA graph "
                           "captures a model on a CUDA device")
    forward = make_forward(model, eval_cfg)
    with torch.cuda.device(device):
        static_inputs = {k: v.to(device, copy=True) for k, v in example.items()}
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(warmup):
                forward(static_inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)

        graph = torch.cuda.CUDAGraph()
        before = {n: w.launches for n, w in WRAPPERS.items()}
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            static_outputs = forward(static_inputs)
        torch.cuda.synchronize(device)
        capture_ms = (time.perf_counter() - t0) * 1e3
        launches = {n: w.launches - before[n] for n, w in WRAPPERS.items()}
    return CapturedForward(graph, static_inputs, static_outputs, capture_ms, launches)
