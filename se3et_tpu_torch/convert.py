r"""Flax parameter tree -> state dict of the PyTorch port.

The port's modules are registered under the flax tree's own names
(``backbone_net._EPNStage0_0.SimpleBlockEPN_0...``), so conversion walks
the tree and renames only the leaves:

* ``TorchLinear.kernel`` is stored ``(in, out)`` in flax and becomes
  ``weight`` ``(out, in)``;
* a norm's ``scale`` becomes ``weight``;
* everything else keeps name and layout — ``KPConvInterSO3.weights``
  ``(O, Cin, Cout)``, the embedding's ``proj_d_kernel`` / ``proj_a_kernel``
  and the RPE ``proj_*_kernel`` ``(in, out)``, Sinkhorn's scalar ``alpha``;

and flax's setup-list names ``layers_<i>`` become ``layers.<i>``.
Input is the tree as numpy (``jax.tree.map(np.asarray, params)``); this
module imports no JAX.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_LIST_ITEM = re.compile(r"^(\w+)_(\d+)$")
_SETUP_LISTS = ("layers",)


def _module_key(name: str) -> str:
    m = _LIST_ITEM.match(name)
    if m and m.group(1) in _SETUP_LISTS:
        return f"{m.group(1)}.{m.group(2)}"
    return name


def flax_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """Convert a flax ``{'params': ...}`` tree (or its inner dict)."""
    tree = params["params"] if "params" in params else params
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for name, val in node.items():
            if isinstance(val, Mapping):
                walk(val, prefix + _module_key(name) + ".")
                continue
            arr = np.asarray(val, dtype=np.float32)
            if name == "kernel":
                name, arr = "weight", arr.T
            elif name == "scale":
                name = "weight"
            out[prefix + name] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(tree, "")
    return out


def load_flax_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Load a converted flax tree into ``model`` (strict: every parameter
    on both sides must match by name and shape)."""
    model.load_state_dict(flax_to_state_dict(params), strict=True)
    return model
