"""Move parameters between the JAX package's tree and the port's state dict.

The JAX package's parameters are a nested dict (``params["layers"]["wq"]``);
the port keys the same leaves by their flattened names (``"layers.wq"``)
with identical shapes and layouts, so the conversion is a rename: no
transpose, no reshape. Leaves travel as numpy arrays, which is how the
tests hand weights from one package to the other.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _to_tensor(a: Any) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart in from_numpy: move
        # the raw 16-bit patterns and reinterpret them
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_numpy(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays -> ``{"embed": t, "layers.wq": t, ...}`` on
    the CPU, copied bit for bit (the engines cast and move them)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
            return
        out[prefix[:-1]] = _to_tensor(node)

    walk(tree, "")
    return out


def params_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Flattened state dict -> nested dict of numpy arrays (the JAX tree's
    structure). bf16 tensors come back as float32 arrays holding the same
    values, since numpy has no bfloat16 of its own."""
    tree: Dict[str, Any] = {}
    for name, t in state.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t.numpy().copy()
    return tree
