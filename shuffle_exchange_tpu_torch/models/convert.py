"""Move parameters between the JAX package's tree and the port's state dict.

The JAX package's parameters are a nested dict (``params["layers"]["wq"]``);
the port keys the same leaves by their flattened names (``"layers.wq"``)
with identical shapes and layouts, so the conversion is a rename: no
transpose, no reshape. Leaves travel as numpy arrays, which is how the
tests hand weights from one package to the other. A training engine's
state (f32 master, the Adam moments ``mu`` / ``nu`` and the update count)
moves the same way, so a test can start both engines from one state and
compare them after N steps.
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


# ---------------------------------------------------------------------------
# Training state
# ---------------------------------------------------------------------------


def _flatten(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}{k}."))
    return out


def load_train_state(engine, master, mu=None, nu=None, count: int = 0, step=None) -> None:
    """Put a JAX ``TrainState``'s pieces into a port engine, in place:
    ``master`` and the Adam moments ``mu`` / ``nu`` as nested (or flattened)
    dicts of numpy arrays, ``count`` the optimizer's update count and
    ``step`` the state's step (default: ``count``). Names and shapes must
    be the engine's."""
    st = engine.state
    for what, tree, dst in (("master", master, st.master), ("mu", mu, st.opt_state.mu),
                            ("nu", nu, st.opt_state.nu)):
        if tree is None:
            continue
        flat = _flatten(tree)
        if set(flat) != set(dst):
            raise ValueError(f"{what}: names differ: missing {sorted(set(dst) - set(flat))}, "
                             f"unexpected {sorted(set(flat) - set(dst))}")
        for name, arr in flat.items():
            t = _to_tensor(arr)
            if tuple(t.shape) != tuple(dst[name].shape):
                raise ValueError(f"{what}.{name}: shape {tuple(t.shape)} != "
                                 f"{tuple(dst[name].shape)}")
            dst[name].copy_(t)
    st.opt_state.count = int(count)
    st.step = int(count if step is None else step)


def train_state_to_numpy(engine) -> Dict[str, Any]:
    """``{"master", "mu", "nu"}`` as nested dicts of f32 numpy arrays (the
    JAX tree's structure), ``"count"`` and ``"step"``."""
    st = engine.state
    return {"master": params_to_numpy(st.master), "mu": params_to_numpy(st.opt_state.mu),
            "nu": params_to_numpy(st.opt_state.nu), "count": int(st.opt_state.count),
            "step": int(st.step)}
