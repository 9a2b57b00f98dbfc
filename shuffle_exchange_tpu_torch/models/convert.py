"""Move parameters between the JAX package's tree and the port's state dict.

The JAX package's parameters are a nested dict (``params["layers"]["wq"]``);
the port keys the same leaves by their flattened names (``"layers.wq"``)
with identical shapes and layouts, so the conversion is a rename: no
transpose, no reshape. Every leaf crosses by name, the GPT-2 and BLOOM
ones (``pos_embed``, ``embed_ln_w`` / ``embed_ln_b``, ``b_q`` / ``b_k`` /
``b_v`` / ``b_o``, ``b_up`` / ``b_down``) as the Llama ones, and so do the
parallel-block trees (GPT-J's ``unembed_b`` and its missing ``ln2_*``). Leaves travel as numpy arrays, which is how the
tests hand weights from one package to the other. A training engine's
state (f32 master, the Adam moments ``mu`` / ``nu`` and the update count)
moves the same way, so a test can start both engines from one state and
compare them after N steps.

Quantized weights cross too: a leaf with the children of a JAX
``QuantizedMatrix`` (``q``, ``scales``, ``group_size``, ``bits``, the
column count and the compute dtype; numpy or JAX arrays) becomes the
port's ``QuantizedMatrix``, and ``params_to_numpy`` gives those children
back as :class:`QuantizedArrays`. An adapter pool's planes come back as
numpy with ``adapter_pool_to_numpy``. MoE trees cross the same way: the
router ``moe_gate``, the expert stacks ``moe_w_gate`` / ``moe_w_up`` /
``moe_w_down`` (``[L, E, K, N]``, dense or quantized), the optional
expert biases ``moe_b_*`` and the shared expert ``moe_shared_*``. e4m3 storage crosses as its bytes
(``uint8``) reinterpreted on arrival, because ``torch.from_numpy`` does not
take ml_dtypes' float8.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from ..ops.quant_matmul import FP8, QuantizedMatrix


class QuantizedArrays(NamedTuple):
    """A ``QuantizedMatrix`` as numpy children: ``q`` (int8, uint8 packed
    int4, or the e4m3 bytes as uint8), f32 ``scales``, and its
    ``group_size``, ``bits``, ``n_cols`` and compute ``dtype`` name."""

    q: np.ndarray
    scales: np.ndarray
    group_size: int
    bits: Any
    n_cols: int
    dtype: str


def _is_quantized(node: Any) -> bool:
    return all(hasattr(node, a) for a in ("q", "scales", "group_size", "bits"))


def _dtype_name(dtype: Any) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return dtype if isinstance(dtype, str) else np.dtype(dtype).name


def quantized_from_numpy(node: Any) -> QuantizedMatrix:
    """A JAX ``QuantizedMatrix`` (or :class:`QuantizedArrays`) -> the port's,
    on the CPU, bit for bit."""
    q = np.asarray(node.q)
    if node.bits == "fp8":
        qt = torch.from_numpy(q.view(np.uint8).copy()).view(FP8)
    else:
        qt = torch.from_numpy(q.copy())
    n_cols = getattr(node, "n_cols", None) or getattr(node, "_n", 0)
    return QuantizedMatrix(qt, _to_tensor(node.scales), int(node.group_size),
                           getattr(torch, _dtype_name(node.dtype)), bits=node.bits,
                           n_cols=int(n_cols))


def quantized_to_numpy(qm: QuantizedMatrix) -> QuantizedArrays:
    q = qm.q.detach().cpu()
    if qm.bits == "fp8":
        q = q.view(torch.uint8)
    return QuantizedArrays(q.numpy().copy(), qm.scales.detach().cpu().numpy().copy(),
                           qm.group_size, qm.bits, qm.n_cols, _dtype_name(qm.dtype))


def _to_tensor(a: Any) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has no torch counterpart in from_numpy: move
        # the raw 16-bit patterns and reinterpret them
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_numpy(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of arrays -> ``{"embed": t, "layers.wq": t, ...}`` on
    the CPU, copied bit for bit (the engines cast and move them); quantized
    leaves become ``QuantizedMatrix``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
            return
        out[prefix[:-1]] = (quantized_from_numpy(node) if _is_quantized(node)
                            else _to_tensor(node))

    walk(tree, "")
    return out


def params_to_numpy(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Flattened state dict -> nested dict of numpy arrays (the JAX tree's
    structure). bf16 tensors come back as float32 arrays holding the same
    values, since numpy has no bfloat16 of its own; a ``QuantizedMatrix``
    comes back as :class:`QuantizedArrays`."""
    tree: Dict[str, Any] = {}
    for name, t in state.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        if isinstance(t, QuantizedMatrix):
            node[leaf] = quantized_to_numpy(t)
            continue
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        node[leaf] = t.numpy().copy()
    return tree


def adapter_pool_to_numpy(pool) -> Dict[str, np.ndarray]:
    """An adapter pool's device planes as f32 numpy arrays under
    ``{target}.a`` ([L, S, d_in, R]) and ``{target}.b`` ([L, S, R, d_out]),
    the layout of the JAX pool's ``a[target]`` / ``b[target]``. Adapter
    factors themselves cross as numpy in both packages (``register`` takes
    the same arrays), so this is for holding the two pools' planes equal."""
    ops = pool.device_operands()
    return {f"{t}.{k}": ops[k][t].detach().float().cpu().numpy().copy()
            for t in pool.targets for k in ("a", "b")}


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
