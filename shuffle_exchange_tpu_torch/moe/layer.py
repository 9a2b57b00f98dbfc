"""The MoE layer in PyTorch: routing, expert dispatch and the expert FFN.

Counterpart of ``shuffle_exchange_tpu/moe/layer.py`` for one card. Expert
weights are stacked on a leading E dim (``[E, K, F]``, or int8 / e4m3
``QuantizedMatrix`` stacks in quantized serving), and every expert product
is a grouped matmul (``ops/grouped_gemm.py``: the hand-written kernel on
the card, its plain version on the CPU):

- ``expert_mlp`` (the capacity routes' batched FFN, ``[E, C, M]``) runs
  each projection as one grouped matmul of E equal groups of C rows, where
  the JAX package lets XLA fuse the dequantize into a batched einsum;
- ``expert_mlp_ragged`` (the dropless route) sorts the token copies by
  expert (a stable sort, as JAX's), counts them per expert on the device
  and runs the three projections over the sorted rows.

Nothing in the layer copies a device value to the host: shapes are fixed
by S, k, E and the capacity, group sizes stay on the device, and the
gathers, scatters and the unsort are index operations.

The layer trains: autograd runs through the gathers, the unsort, the
expert biases, the routing weights and the aux loss, and each grouped
matmul's backward is its own pair of kernels. The forward adds no floats
with atomics (its counts are integer sums), so a remat recompute sees
bit-equal router logits and routes, drops included, as its forward did
(``chip_smoke.py`` phase 6b checks it); only ``index_select``'s backward
accumulates floats with atomics.

``moe_layer`` takes the JAX package's four impls ("auto", "capacity",
"capacity_einsum" — the dense one-hot oracle — and "ragged"). The JAX
package's expert-axis sharding (``_gather_expert_sharded``,
``_constrain_expert``) is the identity on one card; a mesh with an expert
axis above 1 raises (expert parallelism is ROADMAP queue A, item 12).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops.grouped_gemm import grouped_matmul
from ..ops.quant_matmul import QuantizedMatrix
from ..utils.logging import warning_once
from .gating import topk_gating, topk_gating_compact, topk_select

IMPLS = ("auto", "capacity", "capacity_einsum", "ragged")


def init_expert_mlp(generator: Optional[torch.Generator], n_experts: int, d_model: int,
                    d_ff: int, activation: str = "swiglu", bias: bool = False,
                    device=None) -> Dict[str, torch.Tensor]:
    """Stacked expert FFN weights [E, ...] in f32 with the JAX init's
    scales (normal draws times 1/sqrt(fan_in)); ``bias=True`` adds zero
    per-expert biases."""
    _refuse_activation(activation)

    def draw(shape, fan_in):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device) / math.sqrt(fan_in)

    params = {"w_up": draw((n_experts, d_model, d_ff), d_model),
              "w_down": draw((n_experts, d_ff, d_model), d_ff),
              "w_gate": draw((n_experts, d_model, d_ff), d_model)}
    if bias:
        params.update(b_up=torch.zeros(n_experts, d_ff, device=device),
                      b_down=torch.zeros(n_experts, d_model, device=device),
                      b_gate=torch.zeros(n_experts, d_ff, device=device))
    return params


def _refuse_activation(activation: str) -> None:
    if activation != "swiglu":
        raise NotImplementedError(f"MoE experts with activation={activation!r} are not in "
                                  "the PyTorch port yet (only swiglu): ROADMAP queue A, item 4")


def _weight(w, dtype: torch.dtype):
    """An expert stack as the grouped matmul takes it (JAX ``_dense_w``'s
    place): int8 / fp8 storage passes through uncast — the kernel
    dequantizes in registers, the plain version rounds the stack as JAX's
    ``_dense_w`` does — and a dense stack is cast."""
    return w if isinstance(w, QuantizedMatrix) else w.to(dtype)


def _ffn_rows(params, rows: torch.Tensor, group_sizes: torch.Tensor, activation: str,
              bias_rows) -> torch.Tensor:
    """SwiGLU over rows grouped by expert: three grouped matmuls, each
    followed by its bias epilogue ``bias_rows(key, t)``."""
    _refuse_activation(activation)
    dtype = rows.dtype
    up = bias_rows("b_up", grouped_matmul(rows, _weight(params["w_up"], dtype), group_sizes))
    gate = bias_rows("b_gate", grouped_matmul(rows, _weight(params["w_gate"], dtype),
                                              group_sizes))
    h = F.silu(gate) * up
    return bias_rows("b_down", grouped_matmul(h, _weight(params["w_down"], dtype), group_sizes))


def expert_mlp(params, x: torch.Tensor, activation: str = "swiglu") -> torch.Tensor:
    """x [E, C, M] -> [E, C, M]: each expert's FFN over its C rows, as one
    grouped matmul of E groups of C rows per projection. Optional
    per-expert biases (b_gate / b_up / b_down) broadcast over the rows."""
    E, C, M = x.shape
    sizes = torch.full((E,), C, dtype=torch.int32, device=x.device)

    def bias_rows(key, t):
        if key not in params:
            return t
        return (t.reshape(E, C, -1) + params[key].to(t.dtype)[:, None, :]).reshape(E * C, -1)

    out = _ffn_rows(params, x.reshape(E * C, M), sizes, activation, bias_rows)
    return out.reshape(E, C, -1)


def expert_counts(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """Rows per expert, int32 [E], counted on the device (``bincount``
    with a fixed length; ``torch.bincount`` would read the largest id on
    the host)."""
    ones = torch.ones_like(flat_e, dtype=torch.int32)
    return torch.zeros(E, dtype=torch.int32, device=flat_e.device).scatter_add_(
        0, flat_e.long(), ones)


def expert_mlp_ragged(params, xs: torch.Tensor, topk_idx: torch.Tensor,
                      topk_w: torch.Tensor, activation: str = "swiglu") -> torch.Tensor:
    """Dropless grouped-GEMM experts: xs [S, M], topk_idx [S, k] int32,
    topk_w [S, k] f32 -> [S, M]. The S·k token copies sort by expert
    (stable, so each expert's rows keep token order), the three
    projections run as grouped matmuls over the sorted rows, and the
    results unsort and sum with the routing weights."""
    S, M = xs.shape
    k = topk_idx.shape[1]
    E = params["w_up"].shape[0]
    flat_e = topk_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    xsort = xs.index_select(0, order // k)
    sizes = expert_counts(flat_e, E)
    e_sorted = flat_e.index_select(0, order).long()

    def bias_rows(key, t):
        # grouped-GEMM bias epilogue: each row's expert bias
        if key not in params:
            return t
        return t + params[key].to(t.dtype).index_select(0, e_sorted)

    out_sorted = _ffn_rows(params, xsort, sizes, activation, bias_rows)
    out_flat = torch.empty_like(out_sorted).index_copy_(0, order, out_sorted)   # unsort
    return (out_flat.reshape(S, k, M) * topk_w[..., None].to(xs.dtype)).sum(1)


class MoEResult(NamedTuple):
    output: torch.Tensor
    aux_loss: torch.Tensor
    metadata: dict


def resolve_moe_impl(impl: str, ep_size: int, scanned: bool = False) -> str:
    """"auto" -> "capacity" under an expert axis above 1 or a scanned layer
    stack (the JAX engines and model always pass ``scanned=True``, and the
    port keeps their choice), "ragged" otherwise; any other impl as it
    is."""
    if impl != "auto":
        return impl
    if ep_size > 1 or scanned:
        return "capacity"
    return "ragged"


def _expert_axis_size(mesh, expert_axis: str) -> int:
    """1 on one card; a mesh with an expert axis above 1 raises."""
    ep = 1 if mesh is None else int(dict(getattr(mesh, "shape", {})).get(expert_axis, 1))
    if ep > 1:
        raise NotImplementedError(f"an expert axis of {ep} (expert-parallel MoE) is not in the "
                                  "PyTorch port yet: ROADMAP queue A, item 12")
    return ep


def _check_router_precision(xs: torch.Tensor) -> None:
    """The router runs on f32 logits (``xs.f32 @ gate_w.f32``, as JAX's):
    TF32 products keep ~10 bits and flip top-k choices whose logits are
    close, so a CUDA call with TF32 matmuls enabled raises."""
    if xs.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("MoE router: torch.backends.cuda.matmul.allow_tf32 is on; the "
                           "router logits must be full f32 products (turn it off)")


def moe_layer(gate_w: torch.Tensor, expert_params, x: torch.Tensor, k: int = 2,
              capacity_factor: float = 1.0, activation: str = "swiglu", train: bool = True,
              rng=None, noise_std: float = 0.0, min_capacity: int = 4,
              expert_axis: str = "expert", mesh=None, impl: str = "auto",
              normalize_weights: bool = True, scanned: bool = False) -> MoEResult:
    """x [..., M] -> MoEResult; gate_w [M, E]. The impls as in JAX:
    "capacity" (GShard capacity and drops, dispatched by index),
    "capacity_einsum" (the same through the dense one-hot einsums: the
    oracle), "ragged" (dropless grouped GEMM), "auto" (capacity under an
    expert axis above 1 or a scanned stack, ragged otherwise)."""
    if impl not in IMPLS:
        raise ValueError(f"moe impl must be one of 'auto', 'capacity', 'capacity_einsum', "
                         f"'ragged'; got {impl!r}")
    orig_shape = x.shape
    M = orig_shape[-1]
    xs = x.reshape(-1, M)
    S = xs.shape[0]
    E = gate_w.shape[1]
    _check_router_precision(xs)
    logits = xs.float() @ gate_w.float()                       # [S, E]

    ep = _expert_axis_size(mesh, expert_axis)
    if impl == "auto":
        impl = resolve_moe_impl("auto", ep, scanned)
        if impl == "ragged":
            warning_once(
                "moe_impl=auto resolved to the dropless ragged grouped-GEMM path (no expert "
                "axis > 1, unscanned): capacity_factor/min_capacity/drop semantics do not "
                "apply — set moe_impl='capacity' to keep GShard capacity/drop behavior")
        elif scanned:
            warning_once(
                "moe_impl=auto resolved to the capacity (index-dispatch) path, as the JAX "
                "package resolves it under its scanned layer stack. Capacity/drop semantics "
                "apply (capacity_factor/min_capacity; overflow tokens drop) — set "
                "moe_impl='ragged' for dropless routing")
    if impl == "ragged":
        idx, w, aux, _ = topk_select(logits, k, normalize_weights=normalize_weights,
                                     train=train, rng=rng, noise_std=noise_std)
        out = expert_mlp_ragged(expert_params, xs, idx, w, activation)
        counts = expert_counts(idx.reshape(-1), E)
        return MoEResult(out.reshape(orig_shape), aux,
                         {"expert_counts": counts,
                          "drop_fraction": torch.zeros((), device=xs.device), "capacity": S})

    if impl == "capacity_einsum":
        gate = topk_gating(logits, k=k, capacity_factor=capacity_factor, train=train, rng=rng,
                           noise_std=noise_std, min_capacity=min_capacity,
                           normalize_weights=normalize_weights)
        dispatched = torch.einsum("sec,sm->ecm", gate.dispatch_mask.to(xs.dtype), xs)
        expert_out = expert_mlp(expert_params, dispatched, activation)
        combined = torch.einsum("sec,ecm->sm", gate.combine_weights.to(xs.dtype), expert_out)
        return MoEResult(combined.reshape(orig_shape), gate.aux_loss, gate.metadata)

    # "capacity": the same assignment and drops in index form — dispatch is
    # one slot scatter (slot -> token id) plus a row gather, combine a row
    # gather weighted by the compact gate weights
    ca = topk_gating_compact(logits, k=k, capacity_factor=capacity_factor, train=train,
                             rng=rng, noise_std=noise_std, min_capacity=min_capacity,
                             normalize_weights=normalize_weights)
    C = ca.capacity
    slot = (ca.eidx * C + ca.loc).long()                       # [S, k]
    tgt = torch.where(ca.kept, slot, torch.full_like(slot, E * C))   # dropped -> trash slot
    token_ids = torch.arange(S, device=xs.device)[:, None].expand_as(tgt)
    # kept slots are unique (cumsum buffer positions); empty slots keep
    # the sentinel S, the zero row appended below
    inv = torch.full((E * C + 1,), S, dtype=torch.long, device=xs.device).scatter_(
        0, tgt.reshape(-1), token_ids.reshape(-1))[:E * C]
    xs_pad = torch.cat([xs, xs.new_zeros(1, M)], dim=0)
    dispatched = xs_pad.index_select(0, inv).reshape(E, C, M)
    eo = expert_mlp(expert_params, dispatched, activation).reshape(E * C, M)
    gath = eo.index_select(0, slot.clamp(0, E * C - 1).reshape(-1)).reshape(S, k, M)
    # ca.weights is zero for dropped choices, so their clipped rows add nothing
    combined = (ca.weights.to(xs.dtype)[..., None] * gath).sum(1)
    return MoEResult(combined.reshape(orig_shape), ca.aux_loss, ca.metadata)


__all__ = ["IMPLS", "MoEResult", "expert_counts", "expert_mlp", "expert_mlp_ragged",
           "init_expert_mlp", "moe_layer", "resolve_moe_impl"]
