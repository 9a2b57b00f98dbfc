"""MoE gating in PyTorch: top-k routing with capacity and the aux loss.

Counterpart of ``shuffle_exchange_tpu/moe/gating.py``, operation for
operation: a softmax gate over f32 router logits, iterative top-k by
argmax (ties go to the lower expert id: ``torch.argmax`` returns the first
maximum, as ``jnp.argmax`` does, where ``torch.topk``'s tie order is not
specified), per-expert capacity ``ceil(k·S/E · capacity_factor)`` with
buffer positions given by choice order first and token order second,
overflow dropped, and the load-balancing aux loss on the first choice.

Every shape is static ([S, E] in), so nothing here reads a device value
on the host. The routing carries JAX's gradients with respect to the
logits: through the softmax into the aux loss (first choice) and the
combine weights (renormalized after the drops); the choices, buffer
positions, masks and drops carry none, as in JAX. Gate noise (training
exploration) stays refused: the JAX model path never passes an rng, and
its normal draws need JAX's threefry bits (ROADMAP queue A, item 3 (a)).
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch


class GateOutput(NamedTuple):
    combine_weights: torch.Tensor   # [S, E, C] f32
    dispatch_mask: torch.Tensor     # [S, E, C] bool
    aux_loss: torch.Tensor          # scalar
    metadata: dict                  # expert_counts, drop_fraction, capacity


class GateCompact(NamedTuple):
    """Index form of the capacity assignment (the same semantics as
    ``GateOutput``'s dense masks, O(S·k))."""

    eidx: torch.Tensor       # [S, k] i32 expert id per choice
    loc: torch.Tensor        # [S, k] i32 slot within the expert's buffer
    kept: torch.Tensor       # [S, k] bool False = dropped (over capacity)
    weights: torch.Tensor    # [S, k] f32 post-drop (+ renormalized) combine weight
    capacity: int
    aux_loss: torch.Tensor
    metadata: dict


def compute_capacity(num_tokens: int, num_experts: int, k: int, capacity_factor: float,
                     min_capacity: int = 4) -> int:
    cap = int(-(-num_tokens * k * capacity_factor // num_experts))
    return max(cap, min_capacity)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot rows of ``idx`` over ``n`` classes, as a comparison (no
    range check that would read the indices on the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _refuse_noise(train: bool, rng, noise_std: float) -> None:
    if train and noise_std > 0.0 and rng is not None:
        raise NotImplementedError("gate noise (training-time exploration) is not in the "
                                  "PyTorch port yet: MoE training, ROADMAP queue A, item 9 (its "
                                  "normal draws need JAX's threefry bits, item 3 (a))")


def topk_select(logits: torch.Tensor, k: int, normalize_weights: bool = True,
                train: bool = False, rng=None, noise_std: float = 0.0):
    """logits [S, E] -> (idx [S, k] i32, weights [S, k] f32, aux_loss,
    masks): the one top-k rule, shared by the capacity and the ragged
    routes. ``masks`` is the per-choice one-hot list [S, E] f32."""
    _refuse_noise(train, rng, noise_std)
    E = logits.shape[-1]
    logits = logits.float()
    gates = torch.softmax(logits, dim=-1)
    idxs: List[torch.Tensor] = []
    ws: List[torch.Tensor] = []
    masks: List[torch.Tensor] = []
    masked = logits
    for _ in range(k):
        idx = torch.argmax(masked, dim=-1)
        m = _one_hot(idx, E)
        idxs.append(idx.int())
        ws.append((gates * m).sum(-1))
        masks.append(m)
        masked = torch.where(m > 0, torch.full_like(masked, -torch.inf), masked)
    aux_loss = E * (gates.mean(0) * masks[0].mean(0)).sum()
    idx = torch.stack(idxs, dim=1)
    w = torch.stack(ws, dim=1)
    if normalize_weights and k > 1:
        w = w / torch.clamp(w.sum(1, keepdim=True), min=1e-9)
    return idx, w, aux_loss, masks


def topk_gating_compact(logits: torch.Tensor, k: int = 2, capacity_factor: float = 1.0,
                        min_capacity: int = 4, train: bool = True, rng=None,
                        noise_std: float = 0.0, normalize_weights: bool = True,
                        drop_tokens: bool = True) -> GateCompact:
    """logits [S, E] -> GateCompact: selection, buffer positions, drops,
    the weights renormalized after the drops, and the aux loss."""
    S, E = logits.shape
    idx, gates, aux_loss, masks = topk_select(logits, k, normalize_weights=False,
                                              train=train, rng=rng, noise_std=noise_std)
    capacity = compute_capacity(S, E, k, capacity_factor, min_capacity) if drop_tokens else S

    locations, kept_masks = [], []
    running = torch.zeros(E, dtype=torch.float32, device=logits.device)
    for m in masks:
        # the running count down the tokens, taken along the last dim of
        # m^T: a scan over dim 0 of [S, E] is an outer-dim scan, 5 ms at
        # S = 32,736 on the H100; the counts are exact integers either way
        loc = torch.cumsum(m.T.contiguous(), dim=1).T - m + running[None, :]
        running = running + m.sum(0)
        if drop_tokens:
            m = m * (loc < capacity)
        kept_masks.append(m)
        locations.append(loc)

    gate_weights = [gates[:, j] * m.sum(-1) for j, m in enumerate(kept_masks)]
    if normalize_weights and k > 1:
        denom = torch.clamp(sum(gate_weights), min=1e-9)
        gate_weights = [g / denom for g in gate_weights]

    loc_idx = torch.stack([(loc * m).sum(-1).int() for loc, m in zip(locations, kept_masks)],
                          dim=1)
    kept_sk = torch.stack([m.sum(-1) > 0 for m in kept_masks], dim=1)
    w_sk = torch.stack(gate_weights, dim=1)
    expert_counts = sum(kept_masks).sum(0)
    kept = sum(m.sum() for m in kept_masks)
    total = sum(m.sum() for m in masks)
    metadata = {"expert_counts": expert_counts,
                "drop_fraction": 1.0 - kept / torch.clamp(total, min=1.0),
                "capacity": capacity}
    return GateCompact(idx, loc_idx, kept_sk, w_sk, capacity, aux_loss, metadata)


def topk_gating(logits: torch.Tensor, k: int = 2, capacity_factor: float = 1.0,
                min_capacity: int = 4, train: bool = True, rng=None, noise_std: float = 0.0,
                normalize_weights: bool = True, drop_tokens: bool = True) -> GateOutput:
    """logits [S, E] -> GateOutput: ``topk_gating_compact`` densified into
    the [S, E, C] einsum contract."""
    ca = topk_gating_compact(logits, k=k, capacity_factor=capacity_factor,
                             min_capacity=min_capacity, train=train, rng=rng,
                             noise_std=noise_std, normalize_weights=normalize_weights,
                             drop_tokens=drop_tokens)
    S, E = logits.shape
    combine = torch.zeros(S, E, ca.capacity, dtype=torch.float32, device=logits.device)
    for j in range(k):
        m = _one_hot(ca.eidx[:, j], E) * ca.kept[:, j, None].float()
        loc_oh = _one_hot(ca.loc[:, j], ca.capacity)
        combine = combine + ca.weights[:, j, None, None] * m[:, :, None] * loc_oh[:, None, :]
    return GateOutput(combine, combine > 0, ca.aux_loss, ca.metadata)


__all__ = ["GateCompact", "GateOutput", "compute_capacity", "topk_gating",
           "topk_gating_compact", "topk_select"]
