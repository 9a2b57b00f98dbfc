"""Mixture-of-experts routing and the MoE layer (PyTorch port of
``shuffle_exchange_tpu.moe``)."""

from .gating import (GateCompact, GateOutput, compute_capacity, topk_gating,
                     topk_gating_compact, topk_select)
from .layer import (MoEResult, expert_mlp, expert_mlp_ragged, init_expert_mlp, moe_layer,
                    resolve_moe_impl)

__all__ = ["GateCompact", "GateOutput", "MoEResult", "compute_capacity", "expert_mlp",
           "expert_mlp_ragged", "init_expert_mlp", "moe_layer", "resolve_moe_impl",
           "topk_gating", "topk_gating_compact", "topk_select"]
