"""Mixture-of-experts FFN (Mixtral-style), top-k softmax routing.

The reference never runs MoE (SURVEY.md 2.2: expert parallelism absent) but
llama.cpp supports the arch; this provides the capability in JAX.
Expert weights are STACKED QTensors [E, N, K] (loader), which gives two
execution strategies:

  - 'loop' (single shard): python loop over experts, each a fused Pallas
    dequant+matmul, outputs masked by routing weight. Dead-simple, static
    shapes, kernel-accelerated.
  - 'ep' (expert-parallel): one dense einsum over the stacked [E, ...]
    weights sharded P('expert', ...) — GSPMD gives every device only its
    local experts' compute and inserts one psum over the expert axis. No
    ragged all-to-all needed; compute is dense over E (cost E/top_k of
    sparse, divided by the expert-axis size).

Routing: top-k over router logits, softmax over the SELECTED experts
(Mixtral semantics).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp

from kquant.models.config import ModelConfig
from kquant.ops.activations import swiglu
from kquant.ops.qmatmul import qmatmul
from kquant.quant.jnp_codecs import dequant_kmajor
from kquant.quant.qtensor import QTensor


def _routing_weights(router_logits: jnp.ndarray, top_k: int) -> jnp.ndarray:
    """[B, T, E] logits -> [B, T, E] weights (0 for unselected experts)."""
    B, T, E = router_logits.shape
    top_w, top_idx = jax.lax.top_k(router_logits, top_k)
    top_w = jax.nn.softmax(top_w, axis=-1)
    return jnp.zeros_like(router_logits).at[
        jnp.arange(B)[:, None, None], jnp.arange(T)[None, :, None], top_idx
    ].set(top_w)


def _expert_view(stk: QTensor, e: int) -> QTensor:
    """2-D QTensor view of expert ``e`` of a stacked [E, ...] QTensor."""
    return QTensor(stk.kind, "kmajor", tuple(stk.shape[1:]),
                   {k: v[e] for k, v in stk.arrays.items()})


def moe_ffn(layer: dict[str, Any], cfg: ModelConfig, h: jnp.ndarray,
            impl: str = "auto", mesh=None) -> jnp.ndarray:
    """h: [B, T, dim] (already ffn-normed) -> [B, T, dim]."""
    if cfg.moe_impl == "a2a" and mesh is not None:
        from kquant.models.moe_a2a import moe_ffn_a2a

        return moe_ffn_a2a(layer, cfg, h, mesh, impl)
    router_logits = qmatmul(h, layer["gate_inp"], impl, out_dtype=jnp.float32)
    gate_w = _routing_weights(router_logits, cfg.n_experts_used)  # [B, T, E]
    stk = layer["experts"]

    if cfg.moe_impl == "ep":
        cdt = jnp.float32 if h.dtype == jnp.float32 else jnp.bfloat16
        wg = dequant_kmajor(stk["w_gate"], cdt)  # [E, K, F]
        wu = dequant_kmajor(stk["w_up"], cdt)
        wd = dequant_kmajor(stk["w_down"], cdt)  # [E, F, dim]
        hb = h.astype(cdt)
        g = jnp.einsum("btk,ekf->ebtf", hb, wg, preferred_element_type=jnp.float32)
        u = jnp.einsum("btk,ekf->ebtf", hb, wu, preferred_element_type=jnp.float32)
        a = swiglu(g.astype(cdt), u.astype(cdt))
        y = jnp.einsum("ebtf,efd->ebtd", a, wd, preferred_element_type=jnp.float32)
        out = jnp.einsum("ebtd,bte->btd", y, gate_w)
        return out.astype(h.dtype)

    out = jnp.zeros(h.shape, jnp.float32)
    for e in range(cfg.n_experts):
        g = qmatmul(h, _expert_view(stk["w_gate"], e), impl)
        u = qmatmul(h, _expert_view(stk["w_up"], e), impl)
        y = qmatmul(swiglu(g, u), _expert_view(stk["w_down"], e), impl,
                    out_dtype=jnp.float32)
        out = out + y * gate_w[..., e : e + 1]
    return out.astype(h.dtype)
