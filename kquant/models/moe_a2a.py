"""Ragged expert dispatch: token-sharded EP with all_to_all (GShard-style).

The dense-EP einsum (models.moe, 'ep') computes EVERY expert on EVERY token —
cost E/top_k of the sparse ideal, acceptable for few experts but not for
Mixtral-class E=8,k=2 at scale. This module is the sparse path promised in
SURVEY.md 2.2 ("ragged all-to-all dispatch/combine"): the flattened token
axis is sharded over the 'expert' mesh axis, each device routes its local
tokens into capacity-bounded per-expert buffers, one all_to_all moves every
buffer to the device owning that expert, local experts run a dense FFN over
their (ragged, capacity-padded) token sets, and a reverse all_to_all +
weighted gather reassembles the output.

Static shapes throughout (XLA requirement): per-expert capacity
C = ceil(top_k * n_local / E * capacity_factor); tokens routed past an
expert's capacity are dropped (their combine weight contributes zero) —
the standard GShard/Switch overflow semantics. That drop convention is a
TRAINING artifact; in inference a drop silently changes model outputs, so
the DEFAULT capacity_factor is E/top_k, i.e. C = n_local: each token
contributes at most one slot per expert, so even adversarially skewed
routing (every token's top-1 on the same expert) cannot drop. Pass a
smaller capacity_factor only when you can tolerate approximate outputs.
"""

from __future__ import annotations

import math
from typing import Any

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from kquant.models.config import ModelConfig
from kquant.ops.activations import swiglu
from kquant.ops.qmatmul import qmatmul
from kquant.quant.jnp_codecs import dequant_kmajor


def moe_ffn_a2a(
    layer: dict[str, Any],
    cfg: ModelConfig,
    h: jnp.ndarray,  # [B, T, dim] (already ffn-normed)
    mesh: Mesh,
    impl: str = "auto",
    capacity_factor: float | None = None,
) -> jnp.ndarray:
    ep = mesh.shape["expert"]
    E, top_k = cfg.n_experts, cfg.n_experts_used
    if capacity_factor is None:
        capacity_factor = E / top_k  # C = n_loc: lossless under any routing
    B, T, d = h.shape
    N = B * T
    n_pad = -(-N // ep) * ep  # token axis must split evenly over 'expert'
    n_loc = n_pad // ep
    C = max(1, math.ceil(top_k * n_loc / E * capacity_factor))
    cdt = jnp.float32 if h.dtype == jnp.float32 else jnp.bfloat16

    x_flat = h.reshape(N, d)
    if n_pad != N:  # zero tokens route somewhere but combine weights them by 0
        x_flat = jnp.pad(x_flat, ((0, n_pad - N), (0, 0)))

    stk = layer["experts"]
    router = layer["gate_inp"]

    def body(x_loc, stk_loc, router_rep):
        # -- route local tokens (Mixtral semantics: softmax over selected) ---
        logits = qmatmul(x_loc, router_rep, impl, out_dtype=jnp.float32)  # [n, E]
        top_w, top_idx = lax.top_k(logits, top_k)
        top_w = jax.nn.softmax(top_w, axis=-1)  # [n, k]

        # -- capacity-bounded dispatch positions (token-major priority) ------
        flat_e = top_idx.reshape(-1)  # [n*k]
        onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)  # [n*k, E]
        pos = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1  # [n*k]
        keep = pos < C
        pos_c = jnp.minimum(pos, C - 1)
        tok = jnp.repeat(jnp.arange(n_loc), top_k)  # [n*k]

        # -- scatter into [E, C, d] send buffers (dropped rows add zero) -----
        buf = jnp.zeros((E, C, d), cdt)
        vals = x_loc.astype(cdt)[tok] * keep[:, None].astype(cdt)
        buf = buf.at[flat_e, pos_c].add(vals)

        # -- all_to_all: every device -> owner of each expert ----------------
        # [E, C, d] -> [E/ep, ep*C, d]: rows for my local experts from all peers
        recv = lax.all_to_all(buf, "expert", split_axis=0, concat_axis=1,
                              tiled=True)

        # -- dense FFN over local experts' capacity-padded token sets --------
        wg = dequant_kmajor(stk_loc["w_gate"], cdt)  # [E/ep, d, F]
        wu = dequant_kmajor(stk_loc["w_up"], cdt)
        wd = dequant_kmajor(stk_loc["w_down"], cdt)  # [E/ep, F, d]
        g = jnp.einsum("ecd,edf->ecf", recv, wg, preferred_element_type=jnp.float32)
        u = jnp.einsum("ecd,edf->ecf", recv, wu, preferred_element_type=jnp.float32)
        a = swiglu(g.astype(cdt), u.astype(cdt))
        y = jnp.einsum("ecf,efd->ecd", a, wd,
                       preferred_element_type=jnp.float32).astype(cdt)

        # -- reverse all_to_all + weighted combine ----------------------------
        back = lax.all_to_all(y, "expert", split_axis=1, concat_axis=0,
                              tiled=True)  # [E, C, d]
        picked = back[flat_e, pos_c]  # [n*k, d]
        w = (top_w.reshape(-1) * keep.astype(jnp.float32))[:, None]
        out = jnp.sum((picked.astype(jnp.float32) * w).reshape(n_loc, top_k, d),
                      axis=1)
        return out.astype(h.dtype)

    espec = lambda tree: jax.tree.map(lambda _: P("expert"), tree)
    rspec = lambda tree: jax.tree.map(lambda _: P(), tree)
    out_flat = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("expert"), espec(stk), rspec(router)),
        out_specs=P("expert"),
        axis_names=frozenset({"expert"}),
    )(x_flat, stk, router)
    return out_flat[:N].reshape(B, T, d)
