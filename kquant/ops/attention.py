"""Attention over a (possibly quantized) KV cache.

Replaces the reference's attention sub-graph (SURVEY.md 3.3): KQ matmul via
ggml_vec_dot_f16, soft_max_f32, V-gather matmul, with the kq_mask materialized
per ubatch. Here the mask is *computed* from positions (never materialized in
device memory at [S, S]) and the whole sub-graph is one fused XLA region. The
op has no hand-written kernel (ops.registry).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from kquant.ops.registry import kernel_for


def attention_decode(
    q: jnp.ndarray,  # [B, T, H, D]
    k_cache: jnp.ndarray,  # [B, Hkv, S, D]   (bf16 or int8, heads-major)
    v_cache: jnp.ndarray,  # [B, Hkv, S, D]
    q_positions: jnp.ndarray,  # [B, T] absolute position of each query token
    kv_scales: tuple[jnp.ndarray, jnp.ndarray] | None = None,  # int8 per-token scales [B, Hkv, S]
    scale: float | None = None,
    logit_softcap: float = 0.0,
    sliding_window: int = 0,
    impl: str = "auto",
    ring_last: jnp.ndarray | None = None,  # [B] last written abs position
    kv_cur: tuple[jnp.ndarray, jnp.ndarray] | None = None,
) -> jnp.ndarray:
    """Causal GQA attention of T query tokens against S cache slots.

    Cache slot j holds absolute position j (ring-free layout); slots beyond a
    sequence's current length hold garbage but are masked because j > q_pos.
    Returns [B, T, H, D] in q.dtype.

    ring_last: when given, the cache is a RING of S slots (iSWA layout,
    runtime.kv_cache.ISWACache): slot j holds absolute position
    last - ((last - j) mod S) — the mask is computed from that instead of j.

    kv_cur: DEFERRED-APPEND mode (models.llama decode path, T == 1): the
    current token's (k, v) [B, T, Hkv, D] have NOT been written to the cache
    yet — slot q_pos holds garbage. The current token enters as fused
    elementwise patches instead: its logit replaces column q_pos before
    softmax, and its value replaces row q_pos's contribution after. The
    logit/probability set is mathematically identical to attending the
    post-append cache; it exists so the per-layer cache writes (2L tiny
    dynamic_update_slice ops per step) can batch into two stacked writes.

    impl: 'auto' and 'xla' run the XLA version below; 'pallas' raises,
    since attention has no kernel on any backend (ops.registry).
    """
    kernel_for("attention", impl)  # checks impl; 'pallas' raises
    B, T, H, D = q.shape
    # sliding_window may be a traced int32 scalar (per-layer windows threaded
    # through lax.scan for alternating-SWA archs like gemma2); a traced window
    # means "always apply the window mask" — full-attention layers encode it
    # as a huge window, never 0.
    static_win = isinstance(sliding_window, int)
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv  # query groups per kv head
    if scale is None:
        scale = D ** -0.5

    # int8 KV: the per-token scales are constant along the contracted D axis,
    # so they fold OUT of both contractions — K scales multiply logit columns,
    # V scales multiply probability rows. The int8 cache feeds the dot via a
    # bare convert (a fusible producer); no dequantized f32 copy of the cache
    # is materialized in device memory (`cache.astype(f32) * scale[..., None]`
    # would double the KV bytes read per step).
    kf = k_cache.astype(jnp.float32)
    vf = v_cache.astype(jnp.float32)
    if kv_scales is not None:
        ks, vs = kv_scales  # [B, Hkv, S] each

    qf = q.astype(jnp.float32).reshape(B, T, Hkv, G, D)
    # logits: [B, T, Hkv, G, S]
    logits = jnp.einsum("bthgd,bhsd->bthgs", qf, kf,
                        preferred_element_type=jnp.float32) * scale
    if kv_scales is not None:
        logits = logits * ks[:, None, :, None, :]

    at_cur = None
    if kv_cur is not None:
        # deferred append (docstring): slot q_pos is garbage — substitute the
        # current token's logit there (a fused select) before softcap/mask
        k_cur, v_cur = kv_cur
        l_cur = jnp.einsum(
            "bthgd,bthd->bthg", qf,
            k_cur.astype(jnp.float32).reshape(B, T, Hkv, D)) * scale
        cur_pos = jax.lax.broadcasted_iota(jnp.int32, (1, 1, S), 2)
        at_cur = cur_pos == q_positions[:, :, None]  # [B, T, S]
        logits = jnp.where(at_cur[:, :, None, None, :],
                           l_cur[..., None], logits)

    if logit_softcap > 0.0:
        logits = jnp.tanh(logits / logit_softcap) * logit_softcap

    kv_pos = jax.lax.broadcasted_iota(jnp.int32, (1, 1, S), 2)
    if ring_last is not None:
        # ring layout: recover each slot's absolute position from the last
        # written position (slots hold the last S positions, wrap-around)
        last = ring_last[:, None, None].astype(jnp.int32)  # [B, 1, 1]
        kv_pos = last - jnp.mod(last - kv_pos, S)
    mask = kv_pos <= q_positions[:, :, None]  # [B, T, S] causal
    if ring_last is not None:
        mask &= kv_pos >= 0  # slots not yet written (early steps)
    if not static_win or sliding_window > 0:
        mask &= kv_pos > q_positions[:, :, None] - sliding_window
    logits = jnp.where(mask[:, :, None, None, :], logits, -jnp.inf)

    p = jax.nn.softmax(logits, axis=-1)
    if at_cur is not None:
        # value side of the deferred append: extract/zero the garbage row's
        # weight BEFORE the int8 v-scales apply (its scale slot is garbage
        # too); the current token's value re-enters rank-1, unquantized
        at5 = at_cur[:, :, None, None, :]
        p_cur = jnp.sum(jnp.where(at5, p, 0.0), axis=-1)  # [B, T, Hkv, G]
        p = jnp.where(at5, 0.0, p)
    if kv_scales is not None:
        p = p * vs[:, None, :, None, :]
    out = jnp.einsum("bthgs,bhsd->bthgd", p, vf,
                     preferred_element_type=jnp.float32)
    if at_cur is not None:
        out = out + p_cur[..., None] * v_cur.astype(jnp.float32).reshape(
            B, T, Hkv, 1, D)
    return out.reshape(B, T, H, D).astype(q.dtype)
