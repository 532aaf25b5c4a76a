"""Functional Llama-family forward pass (TinyLlama, Llama-2/3, Mistral, Qwen2).

Replaces the reference's graph-builder layer (SURVEY.md 2.1 "Graph builder":
llm_build_llama -> build_attn, evidenced at out.folded:249-250). In JAX the
"graph" is just this traced function; XLA replaces ggml's cgraph + backend
scheduler + threadpool (SURVEY.md section 1, L2-L4).

Params are a pytree:
  {'tok_embd': QTensor(rowmajor), 'output_norm': QTensor, 'output': QTensor,
   'layers': [ {'attn_norm', 'wq', 'wk', 'wv', 'wo',
                'ffn_norm', 'w_gate', 'w_up', 'w_down'} ... ]}
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

import jax.numpy as jnp

from kquant.models.config import ModelConfig
from kquant.ops import apply_rope, attention_decode, qmatmul, rms_norm, rope_cos_sin
from kquant.ops.activations import geglu, swiglu
from kquant.quant.jnp_codecs import dequant_rows

if TYPE_CHECKING:  # avoid models <-> runtime import cycle
    from kquant.runtime.kv_cache import KVCache


def _norm_w(qt) -> jnp.ndarray:
    return qt.arrays["w"]


def llama_layer(
    layer: dict[str, Any],
    cfg: ModelConfig,
    x: jnp.ndarray,  # [B, T, dim]
    positions: jnp.ndarray,  # [B, T]
    cos: jnp.ndarray,
    sin: jnp.ndarray,
    lkv,  # LayerKV: this layer's cache slice (k, v, k_scale, v_scale)
    impl: str = "auto",
    mesh=None,  # only used by the MoE a2a dispatch (cfg.moe_impl == 'a2a')
    window: "int | jnp.ndarray" = 0,  # sliding window (0/huge = full); may be traced
    kv_write=None,  # (k, v) -> (k_all, v_all, scales): direct-cache append
    #                 (unrolled forward); when None, lkv slice flow (lax.scan)
    kv_attend_len: "int | None" = None,  # attention reads only cache slots
    #   [0, kv_attend_len) — valid ONLY when every query position < that
    #   bound (the bucketed-prefill invariant: positions = arange(T)).
    #   Prefill against a max_seq cache otherwise pays QK/softmax/AV over
    #   slots that are all masked (r5: 704-slot cache at pp512 = 27% dead
    #   attention work).
):
    """One transformer block. Returns (x, updated LayerKV or None)."""
    # local import: runtime.__init__ imports the engine, which imports us
    from kquant.runtime.kv_cache import append_layer, layer_scales

    B, T, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    h = rms_norm(x, _norm_w(layer["attn_norm"]), cfg.norm_eps)
    if "wqkv" in layer:  # phi3-style pre-fused QKV (one GGUF tensor)
        qkv = qmatmul(h, layer["wqkv"], impl)
        q = qkv[..., : H * D].reshape(B, T, H, D)
        k = qkv[..., H * D : (H + Hkv) * D].reshape(B, T, Hkv, D)
        v = qkv[..., (H + Hkv) * D :].reshape(B, T, Hkv, D)
    elif "wqk" in layer:  # fused QK projection (loader.fuse_kmajor)
        qk = qmatmul(h, layer["wqk"], impl)
        q = qk[..., : H * D].reshape(B, T, H, D)
        k = qk[..., H * D :].reshape(B, T, Hkv, D)
        v = qmatmul(h, layer["wv"], impl).reshape(B, T, Hkv, D)
    else:
        q = qmatmul(h, layer["wq"], impl).reshape(B, T, H, D)
        k = qmatmul(h, layer["wk"], impl).reshape(B, T, Hkv, D)
        v = qmatmul(h, layer["wv"], impl).reshape(B, T, Hkv, D)
    if cfg.attn_bias:
        q = q + layer["bq"].reshape(H, D)
        k = k + layer["bk"].reshape(Hkv, D)
        v = v + layer["bv"].reshape(Hkv, D)

    q = apply_rope(q, cos[:, :, None, :], sin[:, :, None, :], cfg.rope.mode)
    k = apply_rope(k, cos[:, :, None, :], sin[:, :, None, :], cfg.rope.mode)

    ring_last = None
    kv_cur = None
    if kv_write is not None:
        view = kv_write(k, v)
        k_all, v_all, kv_scales = view[:3]
        if len(view) == 4:  # iSWA ring layer: last written abs position [B]
            ring_last = view[3]
        elif len(view) == 5:  # deferred append: current rows ride attention
            kv_cur = view[4]
    else:
        lkv = append_layer(lkv, k, v, positions)
        k_all, v_all, kv_scales = lkv[0], lkv[1], layer_scales(lkv)
    if (kv_attend_len is not None and ring_last is None and kv_cur is None
            and kv_attend_len < k_all.shape[2]):
        # reads fuse into the attention contraction (no cache copy); the
        # full cache (post-append) is still what flows onward
        k_all = k_all[:, :, :kv_attend_len]
        v_all = v_all[:, :, :kv_attend_len]
        if kv_scales is not None:
            kv_scales = (kv_scales[0][..., :kv_attend_len],
                         kv_scales[1][..., :kv_attend_len])
    attn = attention_decode(q, k_all, v_all, positions, kv_scales,
                            logit_softcap=cfg.attn_logit_softcap,
                            sliding_window=window,
                            impl="xla" if impl == "xla" else "auto",
                            ring_last=ring_last, kv_cur=kv_cur)
    h = qmatmul(attn.reshape(B, T, H * D), layer["wo"], impl)
    if cfg.post_norms:  # gemma2 post-attention norm
        h = rms_norm(h, _norm_w(layer["post_attn_norm"]), cfg.norm_eps)
    x = x + h

    h = rms_norm(x, _norm_w(layer["ffn_norm"]), cfg.norm_eps)
    act = geglu if cfg.act_fn == "gelu" else swiglu
    if cfg.is_moe:
        from kquant.models.moe import moe_ffn

        h = moe_ffn(layer, cfg, h, impl, mesh)
    elif "w_gateup" in layer:  # fused gate+up projection
        gu = qmatmul(h, layer["w_gateup"], impl)
        F = gu.shape[-1] // 2
        h = qmatmul(act(gu[..., :F], gu[..., F:]), layer["w_down"], impl)
    else:
        gate = qmatmul(h, layer["w_gate"], impl)
        up = qmatmul(h, layer["w_up"], impl)
        h = qmatmul(act(gate, up), layer["w_down"], impl)
    if cfg.post_norms:  # gemma2 post-ffn norm
        h = rms_norm(h, _norm_w(layer["post_ffn_norm"]), cfg.norm_eps)
    return x + h, lkv


def stack_layer_params(params: dict[str, Any]) -> dict[str, Any]:
    """Stack the per-layer pytrees along a new leading axis (-> 'layers_stacked')
    so the forward can lax.scan over layers: ONE traced/compiled block instead
    of n_layers copies — the 70B-class compile-time fix. Layers must be
    homogeneous (same keys/shapes), which holds for every GGUF arch we load."""
    import jax

    layers = params["layers"]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *layers)
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers_stacked"] = stacked
    return out


def llama_forward(
    params: dict[str, Any],
    cfg: ModelConfig,
    tokens: jnp.ndarray,  # [B, T] int32
    positions: jnp.ndarray,  # [B, T] int32
    cache: KVCache,
    impl: str = "auto",
    logits_last_only: bool = False,
    act_dtype=jnp.bfloat16,
    mesh=None,  # for MoE a2a dispatch only
    kv_valid=None,  # [B, T] bool: valid (non-pad) slots, iSWA prefill only
    kv_attend_len: "int | None" = None,  # see llama_layer: attention reads
    #   only cache slots [0, kv_attend_len); caller must guarantee every
    #   query position is < kv_attend_len (bucketed prefill: positions =
    #   arange(T) -> pass T)
) -> tuple[jnp.ndarray, KVCache]:
    """Returns (logits [B, T, vocab] (or [B, 1, vocab]), updated cache)."""
    x = dequant_rows(params["tok_embd"], tokens, dtype=act_dtype)
    if cfg.embed_scale != 1.0:  # gemma scales embeddings by sqrt(dim)
        x = x * jnp.asarray(cfg.embed_scale, act_dtype)
    cos, sin = rope_cos_sin(positions, cfg.rope)
    cos, sin = cos.astype(jnp.float32), sin.astype(jnp.float32)

    # full-attention layers encode their window as "huge" when windows must be
    # traced (alternating-SWA archs scanned over layers), 0 when static
    FULL = 1 << 30

    if "layers_stacked" in params:  # lax.scan over stacked layers
        import jax

        windows = None
        if cfg.sliding_window > 0:
            windows = jnp.asarray(
                [cfg.layer_window(i) or FULL for i in range(cfg.n_layers)],
                jnp.int32,
            )

        def body(x, xs):
            layer, lkv, win = xs
            x, lkv = llama_layer(layer, cfg, x, positions, cos, sin, lkv,
                                 impl, mesh, window=0 if win is None else win,
                                 kv_attend_len=kv_attend_len)
            return x, lkv

        from kquant.runtime.kv_cache import KVCache as _KVCache

        xs = (params["layers_stacked"],
              (cache.k, cache.v, cache.k_scale, cache.v_scale),
              windows)
        x, (k, v, ks, vs) = jax.lax.scan(body, x, xs)
        cache = _KVCache(k, v, ks, vs)
    else:
        # direct full-cache appends (KVCache.append): the slice -> update ->
        # set-back round trip is not elided by XLA and measurably slows the
        # decode step
        holder = {"cache": cache}
        is_iswa = hasattr(cache, "is_ring")
        # deferred batched KV append (TKQ_DEFER_APPEND, default on): at
        # decode shapes the per-layer appends would be 2L tiny
        # dynamic-update-slice ops. Instead each layer's attention folds its
        # current (k, v) in via fused selects (ops.attention kv_cur) and ALL
        # layers' rows are written in two stacked update-slices after the
        # loop.
        import os as _os

        defer = (
            tokens.shape[1] == 1 and not is_iswa
            and kv_valid is None and not cfg.is_recurrent
            and _os.environ.get("TKQ_DEFER_APPEND", "1") == "1"
        )
        pending_kv: list | None = [] if defer else None
        for i, layer in enumerate(params["layers"]):
            def kv_write(k_new, v_new, _i=i):
                if pending_kv is not None:
                    pending_kv.append((k_new, v_new))
                    view = holder["cache"].layer_view(_i)  # pre-append
                    return (*view, None, (k_new, v_new))
                if is_iswa:
                    c = holder["cache"].append(_i, k_new, v_new, positions,
                                               valid=kv_valid)
                else:
                    c = holder["cache"].append(_i, k_new, v_new, positions)
                holder["cache"] = c
                view = c.layer_view(_i)
                if is_iswa and c.is_ring(_i):
                    return (*view, positions[:, -1])  # ring: last abs position
                return view

            x, _ = llama_layer(
                layer, cfg, x, positions, cos, sin, None,
                impl, mesh, window=cfg.layer_window(i),
                kv_write=kv_write, kv_attend_len=kv_attend_len)
        if pending_kv:
            import jax as _jax

            holder["cache"] = holder["cache"].append_all(
                _jax.numpy.stack([kv[0] for kv in pending_kv]),
                _jax.numpy.stack([kv[1] for kv in pending_kv]),
                positions)
        cache = holder["cache"]

    x = rms_norm(x, _norm_w(params["output_norm"]), cfg.norm_eps)
    if logits_last_only:
        x = x[:, -1:, :]
    logits = qmatmul(x, params["output"], impl, out_dtype=jnp.float32)
    if cfg.final_logit_softcap > 0.0:
        cap = cfg.final_logit_softcap
        logits = jnp.tanh(logits / cap) * cap
    return logits, cache
