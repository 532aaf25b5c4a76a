"""Independent NumPy reference forward for parity tests.

Deliberately implemented from the architecture definition (not by calling any
kquant op), mirroring SURVEY.md section 4's implication (c): end-to-end
logit parity of the engine vs a dequantized-fp32 forward.
"""

from __future__ import annotations

import numpy as np


def rms_norm(x, w, eps):
    return x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True) + eps) * w


def rope(x, positions, base, mode="norm"):
    # x: [T, H, D]; ggml NORM mode rotates adjacent pairs (2i, 2i+1),
    # NEOX mode rotates split halves (i, i + D/2)
    T, H, D = x.shape
    half = D // 2
    inv = base ** (-2.0 * np.arange(half) / D)
    theta = positions[:, None] * inv[None, :]  # [T, half]
    cos, sin = np.cos(theta)[:, None, :], np.sin(theta)[:, None, :]
    if mode == "neox":
        x1, x2 = x[..., :half], x[..., half:]
        return np.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = np.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1)
    return out.reshape(x.shape)


def softmax(x, axis=-1):
    m = np.max(x, axis=axis, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=axis, keepdims=True)


def silu(x):
    return x / (1.0 + np.exp(-x))


def gelu(x):
    from math import erf

    return x * 0.5 * (1.0 + np.vectorize(erf)(x / np.sqrt(2.0)))


def ref_forward(reader, cfg, tokens):
    """Full-sequence causal forward. tokens: [T] -> logits [T, vocab].

    Honors the arch quirks the engine supports: neox rope, embedding scaling,
    gemma2 post-norms / softcaps / alternating sliding window, GeGLU, tied
    embeddings."""
    t = lambda name: reader.tensor_float(name).astype(np.float64)
    # raw-GGUF rope pairing: the engine loader canonicalizes NORM-mode models
    # to NEOX by permuting q/k weights, but this reference reads the raw
    # on-disk weights, so it must use the on-disk pairing
    from kquant.models.config import ModelConfig

    raw_mode = ModelConfig.from_gguf(reader.metadata).rope.mode
    T = len(tokens)
    positions = np.arange(T, dtype=np.float64)
    x = t("token_embd.weight")[tokens] * cfg.embed_scale
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    act = gelu if cfg.act_fn == "gelu" else silu
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        h = rms_norm(x, t(p + "attn_norm.weight"), cfg.norm_eps)
        if p + "attn_qkv.weight" in reader.tensors:  # phi3 pre-fused QKV
            qkv = h @ t(p + "attn_qkv.weight").T
            q = qkv[:, : H * D].reshape(T, H, D)
            k = qkv[:, H * D : (H + Hkv) * D].reshape(T, Hkv, D)
            v = qkv[:, (H + Hkv) * D :].reshape(T, Hkv, D)
        else:
            q = (h @ t(p + "attn_q.weight").T).reshape(T, H, D)
            k = (h @ t(p + "attn_k.weight").T).reshape(T, Hkv, D)
            v = (h @ t(p + "attn_v.weight").T).reshape(T, Hkv, D)
        q = rope(q, positions, cfg.rope.freq_base, raw_mode)
        k = rope(k, positions, cfg.rope.freq_base, raw_mode)
        G = H // Hkv
        k_rep = np.repeat(k, G, axis=1)  # [T, H, D]
        v_rep = np.repeat(v, G, axis=1)
        logits = np.einsum("thd,shd->hts", q, k_rep) / np.sqrt(D)
        if cfg.attn_logit_softcap > 0.0:
            logits = np.tanh(logits / cfg.attn_logit_softcap) * cfg.attn_logit_softcap
        mask = np.tril(np.ones((T, T), bool))
        win = cfg.layer_window(i)
        if win > 0:
            qp, kp = np.arange(T)[:, None], np.arange(T)[None, :]
            mask &= kp > qp - win
        logits = np.where(mask[None], logits, -np.inf)
        attn = np.einsum("hts,shd->thd", softmax(logits), v_rep).reshape(T, H * D)
        h = attn @ t(p + "attn_output.weight").T
        if cfg.post_norms:
            h = rms_norm(h, t(p + "post_attention_norm.weight"), cfg.norm_eps)
        x = x + h
        h = rms_norm(x, t(p + "ffn_norm.weight"), cfg.norm_eps)
        if p + "ffn_gate.weight" in reader.tensors:
            gate = h @ t(p + "ffn_gate.weight").T
            up = h @ t(p + "ffn_up.weight").T
        else:  # phi3 pre-fused gate+up: rows [0,F) gate, [F,2F) up
            gu = h @ t(p + "ffn_up.weight").T
            F = cfg.ffn_dim
            gate, up = gu[:, :F], gu[:, F:]
        h = (act(gate) * up) @ t(p + "ffn_down.weight").T
        if cfg.post_norms:
            h = rms_norm(h, t(p + "post_ffw_norm.weight"), cfg.norm_eps)
        x = x + h
    x = rms_norm(x, t("output_norm.weight"), cfg.norm_eps)
    out_w = t("token_embd.weight") if cfg.tie_embeddings else t("output.weight")
    logits = x @ out_w.T
    if cfg.final_logit_softcap > 0.0:
        logits = np.tanh(logits / cfg.final_logit_softcap) * cfg.final_logit_softcap
    return logits
