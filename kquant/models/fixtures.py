"""Synthesize exact-architecture GGUF fixture models (random weights).

With zero network egress, tests and benchmarks exercise the *identical*
tensor inventory, shapes, and quant-type assignment of real Q4_K_M exports:
most weights Q4_K; attn_v / ffn_down / output in Q6_K (the llama.cpp Q4_K_M
mixed recipe — the reference's TinyLlama lm head being Q6_K is why
ggml_vec_dot_q6_K_q8_K is 25.93% of its decode cycles, SURVEY.md section 3.1);
norms F32.
"""

from __future__ import annotations

import numpy as np

from kquant.gguf import GGMLType, GGUFWriter
from kquant.models.config import ModelConfig
from kquant.ops.rope import RopeParams


def tiny_config(
    arch: str = "llama",
    n_layers: int = 2,
    dim: int = 64,
    n_heads: int = 4,
    n_kv_heads: int = 2,
    ffn_dim: int = 128,
    vocab_size: int = 512,
    max_seq_len: int = 256,
    n_experts: int = 0,
    n_experts_used: int = 0,
    sliding_window: int = 0,
) -> ModelConfig:
    hd = dim // n_heads
    quirks: dict = {}
    rope_mode = "norm"
    if arch in ("qwen2", "phi3"):
        rope_mode = "neox"
    if arch in ("gemma", "gemma2"):
        rope_mode = "neox"
        quirks.update(act_fn="gelu", embed_scale=float(dim) ** 0.5,
                      tie_embeddings=True)
    if arch == "gemma2":
        quirks.update(post_norms=True, swa_pattern=2,
                      attn_logit_softcap=50.0, final_logit_softcap=30.0)
    return ModelConfig(
        arch=arch, n_layers=n_layers, dim=dim, n_heads=n_heads,
        n_kv_heads=n_kv_heads, head_dim=hd, ffn_dim=ffn_dim,
        vocab_size=vocab_size, max_seq_len=max_seq_len,
        rope=RopeParams(head_dim=hd, n_rot=hd, mode=rope_mode),
        n_experts=n_experts, n_experts_used=n_experts_used,
        sliding_window=sliding_window, **quirks,
    )


def tiny_mamba_config(
    n_layers: int = 2,
    dim: int = 64,
    vocab_size: int = 512,
    max_seq_len: int = 256,
    d_state: int = 16,
    d_conv: int = 4,
    expand: int = 2,
) -> ModelConfig:
    """Mamba (recurrent) test architecture — llama.cpp `mamba` GGUF layout."""
    di = expand * dim
    return ModelConfig(
        arch="mamba", n_layers=n_layers, dim=dim, n_heads=0, n_kv_heads=0,
        head_dim=0, ffn_dim=0, vocab_size=vocab_size, max_seq_len=max_seq_len,
        rope=RopeParams(head_dim=0, n_rot=0),
        ssm_d_conv=d_conv, ssm_d_inner=di, ssm_d_state=d_state,
        ssm_dt_rank=max(1, -(-dim // 16)),
    )


def tinyllama_1b_config() -> ModelConfig:
    """TinyLlama-1.1B-Chat-v1.0 — the reference's exact benchmark model
    (BASELINE.md: 1.10 B params, 636.18 MiB at Q4_K_M)."""
    return ModelConfig(
        arch="llama", n_layers=22, dim=2048, n_heads=32, n_kv_heads=4,
        head_dim=64, ffn_dim=5632, vocab_size=32000, max_seq_len=2048,
        rope=RopeParams(head_dim=64, n_rot=64),
    )


def llama3_8b_config() -> ModelConfig:
    return ModelConfig(
        arch="llama", n_layers=32, dim=4096, n_heads=32, n_kv_heads=8,
        head_dim=128, ffn_dim=14336, vocab_size=128256, max_seq_len=8192,
        rope=RopeParams(head_dim=128, n_rot=128, freq_base=500000.0),
    )


def llama3_70b_config() -> ModelConfig:
    """BASELINE config #5 (tensor+expert sharded, N>=4 hosts). ~35 GB at
    Q4_K_M: requires a sharded mesh; single-chip runs use tiny_config."""
    return ModelConfig(
        arch="llama", n_layers=80, dim=8192, n_heads=64, n_kv_heads=8,
        head_dim=128, ffn_dim=28672, vocab_size=128256, max_seq_len=8192,
        rope=RopeParams(head_dim=128, n_rot=128, freq_base=500000.0),
    )


def mixtral_8x7b_config() -> ModelConfig:
    """BASELINE config #4 (MoE expert-sharded across hosts)."""
    return ModelConfig(
        arch="llama", n_layers=32, dim=4096, n_heads=32, n_kv_heads=8,
        head_dim=128, ffn_dim=14336, vocab_size=32000, max_seq_len=8192,
        rope=RopeParams(head_dim=128, n_rot=128, freq_base=1000000.0),
        n_experts=8, n_experts_used=2,
    )


def _qtype_for(name: str, shape, quant: str) -> GGMLType:
    """llama.cpp-style Q4_K_M type recipe (or uniform f16/f32)."""
    if name.endswith("_norm.weight"):
        return GGMLType.F32
    if quant == "f32":
        return GGMLType.F32
    if quant == "f16":
        return GGMLType.F16
    # Q4_K_M mix
    if any(s in name for s in ("attn_v", "ffn_down", "output.weight")):
        return GGMLType.Q6_K
    if shape[-1] % 256 != 0:
        return GGMLType.Q8_0 if shape[-1] % 32 == 0 else GGMLType.F16
    return GGMLType.Q4_K


def _random_kquant(t: GGMLType, n: int, scale: float, rng) -> np.ndarray:
    """Random Q4_K / Q6_K superblocks whose weights have about ``scale``
    standard deviation, drawn straight as bytes: no quantizer pass, so a
    billion-parameter fixture builds in seconds."""
    from kquant.gguf.constants import type_size

    nb = n // 256
    blocks = rng.integers(0, 256, (nb, type_size(t)), dtype=np.uint8)
    if t == GGMLType.Q4_K:
        # w = d*sc*q - dmin*m, sc, m in [0, 63], q in [0, 15]: dmin = 7.5 d
        # centres the weights, whose std is then ~258 d
        d = np.float16(scale / 258.0)
        dmin = np.float16(7.5 * float(d))
        blocks[:, 0:2] = np.frombuffer(d.tobytes(), np.uint8)
        blocks[:, 2:4] = np.frombuffer(dmin.tobytes(), np.uint8)
    elif t == GGMLType.Q6_K:
        # w = d*sc*(q - 32), sc int8, q in [0, 63]: std ~ 1366 d
        d = np.float16(scale / 1366.0)
        blocks[:, 208:210] = np.frombuffer(d.tobytes(), np.uint8)
    else:
        raise ValueError(f"no random blocks for {t!r}")
    return blocks.reshape(-1)


def write_fixture_gguf(
    path,
    cfg: ModelConfig,
    seed: int = 0,
    quant: str = "q4_k_m",
    scale: float = 0.05,
    with_tokenizer: bool = True,
    random_codes: bool = False,
) -> str:
    """Write a random-weight GGUF with ``cfg``'s exact tensor inventory.

    random_codes: draw the Q4_K/Q6_K tensors as random superblock bytes
    instead of quantizing random floats (full-width presets build in seconds
    instead of minutes; the tensors' types, shapes and bytes are the same)."""
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path)
    for k, v in cfg.to_gguf_metadata().items():
        w.add(k, v)
    w.add("general.name", f"fixture-{cfg.arch}")
    if with_tokenizer:
        # minimal SPM-style vocab: specials + byte tokens + a few merged pieces
        toks = ["<unk>", "<s>", "</s>"]
        toks += [f"<0x{b:02X}>" for b in range(256)]
        pieces = ["▁the", "▁a", "he", "ll", "o", "▁hello", "▁world", "th", "er", "▁t"]
        toks += pieces
        toks += [f"tok{i}" for i in range(cfg.vocab_size - len(toks))]
        scores = [0.0] * 3 + [0.0] * 256 + [-float(i) for i in range(len(pieces))]
        scores += [-1000.0] * (cfg.vocab_size - len(scores))
        ttypes = [2, 3, 3] + [6] * 256 + [1] * (cfg.vocab_size - 259)
        w.add("tokenizer.ggml.model", "llama")
        w.add("tokenizer.ggml.tokens", toks[: cfg.vocab_size])
        w.add("tokenizer.ggml.scores", np.array(scores[: cfg.vocab_size], np.float32))
        w.add("tokenizer.ggml.token_type", np.array(ttypes[: cfg.vocab_size], np.int32))
        w.add("tokenizer.ggml.bos_token_id", 1)
        w.add("tokenizer.ggml.eos_token_id", 2)

    def add(name: str, shape):
        t = _qtype_for(name, shape, quant)
        if random_codes and t in (GGMLType.Q4_K, GGMLType.Q6_K):
            n = int(np.prod(shape))
            w.add_tensor(name, np.empty(shape, np.uint8), t,
                         raw=_random_kquant(t, n, scale, rng))
            return
        x = rng.standard_normal(shape).astype(np.float32) * scale
        w.add_tensor(name, x, t)

    D, H, Hkv, hd, F, V = cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.ffn_dim, cfg.vocab_size
    add("token_embd.weight", (V, D))
    add("output_norm.weight", (D,))
    if not cfg.tie_embeddings:
        add("output.weight", (V, D))
    if cfg.is_recurrent:
        di, ds, dc, dtr = (cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_d_conv,
                           cfg.ssm_dt_rank)
        for i in range(cfg.n_layers):
            p = f"blk.{i}."
            add(p + "attn_norm.weight", (D,))
            add(p + "ssm_in.weight", (2 * di, D))
            add(p + "ssm_x.weight", (dtr + 2 * ds, di))
            add(p + "ssm_dt.weight", (di, dtr))
            add(p + "ssm_out.weight", (D, di))
            for nm, shape in (("ssm_conv1d.weight", (di, dc)),
                              ("ssm_conv1d.bias", (di,)),
                              ("ssm_dt.bias", (di,)),
                              ("ssm_a", (di, ds)),
                              ("ssm_d", (di,))):
                w.add_tensor(p + nm,
                             rng.standard_normal(shape).astype(np.float32)
                             * scale, GGMLType.F32)
        return str(w.write())
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        add(p + "attn_norm.weight", (D,))
        if cfg.post_norms:
            add(p + "post_attention_norm.weight", (D,))
            add(p + "post_ffw_norm.weight", (D,))
        if cfg.arch == "phi3":  # pre-fused QKV, one tensor (HF qkv_proj order)
            add(p + "attn_qkv.weight", ((H + 2 * Hkv) * hd, D))
        else:
            add(p + "attn_q.weight", (H * hd, D))
            add(p + "attn_k.weight", (Hkv * hd, D))
            add(p + "attn_v.weight", (Hkv * hd, D))
        if cfg.arch == "qwen2":  # attention biases
            for bn, bd in (("attn_q.bias", H * hd), ("attn_k.bias", Hkv * hd),
                           ("attn_v.bias", Hkv * hd)):
                w.add_tensor(p + bn, rng.standard_normal((bd,)).astype(np.float32) * scale,
                             GGMLType.F32)
        add(p + "attn_output.weight", (D, H * hd))
        add(p + "ffn_norm.weight", (D,))
        if cfg.is_moe:
            add(p + "ffn_gate_inp.weight", (cfg.n_experts, D))
            add(p + "ffn_gate_exps.weight", (cfg.n_experts, F, D))
            add(p + "ffn_up_exps.weight", (cfg.n_experts, F, D))
            add(p + "ffn_down_exps.weight", (cfg.n_experts, D, F))
        elif cfg.arch == "phi3":  # pre-fused gate+up (HF gate_up_proj order)
            add(p + "ffn_up.weight", (2 * F, D))
            add(p + "ffn_down.weight", (D, F))
        else:
            add(p + "ffn_gate.weight", (F, D))
            add(p + "ffn_up.weight", (F, D))
            add(p + "ffn_down.weight", (D, F))
    return str(w.write())


def projection_shapes(cfg: ModelConfig) -> list[tuple[str, str, int, int]]:
    """(name, kind, K, N) of each matmul of one Q4_K_M layer and the lm head,
    as the loader holds them: fused q/k and gate/up, Q6_K tensors widened."""
    D, H, Hkv, hd, F = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        cfg.ffn_dim)
    return [
        ("qk", "q4", D, (H + Hkv) * hd),
        ("v", "q6w", D, Hkv * hd),
        ("o", "q4", H * hd, D),
        ("gate_up", "q4", D, 2 * F),
        ("down", "q6w", F, D),
        ("lm_head", "q6w", D, cfg.vocab_size),
    ]


def random_qtensor(kind: str, N: int, K: int, scales: str = "bf16",
                   seed: int = 0, scale_mag: float = 0.01):
    """A random packed kmajor weight of logical shape (N, K) for the kinds of
    the Q4_K_M recipe after loading: 'q4' (Q4_K) and 'q6w' (widened Q6_K).

    scales='bf16' packs the side arrays as the loader does under
    scale_dtype='bf16' (q4 'sm' pairs, q6w 'sp' pairs); 'f32' keeps plain
    'scales' (+ 'mins'). Codes are drawn on the default device, so even an
    lm head of 128256 x 4096 builds in a moment."""
    import jax
    import jax.numpy as jnp

    from kquant.quant.qtensor import QTensor
    from kquant.quant.repack import (GROUP_SIZE, pack_scale_kpairs,
                                     pack_scale_pairs)

    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    G = K // GROUP_SIZE[kind]
    if kind == "q4":
        arrays = {
            "qs": jax.random.randint(key, (K // 2, N), 0, 256,
                                     jnp.int32).astype(jnp.uint8),
            "scales": rng.random((G, N), dtype=np.float32) * scale_mag,
            "mins": rng.random((G, N), dtype=np.float32) * scale_mag,
        }
    elif kind == "q6w":
        arrays = {
            "qs": jax.random.randint(key, (K, N), -32, 32,
                                     jnp.int32).astype(jnp.int8),
            "scales": rng.random((G, N), dtype=np.float32) * scale_mag,
        }
    else:
        raise ValueError(f"random_qtensor makes q4 or q6w, not {kind!r}")
    qt = QTensor(kind, "kmajor", (N, K), arrays)
    if scales == "bf16":
        qt = pack_scale_kpairs(qt) if kind == "q6w" else pack_scale_pairs(qt)
    return QTensor(kind, "kmajor", (N, K),
                   {k: jnp.asarray(v) for k, v in qt.arrays.items()})


def random_qparams(cfg: ModelConfig, seed: int = 0, scale_mag: float = 0.01,
                   avals: bool = False):
    """Build a params pytree with random *packed* quantized weights directly —
    no quantization pass, so even billion-parameter models materialize in
    seconds. Numerics are garbage (random codes) but shapes, dtypes, layouts
    and compute graphs are identical to a real Q4_K_M load; used for compile
    checks and kernel benchmarking.

    avals=True materializes NOTHING: every leaf is a jax.ShapeDtypeStruct —
    the 70B-geometry AOT-lowering path (tools_scale_ready.py), where 35 GB
    of packed weights must never exist on the host.
    """
    import jax
    import jax.numpy as jnp

    from kquant.quant.qtensor import QTensor

    rng = np.random.default_rng(seed)

    def q4(shape, layout="kmajor"):
        K = shape[-1]
        # stacked expert tensors (E, N, K) keep their leading axis on arrays
        pre = shape[:-2] if len(shape) > 2 else ()
        N = shape[-2] if len(shape) > 1 else 1
        if avals:
            arrays = {
                "qs": jax.ShapeDtypeStruct((*pre, K // 2, N), jnp.uint8),
                "scales": jax.ShapeDtypeStruct((*pre, K // 32, N), jnp.float32),
                "mins": jax.ShapeDtypeStruct((*pre, K // 32, N), jnp.float32),
            }
            if layout == "rowmajor":
                arrays = {k: jax.ShapeDtypeStruct(v.shape[::-1], v.dtype)
                          for k, v in arrays.items()}
            return QTensor("q4", layout, tuple(shape), arrays)
        qs = rng.integers(0, 256, (*pre, K // 2, N), dtype=np.uint8)
        scales = (rng.random((*pre, K // 32, N), dtype=np.float32) * scale_mag)
        mins = (rng.random((*pre, K // 32, N), dtype=np.float32) * scale_mag)
        arrays = {"qs": qs, "scales": scales, "mins": mins}
        if layout == "rowmajor":
            arrays = {k: np.ascontiguousarray(v.T) for k, v in arrays.items()}
        return QTensor("q4", layout, tuple(shape), {k: jnp.asarray(v) for k, v in arrays.items()})

    def dense(shape):
        if avals:
            return QTensor("dense", "dense", tuple(shape),
                           {"w": jax.ShapeDtypeStruct(tuple(shape), jnp.float32)})
        return QTensor("dense", "dense", tuple(shape),
                       {"w": jnp.ones(shape, jnp.float32)})

    D, H, Hkv, hd, F, V = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                           cfg.ffn_dim, cfg.vocab_size)
    params = {
        "tok_embd": q4((V, D), "rowmajor"),
        "output_norm": dense((D,)),
        "output": q4((V, D)),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": dense((D,)),
            "wq": q4((H * hd, D)),
            "wk": q4((Hkv * hd, D)),
            "wv": q4((Hkv * hd, D)),
            "wo": q4((D, H * hd)),
            "ffn_norm": dense((D,)),
        }
        if cfg.is_moe:
            E = cfg.n_experts
            layer["gate_inp"] = q4((E, D))
            layer["experts"] = {
                "w_gate": q4((E, F, D)), "w_up": q4((E, F, D)),
                "w_down": q4((E, D, F)),
            }
        else:
            layer.update(w_gate=q4((F, D)), w_up=q4((F, D)), w_down=q4((D, F)))
        params["layers"].append(layer)
    return params
