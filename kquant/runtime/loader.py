"""GGUF -> (ModelConfig, params pytree) loader.

Replaces the reference's model loader + arch registry (SURVEY.md 2.1:
llama_model_load_from_file / llama_model::load_tensors; call stack 3.2).
Parse is zero-copy (mmap views); each tensor is host-repacked into its
canonical layout (quant.repack) and device_put — packed bits travel to
device memory still packed, the analog of the reference never copying mmap'd
weights.
"""

from __future__ import annotations

from typing import Any, Callable

import jax.numpy as jnp
import numpy as np

from kquant.gguf import GGUFReader
from kquant.models.config import ModelConfig
from kquant.quant.qtensor import QTensor
from kquant.quant.repack import (
    pack_scale_kpairs,
    pack_scale_pairs,
    repack,
    widen_q6,
)

# supported architecture name aliases -> llama-family forward
LLAMA_FAMILY = {"llama", "mistral", "qwen2", "tinyllama", "mixtral", "phi3",
                "gemma", "gemma2"}


def _put(qt: QTensor, put: Callable[[str, QTensor], QTensor] | None, name: str) -> QTensor:
    if put is not None:
        return put(name, qt)
    return QTensor(qt.kind, qt.layout, qt.shape, {k: jnp.asarray(v) for k, v in qt.arrays.items()})


def _repack_named(r: GGUFReader, name: str, layout: str, scale_dtype=np.float32,
                  pack_pairs: bool = False, widen: bool = False) -> QTensor:
    ti = r.tensors[name]
    qt = repack(r.tensor_bytes(name), ti.ggml_type, ti.shape, layout=layout,
                scale_dtype=scale_dtype)
    if widen:
        qt = widen_q6(qt)
    if pack_pairs:
        qt = pack_scale_pairs(qt)
        if layout == "kmajor":
            qt = pack_scale_kpairs(qt)
    return qt


def _repack_row_slice(r: GGUFReader, name: str, r0: int, r1: int, layout: str,
                      scale_dtype=np.float32, pack_pairs: bool = False,
                      widen: bool = False) -> QTensor:
    """Repack a contiguous row range [r0, r1) of a 2-D GGUF tensor — used to
    split pre-fused projections (phi3 attn_qkv / ffn_up) into their parts for
    tensor-parallel loads. GGUF rows are contiguous, so the slice is a pure
    byte view."""
    ti = r.tensors[name]
    N, K = ti.shape
    raw = r.tensor_bytes(name).reshape(N, -1)[r0:r1]
    qt = repack(np.ascontiguousarray(raw).reshape(-1), ti.ggml_type,
                (r1 - r0, K), layout=layout, scale_dtype=scale_dtype)
    if widen:
        qt = widen_q6(qt)
    if pack_pairs:
        qt = pack_scale_pairs(qt)
        if layout == "kmajor":
            qt = pack_scale_kpairs(qt)
    return qt


def _expert_split(r: GGUFReader, name: str, scale_dtype=np.float32,
                  pack_pairs: bool = False, widen: bool = False) -> list[QTensor]:
    """Split a stacked (E, N, K) expert tensor into per-expert kmajor QTensors."""
    ti = r.tensors[name]
    E, N, K = ti.shape
    raw = r.tensor_bytes(name)
    per = raw.size // E
    qts = [
        repack(raw[e * per : (e + 1) * per], ti.ggml_type, (N, K), layout="kmajor",
               scale_dtype=scale_dtype)
        for e in range(E)
    ]
    if widen:
        qts = [widen_q6(q) for q in qts]
    if pack_pairs:
        qts = [pack_scale_pairs(q) for q in qts]
        qts = [pack_scale_kpairs(q) for q in qts]
    return qts


def _rope_neox_perm(n_feats: int, head_dim: int) -> np.ndarray:
    """Per-head un-interleave: output-feature permutation turning ggml NORM
    rope pairing (adjacent (2i, 2i+1)) into NEOX pairing (split halves
    (i, i + D/2)).

    Applying this to the q/k projection OUTPUT features (and therefore to the
    cached K) leaves attention invariant — QK^T contracts over head_dim, and
    both operands carry the same per-head permutation — while making the
    rotation a half-rotate, which is cheaper in XLA and fusable into a
    matmul epilogue (a roll instead of an even/odd interleave).
    This inverts llama.cpp's convert-time `permute` (reference SURVEY.md:
    llama/mistral GGUF exports store q/k in Meta layout for NORM mode)."""
    within = np.concatenate(
        [np.arange(0, head_dim, 2), np.arange(1, head_dim, 2)]
    )
    base = np.arange(0, n_feats, head_dim)
    return (base[:, None] + within[None, :]).reshape(-1)


def permute_out_features(qt: QTensor, perm: np.ndarray) -> QTensor:
    """Reorder a weight's output features. kmajor packed arrays all carry N
    as the last axis (qs/qh/scales/mins/sm), so this never touches the packed
    bit layout; dense tensors carry N first."""
    if qt.layout == "kmajor":
        arrays = {
            k: np.ascontiguousarray(np.asarray(v)[:, perm])
            for k, v in qt.arrays.items()
        }
    elif qt.layout == "dense":
        arrays = {"w": np.ascontiguousarray(np.asarray(qt.arrays["w"])[perm])}
    else:
        raise ValueError(f"cannot permute layout {qt.layout!r}")
    return QTensor(qt.kind, qt.layout, qt.shape, arrays)


def fuse_kmajor(qts: list[QTensor]) -> QTensor | None:
    """Concatenate same-kind kmajor QTensors along N (fused QK / gate+up
    projections — one kernel launch instead of two on the decode path)."""
    if not all(q.layout == "kmajor" and q.kind == qts[0].kind for q in qts):
        return None
    if not all(q.shape[-1] == qts[0].shape[-1] for q in qts):
        return None
    if not all(set(q.arrays) == set(qts[0].arrays) for q in qts):
        return None
    arrays = {
        k: np.concatenate([np.asarray(q.arrays[k]) for q in qts], axis=1)
        for k in qts[0].arrays
    }
    n_total = sum(int(np.prod(q.shape[:-1])) for q in qts)
    return QTensor(qts[0].kind, "kmajor", (n_total, qts[0].shape[-1]), arrays)


def load_model(
    path: str,
    put: Callable[[str, QTensor], QTensor] | None = None,
    scale_dtype=np.float32,
    fuse: bool | None = None,
    widen_q6: bool = True,
) -> tuple[ModelConfig, dict[str, Any], GGUFReader]:
    """Load a GGUF model. ``put`` optionally device_puts/shards each QTensor
    (parallel.sharding provides mesh-aware versions). Returns the open reader
    too (metadata/tokenizer live there).

    scale_dtype: dtype of the per-group scale/min side arrays ("f32"/"bf16"
    or a numpy dtype). bf16 halves/quarters the side-array HBM traffic
    (q4: 5.0 vs 6.0 bits/weight) at ~2^-9 relative scale error — the perf
    CLIs default to it; f32 is the bit-exact-parity default here.

    fuse: merge QK and gate+up projections into single packed matmuls.
    Defaults to on for single-shard runs, off under tensor parallelism
    (the concat boundary would straddle TP shards).

    widen_q6: store Q6_K matmul weights as bit-exact int8 codes ('q6w',
    quant.repack.widen_q6): a plain int8 convert in place of the packed
    unpack, for +2 bits/weight of memory traffic."""
    import dataclasses

    pack_pairs = False
    if isinstance(scale_dtype, str):
        if scale_dtype == "bf16":
            # packed bf16 (scale, min) pairs in an f32 container (quant.repack.
            # pack_scale_pairs); kinds without mins (q8) keep f32 scales
            pack_pairs = True
            scale_dtype = np.float32
        else:
            scale_dtype = {"f32": np.float32, "f16": np.float16}[scale_dtype]

    r = GGUFReader(path)
    cfg = ModelConfig.from_gguf(r.metadata)
    if cfg.arch == "mamba":
        return _load_mamba(r, cfg, put, scale_dtype, pack_pairs, widen_q6)
    if cfg.arch not in LLAMA_FAMILY:
        raise ValueError(f"unsupported architecture {cfg.arch!r}")
    if "blk.0.attn_q.bias" in r.tensors:  # qwen2-style attention biases
        cfg = dataclasses.replace(cfg, attn_bias=True)
    if cfg.is_moe and getattr(put, "ep_size", 1) > 1:
        cfg = dataclasses.replace(cfg, moe_impl=getattr(put, "moe_impl", "ep"))
    if fuse is None:
        fuse = getattr(put, "tp_size", 1) == 1

    # canonicalize NORM-mode rope to NEOX by permuting q/k output features
    # (see _rope_neox_perm): everything downstream — runtime rope, KV cache,
    # context-shift re-rotation, Pallas epilogues — sees one pairing
    canon_rope = (
        cfg.rope.mode == "norm"
        and cfg.rope.n_rot == cfg.head_dim
        and cfg.head_dim % 2 == 0
    )
    if canon_rope:
        cfg = dataclasses.replace(
            cfg, rope=dataclasses.replace(cfg.rope, mode="neox")
        )
        q_perm = _rope_neox_perm(cfg.n_heads * cfg.head_dim, cfg.head_dim)
        k_perm = _rope_neox_perm(cfg.n_kv_heads * cfg.head_dim, cfg.head_dim)

    def rp(name: str, layout: str = "kmajor") -> QTensor:
        return _put(
            _repack_named(r, name, layout, scale_dtype, pack_pairs, widen_q6),
            put, name,
        )

    params: dict[str, Any] = {
        "tok_embd": rp("token_embd.weight", "rowmajor"),
        "output_norm": rp("output_norm.weight", "dense"),
    }
    if "output.weight" in r.tensors:
        params["output"] = rp("output.weight")
    else:
        # tied embeddings: reuse token_embd, repacked kmajor for the lm head
        params["output"] = rp("token_embd.weight", "kmajor")

    layers = []
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        layer: dict[str, Any] = {
            "attn_norm": rp(p + "attn_norm.weight", "dense"),
            "wo": rp(p + "attn_output.weight"),
            "ffn_norm": rp(p + "ffn_norm.weight", "dense"),
        }
        if cfg.post_norms:  # gemma2 post-attention / post-ffn norms
            layer["post_attn_norm"] = rp(p + "post_attention_norm.weight", "dense")
            layer["post_ffn_norm"] = rp(p + "post_ffw_norm.weight", "dense")
        if p + "attn_qkv.weight" in r.tensors:
            # phi3-style pre-fused QKV projection (single GGUF tensor; rows
            # [0,Q)(Q,Q+KV)(Q+KV,Q+2KV) = q,k,v like HF Phi3Attention.qkv_proj)
            nq = cfg.n_heads * cfg.head_dim
            nkv = cfg.n_kv_heads * cfg.head_dim
            if fuse:
                wqkv = _repack_named(r, p + "attn_qkv.weight", "kmajor",
                                     scale_dtype, pack_pairs, widen_q6)
                if canon_rope:
                    perm = np.concatenate(
                        [q_perm, nq + k_perm, nq + nkv + np.arange(nkv)]
                    )
                    wqkv = permute_out_features(wqkv, perm)
                layer["wqkv"] = _put(wqkv, put, p + "attn_qkv.weight")
            else:  # TP: split at head boundaries so shards don't straddle q/k/v
                for wname, tname, a, b, perm in (
                    ("wq", "attn_q.weight", 0, nq, q_perm if canon_rope else None),
                    ("wk", "attn_k.weight", nq, nq + nkv, k_perm if canon_rope else None),
                    ("wv", "attn_v.weight", nq + nkv, nq + 2 * nkv, None),
                ):
                    qt = _repack_row_slice(r, p + "attn_qkv.weight", a, b,
                                           "kmajor", scale_dtype, pack_pairs,
                                           widen_q6)
                    if perm is not None:
                        qt = permute_out_features(qt, perm)
                    layer[wname] = _put(qt, put, p + tname)
        else:
            wq = _repack_named(r, p + "attn_q.weight", "kmajor", scale_dtype,
                               pack_pairs, widen_q6)
            wk = _repack_named(r, p + "attn_k.weight", "kmajor", scale_dtype,
                               pack_pairs, widen_q6)
            wv = _repack_named(r, p + "attn_v.weight", "kmajor", scale_dtype,
                               pack_pairs, widen_q6)
            if canon_rope:
                wq = permute_out_features(wq, q_perm)
                wk = permute_out_features(wk, k_perm)
            fused_qk = fuse_kmajor([wq, wk]) if fuse else None
            if fused_qk is not None:
                layer["wqk"] = _put(fused_qk, put, p + "attn_qk.weight")
                layer["wv"] = _put(wv, put, p + "attn_v.weight")
            else:
                layer["wq"] = _put(wq, put, p + "attn_q.weight")
                layer["wk"] = _put(wk, put, p + "attn_k.weight")
                layer["wv"] = _put(wv, put, p + "attn_v.weight")
        if cfg.attn_bias:
            for b, nm in (("bq", "attn_q.bias"), ("bk", "attn_k.bias"), ("bv", "attn_v.bias")):
                bias = r.tensor_float(p + nm)
                if canon_rope and b == "bq":
                    bias = bias[q_perm]
                elif canon_rope and b == "bk":
                    bias = bias[k_perm]
                layer[b] = jnp.asarray(bias)
        if cfg.is_moe:
            layer["gate_inp"] = rp(p + "ffn_gate_inp.weight")
            # experts stored STACKED [E, ...]: shardable over the 'expert'
            # mesh axis (EP) and sliceable per-expert on a single chip
            stk: dict[str, QTensor] = {}
            for wname, tname in (
                ("w_gate", "ffn_gate_exps.weight"),
                ("w_up", "ffn_up_exps.weight"),
                ("w_down", "ffn_down_exps.weight"),
            ):
                qts = _expert_split(r, p + tname, scale_dtype, pack_pairs,
                                    widen_q6)
                arrays = {
                    k: np.stack([np.asarray(q.arrays[k]) for q in qts])
                    for k in qts[0].arrays
                }
                qt = QTensor(qts[0].kind, "kmajor", (len(qts),) + qts[0].shape, arrays)
                stk[wname] = _put(qt, put, p + tname)
            layer["experts"] = stk
        elif p + "ffn_gate.weight" not in r.tensors:
            # phi3-style pre-fused gate+up in ffn_up.weight: rows [0,F) gate,
            # [F,2F) up (HF Phi3MLP.gate_up_proj ordering)
            F = cfg.ffn_dim
            if fuse:
                layer["w_gateup"] = rp(p + "ffn_up.weight")
            else:
                wg = _repack_row_slice(r, p + "ffn_up.weight", 0, F, "kmajor",
                                       scale_dtype, pack_pairs, widen_q6)
                wu = _repack_row_slice(r, p + "ffn_up.weight", F, 2 * F, "kmajor",
                                       scale_dtype, pack_pairs, widen_q6)
                layer["w_gate"] = _put(wg, put, p + "ffn_gate.weight")
                layer["w_up"] = _put(wu, put, p + "ffn_up.weight")
            layer["w_down"] = rp(p + "ffn_down.weight")
        else:
            wg = _repack_named(r, p + "ffn_gate.weight", "kmajor", scale_dtype,
                               pack_pairs, widen_q6)
            wu = _repack_named(r, p + "ffn_up.weight", "kmajor", scale_dtype,
                               pack_pairs, widen_q6)
            fused_gu = fuse_kmajor([wg, wu]) if fuse else None
            if fused_gu is not None:
                layer["w_gateup"] = _put(fused_gu, put, p + "ffn_gateup.weight")
            else:
                layer["w_gate"] = _put(wg, put, p + "ffn_gate.weight")
                layer["w_up"] = _put(wu, put, p + "ffn_up.weight")
            layer["w_down"] = rp(p + "ffn_down.weight")
        layers.append(layer)
    params["layers"] = layers
    return cfg, params, r


def _load_mamba(r: GGUFReader, cfg, put, scale_dtype, pack_pairs,
                widen: bool):
    """Mamba (recurrent) arch: llama.cpp `mamba` GGUF tensor naming.

    Matmul weights repack like any other arch; the SSM side parameters
    (conv taps, dt bias, A_log, D) are small f32 tensors kept dense."""

    def rp(name: str, layout: str = "kmajor") -> QTensor:
        return _put(
            _repack_named(r, name, layout, scale_dtype, pack_pairs, widen),
            put, name,
        )

    params: dict = {
        "tok_embd": rp("token_embd.weight", "rowmajor"),
        "output_norm": rp("output_norm.weight", "dense"),
    }
    if "output.weight" in r.tensors:
        params["output"] = rp("output.weight")
    else:
        params["output"] = rp("token_embd.weight", "kmajor")

    layers = []
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        di, dc = cfg.ssm_d_inner, cfg.ssm_d_conv
        layer = {
            "attn_norm": rp(p + "attn_norm.weight", "dense"),
            "ssm_in": rp(p + "ssm_in.weight"),
            "ssm_x": rp(p + "ssm_x.weight"),
            "ssm_dt": rp(p + "ssm_dt.weight"),
            "ssm_out": rp(p + "ssm_out.weight"),
            "conv_w": jnp.asarray(
                r.tensor_float(p + "ssm_conv1d.weight").reshape(di, dc)),
            "conv_b": jnp.asarray(r.tensor_float(p + "ssm_conv1d.bias")),
            "dt_b": jnp.asarray(r.tensor_float(p + "ssm_dt.bias")),
            "A_log": jnp.asarray(
                r.tensor_float(p + "ssm_a").reshape(di, cfg.ssm_d_state)),
            "Dd": jnp.asarray(r.tensor_float(p + "ssm_d")),
        }
        layers.append(layer)
    params["layers"] = layers
    return cfg, params, r
