"""Mamba (S6 selective-state-space) family — the RECURRENT memory-context
variant of the engine.

The reference's memory abstraction (`llama_memory_context_i`, SURVEY.md §2.1
"Memory-context abstraction") covers unified KV, SWA and RECURRENT backends;
llama.cpp's recurrent backend serves its `mamba` architecture. This module is
the JAX equivalent: the per-layer "cache" is not a KV ring but a fixed
O(1)-per-token recurrent state — a depthwise-conv window plus the SSM hidden
state — so context length costs no memory or bandwidth at decode.

Tensor naming follows llama.cpp's GGUF export for `mamba`
(`blk.N.ssm_{in,conv1d,x,dt,a,d,out}`); hparams from `mamba.ssm.*` metadata.

Device mapping:
  - decode is a single fused step: two matmuls around elementwise SSM
    updates — everything XLA-fusible, state donated in place;
  - prefill scans time with `lax.scan` carrying (conv, ssm) state; the
    matmuls are batched over T OUTSIDE the scan (they're time-independent),
    so the matmuls see [B*T, ...] shapes and only the O(d_state) recurrence
    serializes;
  - right-padded prefill threads a validity mask: pad steps carry the state
    through unchanged (unlike KV slots, a recurrent state cannot be
    "overwritten later").
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from kquant.models.config import ModelConfig
from kquant.ops import qmatmul, rms_norm
from kquant.quant.jnp_codecs import dequant_rows


class RecurrentCache(NamedTuple):
    """Per-layer recurrent state (the llama.cpp recurrent-memory analog).

    conv: [L, B, d_conv-1, d_inner] — trailing inputs of the depthwise conv
    ssm:  [L, B, d_inner, d_state]  — SSM hidden state
    """

    conv: jnp.ndarray
    ssm: jnp.ndarray

    @staticmethod
    def create(n_layers: int, batch: int, d_conv: int, d_inner: int,
               d_state: int, dtype=jnp.float32) -> "RecurrentCache":
        return RecurrentCache(
            conv=jnp.zeros((n_layers, batch, d_conv - 1, d_inner), dtype),
            ssm=jnp.zeros((n_layers, batch, d_inner, d_state), dtype),
        )

    @property
    def quantized(self) -> bool:  # engine interface parity with KVCache
        return False


def _softplus(x):
    return jax.nn.softplus(x)


def mamba_layer_scan(
    layer: dict[str, Any],
    cfg: ModelConfig,
    x: jnp.ndarray,  # [B, T, D] residual stream
    conv_state: jnp.ndarray,  # [B, dc-1, di]
    ssm_state: jnp.ndarray,  # [B, di, ds]
    valid: jnp.ndarray | None,  # [B, T] bool (None = all valid)
    impl: str = "auto",
):
    """One mamba block over T steps. Returns (y [B,T,D], conv', ssm')."""
    B, T, D = x.shape
    di = cfg.ssm_d_inner
    ds = cfg.ssm_d_state
    dc = cfg.ssm_d_conv
    dtr = cfg.ssm_dt_rank

    h = rms_norm(x, layer["attn_norm"].arrays["w"], cfg.norm_eps)
    xz = qmatmul(h, layer["ssm_in"], impl)  # [B, T, 2*di]
    xin = xz[..., :di].astype(jnp.float32)
    z = xz[..., di:].astype(jnp.float32)

    conv_w = layer["conv_w"]  # [di, dc] f32 (depthwise taps, llama.cpp order)
    conv_b = layer["conv_b"]  # [di]
    A = -jnp.exp(layer["A_log"].astype(jnp.float32))  # [di, ds]
    Dv = layer["Dd"].astype(jnp.float32)  # [di]

    # depthwise causal conv over time: full input window = carried state ++
    # this call's T inputs; output t uses window[t : t+dc]
    win = jnp.concatenate([conv_state.astype(jnp.float32), xin], axis=1)
    idx = jnp.arange(T)[:, None] + jnp.arange(dc)[None, :]  # [T, dc]
    xw = win[:, idx, :]  # [B, T, dc, di]
    xc = jnp.einsum("btcd,dc->btd", xw, conv_w) + conv_b
    xc = jax.nn.silu(xc)

    # data-dependent SSM parameters (time-independent matmuls, batched)
    xdb = qmatmul(xc.astype(jnp.bfloat16), layer["ssm_x"], impl).astype(jnp.float32)
    dt = xdb[..., :dtr]
    Bm = xdb[..., dtr : dtr + ds]  # [B, T, ds]
    Cm = xdb[..., dtr + ds :]  # [B, T, ds]
    dt = qmatmul(dt.astype(jnp.bfloat16), layer["ssm_dt"], impl).astype(jnp.float32)
    dt = _softplus(dt + layer["dt_b"])  # [B, T, di]

    dA = jnp.exp(dt[..., None] * A[None, None])  # [B, T, di, ds]
    dBx = (dt * xc)[..., None] * Bm[:, :, None, :]  # [B, T, di, ds]

    if valid is None:
        v = jnp.ones((B, T), bool)
    else:
        v = valid

    def step(state, t):
        s_new = state * dA[:, t] + dBx[:, t]
        state = jnp.where(v[:, t][:, None, None], s_new, state)
        y_t = jnp.einsum("bds,bs->bd", state, Cm[:, t])
        return state, y_t

    ssm_state, ys = jax.lax.scan(step, ssm_state.astype(jnp.float32),
                                 jnp.arange(T))
    y = ys.transpose(1, 0, 2) + Dv * xc  # [B, T, di]
    y = y * jax.nn.silu(z)
    out = qmatmul(y.astype(jnp.bfloat16), layer["ssm_out"], impl)

    # conv state: last dc-1 VALID inputs per row. With right-padded prefill
    # the pads are trailing, so roll each row back by its pad count.
    if valid is None:
        conv_new = win[:, T:, :]
    else:
        n_valid = jnp.sum(v, axis=1)  # [B]
        # gather the dc-1 inputs ending at the last valid position
        base = n_valid[:, None] + jnp.arange(dc - 1)[None, :]  # [B, dc-1]
        conv_new = jnp.take_along_axis(win, base[:, :, None], axis=1)
    return out.astype(x.dtype), conv_new.astype(conv_state.dtype), ssm_state


def mamba_forward(
    params: dict[str, Any],
    cfg: ModelConfig,
    tokens: jnp.ndarray,  # [B, T] int32
    positions: jnp.ndarray,  # [B, T] (unused: state IS the position)
    cache: RecurrentCache,
    impl: str = "auto",
    logits_last_only: bool = False,
    act_dtype=jnp.bfloat16,
    mesh=None,
    kv_valid=None,  # [B, T] bool: pad mask for right-padded prefill
) -> tuple[jnp.ndarray, RecurrentCache]:
    """Returns (logits [B, T or 1, vocab], updated cache)."""
    x = dequant_rows(params["tok_embd"], tokens, dtype=act_dtype)
    convs, ssms = [], []
    for i, layer in enumerate(params["layers"]):
        y, c_new, s_new = mamba_layer_scan(
            layer, cfg, x, cache.conv[i], cache.ssm[i], kv_valid, impl)
        x = x + y
        convs.append(c_new)
        ssms.append(s_new)
    cache = RecurrentCache(conv=jnp.stack(convs), ssm=jnp.stack(ssms))
    x = rms_norm(x, params["output_norm"].arrays["w"], cfg.norm_eps)
    if logits_last_only:
        if kv_valid is not None:
            last = jnp.sum(kv_valid.astype(jnp.int32), axis=1) - 1  # [B]
            x = jnp.take_along_axis(x, last[:, None, None], axis=1)
        else:
            x = x[:, -1:, :]
    logits = qmatmul(x, params["output"], impl, out_dtype=jnp.float32)
    return logits, cache
