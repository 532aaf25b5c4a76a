"""On-device Q8_K-style activation quantization.

The reference quantizes activations fp32 -> Q8_K on the fly inside mul_mat
(SURVEY.md 3.1: quantize_row_q8_K_ref, out.folded:184-186) so the hot dot
runs int8 x int8 with per-32-group rescale and ``bsums`` for the min-term.
This is the JAX equivalent, producing the operands for an int8
tensor-core matmul path:

  xq     int8  [..., K]        round(x / scale), clamped to ±127
  scales f32   [..., K/g]      amax per group / 127
  gsums  f32   [..., K/g]      scale * sum(xq in group)  (= bsums trick:
                               the Q4_K min-term becomes gsums @ mins)
"""

from __future__ import annotations

import jax.numpy as jnp


def quantize_activations(x: jnp.ndarray, group: int = 32):
    """x: [..., K] float -> (xq int8, scales f32 [..., K/g], gsums f32)."""
    K = x.shape[-1]
    assert K % group == 0, (K, group)
    xf = x.astype(jnp.float32)
    xg = xf.reshape(*x.shape[:-1], K // group, group)
    amax = jnp.max(jnp.abs(xg), axis=-1)
    scales = amax / 127.0
    safe = jnp.where(scales > 0, scales, 1.0)
    q = jnp.clip(jnp.round(xg / safe[..., None]), -127, 127)
    xq = q.astype(jnp.int8).reshape(x.shape)
    gsums = scales * q.sum(axis=-1)
    return xq, scales, gsums


def dequantize_activations(xq: jnp.ndarray, scales: jnp.ndarray, group: int = 32):
    K = xq.shape[-1]
    xg = xq.astype(jnp.float32).reshape(*xq.shape[:-1], K // group, group)
    return (xg * scales[..., None]).reshape(xq.shape)
