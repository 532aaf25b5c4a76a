"""Quantized matmul: the analog of ggml_compute_forward_mul_mat.

The reference's hot path (SURVEY.md 3.1) is mul_mat over packed Q4_K/Q6_K
weights via per-row NEON vec-dots (67%+26% of decode cycles). Here the same
contraction has two implementations, chosen in ops.registry:

  - XLA:    dequantize W^T [K, N] with the jnp unpackers, then one
            dot_general with float32 accumulation;
  - kernel: ops.qmm_triton, which reads the packed bytes once and
            dequantizes in registers (GPU).

Under impl='auto' the kernel takes the shapes where it was measured faster
on the card (``KERNEL_MAX_ROWS``) and XLA takes the rest.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from kquant.ops import qmm_triton
from kquant.ops.registry import kernel_for
from kquant.quant.jnp_codecs import dequant_kmajor
from kquant.quant.qtensor import QTensor

# rows (batch x tokens) up to which 'auto' takes the kernel
KERNEL_MAX_ROWS = 32


def kernel_takes(x: jnp.ndarray, qt: QTensor) -> bool:
    """Whether the fused kernel can run this product at all."""
    return (qt.layout == "kmajor" and len(qt.shape) == 2
            and (qt.fold or 1) == 1 and qt.tp is None
            and qmm_triton.supported(qt.kind, qt.shape[1], qt.shape[0]))


def qmatmul(
    x: jnp.ndarray,
    qt: QTensor,
    impl: str = "auto",
    out_dtype=None,
    interpret: bool = False,
) -> jnp.ndarray:
    """y[..., n] = sum_k x[..., k] * W[n, k] for a kmajor/dense QTensor.

    Accumulates in float32; the output is cast to ``out_dtype`` (default:
    x.dtype)."""
    out_dtype = out_dtype or x.dtype
    kernel = None if qt.kind == "dense" else kernel_for(
        "qmm", impl, interpret=interpret)
    if kernel is not None:
        rows = x.size // x.shape[-1]
        if impl == "pallas" or interpret:
            return qmm_triton.qmm_triton(x, qt, out_dtype=out_dtype,
                                         interpret=interpret)
        if (kernel_takes(x, qt) and x.dtype == jnp.bfloat16
                and rows <= KERNEL_MAX_ROWS):
            return qmm_triton.qmm_triton(x, qt, out_dtype=out_dtype)

    # compute dtype follows the activations: bf16 activations -> bf16
    # matmul (f32 accumulate); f32 activations -> full-precision parity path
    cdt = jnp.float32 if x.dtype == jnp.float32 else jnp.bfloat16
    wt = dequant_kmajor(qt, dtype=cdt)  # [K, N]
    if qt.tp in ("col", "row"):
        # pin the dequanted weight to the loader's Megatron orientation so
        # the SPMD partitioner cannot reshard packed weights per layer
        # (parallel.sharding.tp_shard_constraints has the full story)
        from kquant.parallel.sharding import current_tp_ctx

        ctx = current_tp_ctx()
        if ctx is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            mesh, axis = ctx
            n = mesh.shape[axis]
            spec = ((None, axis) if qt.tp == "col" else (axis, None))
            ok = (wt.ndim == 2
                  and wt.shape[1 if qt.tp == "col" else 0] % n == 0)
            if ok:
                wt = jax.lax.with_sharding_constraint(
                    wt, NamedSharding(mesh, P(*spec)))
    y = jax.lax.dot_general(
        x.astype(cdt),
        wt,
        dimension_numbers=(((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return y.astype(out_dtype)
