"""Device-side (jnp) dequantization of canonical QTensors.

This is the slow-but-exact XLA path (SURVEY.md section 7 step 2): dequantize a
whole packed weight to floats, then matmul. It defines the numerics the fused
Pallas kernels must match and serves as the fallback on any backend.

All unpacks mirror kquant.quant.repack's bit conventions and are pure
mask/shift + concatenation along the packed-K axis.
"""

from __future__ import annotations

import jax.numpy as jnp

from kquant.quant.qtensor import QTensor
from kquant.quant.repack import GROUP_SIZE


def _unpack_codes_kmajor(qt: QTensor) -> jnp.ndarray:
    """Packed arrays -> integer codes [..., K, N] (int8/int32).

    Axis -2 is the packed-K axis, so stacked expert tensors [E, K/2, N]
    unpack the same way as plain [K/2, N] weights.

    qt.fold > 1 (quant.repack.refold_kmajor, row-parallel TP shards): the
    packed-K axis is split into fold blocks and the bit fold is block-local
    — the concat runs on the within-block axis, so a shard's unpack touches
    only its own bytes (no cross-shard redistribution)."""
    a = qt.arrays
    kind = qt.kind
    f = qt.fold or 1
    ax = -2
    if kind in ("q8", "q6w"):
        return a["qs"]

    def blk(x):
        if f == 1:
            return x
        return x.reshape(*x.shape[:-2], f, x.shape[-2] // f, x.shape[-1])

    def merge(q):
        if f == 1:
            return q
        return q.reshape(*q.shape[:-3], q.shape[-3] * q.shape[-2],
                         q.shape[-1])

    if kind in ("q4", "q5", "q6"):
        qs = blk(a["qs"])
        q = jnp.concatenate([qs & 0xF, qs >> 4], axis=ax)
        if kind == "q5":
            qh = blk(a["qh"])
            h = jnp.concatenate([(qh >> j) & 1 for j in range(8)], axis=ax)
            q = q | (h << 4)
        elif kind == "q6":
            qh = blk(a["qh"])
            h = jnp.concatenate([(qh >> (2 * j)) & 3 for j in range(4)], axis=ax)
            q = q | (h << 4)
        return merge(q)
    if kind in ("q2", "q3"):
        qs = blk(a["qs"])
        q = jnp.concatenate([(qs >> (2 * j)) & 3 for j in range(4)], axis=ax)
        if kind == "q3":
            qh = blk(a["qh"])
            h = jnp.concatenate([(qh >> j) & 1 for j in range(8)], axis=ax)
            q = q | (h << 2)
        return merge(q)
    raise ValueError(f"unknown kind {kind}")


def unpack_scale_pairs(sm: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """f32-container packed pairs -> (scales, mins) f32 (see
    quant.repack.pack_scale_pairs: low 16 bits = bf16 scale, high = bf16 min)."""
    import jax

    bits = jax.lax.bitcast_convert_type(sm, jnp.int32)
    s = jax.lax.bitcast_convert_type(bits << 16, jnp.float32)
    m = jax.lax.bitcast_convert_type(bits & jnp.int32(-65536), jnp.float32)
    return s, m


def _scales_mins(arrays) -> tuple[jnp.ndarray, jnp.ndarray | None]:
    if "sm" in arrays:
        return unpack_scale_pairs(arrays["sm"])
    if "sp" in arrays:
        # adjacent-group bf16 scale pairs (quant.repack.pack_scale_kpairs):
        # re-interleave the group axis (low bits = even group, high = odd)
        even, odd = unpack_scale_pairs(arrays["sp"])
        s2 = jnp.stack([even, odd], axis=-2)  # [..., G/2, 2, N]
        return s2.reshape(*s2.shape[:-3], -1, s2.shape[-1]), None
    s = arrays["scales"].astype(jnp.float32)
    m = arrays["mins"].astype(jnp.float32) if "mins" in arrays else None
    return s, m


def dequant_kmajor(qt: QTensor, dtype=jnp.float32) -> jnp.ndarray:
    """Dequantize a kmajor QTensor to W^T of shape [..., K, N]."""
    if qt.kind == "dense":
        return qt.arrays["w"].T.astype(dtype)
    assert qt.layout == "kmajor", qt.layout
    g = GROUP_SIZE[qt.kind]
    q = _unpack_codes_kmajor(qt)
    if qt.tp in ("col", "row"):
        # pin the unpacked codes to the loader's TP orientation: the SPMD
        # partitioner otherwise shards the unpack CONCAT's output along the
        # concat (K) axis and implements it as a per-layer all_to_all of
        # the packed codes (found by tools_scale_ready's 70B lowering;
        # see parallel.sharding.tp_shard_constraints)
        from kquant.parallel.sharding import current_tp_ctx

        ctx = current_tp_ctx()
        if ctx is not None and q.ndim == 2:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec as P

            mesh, axis = ctx
            spec = (None, axis) if qt.tp == "col" else (axis, None)
            if q.shape[1 if qt.tp == "col" else 0] % mesh.shape[axis] == 0:
                q = jax.lax.with_sharding_constraint(
                    q, NamedSharding(mesh, P(*spec)))
    q = q.astype(jnp.float32)
    scales, mins = _scales_mins(qt.arrays)
    w = q * jnp.repeat(scales, g, axis=-2)
    if mins is not None:
        w = w - jnp.repeat(mins, g, axis=-2)
    return w.astype(dtype)


def dequant_logical(qt: QTensor, dtype=jnp.float32) -> jnp.ndarray:
    """Dequantize to the logical numpy-order shape (e.g. (N, K))."""
    if qt.kind == "dense":
        return qt.arrays["w"].astype(dtype)
    if qt.layout == "kmajor":
        w = dequant_kmajor(qt, dtype).T
        return w.reshape(qt.shape)
    return dequant_rows(qt, None, dtype)


def dequant_rows(qt: QTensor, rows, dtype=jnp.float32) -> jnp.ndarray:
    """Gather + dequantize rows of a rowmajor QTensor (embedding lookup).

    rows: int array of row indices (any shape) or None for all rows.
    This replaces the reference's get_rows op on quantized token embeddings.
    """
    if qt.kind == "dense":
        w = qt.arrays["w"]
        out = w if rows is None else jnp.take(w, rows, axis=0)
        return out.astype(dtype)
    assert qt.layout == "rowmajor", qt.layout
    a = qt.arrays
    take = (lambda x: x) if rows is None else (lambda x: jnp.take(x, rows, axis=0))
    # rowmajor arrays are the kmajor ones transposed; reuse the unpacker by
    # transposing back the (small) gathered slices
    sub = QTensor(
        qt.kind,
        "kmajor",
        qt.shape,
        {k: take(v).reshape(-1, v.shape[-1]).T for k, v in a.items()},
    )
    g = GROUP_SIZE[qt.kind]
    q = _unpack_codes_kmajor(sub).astype(jnp.float32)  # [K, R]
    scales, mins = _scales_mins(sub.arrays)
    w = q * jnp.repeat(scales, g, axis=0)
    if mins is not None:
        w = w - jnp.repeat(mins, g, axis=0)
    K = qt.shape[-1]
    out = w.T  # [R, K]
    if rows is None:
        return out.reshape(qt.shape).astype(dtype)
    return out.reshape(tuple(jnp.shape(rows)) + (K,)).astype(dtype)
