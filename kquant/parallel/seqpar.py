"""Sequence (context) parallelism: the KV cache's S axis sharded over a
'seq' mesh axis.

The reference has NO long-context strategy — its KV cache is a single
contiguous f16 buffer and attention a plain KQ matmul (SURVEY.md 2.2
"Sequence/context parallelism": absent; 5 "Long-context"). This module is
the answer for contexts that outgrow one card's memory:

- **decode** (`seq_attention_decode`): every chip holds S/n_seq KV slots and
  computes a LOCAL flash partial (m_j, l_j, acc_j) over its shard; the exact
  global softmax is recovered with one log-sum-exp combine over the 'seq'
  axis (pmax of the maxima, psum of the rescaled denominators/accumulators)
  — a single lightweight collective per layer, O(B*H*D), riding ICI.
- **prefill** (`ring_attention`): blockwise ring attention — Q stays put,
  each chip's (K, V) block rotates around the ring via ppermute while every
  chip folds the visiting block into its online-softmax state. Compute on
  block i overlaps the transfer of block i+1 (XLA schedules the ppermute
  async); masking is computed from absolute positions, never materialized.

Both are shard_map-manual over 'seq' and compose with the GSPMD TP axis
('model': kv heads) — specs put 'seq' on S and 'model' on Hkv.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_NEG_INF = -1e30


def _pvary(x):
    """Mark a freshly-created array device-varying over 'seq' so fori_loop
    carry types match the body outputs."""
    return jax.lax.pcast(x, ("seq",), to="varying")


def make_seq_mesh(seq: int, model: int = 1, devices=None) -> Mesh:
    """('seq', 'model') mesh: consecutive devices form the ring."""
    import numpy as np

    devices = devices if devices is not None else jax.devices()
    n = seq * model
    if n > len(devices):
        raise ValueError(f"mesh {seq}x{model} needs {n} devices")
    dev = np.asarray(devices[:n]).reshape(seq, model)
    return Mesh(dev, ("seq", "model"))


def shard_cache_seq(cache, mesh: Mesh):
    """Shard a KVCache's S axis over 'seq' (heads over 'model' if present).

    Heads-major layout [L, B, Hkv, S, D]: S is axis 3, scales axis 3 too.
    """
    from kquant.runtime.kv_cache import KVCache

    names = mesh.axis_names
    model = "model" if ("model" in names and mesh.shape["model"] > 1) else None

    def put(x, with_d: bool):
        if x is None:
            return None
        spec = [None] * x.ndim
        spec[2] = model
        spec[3] = "seq"
        return jax.device_put(x, NamedSharding(mesh, P(*spec)))

    return KVCache(put(cache.k, True), put(cache.v, True),
                   put(cache.k_scale, False), put(cache.v_scale, False))


def _local_flash(q, k, v, valid):
    """Flash partial over the local KV shard.

    q: [B, Hkv, G, D] f32; k/v: [B, Hkv, Sl, D] f32; valid: [B, 1, 1, Sl]
    bool. Returns (m [B,Hkv,G,1], l [B,Hkv,G,1], acc [B,Hkv,G,D]).
    """
    s = jnp.einsum("bhgd,bhsd->bhgs", q, k)
    s = jnp.where(valid, s, _NEG_INF)
    m = jnp.max(s, axis=-1, keepdims=True)
    # all-masked shards contribute l=0, acc=0 (exp(-inf - -inf) guarded)
    m_safe = jnp.maximum(m, _NEG_INF / 2)
    p = jnp.exp(s - m_safe)
    p = jnp.where(valid, p, 0.0)
    l = jnp.sum(p, axis=-1, keepdims=True)
    acc = jnp.einsum("bhgs,bhsd->bhgd", p, v)
    return m, l, acc


def seq_attention_decode(
    q: jnp.ndarray,  # [B, 1, H, D]
    k_cache: jnp.ndarray,  # [B, Hkv, S, D] sharded on S over 'seq'
    v_cache: jnp.ndarray,
    q_positions: jnp.ndarray,  # [B, 1]
    mesh: Mesh,
    kv_scales=None,  # (ks, vs) [B, Hkv, S] or None
    scale: float | None = None,
) -> jnp.ndarray:
    """Causal decode attention over a sequence-sharded KV cache."""
    B, T, H, D = q.shape
    Hkv = k_cache.shape[1]
    S = k_cache.shape[2]
    G = H // Hkv
    n_seq = mesh.shape["seq"]
    Sl = S // n_seq
    if scale is None:
        scale = D**-0.5

    def local(qg, k, v, ks, vs, pos):
        j = jax.lax.axis_index("seq")
        base = j * Sl
        kv_idx = base + jax.lax.broadcasted_iota(jnp.int32, (1, 1, 1, Sl), 3)
        valid = kv_idx <= pos[:, :, None, None]  # [B, 1, 1, Sl]
        kf = k.astype(jnp.float32)
        vf = v.astype(jnp.float32)
        if ks is not None:
            kf = kf * ks[..., None]
            vf = vf * vs[..., None]
        m, l, acc = _local_flash(qg.astype(jnp.float32) * scale, kf, vf, valid)
        # exact global softmax: log-sum-exp combine over the ring
        m_g = jax.lax.pmax(m, "seq")
        corr = jnp.exp(m - m_g)
        l_g = jax.lax.psum(l * corr, "seq")
        acc_g = jax.lax.psum(acc * corr, "seq")
        return (acc_g / jnp.maximum(l_g, 1e-30)).astype(q.dtype)

    qg = q[:, 0].reshape(B, Hkv, G, D)
    qspec = P(None, None, None, None)
    kvspec = P(None, None, "seq", None)
    sspec = P(None, None, "seq")
    pspec = P(None, None)
    ks, vs = kv_scales if kv_scales is not None else (None, None)
    in_specs = (qspec, kvspec, kvspec,
                sspec if ks is not None else P(),
                sspec if vs is not None else P(), pspec)
    # only 'seq' is manual; any 'model' (TP) axis stays GSPMD-auto
    fn = jax.shard_map(
        lambda qg_, k_, v_, ks_, vs_, pos_: local(
            qg_, k_, v_,
            ks_ if ks is not None else None,
            vs_ if vs is not None else None, pos_),
        mesh=mesh, in_specs=in_specs, out_specs=qspec,
        axis_names=frozenset({"seq"}),
    )
    dummy = jnp.zeros((), jnp.float32)
    out = fn(qg, k_cache, v_cache,
             ks if ks is not None else dummy,
             vs if vs is not None else dummy, q_positions)
    return out.reshape(B, T, H, D)


def ring_attention(
    q: jnp.ndarray,  # [B, T, H, D] queries, T sharded over 'seq'
    k: jnp.ndarray,  # [B, Hkv, T, D] keys, T sharded over 'seq'
    v: jnp.ndarray,
    positions: jnp.ndarray,  # [B, T] absolute positions, sharded over 'seq'
    mesh: Mesh,
    scale: float | None = None,
) -> jnp.ndarray:
    """Causal blockwise ring attention for sequence-parallel prefill.

    Each chip keeps its Q block; (K, V) blocks rotate via ppermute. After
    n_seq hops every Q block has folded every KV block into its online
    softmax state. Returns [B, T, H, D] sharded like q.
    """
    B, T, H, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    n_seq = mesh.shape["seq"]
    if scale is None:
        scale = D**-0.5
    perm = [(i, (i + 1) % n_seq) for i in range(n_seq)]

    def local(qb, kb, vb, pos_q):
        # qb: [B, Tl, H, D]; kb/vb: [B, Hkv, Tl, D]; pos_q: [B, Tl]
        Tl = qb.shape[1]
        qg = (qb.reshape(B, Tl, Hkv, G, D).transpose(0, 2, 3, 1, 4)
              .reshape(B, Hkv, G * Tl, D).astype(jnp.float32) * scale)
        # fresh accumulators are unvarying; mark them device-varying over
        # 'seq' so the fori_loop carry type matches the body's outputs
        m = _pvary(jnp.full((B, Hkv, G * Tl, 1), _NEG_INF, jnp.float32))
        l = _pvary(jnp.zeros((B, Hkv, G * Tl, 1), jnp.float32))
        acc = _pvary(jnp.zeros((B, Hkv, G * Tl, D), jnp.float32))
        # the visiting block's key positions: start from OUR shard's
        pos_k0 = pos_q

        def body(i, carry):
            m, l, acc, kb, vb, pos_k = carry
            s = jnp.einsum("bhqd,bhsd->bhqs", qg, kb.astype(jnp.float32))
            # causal mask from absolute positions: q row r is query
            # pos_q[b, r % Tl] (G-major rows)
            pq = jnp.tile(pos_q[:, None, :], (1, 1, G))  # [B, 1, G*Tl]
            mask = pos_k[:, None, None, :] <= pq[..., None]
            s = jnp.where(mask, s, _NEG_INF)
            m_new = jnp.maximum(m, jnp.max(s, axis=-1, keepdims=True))
            m_safe = jnp.maximum(m_new, _NEG_INF / 2)
            p = jnp.exp(s - m_safe)
            p = jnp.where(mask, p, 0.0)
            alpha = jnp.exp(jnp.maximum(m, _NEG_INF / 2) - m_safe)
            alpha = jnp.where(m == _NEG_INF, 0.0, alpha)
            l = l * alpha + jnp.sum(p, axis=-1, keepdims=True)
            acc = acc * alpha + jnp.einsum(
                "bhqs,bhsd->bhqd", p, vb.astype(jnp.float32))
            # rotate KV (and its positions) to the next chip
            kb = jax.lax.ppermute(kb, "seq", perm)
            vb = jax.lax.ppermute(vb, "seq", perm)
            pos_k = jax.lax.ppermute(pos_k, "seq", perm)
            return m_new, l, acc, kb, vb, pos_k

        m, l, acc, _, _, _ = jax.lax.fori_loop(
            0, n_seq, body, (m, l, acc, kb, vb, pos_k0))
        out = acc / jnp.maximum(l, 1e-30)
        out = (out.reshape(B, Hkv, G, Tl, D).transpose(0, 3, 1, 2, 4)
               .reshape(B, Tl, H, D))
        return out.astype(q.dtype)

    fn = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "seq", None, None), P(None, None, "seq", None),
                  P(None, None, "seq", None), P(None, "seq")),
        out_specs=P(None, "seq", None, None),
        axis_names=frozenset({"seq"}),
    )
    return fn(q, k, v, positions)
