"""KV cache: contiguous per-sequence slots, bf16 or INT8 with per-token scales.

Replaces the reference's llama_kv_cache (SURVEY.md 2.1: slot allocation,
set_rows K/V append, mask construction; evidence out.folded:52-55,250). The
ggml ``set_rows`` append becomes a vmapped dynamic-update-slice; the kq_mask
is never materialized — attention computes it from positions (ops.attention).

INT8 mode is the north-star KV compression (BASELINE.json): values are stored
as int8 with one f32 scale per (token, kv-head), chosen as amax/127 at append
time; attention dequantizes on the fly.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class KVCache:
    """Heads-major layout [L, B, Hkv, S, D]: a head's tokens are contiguous,
    so attention reads (S, D) tiles straight from device memory — no
    per-layer cache transpose."""

    k: jnp.ndarray  # [L, B, Hkv, S, D] bf16, or int8 when quantized
    v: jnp.ndarray
    k_scale: jnp.ndarray | None  # [L, B, Hkv, S] f32 (int8 mode only)
    v_scale: jnp.ndarray | None

    def tree_flatten(self):
        return (self.k, self.v, self.k_scale, self.v_scale), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- construction ----------------------------------------------------------
    @staticmethod
    def create(
        n_layers: int,
        batch: int,
        max_seq: int,
        n_kv_heads: int,
        head_dim: int,
        dtype=jnp.bfloat16,
        quantized: bool = False,
    ) -> "KVCache":
        shape = (n_layers, batch, n_kv_heads, max_seq, head_dim)
        if quantized:
            return KVCache(
                k=jnp.zeros(shape, jnp.int8),
                v=jnp.zeros(shape, jnp.int8),
                k_scale=jnp.zeros(shape[:-1], jnp.float32),
                v_scale=jnp.zeros(shape[:-1], jnp.float32),
            )
        return KVCache(jnp.zeros(shape, dtype), jnp.zeros(shape, dtype), None, None)

    @property
    def quantized(self) -> bool:
        return self.k.dtype == jnp.int8

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]

    # -- update ----------------------------------------------------------------
    def append(
        self,
        layer_idx,
        k_new: jnp.ndarray,  # [B, T, Hkv, D]
        v_new: jnp.ndarray,
        positions: jnp.ndarray,  # [B, T] absolute, contiguous per row
    ) -> "KVCache":
        """Direct update-slice into the full [L, B, Hkv, S, D] arrays — no
        per-layer slice/set-back round trip, which XLA does not elide. The new
        tokens transpose to heads-major on the device (tiny: [B, T, Hkv, D])."""
        start = positions[:, 0]
        B = k_new.shape[0]

        # unrolled per-row update-slices (B is static and small): each is a
        # plain in-place DUS on the donated buffer — no vmap/scatter lowering
        def upd(full, val):
            val = val.transpose(0, 2, 1, 3)  # [B, Hkv, T, D]
            for b in range(B):
                full = jax.lax.dynamic_update_slice(
                    full, val[b][None, None], (layer_idx, b, 0, start[b], 0)
                )
            return full

        if self.quantized:
            kq, ks = _quant_i8(k_new)
            vq, vs = _quant_i8(v_new)

            def upd_s(full, val):
                val = val.transpose(0, 2, 1)  # [B, Hkv, T]
                for b in range(B):
                    full = jax.lax.dynamic_update_slice(
                        full, val[b][None, None], (layer_idx, b, 0, start[b])
                    )
                return full

            return KVCache(upd(self.k, kq), upd(self.v, vq),
                           upd_s(self.k_scale, ks), upd_s(self.v_scale, vs))
        dt = self.k.dtype
        return KVCache(upd(self.k, k_new.astype(dt)),
                       upd(self.v, v_new.astype(dt)), None, None)

    def append_all(
        self,
        k_new: jnp.ndarray,  # [L, B, T, Hkv, D]
        v_new: jnp.ndarray,
        positions: jnp.ndarray,  # [B, T]
    ) -> "KVCache":
        """EVERY layer's new rows in two update-slices per batch row — the
        deferred-append decode path (models.llama): the per-layer eager path
        costs 2 tiny DUS ops/layer (plus 2 more for the int8 scale planes);
        this batches a step's 2L (4L quantized) writes into 2 (4)."""
        start = positions[:, 0]
        L, B = k_new.shape[0], k_new.shape[1]
        dt = self.k.dtype

        def upd(full, val):
            val = val.transpose(0, 1, 3, 2, 4).astype(dt)  # [L, B, Hkv, T, D]
            for b in range(B):
                full = jax.lax.dynamic_update_slice(
                    full, val[:, b][:, None], (0, b, 0, start[b], 0))
            return full

        if self.quantized:
            kq, ks = _quant_i8(k_new)  # [L,B,T,Hkv,D] i8 / [L,B,T,Hkv] f32
            vq, vs = _quant_i8(v_new)

            def upd_s(full, val):
                val = val.transpose(0, 1, 3, 2)  # [L, B, Hkv, T]
                for b in range(B):
                    full = jax.lax.dynamic_update_slice(
                        full, val[:, b][:, None], (0, b, 0, start[b]))
                return full

            return KVCache(upd(self.k, kq), upd(self.v, vq),
                           upd_s(self.k_scale, ks), upd_s(self.v_scale, vs))
        return KVCache(upd(self.k, k_new), upd(self.v, v_new), None, None)

    def layer(self, layer_idx) -> "LayerKV":
        """Per-layer slice (k [B,Hkv,S,D], v, k_scale|None, v_scale|None).
        ``layer_idx`` may be traced."""
        def sl(x):
            return None if x is None else x[layer_idx]

        return (sl(self.k), sl(self.v), sl(self.k_scale), sl(self.v_scale))

    def set_layer(self, layer_idx, lkv: "LayerKV") -> "KVCache":
        k_l, v_l, ks_l, vs_l = lkv
        return KVCache(
            k=self.k.at[layer_idx].set(k_l),
            v=self.v.at[layer_idx].set(v_l),
            k_scale=None if ks_l is None else self.k_scale.at[layer_idx].set(ks_l),
            v_scale=None if vs_l is None else self.v_scale.at[layer_idx].set(vs_l),
        )

    def layer_view(self, layer_idx: int):
        """(k [B,Hkv,S,D], v, scales-tuple-or-None) for attention."""
        if self.quantized:
            return (
                self.k[layer_idx],
                self.v[layer_idx],
                (self.k_scale[layer_idx], self.v_scale[layer_idx]),
            )
        return self.k[layer_idx], self.v[layer_idx], None


# A single layer's cache slice: (k, v, k_scale|None, v_scale|None). Plain
# tuple so it threads through lax.scan xs/ys without a wrapper class.
LayerKV = tuple


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ISWACache:
    """iSWA memory layout: TWO stacked caches — full-attention layers get
    max_seq slots, sliding-window layers get a RING of ``ring`` slots
    (slot = position % ring), so their KV memory is bounded by the window
    instead of the context length.

    The llama.cpp equivalent is llama_kv_cache_unified_iswa (the reference's
    pluggable memory-context abstraction, SURVEY.md 2.1 "Memory-context
    abstraction" / 5 "Long-context"). Unrolled-forward only: lax.scan needs
    homogeneous per-layer shapes.
    """

    full: KVCache | None  # [L_full, B, Hkv, S, D]
    swa: KVCache | None   # [L_swa, B, Hkv, ring, D]
    layer_map: tuple      # static: per model layer ('full'|'swa', index)
    ring: int             # static: swa ring size

    def tree_flatten(self):
        return (self.full, self.swa), (self.layer_map, self.ring)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0], aux[1])

    @staticmethod
    def create(windows: list[int], batch: int, max_seq: int, ring: int,
               n_kv_heads: int, head_dim: int, dtype=jnp.bfloat16,
               quantized: bool = False) -> "ISWACache":
        """windows: per-layer sliding window (0 = full attention)."""
        lmap: list = []
        nf = ns = 0
        for w in windows:
            if w > 0:
                lmap.append(("swa", ns))
                ns += 1
            else:
                lmap.append(("full", nf))
                nf += 1

        def mk(n, s):
            return KVCache.create(n, batch, s, n_kv_heads, head_dim, dtype,
                                  quantized) if n else None

        return ISWACache(mk(nf, max_seq), mk(ns, ring), tuple(lmap), ring)

    @property
    def quantized(self) -> bool:
        c = self.full if self.full is not None else self.swa
        return c.quantized

    @property
    def max_seq(self) -> int:
        return self.full.max_seq if self.full is not None else self.swa.max_seq

    def append(self, layer_idx: int, k_new, v_new, positions,
               valid=None) -> "ISWACache":
        """valid [B, T] bool: rows' padding slots must NOT be written to the
        ring during bucketed prefill — a padded position p > row_len wraps to
        slot p %% ring, which may hold live in-window history of that row
        (unlike the unified layout, where pad slots are always overwritten
        before any query can attend them)."""
        kind, li = self.layer_map[layer_idx]
        if kind == "full":
            return dataclasses.replace(
                self, full=self.full.append(li, k_new, v_new, positions))
        T = k_new.shape[1]
        if T == 1:  # decode: plain in-place update-slices at pos % ring
            return dataclasses.replace(
                self, swa=self.swa.append(li, k_new, v_new,
                                          positions % self.ring))
        # prefill: the write may wrap the ring -> per-row scatter
        slots = positions % self.ring  # [B, T]
        B = k_new.shape[0]
        b_idx = jnp.arange(B)[:, None]
        c = self.swa

        def scat(full, val):
            # advanced indices (b_idx, slots) separated by the ':' head axis
            # move to the front: the gather/scatter shape is [B, T, Hkv(, D)]
            if valid is not None:  # keep existing content under pad slots
                cur = full[li, b_idx, :, slots]
                v = valid.reshape(valid.shape + (1,) * (val.ndim - 2))
                val = jnp.where(v, val.astype(cur.dtype), cur)
            return full.at[li, b_idx, :, slots].set(val)

        if c.quantized:
            kq, ks = _quant_i8(k_new)
            vq, vs = _quant_i8(v_new)
            swa = KVCache(scat(c.k, kq), scat(c.v, vq),
                          scat(c.k_scale, ks), scat(c.v_scale, vs))
        else:
            dt = c.k.dtype
            swa = KVCache(scat(c.k, k_new.astype(dt)),
                          scat(c.v, v_new.astype(dt)), None, None)
        return dataclasses.replace(self, swa=swa)

    def layer_view(self, layer_idx: int):
        kind, li = self.layer_map[layer_idx]
        return (self.full if kind == "full" else self.swa).layer_view(li)

    def is_ring(self, layer_idx: int) -> bool:
        return self.layer_map[layer_idx][0] == "swa"


def _quant_i8(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """INT8 KV quantization: per-(token, head) amax/127 f32 scales."""
    scale = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1) / 127.0
    safe = jnp.where(scale > 0, scale, 1.0)
    q = jnp.round(x.astype(jnp.float32) / safe[..., None])
    return q.astype(jnp.int8), scale.astype(jnp.float32)


def append_layer(
    lkv: LayerKV,
    k_new: jnp.ndarray,  # [B, T, Hkv, D]
    v_new: jnp.ndarray,
    positions: jnp.ndarray,  # [B, T] absolute, contiguous per row
) -> LayerKV:
    """ggml set_rows equivalent on one layer's slice (vmapped update-slice) —
    the lax.scan form, where per-layer slices are the natural carry. The
    unrolled forward uses KVCache.append (direct full-array update) instead."""
    k_l, v_l, ks_l, vs_l = lkv
    start = positions[:, 0]

    def upd(cache_l, val):  # vmap over batch; cache_l [B, Hkv, S, D]
        val = val.transpose(0, 2, 1, 3)  # [B, Hkv, T, D]
        return jax.vmap(
            lambda c, u, s: jax.lax.dynamic_update_slice(c, u, (0, s, 0))
        )(cache_l, val, start)

    if k_l.dtype == jnp.int8:  # quantized: per-(token, head) f32 scales
        kq, ks = _quant_i8(k_new)
        vq, vs = _quant_i8(v_new)

        def upd_s(cache_l, val):  # cache_l [B, Hkv, S]
            val = val.transpose(0, 2, 1)  # [B, Hkv, T]
            return jax.vmap(
                lambda c, u, s: jax.lax.dynamic_update_slice(c, u, (0, s))
            )(cache_l, val, start)

        return (upd(k_l, kq), upd(v_l, vq), upd_s(ks_l, ks), upd_s(vs_l, vs))
    dt = k_l.dtype
    return (upd(k_l, k_new.astype(dt)), upd(v_l, v_new.astype(dt)), None, None)


def layer_scales(lkv: LayerKV):
    """Attention kv_scales arg for a per-layer slice."""
    _, _, ks_l, vs_l = lkv
    return None if ks_l is None else (ks_l, vs_l)


def shift_cache(cache: KVCache, n_keep: int, n_discard: int, rope) -> KVCache:
    """Context shift: drop positions [n_keep, n_keep + n_discard) and slide the
    tail down, re-rotating the moved K entries by -n_discard positions.

    The llama.cpp equivalent is llama_kv_cache_seq_rm + seq_add (the "K-shift"
    ggml graph the reference's KV cache exposes via get_has_shift,
    SURVEY.md 2.1 "KV cache"); it is what makes infinite generation possible
    once the context fills. V carries no positional encoding and only moves.

    INT8 caches dequantize the moved K rows, rotate in f32, and requantize
    with fresh per-(token, head) amax scales.
    """
    from kquant.ops.rope import apply_rope, rope_delta_cos_sin

    S = cache.max_seq
    idx = jnp.arange(S)
    src = jnp.where(idx < n_keep, idx, jnp.minimum(idx + n_discard, S - 1))
    k = jnp.take(cache.k, src, axis=3)
    v = jnp.take(cache.v, src, axis=3)
    ks = None if cache.k_scale is None else jnp.take(cache.k_scale, src, axis=3)
    vs = None if cache.v_scale is None else jnp.take(cache.v_scale, src, axis=3)

    cos, sin = rope_delta_cos_sin(-n_discard, rope)
    moved = idx >= n_keep  # [S]
    if cache.quantized:
        kf = k.astype(jnp.float32) * ks[..., None]
        kr = apply_rope(kf, cos, sin, rope.mode)
        scale = jnp.max(jnp.abs(kr), axis=-1) / 127.0
        safe = jnp.where(scale > 0, scale, 1.0)
        kq = jnp.round(kr / safe[..., None]).astype(jnp.int8)
        k = jnp.where(moved[:, None], kq, k)
        ks = jnp.where(moved, scale.astype(jnp.float32), ks)
    else:
        kr = apply_rope(k, cos, sin, rope.mode).astype(k.dtype)
        k = jnp.where(moved[:, None], kr, k)
    return KVCache(k, v, ks, vs)


def slice_batch_row(cache, slot):
    """View of one batch row (slot may be traced). Generic over any cache
    pytree whose every leaf carries batch at axis 1 (KVCache [L,B,Hkv,S,D],
    RecurrentCache [L,B,...])."""
    import jax

    return jax.tree.map(
        lambda x: jax.lax.dynamic_slice_in_dim(x, slot, 1, axis=1), cache)


def set_batch_row(cache, row, slot):
    """Write a [L, 1, ...] row cache back into batch position ``slot``
    (generic over cache pytrees, see slice_batch_row)."""
    import jax

    return jax.tree.map(
        lambda x, u: jax.lax.dynamic_update_slice_in_dim(x, u, slot, axis=1),
        cache, row)


