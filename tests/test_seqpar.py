"""Sequence parallelism (context parallel): sharded-KV decode attention and
ring attention vs the single-device reference, on the virtual 8-device mesh."""

import numpy as np

import jax.numpy as jnp

from kquant.ops.attention import attention_decode
from kquant.parallel.seqpar import (
    make_seq_mesh, ring_attention, seq_attention_decode, shard_cache_seq)

RNG = np.random.default_rng(21)


def _mk_decode(B, S, H, Hkv, D, pos, quantized=False):
    q = jnp.asarray(RNG.standard_normal((B, 1, H, D)), jnp.float32)
    if quantized:
        k = jnp.asarray(RNG.integers(-127, 127, (B, Hkv, S, D)), jnp.int8)
        v = jnp.asarray(RNG.integers(-127, 127, (B, Hkv, S, D)), jnp.int8)
        ks = jnp.asarray(RNG.random((B, Hkv, S)) * 0.01 + 0.001, jnp.float32)
        vs = jnp.asarray(RNG.random((B, Hkv, S)) * 0.01 + 0.001, jnp.float32)
        scales = (ks, vs)
    else:
        k = jnp.asarray(RNG.standard_normal((B, Hkv, S, D)), jnp.float32)
        v = jnp.asarray(RNG.standard_normal((B, Hkv, S, D)), jnp.float32)
        scales = None
    positions = jnp.asarray(pos, jnp.int32).reshape(B, 1)
    return q, k, v, positions, scales


def test_seq_decode_matches_single_device():
    mesh = make_seq_mesh(seq=8)
    B, S, H, Hkv, D = 2, 64, 8, 2, 16
    q, k, v, positions, scales = _mk_decode(B, S, H, Hkv, D, [30, 63])
    ref = attention_decode(q, k, v, positions, scales, impl="xla")
    got = seq_attention_decode(q, k, v, positions, mesh, scales)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_seq_decode_int8_kv():
    mesh = make_seq_mesh(seq=4)
    B, S, H, Hkv, D = 1, 64, 4, 4, 16
    q, k, v, positions, scales = _mk_decode(B, S, H, Hkv, D, [40],
                                            quantized=True)
    ref = attention_decode(q, k, v, positions, scales, impl="xla")
    got = seq_attention_decode(q, k, v, positions, mesh, scales)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_seq_decode_position_inside_first_shard():
    """Shards whose slots are entirely in the future must contribute zero."""
    mesh = make_seq_mesh(seq=8)
    B, S, H, Hkv, D = 1, 64, 4, 2, 16
    q, k, v, positions, scales = _mk_decode(B, S, H, Hkv, D, [3])
    ref = attention_decode(q, k, v, positions, scales, impl="xla")
    got = seq_attention_decode(q, k, v, positions, mesh, scales)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_shard_cache_seq_specs():
    from kquant.runtime.kv_cache import KVCache

    mesh = make_seq_mesh(seq=4, model=2)
    cache = KVCache.create(2, 1, 4, 32, 16, quantized=True)
    sc = shard_cache_seq(cache, mesh)
    # S axis (3) sharded over seq; head axis (2) over model
    spec = sc.k.sharding.spec
    assert spec[3] == "seq" and spec[2] == "model"
    assert sc.k_scale.sharding.spec[3] == "seq"


def _ring_reference(q, k, v, positions):
    """Full causal attention, all positions, f32."""
    B, T, H, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qf = q.astype(jnp.float32).reshape(B, T, Hkv, G, D)
    logits = jnp.einsum("bthgd,bhsd->bthgs", qf, k.astype(jnp.float32))
    logits = logits * (D**-0.5)
    mask = positions[:, None, :] <= positions[:, :, None]  # [B, Tq, Tk]
    logits = jnp.where(mask[:, :, None, None, :], logits, -jnp.inf)
    import jax

    p = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("bthgs,bhsd->bthgd", p, v.astype(jnp.float32))
    return out.reshape(B, T, H, D)


def test_ring_attention_matches_full():
    mesh = make_seq_mesh(seq=4)
    B, T, H, Hkv, D = 1, 32, 4, 2, 16
    q = jnp.asarray(RNG.standard_normal((B, T, H, D)), jnp.float32)
    k = jnp.asarray(RNG.standard_normal((B, Hkv, T, D)), jnp.float32)
    v = jnp.asarray(RNG.standard_normal((B, Hkv, T, D)), jnp.float32)
    positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    ref = _ring_reference(q, k, v, positions)
    got = ring_attention(q, k, v, positions, mesh)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_ring_attention_gqa_batch():
    mesh = make_seq_mesh(seq=8)
    B, T, H, Hkv, D = 2, 64, 8, 2, 16
    q = jnp.asarray(RNG.standard_normal((B, T, H, D)), jnp.float32)
    k = jnp.asarray(RNG.standard_normal((B, Hkv, T, D)), jnp.float32)
    v = jnp.asarray(RNG.standard_normal((B, Hkv, T, D)), jnp.float32)
    positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    ref = _ring_reference(q, k, v, positions)
    got = ring_attention(q, k, v, positions, mesh)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
