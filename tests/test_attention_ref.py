"""The XLA attention path (ops.attention.attention_decode) against an
independent NumPy attention, over the cache kinds and masking modes the
engine uses: bf16 and int8 KV, one and several query tokens, sliding windows,
logit softcaps, the deferred-append current-token patch and the ring cache."""

import jax.numpy as jnp
import numpy as np
import pytest

from kquant.ops.attention import attention_decode

B, H, HKV, D, S = 2, 4, 2, 16, 24


def _quant_i8(x):
    """Per-(b, h, s) symmetric int8, the cache's convention."""
    amax = np.abs(x).max(axis=-1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(x / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale


def _np_attention(q, k, v, qpos, kpos, window=0, softcap=0.0):
    """q [B,T,H,D]; k, v [B,Hkv,S,D] float; qpos [B,T]; kpos [B,S] absolute
    position of each slot (-1: empty)."""
    Bq, T, Hq, Dq = q.shape
    G = Hq // k.shape[1]
    out = np.zeros((Bq, T, Hq, Dq))
    for b in range(Bq):
        for t in range(T):
            p = qpos[b, t]
            ok = (kpos[b] >= 0) & (kpos[b] <= p)
            if window:
                ok &= kpos[b] > p - window
            for h in range(Hq):
                kh, vh = k[b, h // G], v[b, h // G]
                s = kh @ q[b, t, h] / np.sqrt(Dq)
                if softcap:
                    s = np.tanh(s / softcap) * softcap
                s = np.where(ok, s, -np.inf)
                w = np.exp(s - s.max())
                out[b, t, h] = (w / w.sum()) @ vh
    return out


def _cache(rng, int8):
    k = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    if not int8:
        kb = np.asarray(jnp.asarray(k, jnp.bfloat16), np.float32)
        vb = np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32)
        return (jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16),
                None, kb, vb)
    kq, ks = _quant_i8(k)
    vq, vs = _quant_i8(v)
    return (jnp.asarray(kq), jnp.asarray(vq), (jnp.asarray(ks), jnp.asarray(vs)),
            kq * ks[..., None], vq * vs[..., None])


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("T", [1, 7])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_matches_numpy(int8, T, window, softcap):
    rng = np.random.default_rng(T * 10 + window + int(softcap) + int8)
    kc, vc, scales, kf, vf = _cache(rng, int8)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    start = np.array([3, 16 - T])
    qpos = start[:, None] + np.arange(T)[None, :]
    got = attention_decode(jnp.asarray(q), kc, vc, jnp.asarray(qpos, jnp.int32),
                           scales, logit_softcap=softcap,
                           sliding_window=window, impl="xla")
    kpos = np.broadcast_to(np.arange(S), (B, S))
    _close(got, _np_attention(q, kf, vf, qpos, kpos, window, softcap))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("window", [0, 5])
def test_deferred_append_matches_numpy(int8, window):
    """kv_cur: slot q_pos holds garbage; the current token's own (k, v) ride
    in unquantized, as if appended first."""
    rng = np.random.default_rng(40 + window + int8)
    kc, vc, scales, kf, vf = _cache(rng, int8)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k_cur = rng.standard_normal((B, 1, HKV, D)).astype(np.float32)
    v_cur = rng.standard_normal((B, 1, HKV, D)).astype(np.float32)
    qpos = np.array([[6], [11]])
    got = attention_decode(
        jnp.asarray(q), kc, vc, jnp.asarray(qpos, jnp.int32), scales,
        sliding_window=window, impl="xla",
        kv_cur=(jnp.asarray(k_cur), jnp.asarray(v_cur)))
    kf, vf = kf.copy(), vf.copy()
    for b in range(B):
        kf[b, :, qpos[b, 0]] = k_cur[b, 0]
        vf[b, :, qpos[b, 0]] = v_cur[b, 0]
    kpos = np.broadcast_to(np.arange(S), (B, S))
    _close(got, _np_attention(q, kf, vf, qpos, kpos, window))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("T", [1, 3])
def test_ring_cache_matches_numpy(int8, T):
    """ring_last: slot j holds absolute position last - ((last - j) mod S)."""
    rng = np.random.default_rng(60 + T + int8)
    kc, vc, scales, kf, vf = _cache(rng, int8)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    last = np.array([S + 9, 5])  # one wrapped ring, one not yet full
    qpos = last[:, None] - (T - 1) + np.arange(T)[None, :]
    got = attention_decode(
        jnp.asarray(q), kc, vc, jnp.asarray(qpos, jnp.int32), scales,
        sliding_window=S - 2, impl="xla",
        ring_last=jnp.asarray(last, jnp.int32))
    j = np.arange(S)
    kpos = last[:, None] - np.mod(last[:, None] - j[None, :], S)
    _close(got, _np_attention(q, kf, vf, qpos, kpos, S - 2))


def test_kernel_request_raises():
    """Attention has no kernel on any backend: 'pallas' is an error."""
    q = jnp.zeros((1, 1, H, D))
    kc = jnp.zeros((1, HKV, S, D), jnp.bfloat16)
    with pytest.raises(NotImplementedError):
        attention_decode(q, kc, kc, jnp.zeros((1, 1), jnp.int32),
                         impl="pallas")
