"""KV-cache context shift: drop old positions, slide the tail down, re-rotate
K in place — the llama.cpp llama_kv_cache_seq_rm + seq_add (K-shift)
equivalent (reference KV cache exposes it via get_has_shift, SURVEY.md 2.1).

The core invariant: after shifting away n_discard positions, the cache must
be bit-for-bit (up to dtype rounding) what you would get by re-encoding the
surviving tokens at their new positions.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from kquant.ops.rope import RopeParams, apply_rope, rope_cos_sin
from kquant.runtime.kv_cache import KVCache, shift_cache

L, B, S, H, D = 2, 2, 16, 2, 8


def build_cache(rope: RopeParams, k_raw, v_raw, quantized=False):
    """Cache holding rope(k_raw[p], p) at position p for all S positions."""
    cache = KVCache.create(L, B, S, H, D, quantized=quantized)
    cos, sin = rope_cos_sin(jnp.arange(S)[None, :], rope)  # [1, S, d2]
    for layer in range(L):
        k = apply_rope(
            jnp.asarray(k_raw[layer]), cos[:, :, None, :], sin[:, :, None, :],
            rope.mode,
        )
        cache = cache.append(
            layer, k, jnp.asarray(v_raw[layer]),
            jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S)),
        )
    return cache


def expected_after_shift(rope: RopeParams, k_raw, v_raw, n_keep, n_discard,
                         quantized=False):
    """Re-encode the surviving tokens at their post-shift positions."""
    keep = list(range(n_keep)) + list(range(n_keep + n_discard, S))
    k_kept = k_raw[:, :, keep, :, :]
    v_kept = v_raw[:, :, keep, :, :]
    pad = S - len(keep)
    k_kept = np.concatenate([k_kept, k_kept[:, :, -1:].repeat(pad, 2)], axis=2)
    v_kept = np.concatenate([v_kept, v_kept[:, :, -1:].repeat(pad, 2)], axis=2)
    return build_cache(rope, k_kept, v_kept, quantized=quantized)


ROPES = {
    "norm": RopeParams(head_dim=D, n_rot=D, mode="norm"),
    "neox": RopeParams(head_dim=D, n_rot=D, mode="neox"),
    "yarn": RopeParams(head_dim=D, n_rot=D, mode="norm", freq_scale=0.25,
                       ext_factor=1.0, n_ctx_orig=64),
}


@pytest.mark.parametrize("rope_name", list(ROPES))
def test_shift_matches_reencoding_bf16(rope_name):
    rope = ROPES[rope_name]
    rng = np.random.default_rng(0)
    k_raw = rng.standard_normal((L, B, S, H, D)).astype(np.float32)
    v_raw = rng.standard_normal((L, B, S, H, D)).astype(np.float32)
    n_keep, n_discard = 3, 5

    got = shift_cache(build_cache(rope, k_raw, v_raw), n_keep, n_discard, rope)
    want = expected_after_shift(rope, k_raw, v_raw, n_keep, n_discard)

    live = S - n_discard
    np.testing.assert_allclose(
        np.asarray(got.k[:, :, :, :live], np.float32),
        np.asarray(want.k[:, :, :, :live], np.float32),
        atol=0.04,  # bf16 storage + one extra rotation round-trip
    )
    np.testing.assert_array_equal(
        np.asarray(got.v[:, :, :, :live]), np.asarray(want.v[:, :, :, :live])
    )


def test_shift_matches_reencoding_int8():
    rope = ROPES["norm"]
    rng = np.random.default_rng(1)
    k_raw = rng.standard_normal((L, B, S, H, D)).astype(np.float32)
    v_raw = rng.standard_normal((L, B, S, H, D)).astype(np.float32)
    n_keep, n_discard = 2, 4

    got = shift_cache(
        build_cache(rope, k_raw, v_raw, quantized=True), n_keep, n_discard, rope
    )
    want = expected_after_shift(rope, k_raw, v_raw, n_keep, n_discard,
                                quantized=True)

    live = S - n_discard
    got_k = np.asarray(got.k[:, :, :, :live], np.float32) * np.asarray(
        got.k_scale[:, :, :, :live]
    )[..., None]
    want_k = np.asarray(want.k[:, :, :, :live], np.float32) * np.asarray(
        want.k_scale[:, :, :, :live]
    )[..., None]
    # int8 round-trip twice (append + requantize after rotation)
    np.testing.assert_allclose(got_k, want_k, atol=0.1)
    np.testing.assert_array_equal(
        np.asarray(got.v[:, :, :, :live]), np.asarray(want.v[:, :, :, :live])
    )


def test_rope_delta_is_pure_rotation_under_yarn():
    from kquant.ops.rope import rope_delta_cos_sin

    rope = ROPES["yarn"]
    cos, sin = rope_delta_cos_sin(-7, rope)
    np.testing.assert_allclose(
        np.asarray(cos) ** 2 + np.asarray(sin) ** 2, 1.0, atol=1e-5
    )


# -- engine-level: infinite generation past the KV capacity -------------------


@pytest.fixture(scope="module")
def eng(tmp_path_factory):
    from kquant.models.fixtures import tiny_config, write_fixture_gguf
    from kquant.runtime import InferenceEngine, load_model

    path = tmp_path_factory.mktemp("m") / "shift.gguf"
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128,
                      vocab_size=512)
    write_fixture_gguf(path, cfg, seed=3, scale=0.08)
    cfg, params, _ = load_model(str(path))
    return InferenceEngine(cfg, params, max_batch=1, max_seq=32, impl="xla")


def test_generate_with_context_shift_passes_capacity(eng):
    prompt = [[3, 5, 7, 11] * 3]  # 12 tokens, cap 32
    base = eng.generate(prompt, max_new_tokens=40, context_shift=True, n_keep=4)
    assert len(base[0]) == 40  # NOT clamped to 32 - 12
    clamped = eng.generate(prompt, max_new_tokens=40)
    assert len(clamped[0]) == 32 - 12
    # identical decode path until the first shift triggers
    assert base[0][: len(clamped[0]) - 1] == clamped[0][:-1]


def test_shift_guard_rejects_dropping_live_entries(eng):
    cache = eng.new_cache(1)
    with pytest.raises(ValueError, match="drop live"):
        eng.shift_context(cache, np.array([5]), n_keep=4, n_discard=10)
