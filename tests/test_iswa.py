"""iSWA KV layout: ring-buffer caches for sliding-window layers.

The llama.cpp equivalent is llama_kv_cache_unified_iswa (SURVEY.md 2.1
"Memory-context abstraction"): full-attention layers keep max_seq slots,
sliding-window layers a ring of window + chunk slots. Logits must match the
unified layout exactly (same attended K/V set, only slot order differs).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from kquant.models.fixtures import tiny_config, write_fixture_gguf
from kquant.runtime import InferenceEngine, load_model


@pytest.fixture(scope="module")
def swa_model(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "swa.gguf"
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128,
                      vocab_size=512, max_seq_len=256, sliding_window=16)
    write_fixture_gguf(path, cfg, seed=11, scale=0.08)
    return load_model(str(path))


def _engines(swa_model, **kw):
    cfg, params, _ = swa_model
    uni = InferenceEngine(cfg, params, max_batch=2, max_seq=128, impl="xla", **kw)
    isw = InferenceEngine(cfg, params, max_batch=2, max_seq=128, impl="xla",
                          kv_layout="iswa", iswa_chunk=16, **kw)
    return uni, isw


def test_ring_smaller_than_max_seq(swa_model):
    _, isw = _engines(swa_model)
    cache = isw.new_cache(1)
    assert cache.ring == 32  # window 16 + chunk 16
    assert cache.full is None  # every layer is sliding (swa_pattern=1)
    assert cache.swa.k.shape[3] == 32 < 128


def test_iswa_prefill_matches_unified(swa_model):
    uni, isw = _engines(swa_model)
    # 40-token prompt: 3 ring-sized prefill chunks, ring wraps once
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 500, 40).tolist(),
               rng.integers(3, 500, 23).tolist()]  # ragged batch
    lu, cu, lens_u = uni.prefill(prompts, uni.new_cache(2))
    li, ci, lens_i = isw.prefill(prompts, isw.new_cache(2))
    np.testing.assert_array_equal(lens_u, lens_i)
    np.testing.assert_allclose(np.asarray(lu), np.asarray(li), rtol=2e-2,
                               atol=2e-2)
    assert (np.argmax(np.asarray(lu), -1) == np.argmax(np.asarray(li), -1)).all()

    # decode a few steps from both; logits must stay in lockstep
    tu = jnp.argmax(lu, axis=-1).astype(jnp.int32)
    ti = jnp.argmax(li, axis=-1).astype(jnp.int32)
    pu, pi = jnp.asarray(lens_u), jnp.asarray(lens_i)
    for _ in range(5):
        lu2, cu = uni.decode_step(tu, pu, cu)
        li2, ci = isw.decode_step(ti, pi, ci)
        assert (np.argmax(np.asarray(lu2), -1)
                == np.argmax(np.asarray(li2), -1)).all()
        tu = jnp.argmax(lu2, axis=-1).astype(jnp.int32)
        ti = jnp.argmax(li2, axis=-1).astype(jnp.int32)
        pu, pi = pu + 1, pi + 1


def test_iswa_generate_matches_unified(swa_model):
    uni, isw = _engines(swa_model)
    prompt = [3, 100, 7, 256, 42, 9, 300, 5]
    # long enough that decode wraps the 32-slot ring several times
    gu = uni.generate([prompt], max_new_tokens=48)
    gi = isw.generate([prompt], max_new_tokens=48)
    assert gu == gi


def test_iswa_generate_int8(swa_model):
    uni, isw = _engines(swa_model, kv_quantized=True)
    prompt = [3, 100, 7, 256, 42]
    gu = uni.generate([prompt], max_new_tokens=24)
    gi = isw.generate([prompt], max_new_tokens=24)
    assert gu == gi


def test_iswa_fused_decode_loop(swa_model):
    """The on-device lax.scan decode loop must work over the ISWACache pytree."""
    uni, isw = _engines(swa_model)
    prompt = [3, 100, 7, 256]
    lu, cu, lens = uni.prefill([prompt, prompt], uni.new_cache(2))
    li, ci, _ = isw.prefill([prompt, prompt], isw.new_cache(2))
    tu = jnp.argmax(lu, axis=-1).astype(jnp.int32)
    ti = jnp.argmax(li, axis=-1).astype(jnp.int32)
    pos = jnp.asarray(lens)
    toks_u, _ = uni.decode_greedy_jit(tu, pos, cu, 40)
    toks_i, _ = isw.decode_greedy_jit(ti, pos, ci, 40)
    np.testing.assert_array_equal(np.asarray(toks_u), np.asarray(toks_i))


def test_iswa_guards(swa_model):
    cfg, params, _ = swa_model
    _, isw = _engines(swa_model)
    cache = isw.new_cache(1)
    with pytest.raises(NotImplementedError):
        isw.save_session("/tmp/x.npz", cache, [1])
    with pytest.raises(NotImplementedError):
        isw.shift_context(cache, np.array([60]), 4, 8)
    with pytest.raises(ValueError):  # needs a sliding-window arch
        cfg2 = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2,
                           ffn_dim=128, vocab_size=512)
        InferenceEngine(cfg2, params, kv_layout="iswa")


def test_iswa_alternating_layers(tmp_path):
    """gemma2-style alternating SWA: full layers get max_seq, swa layers the
    ring; parity with unified."""
    path = tmp_path / "g2.gguf"
    cfg = tiny_config(arch="gemma2", n_layers=2, dim=64, n_heads=4,
                      n_kv_heads=2, ffn_dim=128, vocab_size=512,
                      sliding_window=16)
    write_fixture_gguf(path, cfg, seed=13, scale=0.08)
    cfg2, params, _ = load_model(str(path))
    uni = InferenceEngine(cfg2, params, max_batch=1, max_seq=128, impl="xla")
    isw = InferenceEngine(cfg2, params, max_batch=1, max_seq=128, impl="xla",
                          kv_layout="iswa", iswa_chunk=16)
    cache = isw.new_cache(1)
    assert cache.full is not None and cache.swa is not None
    assert cache.full.k.shape[0] == 1 and cache.swa.k.shape[0] == 1
    assert cache.swa.k.shape[3] == 32 and cache.full.k.shape[3] == 128
    prompt = [3, 100, 7, 256, 42, 9]
    assert uni.generate([prompt], max_new_tokens=24) == \
           isw.generate([prompt], max_new_tokens=24)
