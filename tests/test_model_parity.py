"""End-to-end logit parity: engine vs independent NumPy forward
(SURVEY.md section 4 implication (c))."""

import numpy as np
import pytest

from tests.reference_forward import ref_forward
from kquant.models.fixtures import tiny_config, write_fixture_gguf
from kquant.runtime import InferenceEngine, load_model


@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "tiny.gguf"
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=160,
                      vocab_size=512, max_seq_len=128)
    write_fixture_gguf(path, cfg, seed=7, quant="q4_k_m", scale=0.08)
    cfg2, params, reader = load_model(str(path))
    return cfg2, params, reader


def test_config_roundtrip(tiny_model):
    cfg, _, _ = tiny_model
    assert cfg.arch == "llama"
    assert cfg.n_layers == 2
    assert cfg.dim == 64
    assert cfg.n_kv_heads == 2
    assert cfg.head_dim == 16
    assert cfg.vocab_size == 512


def test_prefill_logits_match_reference(tiny_model):
    cfg, params, reader = tiny_model
    tokens = [3, 100, 7, 256, 42, 9, 300, 5]
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64, impl="xla")
    cache = eng.new_cache(1)
    logits, cache, lens = eng.prefill([tokens], cache)
    ref = ref_forward(reader, cfg, np.array(tokens))
    got = np.asarray(logits[0], np.float64)
    want = ref[-1]
    # engine computes in bf16 activations; correlation + argmax agreement
    denom = np.sqrt((got**2).mean() * (want**2).mean())
    corr = float((got * want).mean() / denom)
    assert corr > 0.99, corr
    assert np.argmax(got) == np.argmax(want)


def test_decode_matches_prefill(tiny_model):
    """Decoding token-by-token must produce the same logits as prefilling the
    whole sequence (KV cache consistency)."""
    cfg, params, reader = tiny_model
    tokens = [3, 100, 7, 256, 42, 9]
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64, impl="xla")

    cache = eng.new_cache(1)
    full_logits, _, _ = eng.prefill([tokens], cache)

    cache2 = eng.new_cache(1)
    l2, cache2, lens = eng.prefill([tokens[:3]], cache2)
    import jax.numpy as jnp

    pos = jnp.asarray(lens)
    for t in tokens[3:]:
        l2, cache2 = eng.decode_step(jnp.asarray([t], jnp.int32), pos, cache2)
        pos = pos + 1

    a, b = np.asarray(full_logits[0]), np.asarray(l2[0])
    np.testing.assert_allclose(a, b, rtol=0.05, atol=0.05 * np.abs(a).max())
    assert np.argmax(a) == np.argmax(b)


def test_batched_prefill_ragged(tiny_model):
    """Ragged right-padded batch rows match single-row prefill."""
    cfg, params, reader = tiny_model
    eng = InferenceEngine(cfg, params, max_batch=2, max_seq=64, impl="xla")
    rows = [[3, 100, 7, 256, 42], [9, 300]]
    cache = eng.new_cache(2)
    logits, _, lens = eng.prefill(rows, cache)
    for i, row in enumerate(rows):
        c1 = eng.new_cache(1)
        l1, _, _ = eng.prefill([row], c1)
        np.testing.assert_allclose(
            np.asarray(logits[i]), np.asarray(l1[0]), rtol=1e-3, atol=1e-3
        )


def test_generate_deterministic(tiny_model):
    cfg, params, _ = tiny_model
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64, impl="xla")
    out1 = eng.generate([[3, 100, 7]], max_new_tokens=8)
    out2 = eng.generate([[3, 100, 7]], max_new_tokens=8)
    assert out1 == out2
    assert len(out1[0]) == 8
    assert all(0 <= t < cfg.vocab_size for t in out1[0])


def test_kv_cache_int8(tiny_model):
    """INT8 KV cache tracks the bf16 cache closely (north-star numerics)."""
    cfg, params, _ = tiny_model
    eng16 = InferenceEngine(cfg, params, max_batch=1, max_seq=64, impl="xla")
    eng8 = InferenceEngine(
        cfg, params, max_batch=1, max_seq=64, impl="xla", kv_quantized=True
    )
    toks = [[3, 100, 7, 256, 42, 9, 300, 5]]
    out16 = eng16.generate(toks, max_new_tokens=6)
    out8 = eng8.generate(toks, max_new_tokens=6)
    # greedy paths may diverge after a while; require the first tokens agree
    assert out16[0][:2] == out8[0][:2]


def test_fused_decode_loop_matches_generate(tiny_model):
    """decode_greedy_jit (on-device lax.scan loop, the bench path) must
    produce exactly the tokens of the step-by-step greedy generate loop."""
    import jax.numpy as jnp

    cfg, params, _ = tiny_model
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64, impl="xla")
    prompt = [3, 100, 7, 256]
    want = eng.generate([prompt], max_new_tokens=6)[0]

    cache = eng.new_cache(1)
    logits, cache, lens = eng.prefill([prompt], cache)
    first = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks, _ = eng.decode_greedy_jit(first, jnp.asarray(lens), cache, 5)
    got = [int(first[0])] + np.asarray(toks[0]).tolist()
    assert got == want
