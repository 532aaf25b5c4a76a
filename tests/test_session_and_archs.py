"""KV session save/restore + qwen2 (attention-bias) architecture support."""

import numpy as np
import pytest

import jax.numpy as jnp

from kquant.models.fixtures import tiny_config, write_fixture_gguf
from kquant.runtime import InferenceEngine, load_model


def test_session_save_restore(tmp_path):
    path = tmp_path / "m.gguf"
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128,
                      vocab_size=512)
    write_fixture_gguf(path, cfg, seed=3, scale=0.08)
    cfg, params, _ = load_model(str(path))
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64, impl="xla")

    prompt = [3, 100, 7, 256]
    cache = eng.new_cache(1)
    logits, cache, lens = eng.prefill([prompt], cache)
    eng.save_session(str(tmp_path / "sess.npz"), cache, lens)

    # continue from the restored session; must match continuing directly
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    direct, _ = eng.decode_step(tok, jnp.asarray(lens), cache)

    cache2, lens2 = eng.load_session(str(tmp_path / "sess.npz"))
    resumed, _ = eng.decode_step(tok, jnp.asarray(lens2), cache2)
    np.testing.assert_allclose(np.asarray(direct), np.asarray(resumed),
                               rtol=1e-5, atol=1e-5)


def test_session_int8(tmp_path):
    path = tmp_path / "m.gguf"
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128,
                      vocab_size=512)
    write_fixture_gguf(path, cfg, seed=3, scale=0.08)
    cfg, params, _ = load_model(str(path))
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64, impl="xla",
                          kv_quantized=True)
    cache = eng.new_cache(1)
    logits, cache, lens = eng.prefill([[3, 100, 7]], cache)
    eng.save_session(str(tmp_path / "s8.npz"), cache, lens)
    cache2, lens2 = eng.load_session(str(tmp_path / "s8.npz"))
    assert cache2.quantized


def test_qwen2_attention_bias(tmp_path):
    path = tmp_path / "q.gguf"
    cfg = tiny_config(arch="qwen2", n_layers=2, dim=64, n_heads=4, n_kv_heads=2,
                      ffn_dim=128, vocab_size=512)
    write_fixture_gguf(path, cfg, seed=4, scale=0.08)
    cfg2, params, _ = load_model(str(path))
    assert cfg2.arch == "qwen2"
    assert cfg2.attn_bias  # detected from tensor presence
    assert "bq" in params["layers"][0]
    eng = InferenceEngine(cfg2, params, max_batch=1, max_seq=64, impl="xla")
    out = eng.generate([[3, 100, 7]], max_new_tokens=5)
    assert len(out[0]) == 5

    # bias must actually change the logits
    import dataclasses

    params_nb = dict(params)
    params_nb["layers"] = [
        {k: v for k, v in layer.items() if k not in ("bq", "bk", "bv")}
        for layer in params["layers"]
    ]
    cfg_nb = dataclasses.replace(cfg2, attn_bias=False)
    eng_nb = InferenceEngine(cfg_nb, params_nb, max_batch=1, max_seq=64, impl="xla")
    l1, _, _ = eng.prefill([[3, 100, 7]], eng.new_cache(1))
    l2, _, _ = eng_nb.prefill([[3, 100, 7]], eng_nb.new_cache(1))
    assert not np.allclose(np.asarray(l1), np.asarray(l2), atol=1e-4)


def test_phi3_fused_qkv_parity(tmp_path):
    """phi3: pre-fused QKV + gate_up tensors, neox rope; logits must match the
    independent NumPy reference forward."""
    from tests.reference_forward import ref_forward

    path = tmp_path / "p.gguf"
    cfg = tiny_config(arch="phi3", n_layers=2, dim=64, n_heads=4, n_kv_heads=2,
                      ffn_dim=128, vocab_size=512)
    write_fixture_gguf(path, cfg, seed=5, scale=0.08)
    cfg2, params, reader = load_model(str(path))
    assert cfg2.arch == "phi3"
    assert cfg2.rope.mode == "neox"
    assert "wqkv" in params["layers"][0]
    assert "w_gateup" in params["layers"][0]

    tokens = [3, 100, 7, 256, 42]
    eng = InferenceEngine(cfg2, params, max_batch=1, max_seq=64, impl="xla")
    logits, _, _ = eng.prefill([tokens], eng.new_cache(1))
    ref = ref_forward(reader, cfg2, np.array(tokens))
    got, want = np.asarray(logits[0], np.float64), ref[-1]
    corr = float((got * want).mean()
                 / np.sqrt((got**2).mean() * (want**2).mean()))
    assert corr > 0.99, corr
    assert np.argmax(got) == np.argmax(want)


def test_phi3_split_load_matches_fused(tmp_path):
    """fuse=False (the TP load path) splits attn_qkv / ffn_up by rows; logits
    must match the fused load bit-for-bit (same packed blocks, same math
    modulo fused-vs-split matmul associativity)."""
    path = tmp_path / "p.gguf"
    cfg = tiny_config(arch="phi3", n_layers=2, dim=64, n_heads=4, n_kv_heads=2,
                      ffn_dim=128, vocab_size=512)
    write_fixture_gguf(path, cfg, seed=6, scale=0.08)
    cfg_f, params_f, _ = load_model(str(path), fuse=True)
    cfg_s, params_s, _ = load_model(str(path), fuse=False)
    assert "wq" in params_s["layers"][0] and "w_gate" in params_s["layers"][0]

    tokens = [3, 100, 7, 9]
    ef = InferenceEngine(cfg_f, params_f, max_batch=1, max_seq=64, impl="xla")
    es = InferenceEngine(cfg_s, params_s, max_batch=1, max_seq=64, impl="xla")
    lf, _, _ = ef.prefill([tokens], ef.new_cache(1))
    ls, _, _ = es.prefill([tokens], es.new_cache(1))
    np.testing.assert_allclose(np.asarray(lf), np.asarray(ls), rtol=2e-2,
                               atol=2e-2)
    assert np.argmax(np.asarray(lf[0])) == np.argmax(np.asarray(ls[0]))


def test_sliding_window_attention(tmp_path):
    """SWA must mask tokens beyond the window (Mistral/Gemma2-style)."""
    import jax.numpy as jnp
    import numpy as np

    from kquant.ops.attention import attention_decode

    rng = np.random.default_rng(0)
    B, S, H, Hkv, D = 1, 64, 4, 2, 16
    q = jnp.asarray(rng.standard_normal((B, 1, H, D)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((B, Hkv, S, D)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((B, Hkv, S, D)), jnp.float32)
    pos = jnp.asarray([[40]], jnp.int32)

    full = attention_decode(q, k, v, pos, impl="xla")
    win = attention_decode(q, k, v, pos, sliding_window=8, impl="xla")
    assert not np.allclose(np.asarray(full), np.asarray(win), atol=1e-4)

    # corrupting K/V outside the window must not change windowed output
    k2 = k.at[:, :, :30].set(99.0)
    v2 = v.at[:, :, :30].set(99.0)
    win2 = attention_decode(q, k2, v2, pos, sliding_window=8, impl="xla")
    np.testing.assert_allclose(np.asarray(win), np.asarray(win2), atol=1e-6)


def test_sliding_window_from_metadata(tmp_path):
    from kquant.models.fixtures import tiny_config, write_fixture_gguf
    from kquant.runtime import load_model

    path = tmp_path / "swa.gguf"
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128,
                      vocab_size=512, sliding_window=16)
    write_fixture_gguf(path, cfg, seed=8, scale=0.08)
    cfg2, params, _ = load_model(str(path))
    assert cfg2.sliding_window == 16
    from kquant.runtime import InferenceEngine

    eng = InferenceEngine(cfg2, params, max_batch=1, max_seq=64, impl="xla")
    out = eng.generate([[3, 100, 7]], max_new_tokens=4)
    assert len(out[0]) == 4
