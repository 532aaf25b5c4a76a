"""Gemma-2 architecture family: post-norms, logit softcapping, GeGLU,
sqrt(dim) embedding scaling, tied embeddings, alternating sliding-window
attention (even layers SWA, odd full — HF/llama.cpp swa_pattern=2).

Parity is checked against the independent NumPy reference forward; the
alternating window is additionally exercised under scan_layers, where the
per-layer window becomes a *traced* scalar threaded through lax.scan.
"""

import numpy as np
import pytest

from tests.reference_forward import ref_forward
from kquant.models.fixtures import tiny_config, write_fixture_gguf
from kquant.runtime import InferenceEngine, load_model

TOKENS = [3, 100, 7, 256, 42, 9, 300, 5, 17, 250, 63, 8]


def _corr(a, b):
    denom = np.sqrt((a**2).mean() * (b**2).mean())
    return float((a * b).mean() / denom)


@pytest.fixture(scope="module")
def gemma2_model(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "g2.gguf"
    cfg = tiny_config(arch="gemma2", n_layers=4, dim=64, n_heads=4,
                      n_kv_heads=2, ffn_dim=160, vocab_size=512,
                      max_seq_len=128, sliding_window=6)
    write_fixture_gguf(path, cfg, seed=11, quant="f32", scale=0.08)
    return load_model(str(path))


def test_config_quirks_roundtrip(gemma2_model):
    cfg, params, _ = gemma2_model
    assert cfg.arch == "gemma2"
    assert cfg.act_fn == "gelu"
    assert cfg.post_norms and cfg.tie_embeddings
    assert cfg.embed_scale == pytest.approx(8.0)  # sqrt(64)
    assert cfg.attn_logit_softcap == 50.0
    assert cfg.final_logit_softcap == 30.0
    assert cfg.rope.mode == "neox"
    # alternating SWA: even layers sliding, odd full
    assert [cfg.layer_window(i) for i in range(4)] == [6, 0, 6, 0]
    assert "post_attn_norm" in params["layers"][0]


def test_prefill_logits_match_reference(gemma2_model):
    cfg, params, reader = gemma2_model
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64, impl="xla")
    logits, _, _ = eng.prefill([TOKENS], eng.new_cache(1))
    ref = ref_forward(reader, cfg, np.array(TOKENS))
    got = np.asarray(logits[0], np.float64)
    assert _corr(got, ref[-1]) > 0.99
    assert np.argmax(got) == np.argmax(ref[-1])


def test_sliding_window_actually_masks(gemma2_model):
    """With 12 tokens > window 6, a full-attention forward must disagree with
    the SWA forward — guards against the window silently not applying."""
    import dataclasses

    cfg, params, reader = gemma2_model
    nosw = dataclasses.replace(cfg, sliding_window=0)
    eng = InferenceEngine(nosw, params, max_batch=1, max_seq=64, impl="xla")
    logits, _, _ = eng.prefill([TOKENS], eng.new_cache(1))
    ref = ref_forward(reader, cfg, np.array(TOKENS))  # windowed reference
    got = np.asarray(logits[0], np.float64)
    assert not np.allclose(got, ref[-1], atol=1e-2)


def test_scan_layers_traced_window_parity(gemma2_model):
    """scan_layers threads per-layer windows as traced scalars; logits must
    match the unrolled forward."""
    cfg, params, reader = gemma2_model
    eng_scan = InferenceEngine(cfg, params, max_batch=1, max_seq=64,
                               impl="xla", scan_layers=True)
    eng_flat = InferenceEngine(cfg, params, max_batch=1, max_seq=64, impl="xla")
    ls, _, _ = eng_scan.prefill([TOKENS], eng_scan.new_cache(1))
    lf, _, _ = eng_flat.prefill([TOKENS], eng_flat.new_cache(1))
    np.testing.assert_allclose(np.asarray(ls), np.asarray(lf), atol=1e-3)
    ref = ref_forward(reader, cfg, np.array(TOKENS))
    assert _corr(np.asarray(ls[0], np.float64), ref[-1]) > 0.99


def test_decode_matches_prefill(gemma2_model):
    cfg, params, _ = gemma2_model
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64, impl="xla")
    full, _, _ = eng.prefill([TOKENS], eng.new_cache(1))

    cache = eng.new_cache(1)
    import jax.numpy as jnp

    l2, cache, _ = eng.prefill([TOKENS[:-3]], cache)
    pos = len(TOKENS) - 3
    for tok in TOKENS[-3:]:
        l2, cache = eng.decode_step(jnp.asarray([tok]), jnp.asarray([pos]), cache)
        pos += 1
    np.testing.assert_allclose(np.asarray(full), np.asarray(l2), atol=2e-2)


def test_generate_smoke(gemma2_model):
    cfg, params, _ = gemma2_model
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64)
    out = eng.generate([[3, 5, 7]], max_new_tokens=8)
    assert len(out[0]) == 8
    # softcap bounds every logit to (-30, 30)
    logits, _, _ = eng.prefill([[3, 5, 7]], eng.new_cache(1))
    assert float(np.abs(np.asarray(logits)).max()) < 30.0
