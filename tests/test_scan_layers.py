"""Stacked-layer lax.scan forward must match the per-layer python loop
(same weights, same cache semantics) — prefill logits, decode logits, and
full generation, including quantized KV and MoE."""

import numpy as np
import pytest

import jax.numpy as jnp

from kquant.models.fixtures import tiny_config, write_fixture_gguf
from kquant.runtime import InferenceEngine, load_model


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "scan.gguf"
    cfg = tiny_config(n_layers=3, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128,
                      vocab_size=256, max_seq_len=64)
    write_fixture_gguf(path, cfg, seed=3, quant="q4_k_m", scale=0.08)
    return str(path)


@pytest.fixture(scope="module")
def moe_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "scan_moe.gguf"
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=96,
                      vocab_size=256, max_seq_len=64, n_experts=4,
                      n_experts_used=2)
    write_fixture_gguf(path, cfg, seed=5, quant="q4_k_m", scale=0.08)
    return str(path)


def _engines(path, **kw):
    cfg, params, _ = load_model(path)
    e0 = InferenceEngine(cfg, params, impl="xla", scan_layers=False, **kw)
    e1 = InferenceEngine(cfg, params, impl="xla", scan_layers=True, **kw)
    return e0, e1


def test_prefill_decode_parity(model_path):
    e0, e1 = _engines(model_path, max_batch=2, max_seq=64)
    rows = [[3, 100, 7, 9], [11, 13]]
    l0, c0, lens = e0.prefill(rows, e0.new_cache(2))
    l1, c1, _ = e1.prefill(rows, e1.new_cache(2))
    # scan body is compiled once vs n_layers inlined copies: XLA fuses the
    # bf16 math differently, so parity is to rounding, not bit-exact
    np.testing.assert_allclose(np.asarray(l0), np.asarray(l1), atol=3e-3)
    np.testing.assert_allclose(np.asarray(c0.k, np.float32),
                               np.asarray(c1.k, np.float32), atol=3e-2)

    tok = jnp.argmax(l0, axis=-1).astype(jnp.int32)
    d0, _ = e0.decode_step(tok, jnp.asarray(lens), c0)
    d1, _ = e1.decode_step(tok, jnp.asarray(lens), c1)
    np.testing.assert_allclose(np.asarray(d0), np.asarray(d1), atol=3e-3)


def test_generate_parity_quantized_kv(model_path):
    e0, e1 = _engines(model_path, max_batch=1, max_seq=64, kv_quantized=True)
    out0 = e0.generate([[3, 100, 7]], max_new_tokens=6)
    out1 = e1.generate([[3, 100, 7]], max_new_tokens=6)
    assert out0 == out1


def test_moe_parity(moe_path):
    e0, e1 = _engines(moe_path, max_batch=1, max_seq=64)
    out0 = e0.generate([[3, 5, 7]], max_new_tokens=5)
    out1 = e1.generate([[3, 5, 7]], max_new_tokens=5)
    assert out0 == out1


def test_fused_decode_loop_scan(model_path):
    """The on-device lax.scan decode loop nests over the layer scan."""
    e0, e1 = _engines(model_path, max_batch=1, max_seq=64)
    rows = [[3, 100, 7]]
    l0, c0, lens = e0.prefill(rows, e0.new_cache(1))
    l1, c1, _ = e1.prefill(rows, e1.new_cache(1))
    t0 = jnp.argmax(l0, axis=-1).astype(jnp.int32)
    toks0, _ = e0.decode_greedy_jit(t0, jnp.asarray(lens), c0, 6)
    toks1, _ = e1.decode_greedy_jit(t0, jnp.asarray(lens), c1, 6)
    np.testing.assert_array_equal(np.asarray(toks0), np.asarray(toks1))
