"""Requantization tool + ppl-delta harness tests."""

import numpy as np
import pytest

from kquant.gguf import GGMLType, GGUFReader
from kquant.models.fixtures import tiny_config, write_fixture_gguf
from kquant.runtime import InferenceEngine, load_model
from kquant.tools.quantize import requantize


@pytest.fixture(scope="module")
def f16_model(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "f16.gguf"
    # dims multiples of 256 so K-quant superblocks apply (no Q8_0 fallback)
    cfg = tiny_config(n_layers=2, dim=256, n_heads=4, n_kv_heads=2, ffn_dim=512,
                      vocab_size=512)
    write_fixture_gguf(path, cfg, seed=17, quant="f16", scale=0.08)
    return str(path)


def test_requantize_recipe(f16_model, tmp_path):
    out = str(tmp_path / "q4.gguf")
    stats = requantize(f16_model, out, "q4_k_m", verbose=False)
    assert stats["bytes_out"] < stats["bytes_in"] * 0.45  # ~4.6 vs 16 bits
    with GGUFReader(out) as r:
        assert r.tensors["blk.0.attn_q.weight"].ggml_type == GGMLType.Q4_K
        assert r.tensors["blk.0.attn_v.weight"].ggml_type == GGMLType.Q6_K
        assert r.tensors["blk.0.ffn_down.weight"].ggml_type == GGMLType.Q6_K
        assert r.tensors["output.weight"].ggml_type == GGMLType.Q6_K
        assert r.tensors["blk.0.attn_norm.weight"].ggml_type == GGMLType.F32
        assert r.metadata["general.architecture"] == "llama"


def test_requantized_model_runs_close(f16_model, tmp_path):
    out = str(tmp_path / "q8.gguf")
    requantize(f16_model, out, "q8_0", verbose=False)
    cfg, p16, _ = load_model(f16_model)
    cfg8, p8, _ = load_model(out)
    e16 = InferenceEngine(cfg, p16, max_batch=1, max_seq=64, impl="xla")
    e8 = InferenceEngine(cfg8, p8, max_batch=1, max_seq=64, impl="xla")
    l16, _, _ = e16.prefill([[3, 100, 7, 42]], e16.new_cache(1))
    l8, _, _ = e8.prefill([[3, 100, 7, 42]], e8.new_cache(1))
    a, b = np.asarray(l16[0]), np.asarray(l8[0])
    assert np.argmax(a) == np.argmax(b)
    corr = float((a * b).mean() / np.sqrt((a**2).mean() * (b**2).mean()))
    assert corr > 0.999


def test_ppl_delta_small(f16_model, tmp_path):
    """Q8_0 ppl should sit very close to f16 ppl (the machinery behind the
    north-star ppl-delta gate)."""
    import sys

    from kquant.tools.ppl_delta import main

    text = tmp_path / "t.txt"
    text.write_text("hello world " * 60)
    delta = main(["--model", f16_model, "--text", str(text), "--type", "q8_0",
                  "--ctx", "64", "--max-windows", "2", "--impl", "xla"])
    assert abs(delta) < 1.0  # q8_0 is near-lossless even on a random model
