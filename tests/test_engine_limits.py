"""Engine capacity guards: over-length prompts fail loudly; generation never
writes past KV capacity."""

import numpy as np
import pytest

from kquant.models.fixtures import tiny_config, write_fixture_gguf
from kquant.runtime import InferenceEngine, load_model


@pytest.fixture(scope="module")
def eng(tmp_path_factory):
    path = tmp_path_factory.mktemp("m") / "lim.gguf"
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128,
                      vocab_size=512)
    write_fixture_gguf(path, cfg, seed=2, scale=0.08)
    cfg, params, _ = load_model(str(path))
    return InferenceEngine(cfg, params, max_batch=1, max_seq=32, impl="xla")


def test_prompt_too_long_raises(eng):
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.prefill([[1] * 40], eng.new_cache(1))
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.prefill_slot([1] * 40, eng.new_cache(1), 0)


def test_generate_clamped_to_capacity(eng):
    out = eng.generate([[3, 5, 7] * 8], max_new_tokens=100)  # 24-tok prompt
    assert len(out[0]) == 32 - 24  # clamped, no crash, no overflow


def test_prefill_at_exact_capacity(eng):
    logits, cache, lens = eng.prefill([[7] * 32], eng.new_cache(1))
    assert int(lens[0]) == 32
    assert np.isfinite(np.asarray(logits)).all()
