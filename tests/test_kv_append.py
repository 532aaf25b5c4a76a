"""Deferred KV append: the decode step's batched end-of-step cache writes
against the eager per-layer appends."""


def test_deferred_append_matches_eager(monkeypatch):
    """TKQ_DEFER_APPEND decode path (batched end-of-step cache writes +
    in-attention current-token patches) must produce the same tokens and
    the same cache contents as the eager per-layer append path."""
    import jax.numpy as jnp

    from kquant.models.fixtures import tiny_config, write_fixture_gguf
    from kquant.runtime import InferenceEngine, load_model
    import tempfile, os

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "m.gguf")
        cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2,
                          ffn_dim=128, vocab_size=512, max_seq_len=128)
        write_fixture_gguf(path, cfg, seed=7, quant="q4_k_m", scale=0.08)
        cfg, params, _ = load_model(path)

        def run(defer, kv_int8=False):
            monkeypatch.setenv("TKQ_DEFER_APPEND", "1" if defer else "0")
            eng = InferenceEngine(cfg, params, max_batch=2, max_seq=64,
                                  impl="xla", kv_quantized=kv_int8)
            toks = eng.generate([[3, 100, 7], [9, 300, 2, 41]],
                                max_new_tokens=8)
            return toks

        assert run(True) == run(False)
        # int8 KV: the deferred path quantizes the stacked rows with the
        # same per-(token, head) amax scales; the one numeric difference
        # (the current token attends its own k/v unquantized for one step)
        # must not flip greedy tokens on this fixture
        assert run(True, kv_int8=True) == run(False, kv_int8=True)
