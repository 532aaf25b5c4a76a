"""Sampler-chain pieces beyond greedy/top-k/top-p: min-p and the llama.cpp
penalties sampler (repeat / presence / frequency over a sliding window)."""

import jax
import jax.numpy as jnp
import numpy as np

from kquant.ops.sampling import apply_penalties, sample


def test_min_p_masks_below_relative_threshold():
    # probs ~ softmax([4, 3, 0, 0]): p_max ~ .70, second ~ .26, tail ~ .013
    logits = jnp.asarray([[4.0, 3.0, 0.0, 0.0]])
    key = jax.random.PRNGKey(0)
    toks = [int(sample(logits, jax.random.fold_in(key, i), 1.0, 0, 1.0, 0.10)[0])
            for i in range(200)]
    assert set(toks) <= {0, 1}  # tail tokens (p < 0.1 * p_max) never sampled
    toks = [int(sample(logits, jax.random.fold_in(key, i), 1.0, 0, 1.0, 0.9)[0])
            for i in range(50)]
    assert set(toks) == {0}  # only the argmax survives min_p=0.9


def test_repeat_penalty_sign_behavior():
    logits = jnp.asarray([[2.0, -2.0, 1.0]])
    counts = jnp.asarray([[1, 1, 0]])
    out = np.asarray(apply_penalties(logits, counts, repeat_penalty=2.0))
    assert out[0, 0] == 1.0  # positive logit divided
    assert out[0, 1] == -4.0  # negative logit multiplied (pushed further down)
    assert out[0, 2] == 1.0  # unseen token untouched


def test_presence_and_frequency_penalties():
    logits = jnp.asarray([[1.0, 1.0, 1.0]])
    counts = jnp.asarray([[3, 1, 0]])
    out = np.asarray(apply_penalties(logits, counts, presence_penalty=0.5,
                                     frequency_penalty=0.1))
    np.testing.assert_allclose(out[0], [1.0 - 0.5 - 0.3, 1.0 - 0.5 - 0.1, 1.0])


def test_fused_sampled_loop_matches_host_stepped(tmp_path):
    """The on-device fused sampled decode loop (engine.decode_sampled_jit,
    used by generate) must produce EXACTLY the token stream of a host-stepped
    loop driving sample_step + decode_step with the same key sequence —
    sampler chain + penalties included."""
    from kquant.models.fixtures import tiny_config, write_fixture_gguf
    from kquant.ops.sampling import (
        SamplerConfig, init_penalty_state, sample_step)
    from kquant.runtime import InferenceEngine, load_model

    path = tmp_path / "f.gguf"
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128,
                      vocab_size=512)
    write_fixture_gguf(path, cfg, seed=3, scale=0.08)
    cfg, params, _ = load_model(str(path))
    eng = InferenceEngine(cfg, params, max_batch=2, max_seq=64, impl="xla")
    prompts = [[3, 5, 7], [11, 13]]
    sc = SamplerConfig(temperature=0.9, top_k=40, top_p=0.95, min_p=0.02,
                       repeat_penalty=1.2, penalty_last_n=32)
    N = 12

    # host-stepped oracle
    cache = eng.new_cache(2)
    logits, cache, lens = eng.prefill(prompts, cache)
    key = jax.random.PRNGKey(7)
    pstate = init_penalty_state(prompts, cfg.vocab_size, sc.penalty_last_n)
    pos = jnp.asarray(lens)
    stepped = []
    for _ in range(N):
        tok, key, pstate = sample_step(jnp.asarray(logits), key, sc, pstate)
        stepped.append(np.asarray(tok))
        logits, cache = eng.decode_step(tok, pos, cache)
        pos = pos + 1
    stepped = np.stack(stepped, axis=1)  # [B, N]

    # fused path (same seed): generate() routes through decode_sampled_jit
    fused = eng.generate(prompts, max_new_tokens=N, temperature=0.9, top_k=40,
                         top_p=0.95, min_p=0.02, repeat_penalty=1.2,
                         penalty_last_n=32, seed=7)
    assert [list(r) for r in stepped] == fused


def test_generate_repeat_penalty_breaks_loops(tmp_path):
    """A random tiny model greedy-decodes into a short cycle; a strong repeat
    penalty must break the cycle."""
    from kquant.models.fixtures import tiny_config, write_fixture_gguf
    from kquant.runtime import InferenceEngine, load_model

    path = tmp_path / "p.gguf"
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128,
                      vocab_size=512)
    write_fixture_gguf(path, cfg, seed=2, scale=0.08)
    cfg, params, _ = load_model(str(path))
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64, impl="xla")

    plain = eng.generate([[3, 5, 7]], max_new_tokens=24)[0]
    assert len(set(plain)) < len(plain)  # sanity: random models repeat tokens

    pen = eng.generate([[3, 5, 7]], max_new_tokens=24, repeat_penalty=1e9,
                       penalty_last_n=64)[0]
    # with an effectively-infinite penalty every emitted token is new
    assert len(set(pen)) == len(pen)
