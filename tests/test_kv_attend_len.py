"""kv_attend_len: prefill attention that reads only the cache slots below T
must give the same logits and the same cache as attention over the whole
cache, for the bf16 and the int8 cache, on the unrolled and the scanned
forward."""

import jax.numpy as jnp
import numpy as np
import pytest

from kquant.models.fixtures import random_qparams, tiny_config
from kquant.models.llama import llama_forward, stack_layer_params
from kquant.runtime.kv_cache import KVCache

CFG = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128,
                  vocab_size=256, max_seq_len=64)
PARAMS = random_qparams(CFG, seed=3, scale_mag=0.02)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("T", [5, 16])
@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scan"])
def test_attend_len_matches_full_cache(int8, T, scan):
    params = stack_layer_params(PARAMS) if scan else PARAMS
    rng = np.random.default_rng(T)
    B, S = 2, 48
    tokens = jnp.asarray(rng.integers(0, CFG.vocab_size, (B, T)), jnp.int32)
    positions = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))

    def run(attend_len):
        cache = KVCache.create(CFG.n_layers, B, S, CFG.n_kv_heads,
                               CFG.head_dim, quantized=int8)
        return llama_forward(params, CFG, tokens, positions, cache,
                             impl="xla", act_dtype=jnp.float32,
                             kv_attend_len=attend_len)

    full_logits, full_cache = run(None)
    cut_logits, cut_cache = run(T)
    np.testing.assert_allclose(np.asarray(cut_logits),
                               np.asarray(full_logits), rtol=1e-5, atol=1e-5)
    for a, b in zip(full_cache.tree_flatten()[0], cut_cache.tree_flatten()[0]):
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
