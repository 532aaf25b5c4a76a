"""Block-local bit fold for row(K)-parallel TP shards (quant.repack.refold_kmajor).

The default packed fold is global — byte k pairs codes k and k + K/2 — so a
row-parallel shard's partner nibbles live on another shard and XLA's SPMD
partitioner implements the unpack as a per-layer all_to_all of the packed
code arrays (found by tools_scale_ready's 70B AOT lowering: 6 weight
all_to_alls, 75 MB, per layer). Refolding with fold = n_shards makes each
shard's unpack fully local; these tests pin (a) bit-exact numerics of the
refold, (b) sharded-matmul parity, (c) the HLO staying free of weight
redistribution collectives.
"""

import numpy as np
import pytest

from kquant.gguf.constants import GGMLType
from kquant.quant.jnp_codecs import dequant_kmajor
from kquant.quant.numpy_codecs import quantize
from kquant.quant.repack import refold_kmajor, repack


@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q5_K,
                               GGMLType.Q3_K, GGMLType.Q2_K])
def test_refold_dequant_bit_exact(t):
    rng = np.random.default_rng(3)
    W = (rng.standard_normal((64, 2048)) * 0.1).astype(np.float32)
    qt = repack(quantize(W, t), t, W.shape)
    base = np.asarray(dequant_kmajor(qt))
    qt8 = refold_kmajor(qt, 8)
    assert qt8.fold == 8
    assert np.array_equal(base, np.asarray(dequant_kmajor(qt8)))


def test_refold_misaligned_is_identity():
    rng = np.random.default_rng(4)
    W = (rng.standard_normal((64, 512)) * 0.1).astype(np.float32)
    qt = repack(quantize(W, GGMLType.Q4_K), GGMLType.Q4_K, W.shape)
    # 512 / 8 = 64 < 256: a block would split a superblock -> unchanged
    assert refold_kmajor(qt, 8).fold == 1


def test_row_parallel_matmul_parity_and_no_weight_collectives():
    import jax
    import jax.numpy as jnp

    from kquant.ops.qmatmul import qmatmul
    from kquant.parallel import make_mesh, shard_qtensor

    rng = np.random.default_rng(5)
    N, K = 256, 4096
    W = (rng.standard_normal((N, K)) * 0.05).astype(np.float32)
    qt = repack(quantize(W, GGMLType.Q4_K), GGMLType.Q4_K, W.shape)
    x = (rng.standard_normal((1, 1, K)) * 0.5).astype(np.float32)

    want = np.asarray(qmatmul(jnp.asarray(x), qt, "xla"))

    mesh = make_mesh(model=8)
    sq = shard_qtensor(qt, mesh, "row")
    assert sq.fold == 8 and sq.tp == "row"
    fn = jax.jit(lambda q, a: qmatmul(a, q, "xla"))
    got = np.asarray(fn(sq, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    txt = fn.lower(sq, jnp.asarray(x)).compile().as_text()
    for op in ("all-to-all", "all-gather", "collective-permute"):
        assert f" {op}(" not in txt and f" {op}-start(" not in txt, op
    assert " all-reduce(" in txt or " all-reduce-start(" in txt
