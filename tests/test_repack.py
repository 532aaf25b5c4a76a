"""Repacked QTensor layouts must dequantize bit-identically to the numpy
codecs (SURVEY.md section 4 item (b) precondition: one source of truth for
numerics)."""

import numpy as np
import pytest

from kquant.gguf.constants import GGMLType
from kquant.quant import dequantize, quantize
from kquant.quant.jnp_codecs import dequant_kmajor, dequant_logical, dequant_rows
from kquant.quant.repack import repack

RNG = np.random.default_rng(2)

QTYPES = [
    GGMLType.Q2_K,
    GGMLType.Q3_K,
    GGMLType.Q4_0,
    GGMLType.Q4_1,
    GGMLType.Q4_K,
    GGMLType.Q5_0,
    GGMLType.Q5_1,
    GGMLType.Q5_K,
    GGMLType.Q6_K,
    GGMLType.Q8_0,
]


@pytest.mark.parametrize("qtype", QTYPES)
def test_kmajor_matches_numpy(qtype):
    N, K = 8, 512
    x = RNG.standard_normal((N, K)).astype(np.float32)
    raw = quantize(x, qtype)
    ref = dequantize(raw, qtype, (N, K))
    qt = repack(raw, qtype, (N, K), layout="kmajor")
    wt = np.asarray(dequant_kmajor(qt))
    assert wt.shape == (K, N)
    np.testing.assert_allclose(wt.T, ref, rtol=1e-5, atol=1e-5)
    wl = np.asarray(dequant_logical(qt))
    np.testing.assert_allclose(wl, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0])
def test_rowmajor_gather(qtype):
    N, K = 16, 256
    x = RNG.standard_normal((N, K)).astype(np.float32)
    raw = quantize(x, qtype)
    ref = dequantize(raw, qtype, (N, K))
    qt = repack(raw, qtype, (N, K), layout="rowmajor")
    rows = np.array([3, 0, 15, 7])
    out = np.asarray(dequant_rows(qt, rows))
    np.testing.assert_allclose(out, ref[rows], rtol=1e-5, atol=1e-5)
    full = np.asarray(dequant_rows(qt, None))
    np.testing.assert_allclose(full, ref, rtol=1e-5, atol=1e-5)


def test_dense_fallback():
    x = RNG.standard_normal((4, 64)).astype(np.float32)
    raw = quantize(x, GGMLType.F16)
    qt = repack(raw, GGMLType.F16, (4, 64))
    assert qt.kind == "dense"
    np.testing.assert_allclose(np.asarray(dequant_logical(qt)), x, atol=2e-3, rtol=2e-3)


def test_bits_per_element():
    N, K = 8, 512
    x = RNG.standard_normal((N, K)).astype(np.float32)
    qt = repack(quantize(x, GGMLType.Q4_K), GGMLType.Q4_K, (N, K))
    # 4-bit codes + f32 scales/mins per 32: 4 + 2*32/32... = 6 bits at f32 scales
    assert 4.0 < qt.bits_per_element <= 6.1
    qtb = qt.astype_scales(np.dtype("bfloat16"))
    assert qtb.bits_per_element <= 5.1


def test_f16_scale_dtype_load(tmp_path):
    """Plain half-precision scale storage must stay within rounding of the
    f32-scale logits on smooth fixtures."""
    import numpy as np
    import jax.numpy as jnp
    from kquant.models.fixtures import tiny_config, write_fixture_gguf
    from kquant.runtime import InferenceEngine, load_model

    path = tmp_path / "f16s.gguf"
    cfg = tiny_config(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128,
                      vocab_size=256, max_seq_len=64)
    write_fixture_gguf(path, cfg, seed=21, quant="q4_k_m", scale=0.08)

    cfg1, p1, _ = load_model(str(path))
    cfg2, p2, _ = load_model(str(path), scale_dtype="f16")
    assert p2["layers"][0]["wo"].arrays["scales"].dtype == jnp.float16
    assert (p2["layers"][0]["wo"].n_bytes < p1["layers"][0]["wo"].n_bytes)

    e1 = InferenceEngine(cfg1, p1, max_batch=1, max_seq=64, impl="xla")
    e2 = InferenceEngine(cfg2, p2, max_batch=1, max_seq=64, impl="xla")
    l1, _, _ = e1.prefill([[3, 5, 7]], e1.new_cache(1))
    l2, _, _ = e2.prefill([[3, 5, 7]], e2.new_cache(1))
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l2), atol=0.05)


def test_pack_scale_pairs_roundtrip():
    """sm packing stores exact bf16 roundings of scales and mins."""
    import ml_dtypes
    import numpy as np
    from kquant.quant.qtensor import QTensor
    from kquant.quant.repack import pack_scale_pairs, unpack_scale_pairs_np

    rng = np.random.default_rng(3)
    s = (rng.normal(size=(16, 64)).astype(np.float32) * 0.01) ** 2 + 1e-4
    m = rng.normal(size=(16, 64)).astype(np.float32) * 0.05  # mins may be negative
    qt = QTensor("q4", "kmajor", (64, 512),
                 {"qs": np.zeros((256, 64), np.uint8), "scales": s, "mins": m})
    qp = pack_scale_pairs(qt)
    assert set(qp.arrays) == {"qs", "sm"} and qp.arrays["sm"].dtype == np.float32
    s2, m2 = unpack_scale_pairs_np(qp.arrays["sm"])
    np.testing.assert_array_equal(s2, s.astype(ml_dtypes.bfloat16).astype(np.float32))
    np.testing.assert_array_equal(m2, m.astype(ml_dtypes.bfloat16).astype(np.float32))


def test_sm_jnp_dequant_matches_numpy():
    import numpy as np
    import jax.numpy as jnp
    from kquant.gguf.constants import GGMLType
    from kquant.quant.jnp_codecs import dequant_kmajor
    from kquant.quant.repack import (
        pack_scale_pairs, repack, unpack_scale_pairs_np,
    )
    from kquant.quant.qtensor import QTensor

    N, K = 64, 512
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 255, N * K // 256 * 144, dtype=np.uint8)
    qt = repack(raw, GGMLType.Q4_K, (N, K), "kmajor")
    qp = pack_scale_pairs(qt)
    dq = type(qp)(qp.kind, qp.layout, qp.shape,
                  {k: jnp.asarray(v) for k, v in qp.arrays.items()})
    got = np.asarray(dequant_kmajor(dq))
    # independent numpy expectation from the unpacked pairs
    s, m = unpack_scale_pairs_np(qp.arrays["sm"])
    q = np.asarray(dequant_kmajor(
        QTensor(qt.kind, "kmajor", qt.shape,
                {"qs": jnp.asarray(qt.arrays["qs"]),
                 "scales": jnp.asarray(s), "mins": jnp.asarray(m)})))
    np.testing.assert_array_equal(got, q)


def test_sm_model_load_generate(tmp_path):
    """scale_dtype='bf16' (packed pairs) end to end: sm arrays present,
    fewer bytes, generation matches f32 scales on smooth fixtures."""
    import numpy as np
    import jax.numpy as jnp
    from kquant.models.fixtures import tiny_config, write_fixture_gguf
    from kquant.runtime import InferenceEngine, load_model

    path = tmp_path / "sm.gguf"
    # dim 256 so attention projections quantize as real Q4_K (which carries
    # mins -> sm packing applies); wo itself widens to q6w (scales only)
    cfg = tiny_config(n_layers=2, dim=256, n_heads=4, n_kv_heads=2, ffn_dim=128,
                      vocab_size=256, max_seq_len=64)
    write_fixture_gguf(path, cfg, seed=23, quant="q4_k_m", scale=0.08)

    cfg1, p1, _ = load_model(str(path))
    cfg2, p2, _ = load_model(str(path), scale_dtype="bf16")
    assert "sm" in p2["layers"][0]["wqk"].arrays
    assert p2["layers"][0]["wqk"].n_bytes < p1["layers"][0]["wqk"].n_bytes

    e1 = InferenceEngine(cfg1, p1, max_batch=1, max_seq=64, impl="xla")
    e2 = InferenceEngine(cfg2, p2, max_batch=1, max_seq=64, impl="xla")
    l1, _, _ = e1.prefill([[3, 5, 7]], e1.new_cache(1))
    l2, _, _ = e2.prefill([[3, 5, 7]], e2.new_cache(1))
    np.testing.assert_allclose(np.asarray(l1), np.asarray(l2), atol=0.05)
    assert e1.generate([[3, 5, 7]], max_new_tokens=5) == \
           e2.generate([[3, 5, 7]], max_new_tokens=5)


def test_widen_q6_bit_exact():
    """widen_q6: q6 -> int8-code 'q6w' must dequantize BIT-identically
    (s*q - 32s == s*(q-32) exactly in f32) and drop the mins array."""
    from kquant.quant.repack import widen_q6

    N, K = 8, 512
    x = RNG.standard_normal((N, K)).astype(np.float32)
    raw = quantize(x, GGMLType.Q6_K)
    qt = repack(raw, GGMLType.Q6_K, (N, K), layout="kmajor")
    qw = widen_q6(qt)
    assert qw.kind == "q6w"
    assert set(qw.arrays) == {"qs", "scales"}
    assert qw.arrays["qs"].dtype == np.int8
    a = np.asarray(dequant_kmajor(qt))
    b = np.asarray(dequant_kmajor(qw))
    np.testing.assert_array_equal(a, b)
    # non-q6 / non-kmajor inputs pass through untouched
    qt4 = repack(quantize(x, GGMLType.Q4_K), GGMLType.Q4_K, (N, K))
    assert widen_q6(qt4) is qt4


def test_widen_q6_pallas_parity():
    """Fused q6w kernel (interpret mode) vs XLA dequant matmul."""
    from kquant.ops.qmm_triton import qmm_triton as qmm_pallas
    from kquant.quant.repack import widen_q6
    import jax.numpy as jnp

    N, K, B = 384, 512, 3
    x = RNG.standard_normal((B, K)).astype(np.float32) * 0.1
    w = RNG.standard_normal((N, K)).astype(np.float32) * 0.1
    raw = quantize(w, GGMLType.Q6_K)
    qw = widen_q6(repack(raw, GGMLType.Q6_K, (N, K), layout="kmajor"))
    xb = jnp.asarray(x, jnp.bfloat16)
    got = np.asarray(qmm_pallas(xb, qw, out_dtype=jnp.float32, interpret=True))
    want = np.asarray(xb.astype(jnp.float32) @ dequant_kmajor(qw, jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_widen_q6_model_load(tmp_path):
    """load_model(widen_q6=True) must produce identical logits to the packed
    q6 load (bit-exact dequant)."""
    import jax.numpy as jnp
    from kquant.models.fixtures import tiny_config, write_fixture_gguf
    from kquant.runtime import InferenceEngine, load_model

    path = tmp_path / "m.gguf"
    cfg = tiny_config(n_layers=2, dim=512, n_heads=4, n_kv_heads=2,
                      ffn_dim=512, vocab_size=512)
    write_fixture_gguf(path, cfg, seed=9, scale=0.08)
    cfg1, p1, _ = load_model(str(path), widen_q6=False)
    cfg2, p2, _ = load_model(str(path), widen_q6=True)
    assert p1["output"].kind == "q6"
    assert p2["output"].kind == "q6w"
    e1 = InferenceEngine(cfg1, p1, max_batch=1, max_seq=64, impl="xla")
    e2 = InferenceEngine(cfg2, p2, max_batch=1, max_seq=64, impl="xla")
    toks = [3, 100, 7, 9]
    l1, _, _ = e1.prefill([toks], e1.new_cache(1))
    l2, _, _ = e2.prefill([toks], e2.new_cache(1))
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))
