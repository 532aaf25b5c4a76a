"""Fused dequant+matmul kernel (ops.qmm_triton) vs the XLA
dequant-then-matmul reference (SURVEY.md section 4 implication (b)). Runs in
the Pallas interpreter on the CPU; the same kernel compiles for the GPU
through Triton."""

import numpy as np
import pytest

import jax.numpy as jnp

from kquant.gguf.constants import GGMLType
from kquant.ops.qmm_triton import qmm_triton as qmm_pallas
from kquant.ops.qmatmul import qmatmul
from kquant.quant import quantize
from kquant.quant.repack import repack

RNG = np.random.default_rng(3)

CASES = [
    (GGMLType.Q4_K, "q4"),
    (GGMLType.Q5_K, "q5"),
    (GGMLType.Q6_K, "q6"),
    (GGMLType.Q2_K, "q2"),
    (GGMLType.Q3_K, "q3"),
    (GGMLType.Q8_0, "q8"),
    (GGMLType.Q4_0, "q4"),
]


def _mk(qtype, N, K):
    w = RNG.standard_normal((N, K)).astype(np.float32) * 0.1
    return repack(quantize(w, qtype), qtype, (N, K), layout="kmajor")


@pytest.mark.parametrize("qtype,kind", CASES)
def test_pallas_matches_xla(qtype, kind):
    N, K, B = 256, 512, 4
    qt = _mk(qtype, N, K)
    assert qt.kind == kind
    x = jnp.asarray(RNG.standard_normal((B, K)), jnp.float32)
    ref = qmatmul(x, qt, impl="xla")
    got = qmm_pallas(x, qt, interpret=True)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(ref), rtol=2e-2,
        atol=2e-2 * float(np.abs(np.asarray(ref)).max()),
    )


def test_pallas_3d_batch():
    qt = _mk(GGMLType.Q4_K, 256, 512)
    x = jnp.asarray(RNG.standard_normal((2, 3, 512)), jnp.float32)
    ref = qmatmul(x, qt, impl="xla")
    got = qmm_pallas(x, qt, interpret=True)
    assert got.shape == (2, 3, 256)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=2e-2, atol=0.05)


def test_pallas_large_k_multiblock():
    """K large enough for multiple K-tiles (accumulation path)."""
    qt = _mk(GGMLType.Q4_K, 128, 2048)
    x = jnp.asarray(RNG.standard_normal((8, 2048)), jnp.float32)
    ref = qmatmul(x, qt, impl="xla")
    got = qmm_pallas(x, qt, interpret=True)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(ref), rtol=2e-2,
        atol=2e-2 * float(np.abs(np.asarray(ref)).max()),
    )


def test_pallas_bf16_activations():
    qt = _mk(GGMLType.Q6_K, 256, 512)
    x = jnp.asarray(RNG.standard_normal((4, 512)), jnp.bfloat16)
    ref = qmatmul(x, qt, impl="xla", out_dtype=jnp.float32)
    got = qmm_pallas(x, qt, out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=3e-2, atol=0.08)


def test_pallas_sm_packed_pairs():
    """Packed (scale, min) pair side array: kernel must match the XLA
    dequant of the SAME sm QTensor exactly (both decode bf16 pairs)."""
    from kquant.quant.repack import pack_scale_pairs
    from kquant.quant.qtensor import QTensor

    for t, k in ((GGMLType.Q4_K, 2048), (GGMLType.Q6_K, 1024)):
        qt = _mk(t, 128, k)
        qp = pack_scale_pairs(
            QTensor(qt.kind, qt.layout, qt.shape,
                    {kk: np.asarray(v) for kk, v in qt.arrays.items()})
        )
        qp = QTensor(qp.kind, qp.layout, qp.shape,
                     {kk: jnp.asarray(v) for kk, v in qp.arrays.items()})
        x = jnp.asarray(RNG.standard_normal((4, k)), jnp.float32)
        ref = qmatmul(x, qp, impl="xla")
        got = qmm_pallas(x, qp, interpret=True)
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(ref), rtol=2e-2,
            atol=2e-2 * float(np.abs(np.asarray(ref)).max()),
        )
