"""Native C++ codec library vs NumPy reference: bit-exact parity.

If no toolchain/library is available the tests skip (the framework degrades
to the NumPy reference automatically)."""

import numpy as np
import pytest

from kquant.gguf.constants import GGMLType
from kquant.quant import dequantize, quantize
from kquant.quant.native import (
    dequantize_native,
    get_lib,
    quantize_native,
    repack_kmajor_native,
)
from kquant.quant.repack import repack

pytestmark = pytest.mark.skipif(get_lib() is None, reason="libtkq not available")
RNG = np.random.default_rng(9)


@pytest.mark.parametrize(
    "qtype,kind",
    [(GGMLType.Q4_K, "q4"), (GGMLType.Q5_K, "q5"), (GGMLType.Q6_K, "q6"), (GGMLType.Q8_0, "q8")],
)
def test_repack_bit_exact(qtype, kind):
    N, K = 16, 512
    x = RNG.standard_normal((N, K)).astype(np.float32)
    raw = quantize(x, qtype, use_native=False)
    ref = repack(raw, qtype, (N, K), layout="kmajor", scale_dtype=np.float64)
    # scale_dtype=f64 forces the numpy path for the reference arrays
    nat = repack_kmajor_native(kind, raw, N, K)
    for key in ("qs", "qh"):
        if key in nat:
            np.testing.assert_array_equal(np.asarray(ref.arrays[key]), nat[key])
    np.testing.assert_allclose(
        np.asarray(ref.arrays["scales"], np.float32), nat["scales"], rtol=1e-6
    )
    if "mins" in nat:
        np.testing.assert_allclose(
            np.asarray(ref.arrays["mins"], np.float32), nat["mins"], rtol=1e-6
        )


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K])
def test_quantize_bit_exact(qtype):
    x = RNG.standard_normal(256 * 32).astype(np.float32)
    np.testing.assert_array_equal(
        quantize_native(x, int(qtype)), quantize(x, qtype, use_native=False)
    )


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q6_K])
def test_quantize_search_bit_exact_edge_cases(qtype):
    """The error-minimizing scale search must stay bit-identical between C++
    and NumPy even on structured data that produces exact candidate ties
    (the case FMA contraction used to break)."""
    cases = [
        np.zeros(512, np.float32),
        np.full(512, 3.25, np.float32),
        np.tile(np.array([1, -1], np.float32), 256),
        np.concatenate([np.zeros(256), RNG.standard_normal(256)]).astype(np.float32),
        (RNG.standard_normal(256 * 64) * 100.0).astype(np.float32),
        (RNG.standard_normal(256 * 64) * 0.01).astype(np.float32),
    ]
    for x in cases:
        np.testing.assert_array_equal(
            quantize_native(x, int(qtype)), quantize(x, qtype, use_native=False)
        )


def test_quantize_q80_equivalent():
    x = RNG.standard_normal(32 * 64).astype(np.float32)
    a = dequantize(quantize_native(x, 8), GGMLType.Q8_0, x.shape)
    b = dequantize(quantize(x, GGMLType.Q8_0, use_native=False), GGMLType.Q8_0, x.shape)
    # lround (half away from zero) vs np.round (half to even) may differ by
    # one quantization step on exact ties — compare the ERRORS, not outputs
    ea = np.sqrt(np.mean((a - x) ** 2))
    eb = np.sqrt(np.mean((b - x) ** 2))
    assert abs(ea - eb) < 0.02 * eb
    scale_max = np.abs(x).max() / 127.0
    assert np.abs(a - b).max() <= scale_max * 1.01


@pytest.mark.parametrize("qtype", [GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.Q8_0])
def test_dequantize_matches(qtype):
    n = 256 * 16 if qtype != GGMLType.Q8_0 else 32 * 16
    x = RNG.standard_normal(n).astype(np.float32)
    raw = quantize(x, qtype, use_native=False)
    ref = dequantize(raw, qtype, (n,))
    nat = dequantize_native(int(qtype), raw, n)
    np.testing.assert_allclose(ref, nat, rtol=1e-6, atol=1e-7)
