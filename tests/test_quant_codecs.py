"""Unit tests for the ggml block-quant codecs (SURVEY.md section 4 item (a)).

Strategy: (1) exact round-trip of our own quantizer output — dequant(quant(x))
must reproduce the values implied by the stored scales bit-exactly; (2) error
bounds of quantization vs the original floats; (3) hand-built superblocks that
pin the bit layout (nibble ordering, 6-bit scale packing, high-bit placement)
so a decoder bug cannot cancel an encoder bug.
"""

import numpy as np
import pytest

from kquant.gguf.constants import GGMLType, block_size, row_size, type_size
from kquant.quant import dequantize, quantize
from kquant.quant.numpy_codecs import pack_kscales, unpack_kscales

RNG = np.random.default_rng(0)

ALL_QTYPES = [
    GGMLType.Q4_0,
    GGMLType.Q4_1,
    GGMLType.Q5_0,
    GGMLType.Q5_1,
    GGMLType.Q8_0,
    GGMLType.Q8_1,
    GGMLType.Q2_K,
    GGMLType.Q3_K,
    GGMLType.Q4_K,
    GGMLType.Q5_K,
    GGMLType.Q6_K,
    GGMLType.Q8_K,
]

# max relative RMS error budget per format (vs. N(0,1) data), generous but
# tight enough to catch layout/indexing bugs which blow errors to O(1)
RMS_BUDGET = {
    GGMLType.Q2_K: 0.40,
    GGMLType.Q3_K: 0.25,
    GGMLType.Q4_0: 0.12,
    GGMLType.Q4_1: 0.11,
    GGMLType.Q4_K: 0.10,
    GGMLType.Q5_0: 0.055,
    GGMLType.Q5_1: 0.050,
    GGMLType.Q5_K: 0.050,
    GGMLType.Q6_K: 0.026,
    GGMLType.Q8_0: 0.007,
    GGMLType.Q8_1: 0.007,
    GGMLType.Q8_K: 0.009,
}


@pytest.mark.parametrize("qtype", ALL_QTYPES)
def test_roundtrip_error(qtype):
    n = block_size(qtype) * 16
    x = RNG.standard_normal(n).astype(np.float32)
    raw = quantize(x, qtype)
    assert raw.dtype == np.uint8
    assert raw.size == row_size(qtype, n)
    y = dequantize(raw, qtype, (n,))
    rms = np.sqrt(np.mean((x - y) ** 2)) / np.sqrt(np.mean(x**2))
    assert rms < RMS_BUDGET[qtype], f"{qtype.name}: rms {rms:.4f}"


@pytest.mark.parametrize("qtype", ALL_QTYPES)
def test_double_roundtrip_stable(qtype):
    """Re-quantizing a dequantized tensor drifts far less than the original
    quantization error (near-idempotency; asymmetric formats re-estimate
    scales, so exact fixed points are not guaranteed)."""
    n = block_size(qtype) * 8
    x = RNG.standard_normal(n).astype(np.float32)
    raw1 = quantize(x, qtype)
    y1 = dequantize(raw1, qtype, (n,))
    raw2 = quantize(y1, qtype)
    y2 = dequantize(raw2, qtype, (n,))
    err1 = np.sqrt(np.mean((x - y1) ** 2))
    err2 = np.sqrt(np.mean((y1 - y2) ** 2))
    assert err2 < 0.35 * err1, f"{qtype.name}: drift {err2:.4f} vs quant err {err1:.4f}"


@pytest.mark.parametrize(
    "ftype",
    [GGMLType.F32, GGMLType.F16, GGMLType.BF16],
)
def test_float_formats(ftype):
    x = RNG.standard_normal(64).astype(np.float32)
    raw = quantize(x, ftype)
    y = dequantize(raw, ftype, (64,))
    tol = {GGMLType.F32: 0, GGMLType.F16: 1e-3, GGMLType.BF16: 2e-2}[ftype]
    np.testing.assert_allclose(x, y, rtol=tol, atol=tol)


def test_kscale_pack_unpack_exhaustive():
    """6-bit scale/min packing of Q4_K/Q5_K round-trips all 64 values."""
    sc = np.arange(64, dtype=np.uint8).reshape(8, 8)
    m = np.arange(63, -1, -1, dtype=np.uint8).reshape(8, 8)
    packed = pack_kscales(sc, m)
    assert packed.shape == (8, 12)
    sc2, m2 = unpack_kscales(packed)
    np.testing.assert_array_equal(sc, sc2)
    np.testing.assert_array_equal(m, m2)


def test_q4k_handbuilt_block():
    """Pin the Q4_K bit layout with a hand-constructed 144-byte superblock.

    Layout (reference README.md:725-777): d fp16, dmin fp16, 12 B packed
    scales, 128 B nibbles; chunk c low nibbles = elems 64c..64c+31, high
    nibbles = elems 64c+32..64c+63; y = d*sc[j]*q - dmin*m[j], j = elem//32.
    """
    block = np.zeros(144, np.uint8)
    block[0:2] = np.array([2.0], "<f2").view(np.uint8)  # d = 2.0
    block[2:4] = np.array([0.5], "<f2").view(np.uint8)  # dmin = 0.5
    sc = np.array([[1, 2, 3, 4, 5, 6, 7, 8]], np.uint8)
    m = np.array([[0, 1, 0, 1, 0, 1, 0, 1]], np.uint8)
    block[4:16] = pack_kscales(sc, m)[0]
    qs = np.zeros(128, np.uint8)
    qs[0] = 0x5 | (0x9 << 4)  # elem 0 (low) = 5, elem 32 (high) = 9
    qs[33] = 0x7 | (0xF << 4)  # chunk 1, byte 1: elem 65 = 7, elem 97 = 15
    block[16:144] = qs
    y = dequantize(block, GGMLType.Q4_K, (256,))
    # elem 0: sub-block 0: d*sc0*q - dmin*m0 = 2*1*5 - 0.5*0 = 10
    assert y[0] == 10.0
    # elem 32: sub-block 1: 2*2*9 - 0.5*1 = 35.5
    assert y[32] == 35.5
    # elem 65: sub-block 2: 2*3*7 - 0 = 42
    assert y[65] == 42.0
    # elem 97: sub-block 3: 2*4*15 - 0.5*1 = 119.5
    assert y[97] == 119.5
    # an untouched elem in sub-block 5: q=0 -> -dmin*m5 = -0.5
    assert y[160] == -0.5


def test_q6k_handbuilt_block():
    """Pin Q6_K: ql/qh split, int8 scales per 16 elems, q in [-32,31]."""
    block = np.zeros(210, np.uint8)
    scales = np.zeros(16, np.int8)
    scales[0] = 3
    scales[4] = -2  # elements 64..79 (k=2 of half 0 -> scale idx 4)
    block[192:208] = scales.view(np.uint8)
    block[208:210] = np.array([0.5], "<f2").view(np.uint8)  # d
    ql = np.zeros(128, np.uint8)
    qh = np.zeros(64, np.uint8)
    # element 0: half 0, k=0, l=0: ql[0] low nibble, qh[0] bits 0-1
    ql[0] = 0xF  # low nibble 15
    qh[0] = 0b01  # high bits 01 -> q = 15 | (1<<4) = 31 -> 31-32 = -1
    # element 64: half 0, k=2, l=0: ql[0] high nibble, qh[0] bits 4-5
    ql[0] |= 0x2 << 4
    qh[0] |= 0b10 << 4  # q = 2 | (2<<4) = 34 -> 34-32 = 2
    block[0:128] = ql
    block[128:192] = qh
    y = dequantize(block, GGMLType.Q6_K, (256,))
    assert y[0] == 0.5 * 3 * (-1)
    assert y[64] == 0.5 * (-2) * 2
    assert y[1] == 0.5 * 3 * (0 - 32)  # untouched q=0 -> -32


def test_q8k_layout():
    """Q8_K: fp32 d + 256 int8 + 16 int16 bsums; bsums must match group sums."""
    x = RNG.standard_normal(512).astype(np.float32)
    raw = quantize(x, GGMLType.Q8_K).reshape(2, 292)
    d = raw[:, 0:4].copy().view("<f4")[:, 0]
    q = raw[:, 4:260].view(np.int8)
    bsums = raw[:, 260:292].copy().view("<i2")
    np.testing.assert_array_equal(
        bsums, q.astype(np.int16).reshape(2, 16, 16).sum(axis=2)
    )
    y = dequantize(raw.reshape(-1), GGMLType.Q8_K, (512,))
    np.testing.assert_allclose(y.reshape(2, 256), d[:, None] * q, rtol=1e-6)


def test_q5k_high_bit_placement():
    """Q5_K element e high bit lives at qh[e % 32] bit (e // 32)."""
    x = np.zeros(256, np.float32)
    x[5] = 31.0  # forces q=31 -> high bit set for elem 5
    raw = quantize(x, GGMLType.Q5_K)
    qh = raw[16:48]
    assert qh[5] & 1  # elem 5 -> byte 5, bit 0
    y = dequantize(raw, GGMLType.Q5_K, (256,))
    assert abs(y[5] - 31.0) < 0.2


def test_type_sizes():
    assert type_size(GGMLType.Q4_K) == 144  # stride 0x90, README:611
    assert type_size(GGMLType.Q8_K) == 292  # stride 0x124, README:610
    assert type_size(GGMLType.Q6_K) == 210
    assert type_size(GGMLType.Q2_K) == 84
    assert type_size(GGMLType.Q3_K) == 110
    assert type_size(GGMLType.Q5_K) == 176


@pytest.mark.parametrize("qtype", ALL_QTYPES)
def test_2d_shapes(qtype):
    """Row-major 2D tensors decode with rows = contiguous block runs."""
    bs = block_size(qtype)
    rows, cols = 4, bs * 2
    x = RNG.standard_normal((rows, cols)).astype(np.float32)
    raw = quantize(x, qtype)
    y = dequantize(raw, qtype, (rows, cols))
    assert y.shape == (rows, cols)
    # per-row decode must equal whole-tensor decode
    rs = row_size(qtype, cols)
    for r in range(rows):
        yr = dequantize(raw[r * rs : (r + 1) * rs], qtype, (cols,))
        np.testing.assert_array_equal(y[r], yr)
