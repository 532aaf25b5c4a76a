"""Bit-exact NumPy codecs for ggml block-quant formats.

This is the reference/host implementation of the quantization layer that the
reference engine implements in C + NEON (SURVEY.md section 2.1, "Quant formats
& vec-dot kernels": ``ggml/src/ggml-cpu/arch/arm/quants.c``; Q4_K superblock
layout evidence at reference README.md:725-777, strides 0x90/0x124 at
README.md:610-611).  Everything here is written from the GGUF/ggml *format
spec* (block layouts), fully vectorized in NumPy:

  - ``dequantize(raw_bytes, ggml_type, shape)``  -> float32 ndarray
  - ``quantize(float_array, ggml_type)``         -> raw bytes (uint8 ndarray)

K-quant quantizers implement the ERROR-MINIMIZING scale search of upstream
ggml (the make_qx_quants / make_qkx2_quants algorithms the reference's hot
kernels consume the output of, reference README.md:686-779): a weighted
least-squares fit of (scale[, min]) over a grid of candidate inverse scales,
weights emphasizing large-magnitude values. Without it, requantized models
measure worse perplexity than llama.cpp at identical bit-width. Elementwise
math stays float32 (rounding = nearest-even, matching ggml's nearest_int);
accumulations run in float64 so the NumPy and C++ (csrc/tkq.cpp)
implementations agree bit-for-bit. Dequantizers are bit-exact to the format
so real GGUF files decode correctly.
"""

from __future__ import annotations

import numpy as np

from kquant.gguf.constants import GGMLType, block_size, type_size

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _f16(b: np.ndarray) -> np.ndarray:
    """View little-endian byte pairs as fp16 and convert to fp32. b: (..., 2)."""
    return np.ascontiguousarray(b).view("<f2").astype(np.float32)[..., 0]


def _to_f16_bytes(x: np.ndarray) -> np.ndarray:
    """fp32 -> fp16 little-endian bytes, shape (..., 2)."""
    return x.astype("<f2")[..., None].view(np.uint8)


def _safe_div(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    return np.where(den != 0, num / np.where(den != 0, den, 1.0), 0.0)


_GROUP_MAX_EPS = 1e-15  # ggml GROUP_MAX_EPS


def _nearest(x: np.ndarray) -> np.ndarray:
    """ggml nearest_int == round-half-to-even == np.round."""
    return np.round(x)


# ---------------------------------------------------------------------------
# error-minimizing scale searches (ggml make_qx_quants / make_qkx2_quants)
# vectorized over groups; float32 elementwise, float64 accumulation
# ---------------------------------------------------------------------------


def _make_qx_quants(x: np.ndarray, nmax: int) -> np.ndarray:
    """Symmetric per-group scale via weighted LS over a 19-candidate grid
    (ggml make_qx_quants, rmse_type=1: weights x^2).

    x: (G, n) f32 -> scale (G,) f64. Candidate iscale -(nmax + 0.1*k)/max for
    k in [-9, 9]; each candidate's quantization is scored by the optimum
    weighted objective sumlx^2/suml2 of its code assignment."""
    G, n = x.shape
    xd = x.astype(np.float64)
    w = xd * xd
    idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(G), idx]  # signed value of largest magnitude
    dead = np.abs(maxv) < _GROUP_MAX_EPS
    safe = np.where(dead, np.float32(1.0), maxv)

    def cand(step: int):
        isc = -(np.float32(nmax) + np.float32(0.1) * np.float32(step)) / safe
        l = np.clip(_nearest((isc[:, None] * x).astype(np.float32)),
                    -nmax, nmax - 1).astype(np.float64)
        sumlx = np.sum(w * xd * l, axis=1)
        suml2 = np.sum(w * l * l, axis=1)
        return sumlx, suml2

    sumlx, suml2 = cand(0)
    scale = np.where(suml2 > 0, sumlx / np.where(suml2 > 0, suml2, 1.0), 0.0)
    best = scale * sumlx
    for step in (*range(-9, 0), *range(1, 10)):
        slx, sl2 = cand(step)
        better = (sl2 > 0) & (slx * slx > best * sl2)
        new_scale = np.where(better, slx / np.where(sl2 > 0, sl2, 1.0), scale)
        best = np.where(better, new_scale * slx, best)
        scale = new_scale
    return np.where(dead, 0.0, scale)


def _make_qkx2_quants(
    x: np.ndarray,
    nmax: int,
    weights: np.ndarray,
    rmin: float,
    rdelta: float,
    nstep: int,
    use_mad: bool,
) -> tuple[np.ndarray, np.ndarray]:
    """Asymmetric per-group (scale, min) via weighted LS over a candidate
    grid (ggml make_qkx2_quants). x, weights: (G, n) f32.

    Returns (scale, the_min) both (G,) f64 with the_min >= 0."""
    xd = x.astype(np.float64)
    wd = weights.astype(np.float64)
    sum_w = wd.sum(axis=1)
    sum_x = (wd * xd).sum(axis=1)
    mn = np.minimum(x.min(axis=1), np.float32(0.0))
    mx = x.max(axis=1)
    degen = mx == mn
    span = np.where(degen, np.float32(1.0), mx - mn)

    isc0 = np.float32(nmax) / span
    scale = (np.float32(1.0) / isc0).astype(np.float64)
    minv = mn.astype(np.float64)
    l0 = np.clip(
        _nearest((isc0[:, None] * (x - mn[:, None])).astype(np.float32)),
        0, nmax,
    ).astype(np.float64)
    diff = scale[:, None] * l0 + minv[:, None] - xd
    best_mad = np.sum(wd * (np.abs(diff) if use_mad else diff * diff), axis=1)

    for step in range(nstep + 1):
        isc = (np.float32(rmin) + np.float32(rdelta) * np.float32(step)
               + np.float32(nmax)) / span
        l = np.clip(
            _nearest((isc[:, None] * (x - mn[:, None])).astype(np.float32)),
            0, nmax,
        ).astype(np.float64)
        sum_l = (wd * l).sum(axis=1)
        sum_l2 = (wd * l * l).sum(axis=1)
        sum_xl = (wd * l * xd).sum(axis=1)
        D = sum_w * sum_l2 - sum_l * sum_l
        ok = D > 0
        Ds = np.where(ok, D, 1.0)
        ts = (sum_w * sum_xl - sum_x * sum_l) / Ds
        tm = (sum_l2 * sum_x - sum_l * sum_xl) / Ds
        pos = tm > 0
        sl2s = np.where(sum_l2 > 0, sum_l2, 1.0)
        ts = np.where(pos, sum_xl / sl2s, ts)
        tm = np.where(pos, 0.0, tm)
        diff = ts[:, None] * l + tm[:, None] - xd
        mad = np.sum(wd * (np.abs(diff) if use_mad else diff * diff), axis=1)
        upd = ok & (mad < best_mad)
        scale = np.where(upd, ts, scale)
        minv = np.where(upd, tm, minv)
        best_mad = np.where(upd, mad, best_mad)
    scale = np.where(degen, 0.0, scale)
    minv = np.where(degen, mn.astype(np.float64), minv)
    return scale, -minv


def _make_q3_quants(x: np.ndarray, nmax: int) -> np.ndarray:
    """Symmetric scale with per-element coordinate-descent refinement (ggml
    make_q3_quants, do_rmse=true). x: (G, n) f32 -> scale (G,) f64."""
    G, n = x.shape
    xd = x.astype(np.float64)
    w = xd * xd
    idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(G), idx]
    dead = np.abs(maxv) == 0.0
    safe = np.where(dead, np.float32(1.0), maxv)
    isc = -np.float32(nmax) / safe
    L = np.clip(_nearest((isc[:, None] * x).astype(np.float32)),
                -nmax, nmax - 1).astype(np.float64)
    sumlx = np.sum(w * xd * L, axis=1)
    suml2 = np.sum(w * L * L, axis=1)
    for _ in range(5):
        any_changed = False
        for i in range(n):
            wi, xi, Li = w[:, i], xd[:, i], L[:, i]
            slx = sumlx - wi * xi * Li
            sl2 = suml2 - wi * Li * Li
            good = slx > 0
            new_l = np.clip(
                _nearest(np.where(good, xi * sl2 / np.where(slx != 0, slx, 1.0), Li)),
                -nmax, nmax - 1,
            )
            cand = good & (new_l != Li)
            slx2 = slx + wi * xi * new_l
            sl22 = sl2 + wi * new_l * new_l
            improve = cand & (sl22 > 0) & (slx2 * slx2 * suml2 > sumlx * sumlx * sl22)
            L[:, i] = np.where(improve, new_l, Li)
            sumlx = np.where(improve, slx2, sumlx)
            suml2 = np.where(improve, sl22, suml2)
            any_changed = any_changed or bool(improve.any())
        if not any_changed:
            break
    scale = np.where(suml2 > 0, sumlx / np.where(suml2 > 0, suml2, 1.0), 0.0)
    return np.where(dead, 0.0, scale)


# ---------------------------------------------------------------------------
# Q4_0 / Q4_1 / Q5_0 / Q5_1 / Q8_0 / Q8_1  (32-element blocks)
# ---------------------------------------------------------------------------


def _deq_q4_0(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2])[:, None]
    qs = blocks[:, 2:18]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.int8) - 8
    return d * q.astype(np.float32)


def _q_q4_0(x: np.ndarray) -> np.ndarray:
    amax_idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(x.shape[0]), amax_idx]
    d = maxv / -8.0
    q = np.clip(np.round(_safe_div(x, d[:, None])) + 8, 0, 15).astype(np.uint8)
    out = np.empty((x.shape[0], 18), np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:18] = q[:, :16] | (q[:, 16:] << 4)
    return out


def _deq_q4_1(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2])[:, None]
    m = _f16(blocks[:, 2:4])[:, None]
    qs = blocks[:, 4:20]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.float32)
    return d * q + m


def _q_q4_1(x: np.ndarray) -> np.ndarray:
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / 15.0
    q = np.clip(np.round(_safe_div(x - mn[:, None], d[:, None])), 0, 15).astype(np.uint8)
    out = np.empty((x.shape[0], 20), np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:4] = _to_f16_bytes(mn)
    out[:, 4:20] = q[:, :16] | (q[:, 16:] << 4)
    return out


def _qh_bits(qh_bytes: np.ndarray) -> np.ndarray:
    """(nb, 4) uint8 -> (nb, 32) single bits (little-endian u32 bit order)."""
    bits = np.unpackbits(qh_bytes, axis=1, bitorder="little")
    return bits  # bit i of the u32 == element i's high bit


def _deq_q5_0(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2])[:, None]
    qh = _qh_bits(blocks[:, 2:6])
    qs = blocks[:, 6:22]
    q4 = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    q = (q4 | (qh << 4)).astype(np.int16) - 16
    return d * q.astype(np.float32)


def _q_q5_0(x: np.ndarray) -> np.ndarray:
    amax_idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(x.shape[0]), amax_idx]
    d = maxv / -16.0
    q = np.clip(np.round(_safe_div(x, d[:, None])) + 16, 0, 31).astype(np.uint8)
    out = np.empty((x.shape[0], 22), np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:6] = np.packbits(q >> 4, axis=1, bitorder="little")
    lo = q & 0xF
    out[:, 6:22] = lo[:, :16] | (lo[:, 16:] << 4)
    return out


def _deq_q5_1(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2])[:, None]
    m = _f16(blocks[:, 2:4])[:, None]
    qh = _qh_bits(blocks[:, 4:8])
    qs = blocks[:, 8:24]
    q4 = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    q = (q4 | (qh << 4)).astype(np.float32)
    return d * q + m


def _q_q5_1(x: np.ndarray) -> np.ndarray:
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / 31.0
    q = np.clip(np.round(_safe_div(x - mn[:, None], d[:, None])), 0, 31).astype(np.uint8)
    out = np.empty((x.shape[0], 24), np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:4] = _to_f16_bytes(mn)
    out[:, 4:8] = np.packbits(q >> 4, axis=1, bitorder="little")
    lo = q & 0xF
    out[:, 8:24] = lo[:, :16] | (lo[:, 16:] << 4)
    return out


def _deq_q8_0(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2])[:, None]
    q = blocks[:, 2:34].view(np.int8).astype(np.float32)
    return d * q


def _q_q8_0(x: np.ndarray) -> np.ndarray:
    amax = np.abs(x).max(axis=1)
    d = amax / 127.0
    q = np.clip(np.round(_safe_div(x, d[:, None])), -127, 127).astype(np.int8)
    out = np.empty((x.shape[0], 34), np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:34] = q.view(np.uint8)
    return out


def _deq_q8_1(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2])[:, None]
    q = blocks[:, 4:36].view(np.int8).astype(np.float32)
    return d * q


def _q_q8_1(x: np.ndarray) -> np.ndarray:
    amax = np.abs(x).max(axis=1)
    d = amax / 127.0
    q = np.clip(np.round(_safe_div(x, d[:, None])), -127, 127).astype(np.int8)
    s = d * q.astype(np.float32).sum(axis=1)  # stored block sum (d * sum qs)
    out = np.empty((x.shape[0], 36), np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:4] = _to_f16_bytes(s)
    out[:, 4:36] = q.view(np.uint8)
    return out


# ---------------------------------------------------------------------------
# Q4_K / Q5_K  (256-element superblocks, 6-bit packed scales+mins)
# ---------------------------------------------------------------------------


def unpack_kscales(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack the 12-byte 6-bit scale/min format of Q4_K/Q5_K.

    scales: (nb, 12) uint8 -> (sc, m): each (nb, 8) uint8 in [0, 63].
    Layout documented in the reference README.md:732-746 (kernel source dump):
    for j < 4: sc = s[j] & 63, m = s[j+4] & 63;  for j >= 4:
    sc = (s[j+4] & 0xF) | ((s[j-4] >> 6) << 4), m = (s[j+4] >> 4) | ((s[j] >> 6) << 4).
    """
    s = scales
    sc = np.empty(s.shape[:-1] + (8,), np.uint8)
    m = np.empty_like(sc)
    sc[..., :4] = s[..., 0:4] & 63
    m[..., :4] = s[..., 4:8] & 63
    sc[..., 4:] = (s[..., 8:12] & 0xF) | ((s[..., 0:4] >> 6) << 4)
    m[..., 4:] = (s[..., 8:12] >> 4) | ((s[..., 4:8] >> 6) << 4)
    return sc, m


def pack_kscales(sc: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Inverse of :func:`unpack_kscales`. sc, m: (nb, 8) in [0, 63] -> (nb, 12)."""
    out = np.empty(sc.shape[:-1] + (12,), np.uint8)
    out[..., 0:4] = (sc[..., :4] & 63) | ((sc[..., 4:] >> 4) << 6)
    out[..., 4:8] = (m[..., :4] & 63) | ((m[..., 4:] >> 4) << 6)
    out[..., 8:12] = (sc[..., 4:] & 0xF) | ((m[..., 4:] & 0xF) << 4)
    return out


def _q4k_nibbles(qs: np.ndarray) -> np.ndarray:
    """(nb, 128) packed nibbles -> (nb, 256) element-ordered 4-bit values.

    qs chunk c (bytes 32c..32c+31): low nibbles = elements 64c..64c+31,
    high nibbles = elements 64c+32..64c+63.
    """
    nb = qs.shape[0]
    c = qs.reshape(nb, 4, 32)
    out = np.empty((nb, 4, 2, 32), np.uint8)
    out[:, :, 0, :] = c & 0xF
    out[:, :, 1, :] = c >> 4
    return out.reshape(nb, 256)


def _q4k_pack_nibbles(q: np.ndarray) -> np.ndarray:
    """(nb, 256) 4-bit values -> (nb, 128) packed, inverse of _q4k_nibbles."""
    nb = q.shape[0]
    g = q.reshape(nb, 4, 2, 32)
    return (g[:, :, 0, :] | (g[:, :, 1, :] << 4)).reshape(nb, 128)


def _deq_q4_k(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2])
    dmin = _f16(blocks[:, 2:4])
    sc, m = unpack_kscales(blocks[:, 4:16])
    q = _q4k_nibbles(blocks[:, 16:144]).reshape(-1, 8, 32).astype(np.float32)
    scale = (d[:, None] * sc.astype(np.float32))[:, :, None]
    minv = (dmin[:, None] * m.astype(np.float32))[:, :, None]
    return (scale * q - minv).reshape(-1, 256)


def _kquant_search_scales(
    x: np.ndarray, qmax: int, rmin: float, nstep: int
) -> tuple[np.ndarray, ...]:
    """Shared Q4_K/Q5_K superblock assembly around the qkx2 search.

    x: (nb, 8, 32). Returns (d, dmin, sc, m, scale_eff, min_eff) — effective
    per-sub-block scale/min as dequant will see them (fp16-rounded supers)."""
    nb = x.shape[0]
    # ggml's weighting: av_x + |x| with av_x the group RMS
    av_x = np.sqrt((x.astype(np.float64) ** 2).sum(axis=2) / 32.0).astype(np.float32)
    weights = av_x[:, :, None] + np.abs(x)
    scales, mins = _make_qkx2_quants(
        x.reshape(nb * 8, 32), qmax, weights.reshape(nb * 8, 32),
        rmin, 0.1, nstep, False,
    )
    scales = scales.reshape(nb, 8)
    mins = mins.reshape(nb, 8)
    max_scale = np.maximum(scales.max(axis=1), 0.0)
    max_min = np.maximum(mins.max(axis=1), 0.0)
    inv_scale = np.where(max_scale > 0, 63.0 / np.where(max_scale > 0, max_scale, 1.0), 0.0)
    inv_min = np.where(max_min > 0, 63.0 / np.where(max_min > 0, max_min, 1.0), 0.0)
    sc = np.clip(_nearest(inv_scale[:, None] * scales), 0, 63).astype(np.uint8)
    m = np.clip(_nearest(inv_min[:, None] * mins), 0, 63).astype(np.uint8)
    d = _f16(_to_f16_bytes((max_scale / 63.0).astype(np.float32)))
    dmin = _f16(_to_f16_bytes((max_min / 63.0).astype(np.float32)))
    scale_eff = d[:, None] * sc.astype(np.float32)
    min_eff = dmin[:, None] * m.astype(np.float32)
    return d, dmin, sc, m, scale_eff, min_eff


def _q_q4_k(x: np.ndarray) -> np.ndarray:
    nb = x.shape[0]
    xg = x.reshape(nb, 8, 32)
    d, dmin, sc, m, scale_eff, min_eff = _kquant_search_scales(xg, 15, -1.0, 20)
    q = np.where(
        scale_eff[:, :, None] > 0,
        np.clip(
            _nearest(_safe_div(xg + min_eff[:, :, None], scale_eff[:, :, None])),
            0, 15,
        ),
        0.0,
    ).astype(np.uint8)
    out = np.empty((nb, 144), np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:4] = _to_f16_bytes(dmin)
    out[:, 4:16] = pack_kscales(sc, m)
    out[:, 16:144] = _q4k_pack_nibbles(q.reshape(nb, 256))
    return out


def _deq_q5_k(blocks: np.ndarray) -> np.ndarray:
    d = _f16(blocks[:, 0:2])
    dmin = _f16(blocks[:, 2:4])
    sc, m = unpack_kscales(blocks[:, 4:16])
    qh = blocks[:, 16:48]  # (nb, 32)
    qs = blocks[:, 48:176]  # (nb, 128)
    # low 4 bits: same chunking as Q4_K
    q4 = _q4k_nibbles(qs)  # (nb, 256)
    # high bit: element e -> bit (e // 32) of qh[:, e % 32]
    e = np.arange(256)
    hbit = (qh[:, e % 32] >> (e // 32)) & 1
    q = (q4 | (hbit << 4).astype(np.uint8)).reshape(-1, 8, 32).astype(np.float32)
    scale = (d[:, None] * sc.astype(np.float32))[:, :, None]
    minv = (dmin[:, None] * m.astype(np.float32))[:, :, None]
    return (scale * q - minv).reshape(-1, 256)


def _q_q5_k(x: np.ndarray) -> np.ndarray:
    nb = x.shape[0]
    xg = x.reshape(nb, 8, 32)
    d, dmin, sc, m, scale_eff, min_eff = _kquant_search_scales(xg, 31, -0.5, 15)
    q = np.where(
        scale_eff[:, :, None] > 0,
        np.clip(
            _nearest(_safe_div(xg + min_eff[:, :, None], scale_eff[:, :, None])),
            0, 31,
        ),
        0.0,
    ).astype(np.uint8).reshape(nb, 256)
    out = np.empty((nb, 176), np.uint8)
    out[:, 0:2] = _to_f16_bytes(d)
    out[:, 2:4] = _to_f16_bytes(dmin)
    out[:, 4:16] = pack_kscales(sc, m)
    e = np.arange(256)
    hb = (q >> 4).astype(np.uint8)  # (nb, 256) in {0,1}
    qh = np.zeros((nb, 32), np.uint8)
    for bit in range(8):
        sel = hb[:, bit * 32 : (bit + 1) * 32]
        qh |= (sel << bit).astype(np.uint8)
    out[:, 16:48] = qh
    out[:, 48:176] = _q4k_pack_nibbles(q & 0xF)
    return out


# ---------------------------------------------------------------------------
# Q6_K  (256-element superblocks, 16 int8 sub-block scales, 6-bit values)
# ---------------------------------------------------------------------------


def _q6k_elem_tables() -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-element (ql_idx, ql_shift, qh_idx, qh_shift) for the Q6_K layout.

    Element e (0..255): half n = e//128, r = e%128, k = r//32, l = r%32.
      k=0: q = (ql[64n+l]    & 0xF) | (((qh[32n+l] >> 0) & 3) << 4)
      k=1: q = (ql[64n+l+32] & 0xF) | (((qh[32n+l] >> 2) & 3) << 4)
      k=2: q = (ql[64n+l]    >>  4) | (((qh[32n+l] >> 4) & 3) << 4)
      k=3: q = (ql[64n+l+32] >>  4) | (((qh[32n+l] >> 6) & 3) << 4)
    """
    e = np.arange(256)
    n, r = e // 128, e % 128
    k, l = r // 32, r % 32
    ql_idx = 64 * n + l + 32 * (k % 2)
    ql_shift = 4 * (k // 2)
    qh_idx = 32 * n + l
    qh_shift = 2 * k
    return ql_idx, ql_shift, qh_idx, qh_shift


_Q6K_QL_IDX, _Q6K_QL_SHIFT, _Q6K_QH_IDX, _Q6K_QH_SHIFT = _q6k_elem_tables()


def _deq_q6_k(blocks: np.ndarray) -> np.ndarray:
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].view(np.int8).astype(np.float32)  # (nb, 16)
    d = _f16(blocks[:, 208:210])[:, None]
    q4 = (ql[:, _Q6K_QL_IDX] >> _Q6K_QL_SHIFT) & 0xF
    q2 = (qh[:, _Q6K_QH_IDX] >> _Q6K_QH_SHIFT) & 3
    q = (q4 | (q2 << 4)).astype(np.int16) - 32  # (nb, 256) in [-32, 31]
    scale = np.repeat(sc, 16, axis=1)  # scale per 16-element group
    return d * scale * q.astype(np.float32)


def _q_q6_k(x: np.ndarray) -> np.ndarray:
    nb = x.shape[0]
    xg = x.reshape(nb, 16, 16)
    scales = _make_qx_quants(xg.reshape(nb * 16, 16), 32).reshape(nb, 16)
    aidx = np.argmax(np.abs(scales), axis=1)
    max_scale = scales[np.arange(nb), aidx]  # signed value of largest |scale|
    dead = np.abs(max_scale) < _GROUP_MAX_EPS
    iscale = -128.0 / np.where(dead, 1.0, max_scale)
    d = _f16(_to_f16_bytes((1.0 / iscale).astype(np.float32)))
    d = np.where(dead, np.float32(0.0), d)
    sc = np.clip(np.minimum(127, _nearest(iscale[:, None] * scales)),
                 -128, 127).astype(np.int8)
    sc = np.where(dead[:, None], np.int8(0), sc)
    eff = d[:, None] * sc.astype(np.float32)
    q = np.where(
        eff[:, :, None] != 0,
        np.clip(_nearest(_safe_div(xg, eff[:, :, None])), -32, 31),
        0.0,
    ).astype(np.int16)
    q = (q.reshape(nb, 256) + 32).astype(np.uint8)  # 6-bit biased
    q = np.where(dead[:, None], np.uint8(0), q)  # dead block: all-zero bytes
    out = np.zeros((nb, 210), np.uint8)
    ql = np.zeros((nb, 128), np.uint8)
    qh = np.zeros((nb, 64), np.uint8)
    # scatter element bits via the same tables (low nibble / high 2 bits)
    np.bitwise_or.at(
        ql, (np.arange(nb)[:, None], _Q6K_QL_IDX[None, :]), ((q & 0xF) << _Q6K_QL_SHIFT)
    )
    np.bitwise_or.at(
        qh, (np.arange(nb)[:, None], _Q6K_QH_IDX[None, :]), ((q >> 4) << _Q6K_QH_SHIFT)
    )
    out[:, 0:128] = ql
    out[:, 128:192] = qh
    out[:, 192:208] = sc.view(np.uint8)
    out[:, 208:210] = _to_f16_bytes(d)
    return out


# ---------------------------------------------------------------------------
# Q2_K (2-bit, 16 sub-blocks with 4-bit scale + 4-bit min)
# ---------------------------------------------------------------------------


def _q2k_elem_tables() -> tuple[np.ndarray, np.ndarray]:
    """Element e: half n=e//128, j=(e%128)//32, sub=(e%32)//16, l=e%16.

    q byte = 32*n + 16*sub + l, shift = 2*j. scale index = 8*n + 2*j + sub.
    """
    e = np.arange(256)
    n = e // 128
    j = (e % 128) // 32
    sub = (e % 32) // 16
    l = e % 16
    q_idx = 32 * n + 16 * sub + l
    q_shift = 2 * j
    return q_idx, q_shift


_Q2K_Q_IDX, _Q2K_Q_SHIFT = _q2k_elem_tables()
_Q2K_SCALE_IDX = (
    8 * (np.arange(256) // 128)
    + 2 * ((np.arange(256) % 128) // 32)
    + (np.arange(256) % 32) // 16
)


def _deq_q2_k(blocks: np.ndarray) -> np.ndarray:
    scales = blocks[:, 0:16]
    qs = blocks[:, 16:80]
    d = _f16(blocks[:, 80:82])[:, None]
    dmin = _f16(blocks[:, 82:84])[:, None]
    q = ((qs[:, _Q2K_Q_IDX] >> _Q2K_Q_SHIFT) & 3).astype(np.float32)
    sc = (scales[:, _Q2K_SCALE_IDX] & 0xF).astype(np.float32)
    m = (scales[:, _Q2K_SCALE_IDX] >> 4).astype(np.float32)
    return d * sc * q - dmin * m


def _q_q2_k(x: np.ndarray) -> np.ndarray:
    nb = x.shape[0]
    xg = x.reshape(nb, 16, 16)
    scales, mins = _make_qkx2_quants(
        xg.reshape(nb * 16, 16), 3, np.abs(xg).reshape(nb * 16, 16),
        -0.5, 0.1, 15, True,
    )
    scales = scales.reshape(nb, 16)
    mins = mins.reshape(nb, 16)
    max_scale = np.maximum(scales.max(axis=1), 0.0)
    max_min = np.maximum(mins.max(axis=1), 0.0)
    inv_scale = np.where(max_scale > 0, 15.0 / np.where(max_scale > 0, max_scale, 1.0), 0.0)
    inv_min = np.where(max_min > 0, 15.0 / np.where(max_min > 0, max_min, 1.0), 0.0)
    sc = np.clip(_nearest(inv_scale[:, None] * scales), 0, 15).astype(np.uint8)
    m = np.clip(_nearest(inv_min[:, None] * mins), 0, 15).astype(np.uint8)
    d = np.where(max_scale > 0,
                 _f16(_to_f16_bytes((max_scale / 15.0).astype(np.float32))),
                 np.float32(0.0)).astype(np.float32)
    dmin = np.where(max_min > 0,
                    _f16(_to_f16_bytes((max_min / 15.0).astype(np.float32))),
                    np.float32(0.0)).astype(np.float32)
    eff_s = d[:, None] * sc.astype(np.float32)
    eff_m = dmin[:, None] * m.astype(np.float32)
    q = np.where(
        eff_s[:, :, None] > 0,
        np.clip(_nearest(_safe_div(xg + eff_m[:, :, None], eff_s[:, :, None])), 0, 3),
        0.0,
    ).astype(np.uint8).reshape(nb, 256)
    out = np.zeros((nb, 84), np.uint8)
    out[:, 0:16] = sc | (m << 4)
    qs = np.zeros((nb, 64), np.uint8)
    np.bitwise_or.at(
        qs, (np.arange(nb)[:, None], _Q2K_Q_IDX[None, :]), (q << _Q2K_Q_SHIFT)
    )
    out[:, 16:80] = qs
    out[:, 80:82] = _to_f16_bytes(d)
    out[:, 82:84] = _to_f16_bytes(dmin)
    return out


# ---------------------------------------------------------------------------
# Q3_K (3-bit: 2-bit qs + 1-bit hmask, 16 6-bit signed sub-block scales)
# ---------------------------------------------------------------------------


def _unpack_q3k_scales(s: np.ndarray) -> np.ndarray:
    """(nb, 12) -> (nb, 16) int8 scales in [-32, 31] (stored 6-bit biased)."""
    out = np.empty(s.shape[:-1] + (16,), np.uint8)
    out[..., 0:4] = (s[..., 0:4] & 0xF) | (((s[..., 8:12] >> 0) & 3) << 4)
    out[..., 4:8] = (s[..., 4:8] & 0xF) | (((s[..., 8:12] >> 2) & 3) << 4)
    out[..., 8:12] = (s[..., 0:4] >> 4) | (((s[..., 8:12] >> 4) & 3) << 4)
    out[..., 12:16] = (s[..., 4:8] >> 4) | (((s[..., 8:12] >> 6) & 3) << 4)
    return out.astype(np.int16) - 32


def _pack_q3k_scales(sc: np.ndarray) -> np.ndarray:
    """(nb, 16) values in [-32, 31] -> (nb, 12). Inverse of unpack."""
    b = (sc.astype(np.int16) + 32).astype(np.uint8)  # 6-bit
    out = np.empty(sc.shape[:-1] + (12,), np.uint8)
    out[..., 0:4] = (b[..., 0:4] & 0xF) | ((b[..., 8:12] & 0xF) << 4)
    out[..., 4:8] = (b[..., 4:8] & 0xF) | ((b[..., 12:16] & 0xF) << 4)
    out[..., 8:12] = (
        ((b[..., 0:4] >> 4) << 0)
        | ((b[..., 4:8] >> 4) << 2)
        | ((b[..., 8:12] >> 4) << 4)
        | ((b[..., 12:16] >> 4) << 6)
    )
    return out


# hmask: element e -> byte 16*sub + l (0..31), bit (4*n + j)
_Q3K_H_IDX = 16 * ((np.arange(256) % 32) // 16) + np.arange(256) % 16
_Q3K_H_BIT = 4 * (np.arange(256) // 128) + ((np.arange(256) % 128) // 32)


def _deq_q3_k(blocks: np.ndarray) -> np.ndarray:
    hmask = blocks[:, 0:32]
    qs = blocks[:, 32:96]
    scales = _unpack_q3k_scales(blocks[:, 96:108]).astype(np.float32)
    d = _f16(blocks[:, 108:110])[:, None]
    q2 = ((qs[:, _Q2K_Q_IDX] >> _Q2K_Q_SHIFT) & 3).astype(np.int16)
    hbit = (hmask[:, _Q3K_H_IDX] >> _Q3K_H_BIT) & 1
    q = (q2 - np.where(hbit == 0, 4, 0)).astype(np.float32)  # [-4, 3]
    return d * scales[:, _Q2K_SCALE_IDX] * q


def _q_q3_k(x: np.ndarray) -> np.ndarray:
    nb = x.shape[0]
    xg = x.reshape(nb, 16, 16)
    scales = _make_q3_quants(xg.reshape(nb * 16, 16), 4).reshape(nb, 16)
    aidx = np.argmax(np.abs(scales), axis=1)
    max_scale = scales[np.arange(nb), aidx]  # signed value of largest |scale|
    dead = np.abs(max_scale) < _GROUP_MAX_EPS
    iscale = -32.0 / np.where(dead, 1.0, max_scale)
    d = _f16(_to_f16_bytes((1.0 / iscale).astype(np.float32)))
    d = np.where(dead, np.float32(0.0), d)
    sc = np.clip(_nearest(iscale[:, None] * scales), -32, 31).astype(np.int16)
    sc = np.where(dead[:, None], np.int16(0), sc)
    eff = d[:, None] * sc.astype(np.float32)
    q = np.where(
        eff[:, :, None] != 0,
        np.clip(_nearest(_safe_div(xg, eff[:, :, None])), -4, 3),
        0.0,
    ).astype(np.int16)
    q = q.reshape(nb, 256)
    qp4 = (q + 4).astype(np.uint8)  # [0, 7]: bit 2 -> NOT hmask, bits 0-1 -> qs
    out = np.zeros((nb, 110), np.uint8)
    hmask = np.zeros((nb, 32), np.uint8)
    qs = np.zeros((nb, 64), np.uint8)
    np.bitwise_or.at(
        qs, (np.arange(nb)[:, None], _Q2K_Q_IDX[None, :]), ((qp4 & 3) << _Q2K_Q_SHIFT)
    )
    hval = (qp4 >> 2) & 1  # 1 means q >= 0 region (no -4), hmask bit SET
    np.bitwise_or.at(
        hmask, (np.arange(nb)[:, None], _Q3K_H_IDX[None, :]), (hval << _Q3K_H_BIT)
    )
    out[:, 0:32] = hmask
    out[:, 32:96] = qs
    out[:, 96:108] = _pack_q3k_scales(sc)
    out[:, 108:110] = _to_f16_bytes(d)
    return out


# ---------------------------------------------------------------------------
# Q8_K (activation format: fp32 d, 256 int8, 16 int16 group sums)
# ---------------------------------------------------------------------------


def _deq_q8_k(blocks: np.ndarray) -> np.ndarray:
    d = np.ascontiguousarray(blocks[:, 0:4]).view("<f4").astype(np.float32)
    q = blocks[:, 4:260].view(np.int8).astype(np.float32)
    return d * q


def _q_q8_k(x: np.ndarray) -> np.ndarray:
    amax = np.abs(x).max(axis=1)
    d = amax / 127.0
    q = np.clip(np.round(_safe_div(x, d[:, None])), -127, 127).astype(np.int8)
    bsums = q.astype(np.int16).reshape(-1, 16, 16).sum(axis=2).astype("<i2")
    out = np.empty((x.shape[0], 292), np.uint8)
    out[:, 0:4] = d.astype("<f4")[:, None].view(np.uint8)
    out[:, 4:260] = q.view(np.uint8)
    out[:, 260:292] = bsums[:, :, None].view(np.uint8).reshape(-1, 32)
    return out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

_DEQUANT = {
    GGMLType.Q4_0: _deq_q4_0,
    GGMLType.Q4_1: _deq_q4_1,
    GGMLType.Q5_0: _deq_q5_0,
    GGMLType.Q5_1: _deq_q5_1,
    GGMLType.Q8_0: _deq_q8_0,
    GGMLType.Q8_1: _deq_q8_1,
    GGMLType.Q2_K: _deq_q2_k,
    GGMLType.Q3_K: _deq_q3_k,
    GGMLType.Q4_K: _deq_q4_k,
    GGMLType.Q5_K: _deq_q5_k,
    GGMLType.Q6_K: _deq_q6_k,
    GGMLType.Q8_K: _deq_q8_k,
}

_QUANT = {
    GGMLType.Q4_0: _q_q4_0,
    GGMLType.Q4_1: _q_q4_1,
    GGMLType.Q5_0: _q_q5_0,
    GGMLType.Q5_1: _q_q5_1,
    GGMLType.Q8_0: _q_q8_0,
    GGMLType.Q8_1: _q_q8_1,
    GGMLType.Q2_K: _q_q2_k,
    GGMLType.Q3_K: _q_q3_k,
    GGMLType.Q4_K: _q_q4_k,
    GGMLType.Q5_K: _q_q5_k,
    GGMLType.Q6_K: _q_q6_k,
    GGMLType.Q8_K: _q_q8_k,
}


def dequantize(data: np.ndarray, ggml_type: GGMLType, shape: tuple[int, ...]) -> np.ndarray:
    """Decode raw tensor bytes to float32 of ``shape``.

    ``data`` is the flat uint8 byte buffer of the tensor (e.g. a GGUF mmap
    view). Plain float types are just viewed + converted.
    """
    t = GGMLType(ggml_type)
    n = int(np.prod(shape))
    if t == GGMLType.F32:
        return np.ascontiguousarray(data[: n * 4]).view("<f4").reshape(shape).astype(np.float32)
    if t == GGMLType.F16:
        return np.ascontiguousarray(data[: n * 2]).view("<f2").reshape(shape).astype(np.float32)
    if t == GGMLType.BF16:
        u16 = np.ascontiguousarray(data[: n * 2]).view("<u2").astype(np.uint32) << 16
        return u16.view(np.float32).reshape(shape)
    if t in (GGMLType.I8, GGMLType.I16, GGMLType.I32, GGMLType.I64, GGMLType.F64):
        dt = {GGMLType.I8: "i1", GGMLType.I16: "<i2", GGMLType.I32: "<i4",
              GGMLType.I64: "<i8", GGMLType.F64: "<f8"}[t]
        itemsize = np.dtype(dt).itemsize
        return np.ascontiguousarray(data[: n * itemsize]).view(dt).reshape(shape).astype(np.float32)
    bs, ts = block_size(t), type_size(t)
    if n % bs != 0:
        raise ValueError(f"{n} elements not a multiple of block size {bs} ({t.name})")
    blocks = np.ascontiguousarray(data[: n // bs * ts]).reshape(n // bs, ts)
    return _DEQUANT[t](blocks).reshape(shape).astype(np.float32)


def quantize(x: np.ndarray, ggml_type: GGMLType, use_native: bool = True) -> np.ndarray:
    """Encode a float array into raw ggml bytes (flat uint8).

    Uses the multithreaded C++ quantizer (csrc/tkq.cpp) when available for
    Q4_K/Q6_K/Q8_0 (bit-identical for the K-quants); NumPy otherwise.
    """
    t = GGMLType(ggml_type)
    x = np.asarray(x, np.float32)
    n = x.size
    if use_native and t in (GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q8_0):
        from kquant.quant.native import quantize_native

        out = quantize_native(x.reshape(-1), int(t))
        if out is not None:
            return out
    if t == GGMLType.F32:
        return x.astype("<f4").reshape(-1).view(np.uint8)
    if t == GGMLType.F16:
        return x.astype("<f2").reshape(-1).view(np.uint8)
    if t == GGMLType.BF16:
        u32 = x.reshape(-1).view(np.uint32)
        # round-to-nearest-even bf16
        rounded = ((u32 + 0x7FFF + ((u32 >> 16) & 1)) >> 16).astype("<u2")
        return rounded.view(np.uint8)
    bs = block_size(t)
    if n % bs != 0:
        raise ValueError(f"{n} elements not a multiple of block size {bs} ({t.name})")
    return _QUANT[t](x.reshape(n // bs, bs)).reshape(-1)
