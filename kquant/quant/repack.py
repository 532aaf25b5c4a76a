"""Host-side repack: ggml block formats -> canonical packed-GEMM layouts.

The ggml zoo of per-ISA block codecs (SURVEY.md section 2.1, quants.c) collapses
here into one canonical family, keyed by code width:

  kind  codes                      side arrays            group  source formats
  ----  -------------------------  ---------------------  -----  --------------
  q2    qs2  u8[K/4, N] (2-bit)    scales, mins [K/16,N]    16   Q2_K
  q3    qs2  u8[K/4, N] + qh[K/8]  scales, mins [K/16,N]    16   Q3_K
  q4    qs   u8[K/2, N] (4-bit)    scales, mins [K/32,N]    32   Q4_K, Q4_1, Q4_0
  q5    qs   u8[K/2, N] + qh[K/8]  scales, mins [K/32,N]    32   Q5_K, Q5_1, Q5_0
  q6    qs   u8[K/2, N] + qh2[K/4] scales, mins [K/16,N]    16   Q6_K
  q8    qs   i8[K, N]              scales       [K/32,N]    32   Q8_0
  dense w    bf16/f32[N, K]        --                       --   F32/F16/BF16, rest

Dequant is uniformly  w[k, n] = scales[k//g, n] * q[k, n] - mins[k//g, n]
with q the unsigned code (offsets like Q4_0's -8 or Q6_K's -32 are folded into
``mins`` as offset*scale, so kernels need exactly one fused multiply-subtract).

Bit-packing conventions (shared by the jnp and Pallas unpackers):
  - 4-bit fold: byte (k, n) = code(k) | code(k + K/2) << 4
  - 1-bit (qh): byte (k, n) bit j = code-bit of element k + j*K/8
  - 2-bit: byte (k, n) bits [2j, 2j+1] = element k + j*K/4
All unpacks are mask/shift + concatenation along K: no shuffles within a row.
"""

from __future__ import annotations

import numpy as np

from kquant.gguf.constants import GGMLType, block_size, type_size
from kquant.quant import numpy_codecs as C
from kquant.quant.qtensor import QTensor

# ---------------------------------------------------------------------------
# per-source-format decode to (codes, scale_eff, min_eff)
# codes: (N, K) uint8/int8; scale/min_eff: (N, K/group) float32
# ---------------------------------------------------------------------------


def _decode_q4_k(blocks: np.ndarray):
    d = C._f16(blocks[:, 0:2])
    dmin = C._f16(blocks[:, 2:4])
    sc, m = C.unpack_kscales(blocks[:, 4:16])
    q = C._q4k_nibbles(blocks[:, 16:144])
    return q, d[:, None] * sc, dmin[:, None] * m, 32


def _decode_q5_k(blocks: np.ndarray):
    d = C._f16(blocks[:, 0:2])
    dmin = C._f16(blocks[:, 2:4])
    sc, m = C.unpack_kscales(blocks[:, 4:16])
    qh = blocks[:, 16:48]
    q4 = C._q4k_nibbles(blocks[:, 48:176])
    e = np.arange(256)
    hbit = ((qh[:, e % 32] >> (e // 32)) & 1).astype(np.uint8)
    return q4 | (hbit << 4), d[:, None] * sc, dmin[:, None] * m, 32


def _decode_q6_k(blocks: np.ndarray):
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].view(np.int8).astype(np.float32)
    d = C._f16(blocks[:, 208:210])
    q4 = (ql[:, C._Q6K_QL_IDX] >> C._Q6K_QL_SHIFT) & 0xF
    q2 = (qh[:, C._Q6K_QH_IDX] >> C._Q6K_QH_SHIFT) & 3
    q = (q4 | (q2 << 4)).astype(np.uint8)  # biased [0, 63], logical value q-32
    scale = d[:, None] * sc
    return q, scale, 32.0 * scale, 16


def _decode_q2_k(blocks: np.ndarray):
    scales = blocks[:, 0:16]
    qs = blocks[:, 16:80]
    d = C._f16(blocks[:, 80:82])
    dmin = C._f16(blocks[:, 82:84])
    q = ((qs[:, C._Q2K_Q_IDX] >> C._Q2K_Q_SHIFT) & 3).astype(np.uint8)
    # per-element tables give scale idx per elem; reduce to per-group (16)
    sc = (scales & 0xF).astype(np.float32)
    m = (scales >> 4).astype(np.float32)
    # group g (elements 16g..16g+15) uses scale index _Q2K_SCALE_IDX[16g]
    gidx = C._Q2K_SCALE_IDX[::16]
    return q, d[:, None] * sc[:, gidx], dmin[:, None] * m[:, gidx], 16


def _decode_q3_k(blocks: np.ndarray):
    hmask = blocks[:, 0:32]
    qs = blocks[:, 32:96]
    scales = C._unpack_q3k_scales(blocks[:, 96:108]).astype(np.float32)
    d = C._f16(blocks[:, 108:110])
    q2 = ((qs[:, C._Q2K_Q_IDX] >> C._Q2K_Q_SHIFT) & 3).astype(np.uint8)
    hbit = ((hmask[:, C._Q3K_H_IDX] >> C._Q3K_H_BIT) & 1).astype(np.uint8)
    q = q2 | (hbit << 2)  # biased [0, 7], logical value q-4
    gidx = C._Q2K_SCALE_IDX[::16]
    scale = d[:, None] * scales[:, gidx]
    return q, scale, 4.0 * scale, 16


def _decode_q4_0(blocks: np.ndarray):
    d = C._f16(blocks[:, 0:2])
    qs = blocks[:, 2:18]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    return q, d[:, None], 8.0 * d[:, None], 32


def _decode_q4_1(blocks: np.ndarray):
    d = C._f16(blocks[:, 0:2])
    m = C._f16(blocks[:, 2:4])
    qs = blocks[:, 4:20]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1)
    return q, d[:, None], -m[:, None], 32


def _decode_q5_0(blocks: np.ndarray):
    d = C._f16(blocks[:, 0:2])
    qh = C._qh_bits(blocks[:, 2:6])
    qs = blocks[:, 6:22]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1) | (qh << 4)
    return q, d[:, None], 16.0 * d[:, None], 32


def _decode_q5_1(blocks: np.ndarray):
    d = C._f16(blocks[:, 0:2])
    m = C._f16(blocks[:, 2:4])
    qh = C._qh_bits(blocks[:, 4:8])
    qs = blocks[:, 8:24]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1) | (qh << 4)
    return q, d[:, None], -m[:, None], 32


def _decode_q8_0(blocks: np.ndarray):
    d = C._f16(blocks[:, 0:2])
    q = blocks[:, 2:34].view(np.int8)
    return q, d[:, None], None, 32


_DECODERS = {
    GGMLType.Q2_K: ("q2", _decode_q2_k),
    GGMLType.Q3_K: ("q3", _decode_q3_k),
    GGMLType.Q4_K: ("q4", _decode_q4_k),
    GGMLType.Q4_0: ("q4", _decode_q4_0),
    GGMLType.Q4_1: ("q4", _decode_q4_1),
    GGMLType.Q5_K: ("q5", _decode_q5_k),
    GGMLType.Q5_0: ("q5", _decode_q5_0),
    GGMLType.Q5_1: ("q5", _decode_q5_1),
    GGMLType.Q6_K: ("q6", _decode_q6_k),
    GGMLType.Q8_0: ("q8", _decode_q8_0),
}

GROUP_SIZE = {"q2": 16, "q3": 16, "q4": 32, "q5": 32, "q6": 16, "q8": 32,
              "q6w": 16}
CODE_BITS = {"q2": 2, "q3": 3, "q4": 4, "q5": 5, "q6": 6, "q8": 8, "q6w": 8}


def widen_q6(qt: QTensor) -> QTensor:
    """q6 kmajor -> 'q6w': codes widened to signed int8 (q - 32), per-16 f32
    scales, NO mins. Bit-exact: q6 dequant is s*q - 32s = s*(q - 32) and
    q - 32 ∈ [-32, 31] fits int8.

    Rationale: the packed q6 unpack (nibble + 2-bit high plane + scale-mul +
    min-sub) is the most ALU work per byte of any kind, on Q6_K tensors
    (ffn_down, lm head in the Q4_K_M recipe — the reference's q6_K vec-dot
    is 25.93% of its cycles, SURVEY.md 3.1). Widening trades +2 bits/weight
    of memory traffic for a plain int8 convert. Whether it pays on the GPU
    is not measured: the loader widens by default."""
    if qt.kind != "q6" or qt.layout != "kmajor":
        return qt
    qs = np.asarray(qt.arrays["qs"])
    qh = np.asarray(qt.arrays["qh"])
    K2 = qs.shape[-2]
    K = 2 * K2
    K4 = K // 4
    lo = np.concatenate([qs & 0xF, qs >> 4], axis=-2)  # [..., K, N]
    k = np.arange(K)
    hi = (np.take(qh, k % K4, axis=-2) >> (2 * (k // K4))[:, None]) & 3
    codes = (lo | (hi << 4)).astype(np.int16) - 32
    return QTensor("q6w", "kmajor", qt.shape, {
        "qs": codes.astype(np.int8),
        "scales": np.asarray(qt.arrays["scales"]),  # keep caller's scale dtype
    })


def _pack_bits_kmajor(codes_T: np.ndarray, kind: str) -> dict[str, np.ndarray]:
    """codes_T: (K, N) unsigned codes -> packed arrays per the conventions."""
    K = codes_T.shape[0]
    out: dict[str, np.ndarray] = {}
    if kind == "q8":
        out["qs"] = codes_T.astype(np.int8)
        return out
    if kind in ("q4", "q5", "q6"):
        lo4 = codes_T & 0xF
        out["qs"] = lo4[: K // 2] | (lo4[K // 2 :] << 4)
    if kind == "q5":
        h = (codes_T >> 4) & 1  # (K, N)
        s = K // 8
        out["qh"] = sum((h[j * s : (j + 1) * s] << j) for j in range(8)).astype(np.uint8)
    if kind == "q6":
        h = (codes_T >> 4) & 3
        s = K // 4
        out["qh"] = sum((h[j * s : (j + 1) * s] << (2 * j)) for j in range(4)).astype(np.uint8)
    if kind in ("q2", "q3"):
        lo2 = codes_T & 3
        s = K // 4
        out["qs"] = sum((lo2[j * s : (j + 1) * s] << (2 * j)) for j in range(4)).astype(np.uint8)
    if kind == "q3":
        h = (codes_T >> 2) & 1
        s = K // 8
        out["qh"] = sum((h[j * s : (j + 1) * s] << j) for j in range(8)).astype(np.uint8)
    return out


def _unpack_bits_kmajor_np(arrays, kind: str) -> np.ndarray:
    """Inverse of _pack_bits_kmajor (global fold): packed -> codes (K, N)."""
    if kind == "q8":
        return np.asarray(arrays["qs"])
    if kind in ("q4", "q5", "q6"):
        qs = np.asarray(arrays["qs"])
        q = np.concatenate([qs & 0xF, qs >> 4], axis=0)
        if kind == "q5":
            qh = np.asarray(arrays["qh"])
            h = np.concatenate([(qh >> j) & 1 for j in range(8)], axis=0)
            q = q | (h << 4)
        elif kind == "q6":
            qh = np.asarray(arrays["qh"])
            h = np.concatenate([(qh >> (2 * j)) & 3 for j in range(4)], axis=0)
            q = q | (h << 4)
        return q
    if kind in ("q2", "q3"):
        qs = np.asarray(arrays["qs"])
        q = np.concatenate([(qs >> (2 * j)) & 3 for j in range(4)], axis=0)
        if kind == "q3":
            qh = np.asarray(arrays["qh"])
            h = np.concatenate([(qh >> j) & 1 for j in range(8)], axis=0)
            q = q | (h << 2)
        return q
    raise ValueError(f"unknown kind {kind}")


def refold_kmajor(qt: QTensor, f: int) -> QTensor:
    """Re-pack a folded kmajor QTensor with a BLOCK-LOCAL bit fold: the K
    axis splits into ``f`` contiguous blocks and the nibble/bit fold pairs
    codes within each block only.

    Why: the default fold is global (byte k pairs codes k and k + K/2), so
    a row(K)-parallel TP shard holds bytes whose partner codes live on a
    DIFFERENT shard — XLA's SPMD partitioner then implements the unpack as
    a per-layer all_to_all of the packed code arrays (multi-MB per layer;
    found by tools_scale_ready's 70B lowering). With fold = n_shards each
    shard's unpack is fully local and the row-parallel matmul needs only
    its Megatron partial-sum all-reduce. Scale/min arrays are per-group in
    logical K order and shard cleanly either way (untouched here).

    SURVEY.md section 7 hard part 2 ("sharding packed superblocks") — this
    is the missing half: superblock-aligned *scales* were always safe; the
    bit fold also has to be shard-local."""
    if f <= 1 or qt.kind in ("q8", "q6w", "dense") or qt.layout != "kmajor":
        return qt
    codes = _unpack_bits_kmajor_np(qt.arrays, qt.kind)  # (K, N)
    K = codes.shape[0]
    if K % (f * 256) != 0:  # keep superblocks intact within each block
        return qt
    Kb = K // f
    packs = [_pack_bits_kmajor(codes[b * Kb: (b + 1) * Kb], qt.kind)
             for b in range(f)]
    arrays = dict(qt.arrays)
    for key in packs[0]:
        arrays[key] = np.concatenate([p[key] for p in packs], axis=0)
    return QTensor(qt.kind, qt.layout, qt.shape, arrays, qt.tp, fold=f)


def pack_scale_pairs(qt: QTensor) -> QTensor:
    """Pack per-group (scale, min) into ONE f32-container array ``sm``:
    low 16 bits = bf16(scale) bits, high 16 bits = bf16(min) bits.

    Halves side-array memory traffic (q4: 6.0 -> 5.0 bits/weight); the
    kernel (ops.qmm_triton) reads one f32 word per group and splits it with
    two integer ops. bf16 scale precision costs
    ~2^-9 relative, ≈ +0.1% relative perplexity on the ppl-delta harness."""
    if "mins" not in qt.arrays or "scales" not in qt.arrays:
        return qt
    import ml_dtypes

    s = np.asarray(qt.arrays["scales"], dtype=np.float32)
    m = np.asarray(qt.arrays["mins"], dtype=np.float32)
    sb = s.astype(ml_dtypes.bfloat16).view(np.uint16).astype(np.uint32)
    mb = m.astype(ml_dtypes.bfloat16).view(np.uint16).astype(np.uint32)
    sm = (sb | (mb << 16)).view(np.float32)
    arrays = {k: v for k, v in qt.arrays.items() if k not in ("scales", "mins")}
    arrays["sm"] = sm
    return QTensor(qt.kind, qt.layout, qt.shape, arrays)


def unpack_scale_pairs_np(sm: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """NumPy inverse of pack_scale_pairs: sm f32-container -> (scales, mins) f32."""
    bits = sm.view(np.uint32)
    s = (bits << 16).astype(np.uint32).view(np.float32)
    m = (bits & np.uint32(0xFFFF0000)).view(np.float32)
    return s, m


def pack_scale_kpairs(qt: QTensor) -> QTensor:
    """Flat-kind (q6w/q8) per-group f32 scales -> ``sp``: ADJACENT-group bf16
    scale pairs in one f32 container (low 16 bits = bf16(scales[2j]), high
    16 = bf16(scales[2j+1])).

    Same container trick as pack_scale_pairs, pairing along K instead of
    (scale, min): halves the scale-plane memory traffic. The scale planes
    are a large fraction of flat-kind bytes — q6w at g=16 stores 0.25 f32
    bytes per weight byte (20% of the Q4_K_M lm head / ffn_down traffic);
    bf16 pairs cut that to 10%.
    bf16 scale rounding costs ~2^-9 relative, same budget already accepted
    for the q4 ``sm`` pairs under scale_dtype='bf16'."""
    if qt.kind not in ("q6w", "q8") or "scales" not in qt.arrays:
        return qt
    import ml_dtypes

    s = np.asarray(qt.arrays["scales"], dtype=np.float32)
    if s.shape[-2] % 2:
        return qt
    sb = s.astype(ml_dtypes.bfloat16).view(np.uint16).astype(np.uint32)
    even = sb[..., 0::2, :]
    odd = sb[..., 1::2, :]
    sp = (even | (odd << 16)).view(np.float32)
    arrays = {k: v for k, v in qt.arrays.items() if k != "scales"}
    arrays["sp"] = sp
    return QTensor(qt.kind, qt.layout, qt.shape, arrays)


def unpack_scale_kpairs_np(sp: np.ndarray) -> np.ndarray:
    """NumPy inverse of pack_scale_kpairs: sp f32-container -> scales f32
    with the group axis re-interleaved (twice the rows of sp)."""
    bits = sp.view(np.uint32)
    even = (bits << 16).astype(np.uint32).view(np.float32)
    odd = (bits & np.uint32(0xFFFF0000)).view(np.float32)
    out_shape = list(sp.shape)
    out_shape[-2] *= 2
    out = np.empty(out_shape, np.float32)
    out[..., 0::2, :] = even
    out[..., 1::2, :] = odd
    return out


def repack(
    raw: np.ndarray,
    ggml_type: GGMLType,
    shape: tuple[int, ...],
    layout: str = "kmajor",
    scale_dtype=np.float32,
) -> QTensor:
    """Repack raw ggml tensor bytes into a canonical QTensor.

    ``shape`` is the logical (numpy) shape; for 2-D weights it is (N, K) with
    K contiguous on disk. Formats without a decoder (or 1-D tensors) fall back
    to a dense float tensor.
    """
    t = GGMLType(ggml_type)
    if t not in _DECODERS or len(shape) < 2 or layout == "dense":
        w = C.dequantize(raw, t, shape)
        dt = np.float32 if len(shape) == 1 else scale_dtype
        return QTensor("dense", "dense", tuple(shape), {"w": w.astype(dt)})

    kind, decoder = _DECODERS[t]
    N = int(np.prod(shape[:-1]))
    K = shape[-1]

    if layout == "kmajor":
        # fast path: multithreaded C++ repack (bit-identical; csrc/tkq.cpp)
        from kquant.quant.native import GGML_KIND_CODE, repack_kmajor_native

        if int(t) in GGML_KIND_CODE:
            arrays = repack_kmajor_native(kind, raw, N, K)
            if arrays is not None:
                if scale_dtype != np.float32:
                    for key in ("scales", "mins"):
                        if key in arrays:
                            arrays[key] = arrays[key].astype(scale_dtype)
                return QTensor(kind, "kmajor", tuple(shape), arrays)

    bs, ts = block_size(t), type_size(t)
    blocks = np.ascontiguousarray(raw[: N * K // bs * ts]).reshape(-1, ts)
    codes, scale_eff, min_eff, group = decoder(blocks)
    codes = codes.reshape(N, K)
    scales = scale_eff.reshape(N, K // group).astype(scale_dtype)
    mins = None if min_eff is None else np.broadcast_to(
        min_eff, scale_eff.shape
    ).reshape(N, K // group).astype(scale_dtype)

    arrays: dict[str, np.ndarray]
    if layout == "rowmajor":
        # keep rows intact for gather: fold along K within each row
        arrays = {
            k: v.T for k, v in _pack_bits_kmajor(codes.T, kind).items()
        }
        arrays["scales"] = scales
        if mins is not None:
            arrays["mins"] = mins
    else:
        arrays = _pack_bits_kmajor(codes.T, kind)
        arrays["scales"] = scales.T.copy()
        if mins is not None:
            arrays["mins"] = mins.T.copy()
    return QTensor(kind, layout, tuple(shape), arrays)
