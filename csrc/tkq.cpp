// tkq: native codec/repack library for kquant.
//
// The reference engine's model-I/O + quant layer is C/C++ (SURVEY.md 2.1:
// gguf.cpp, llama-model-loader, quants.c). This is its JAX-framework
// equivalent: multithreaded host-side decode of ggml block formats into the
// canonical packed-GEMM layouts (see kquant/quant/repack.py for the
// layout contract), plus fast quantizers for GGUF export. Loaded from Python
// via ctypes (kquant/quant/native.py); NumPy implementations remain the
// reference and fallback.
//
// Build: make -C csrc   (g++ -O3 -fopenmp -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// fp16 <-> fp32 (scalar; called per block header only)
// ---------------------------------------------------------------------------
static inline float f16_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t man = h & 0x3FF;
    uint32_t out;
    if (exp == 0) {
        if (man == 0) { out = sign; }
        else {  // subnormal
            exp = 127 - 15 + 1;
            while (!(man & 0x400)) { man <<= 1; exp--; }
            man &= 0x3FF;
            out = sign | (exp << 23) | (man << 13);
        }
    } else if (exp == 31) {
        out = sign | 0x7F800000u | (man << 13);
    } else {
        out = sign | ((exp + 127 - 15) << 23) | (man << 13);
    }
    float f;
    std::memcpy(&f, &out, 4);
    return f;
}

static inline uint16_t f32_to_f16(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    uint32_t sign = (x >> 16) & 0x8000;
    int32_t exp = ((x >> 23) & 0xFF) - 127 + 15;
    uint32_t man = x & 0x7FFFFF;
    if (exp <= 0) {
        if (exp < -10) return (uint16_t)sign;
        man |= 0x800000;
        uint32_t shift = 14 - exp;
        // round-to-nearest-EVEN (matches numpy's f32->f16 cast)
        uint32_t rounded = (man + ((1u << (shift - 1)) - 1) + ((man >> shift) & 1)) >> shift;
        return (uint16_t)(sign | rounded);
    }
    if (exp >= 31) return (uint16_t)(sign | 0x7C00);
    // round-to-nearest-EVEN (matches numpy's f32->f16 cast)
    uint32_t rounded = man + 0xFFF + ((man >> 13) & 1);
    if (rounded & 0x800000) { rounded = 0; exp++; if (exp >= 31) return (uint16_t)(sign | 0x7C00); }
    return (uint16_t)(sign | (exp << 10) | (rounded >> 13));
}

// ---------------------------------------------------------------------------
// per-superblock decode to codes + effective scales/mins
// (bit layouts per the GGUF spec; see kquant/quant/numpy_codecs.py)
// ---------------------------------------------------------------------------

static inline void kscales_unpack(const uint8_t* s, uint8_t* sc, uint8_t* m) {
    for (int j = 0; j < 4; j++) {
        sc[j] = s[j] & 63;
        m[j] = s[j + 4] & 63;
        sc[j + 4] = (s[j + 8] & 0xF) | ((s[j] >> 6) << 4);
        m[j + 4] = (s[j + 8] >> 4) | ((s[j + 4] >> 6) << 4);
    }
}

// Q4_K block: 144 B -> 256 codes (uint8), 8 scales, 8 mins
static void decode_q4k_block(const uint8_t* b, uint8_t* codes, float* scale, float* minv) {
    float d = f16_to_f32(*(const uint16_t*)(b));
    float dmin = f16_to_f32(*(const uint16_t*)(b + 2));
    uint8_t sc[8], mn[8];
    kscales_unpack(b + 4, sc, mn);
    for (int j = 0; j < 8; j++) { scale[j] = d * sc[j]; minv[j] = dmin * mn[j]; }
    const uint8_t* qs = b + 16;
    for (int c = 0; c < 4; c++) {
        const uint8_t* q = qs + 32 * c;
        uint8_t* lo = codes + 64 * c;
        for (int l = 0; l < 32; l++) { lo[l] = q[l] & 0xF; lo[l + 32] = q[l] >> 4; }
    }
}

// Q5_K block: 176 B
static void decode_q5k_block(const uint8_t* b, uint8_t* codes, float* scale, float* minv) {
    float d = f16_to_f32(*(const uint16_t*)(b));
    float dmin = f16_to_f32(*(const uint16_t*)(b + 2));
    uint8_t sc[8], mn[8];
    kscales_unpack(b + 4, sc, mn);
    for (int j = 0; j < 8; j++) { scale[j] = d * sc[j]; minv[j] = dmin * mn[j]; }
    const uint8_t* qh = b + 16;
    const uint8_t* qs = b + 48;
    for (int c = 0; c < 4; c++) {
        const uint8_t* q = qs + 32 * c;
        uint8_t* lo = codes + 64 * c;
        for (int l = 0; l < 32; l++) { lo[l] = q[l] & 0xF; lo[l + 32] = q[l] >> 4; }
    }
    for (int e = 0; e < 256; e++)
        codes[e] |= ((qh[e & 31] >> (e >> 5)) & 1) << 4;
}

// Q6_K block: 210 B; codes biased [0,63] (logical value code-32)
static void decode_q6k_block(const uint8_t* b, uint8_t* codes, float* scale, float* minv) {
    const uint8_t* ql = b;
    const uint8_t* qh = b + 128;
    const int8_t* sc = (const int8_t*)(b + 192);
    float d = f16_to_f32(*(const uint16_t*)(b + 208));
    for (int g = 0; g < 16; g++) { scale[g] = d * sc[g]; minv[g] = 32.0f * scale[g]; }
    for (int n = 0; n < 2; n++) {
        const uint8_t* qln = ql + 64 * n;
        const uint8_t* qhn = qh + 32 * n;
        uint8_t* y = codes + 128 * n;
        for (int l = 0; l < 32; l++) {
            uint8_t h = qhn[l];
            y[l] = (qln[l] & 0xF) | ((h & 3) << 4);
            y[l + 32] = (qln[l + 32] & 0xF) | (((h >> 2) & 3) << 4);
            y[l + 64] = (qln[l] >> 4) | (((h >> 4) & 3) << 4);
            y[l + 96] = (qln[l + 32] >> 4) | (((h >> 6) & 3) << 4);
        }
    }
}

// Q8_0 block: 34 B, 32 codes (int8 stored as uint8 bits), 1 scale
static void decode_q80_block(const uint8_t* b, uint8_t* codes, float* scale, float* minv) {
    scale[0] = f16_to_f32(*(const uint16_t*)(b));
    if (minv) minv[0] = 0.0f;
    std::memcpy(codes, b + 2, 32);
}

// ---------------------------------------------------------------------------
// repack: raw blocks of a (N, K) tensor -> kmajor packed arrays
//   q4/q5/q6 -> qs[K/2, N] nibble-folded (+ qh[K/8 or K/4, N])
//   scales/mins [K/g, N] float32
// Matches kquant/quant/repack.py bit-for-bit (tested).
// ---------------------------------------------------------------------------

// kind: 4 = q4_k, 5 = q5_k, 6 = q6_k, 8 = q8_0
int tkq_repack_kmajor(
    int kind, const uint8_t* raw, int64_t N, int64_t K,
    uint8_t* qs_out, uint8_t* qh_out, float* scales_out, float* mins_out,
    int nthreads)
{
    int64_t bs, ts, g;
    void (*dec)(const uint8_t*, uint8_t*, float*, float*);
    switch (kind) {
        case 4: bs = 256; ts = 144; g = 32; dec = decode_q4k_block; break;
        case 5: bs = 256; ts = 176; g = 32; dec = decode_q5k_block; break;
        case 6: bs = 256; ts = 210; g = 16; dec = decode_q6k_block; break;
        case 8: bs = 32; ts = 34; g = 32; dec = decode_q80_block; break;
        default: return -1;
    }
    if (K % bs != 0 && !(kind == 8 && K % 32 == 0)) return -2;
    const int64_t blocks_per_row = K / bs;
    const int64_t K2 = K / 2, K8 = K / 8, K4 = K / 4;

#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
    #pragma omp parallel for schedule(static)
#endif
    for (int64_t n = 0; n < N; n++) {
        uint8_t codes[256];
        float scale[16], minv[16];
        for (int64_t blk = 0; blk < blocks_per_row; blk++) {
            const uint8_t* b = raw + (n * blocks_per_row + blk) * ts;
            dec(b, codes, scale, minv);
            int64_t k0 = blk * bs;
            // scales/mins: column-major-ish [GR, N]
            for (int64_t j = 0; j < bs / g; j++) {
                scales_out[(k0 / g + j) * N + n] = scale[j];
                if (mins_out) mins_out[(k0 / g + j) * N + n] = minv[j];
            }
            if (kind == 8) {
                for (int64_t e = 0; e < bs; e++)
                    qs_out[(k0 + e) * N + n] = codes[e];
                continue;
            }
            // 4-bit fold: byte (k, n) = code(k) | code(k + K/2) << 4
            for (int64_t e = 0; e < bs; e++) {
                int64_t k = k0 + e;
                uint8_t lo4 = codes[e] & 0xF;
                int64_t kr = k % K2;
                uint8_t sh = (k >= K2) ? 4 : 0;
                // accumulate with OR: rows are private to this thread (per n)
                uint8_t* cell = &qs_out[kr * N + n];
                if (sh == 0) *cell = (*cell & 0xF0) | lo4;
                else *cell = (*cell & 0x0F) | (lo4 << 4);
                if (kind == 5) {
                    uint8_t hb = (codes[e] >> 4) & 1;
                    int64_t hr = k % K8;
                    int shift = (int)(k / K8);
                    uint8_t* hc = &qh_out[hr * N + n];
                    *hc = (uint8_t)((*hc & ~(1u << shift)) | (hb << shift));
                } else if (kind == 6) {
                    uint8_t hb = (codes[e] >> 4) & 3;
                    int64_t hr = k % K4;
                    int shift = 2 * (int)(k / K4);
                    uint8_t* hc = &qh_out[hr * N + n];
                    *hc = (uint8_t)((*hc & ~(3u << shift)) | (hb << shift));
                }
            }
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// dequantize rows to f32 (host reference / norm tensors / embeddings)
// ---------------------------------------------------------------------------
int tkq_dequantize(int kind, const uint8_t* raw, float* out, int64_t nelem, int nthreads) {
    int64_t bs, ts, g;
    void (*dec)(const uint8_t*, uint8_t*, float*, float*);
    int offset = 0;
    switch (kind) {
        case 4: bs = 256; ts = 144; g = 32; dec = decode_q4k_block; break;
        case 5: bs = 256; ts = 176; g = 32; dec = decode_q5k_block; break;
        case 6: bs = 256; ts = 210; g = 16; dec = decode_q6k_block; offset = 32; break;
        case 8: bs = 32; ts = 34; g = 32; dec = decode_q80_block; break;
        default: return -1;
    }
    (void)offset;
    int64_t nb = nelem / bs;
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
    #pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < nb; i++) {
        uint8_t codes[256];
        float scale[16], minv[16];
        dec(raw + i * ts, codes, scale, minv);
        float* y = out + i * bs;
        if (kind == 8) {
            const int8_t* c8 = (const int8_t*)codes;
            for (int64_t e = 0; e < bs; e++) y[e] = scale[0] * c8[e];
        } else {
            for (int64_t e = 0; e < bs; e++)
                y[e] = scale[e / g] * codes[e] - minv[e / g];
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// quantize f32 -> raw blocks (GGUF export / fixture building)
// ---------------------------------------------------------------------------
static inline void kscales_pack(const uint8_t* sc, const uint8_t* m, uint8_t* out) {
    for (int j = 0; j < 4; j++) {
        out[j] = (uint8_t)((sc[j] & 63) | ((sc[j + 4] >> 4) << 6));
        out[j + 4] = (uint8_t)((m[j] & 63) | ((m[j + 4] >> 4) << 6));
        out[j + 8] = (uint8_t)((sc[j + 4] & 0xF) | ((m[j + 4] & 0xF) << 4));
    }
}

// ---------------------------------------------------------------------------
// error-minimizing scale searches (ggml make_qx_quants / make_qkx2_quants).
// Float32 elementwise (nearbyintf = nearest-even, matching ggml nearest_int
// and np.round), float64 accumulation — bit-identical to the NumPy reference
// in kquant/quant/numpy_codecs.py (same term values; tested).
// ---------------------------------------------------------------------------

static const double TKQ_GROUP_MAX_EPS = 1e-15;

// symmetric weighted-LS scale over 19 candidate iscales (weights x^2)
static double make_qx_quants_d(int n, int nmax, const float* x) {
    float maxv = 0.0f, amax = 0.0f;
    for (int i = 0; i < n; i++) {
        float ax = std::fabs(x[i]);
        if (ax > amax) { amax = ax; maxv = x[i]; }
    }
    if (std::fabs(maxv) < TKQ_GROUP_MAX_EPS) return 0.0;
    double scale = 0.0, best = 0.0;
    for (int k = 0; k < 19; k++) {
        int step = (k == 0) ? 0 : (k <= 9 ? k - 10 : k - 9);  // 0,-9..-1,1..9
        float isc = -((float)nmax + 0.1f * (float)step) / maxv;
        double sumlx = 0.0, suml2 = 0.0;
        for (int i = 0; i < n; i++) {
            float lf = std::nearbyintf(isc * x[i]);
            double l = std::clamp((double)lf, (double)-nmax, (double)(nmax - 1));
            double w = (double)x[i] * (double)x[i];
            sumlx += w * (double)x[i] * l;
            suml2 += w * l * l;
        }
        if (k == 0) {
            scale = suml2 > 0 ? sumlx / suml2 : 0.0;
            best = scale * sumlx;
        } else if (suml2 > 0 && sumlx * sumlx > best * suml2) {
            scale = sumlx / suml2;
            best = scale * sumlx;
        }
    }
    return scale;
}

// asymmetric weighted-LS (scale, min) over a candidate grid
static double make_qkx2_quants_d(int n, int nmax, const float* x,
                                 const float* weights, double* the_min,
                                 float rmin, float rdelta, int nstep,
                                 bool use_mad) {
    float mn = x[0], mx = x[0];
    double sum_w = weights[0], sum_x = (double)weights[0] * (double)x[0];
    for (int i = 1; i < n; i++) {
        mn = std::min(mn, x[i]); mx = std::max(mx, x[i]);
        double w = weights[i];
        sum_w += w; sum_x += w * (double)x[i];
    }
    mn = std::min(mn, 0.0f);
    if (mx == mn) { *the_min = -(double)mn; return 0.0; }
    float span = mx - mn;
    float isc0 = (float)nmax / span;
    double scale = (double)(1.0f / isc0);
    double minv = (double)mn;
    double best_mad = 0.0;
    for (int i = 0; i < n; i++) {
        float lf = std::nearbyintf(isc0 * (x[i] - mn));
        double l = std::clamp((double)lf, 0.0, (double)nmax);
        double diff = scale * l + minv - (double)x[i];
        best_mad += (double)weights[i] * (use_mad ? std::fabs(diff) : diff * diff);
    }
    for (int is = 0; is <= nstep; is++) {
        float isc = (rmin + rdelta * (float)is + (float)nmax) / span;
        double sum_l = 0.0, sum_l2 = 0.0, sum_xl = 0.0;
        double lbuf[64];
        for (int i = 0; i < n; i++) {
            float lf = std::nearbyintf(isc * (x[i] - mn));
            double l = std::clamp((double)lf, 0.0, (double)nmax);
            lbuf[i] = l;
            double w = weights[i];
            sum_l += w * l;
            sum_l2 += w * l * l;
            sum_xl += w * l * (double)x[i];
        }
        double D = sum_w * sum_l2 - sum_l * sum_l;
        if (D > 0) {
            double ts = (sum_w * sum_xl - sum_x * sum_l) / D;
            double tm = (sum_l2 * sum_x - sum_l * sum_xl) / D;
            if (tm > 0) { tm = 0.0; ts = sum_l2 > 0 ? sum_xl / sum_l2 : ts; }
            double mad = 0.0;
            for (int i = 0; i < n; i++) {
                double diff = ts * lbuf[i] + tm - (double)x[i];
                mad += (double)weights[i] * (use_mad ? std::fabs(diff) : diff * diff);
            }
            if (mad < best_mad) { best_mad = mad; scale = ts; minv = tm; }
        }
    }
    *the_min = -minv;
    return scale;
}

int tkq_quantize_q4k(const float* x, int64_t nelem, uint8_t* out, int nthreads) {
    if (nelem % 256) return -2;
    int64_t nb = nelem / 256;
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
    #pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < nb; i++) {
        const float* xb = x + i * 256;
        uint8_t* b = out + i * 144;
        double scales[8], mins[8];
        float weights[32];
        for (int j = 0; j < 8; j++) {
            const float* xj = xb + 32 * j;
            double s2 = 0.0;
            for (int l = 0; l < 32; l++) s2 += (double)xj[l] * (double)xj[l];
            float av_x = (float)std::sqrt(s2 / 32.0);
            for (int l = 0; l < 32; l++) weights[l] = av_x + std::fabs(xj[l]);
            scales[j] = make_qkx2_quants_d(32, 15, xj, weights, &mins[j],
                                           -1.0f, 0.1f, 20, false);
        }
        double max_scale = 0.0, max_min = 0.0;
        for (int j = 0; j < 8; j++) {
            max_scale = std::max(max_scale, scales[j]);
            max_min = std::max(max_min, mins[j]);
        }
        double inv_scale = max_scale > 0 ? 63.0 / max_scale : 0.0;
        double inv_min = max_min > 0 ? 63.0 / max_min : 0.0;
        uint8_t sc[8], mq[8];
        for (int j = 0; j < 8; j++) {
            sc[j] = (uint8_t)std::clamp(std::nearbyint(inv_scale * scales[j]), 0.0, 63.0);
            mq[j] = (uint8_t)std::clamp(std::nearbyint(inv_min * mins[j]), 0.0, 63.0);
        }
        float d = f16_to_f32(f32_to_f16((float)(max_scale / 63.0)));
        float dmin = f16_to_f32(f32_to_f16((float)(max_min / 63.0)));
        *(uint16_t*)(b) = f32_to_f16((float)(max_scale / 63.0));
        *(uint16_t*)(b + 2) = f32_to_f16((float)(max_min / 63.0));
        kscales_pack(sc, mq, b + 4);
        uint8_t q[256];
        for (int j = 0; j < 8; j++) {
            float se = d * (float)sc[j], me = dmin * (float)mq[j];
            for (int l = 0; l < 32; l++) {
                float v = xb[32 * j + l];
                float qf = se > 0 ? std::nearbyintf((v + me) / se) : 0.0f;
                q[32 * j + l] = (uint8_t)std::clamp(qf, 0.0f, 15.0f);
            }
        }
        uint8_t* qs = b + 16;
        for (int c = 0; c < 4; c++)
            for (int l = 0; l < 32; l++)
                qs[32 * c + l] = (uint8_t)(q[64 * c + l] | (q[64 * c + 32 + l] << 4));
    }
    return 0;
}

int tkq_quantize_q6k(const float* x, int64_t nelem, uint8_t* out, int nthreads) {
    if (nelem % 256) return -2;
    int64_t nb = nelem / 256;
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
    #pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < nb; i++) {
        const float* xb = x + i * 256;
        uint8_t* b = out + i * 210;
        double scales[16];
        double max_scale = 0.0, max_abs = 0.0;
        for (int g = 0; g < 16; g++) {
            scales[g] = make_qx_quants_d(16, 32, xb + 16 * g);
            double a = std::fabs(scales[g]);
            if (a > max_abs) { max_abs = a; max_scale = scales[g]; }
        }
        if (max_abs < TKQ_GROUP_MAX_EPS) {  // dead block: all-zero bytes
            std::memset(b, 0, 210);
            continue;
        }
        double iscale = -128.0 / max_scale;
        float d = f16_to_f32(f32_to_f16((float)(1.0 / iscale)));
        int8_t sc[16];
        for (int g = 0; g < 16; g++) {
            double t = std::min(127.0, std::nearbyint(iscale * scales[g]));
            sc[g] = (int8_t)std::clamp(t, -128.0, 127.0);
        }
        uint8_t q[256];
        for (int g = 0; g < 16; g++) {
            float eff = d * (float)sc[g];
            for (int l = 0; l < 16; l++) {
                float v = xb[16 * g + l];
                float qf = eff != 0 ? std::nearbyintf(v / eff) : 0.0f;
                q[16 * g + l] = (uint8_t)(std::clamp(qf, -32.0f, 31.0f) + 32);
            }
        }
        uint8_t* ql = b;
        uint8_t* qh = b + 128;
        std::memset(ql, 0, 128);
        std::memset(qh, 0, 64);
        for (int n = 0; n < 2; n++) {
            const uint8_t* y = q + 128 * n;
            uint8_t* qln = ql + 64 * n;
            uint8_t* qhn = qh + 32 * n;
            for (int l = 0; l < 32; l++) {
                qln[l] |= (y[l] & 0xF) | ((y[l + 64] & 0xF) << 4);
                qln[l + 32] |= (y[l + 32] & 0xF) | ((y[l + 96] & 0xF) << 4);
                qhn[l] |= (y[l] >> 4) | ((y[l + 32] >> 4) << 2)
                        | ((y[l + 64] >> 4) << 4) | ((y[l + 96] >> 4) << 6);
            }
        }
        std::memcpy(b + 192, sc, 16);
        *(uint16_t*)(b + 208) = f32_to_f16(d);
    }
    return 0;
}

int tkq_quantize_q80(const float* x, int64_t nelem, uint8_t* out, int nthreads) {
    if (nelem % 32) return -2;
    int64_t nb = nelem / 32;
#ifdef _OPENMP
    if (nthreads > 0) omp_set_num_threads(nthreads);
    #pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < nb; i++) {
        const float* xb = x + i * 32;
        uint8_t* b = out + i * 34;
        float amax = 0.0f;
        for (int l = 0; l < 32; l++) amax = std::max(amax, std::fabs(xb[l]));
        float d = amax / 127.0f;
        float df = f16_to_f32(f32_to_f16(d));
        *(uint16_t*)(b) = f32_to_f16(d);
        int8_t* q = (int8_t*)(b + 2);
        for (int l = 0; l < 32; l++) {
            int qi = df > 0 ? (int)std::lround(xb[l] / df) : 0;
            q[l] = (int8_t)std::clamp(qi, -127, 127);
        }
    }
    return 0;
}

int tkq_nthreads_default() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
