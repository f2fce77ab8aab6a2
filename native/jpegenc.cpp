// Native baseline JPEG encoder (quality 100, 4:4:4 / grayscale).
//
// The reference hardcodes JPEG quality 100 (reference: src/io/writers/
// jpeg.rs:14,27). At q100 every quantizer is 1, so the stream is dominated
// by entropy coding of near-raw DCT coefficients — the headline 2048² SAR
// frame compresses to ~17 MB and libjpeg-turbo needs ~95 ms single-core on
// the bench host. This encoder reaches the same stream format faster:
//   * it takes PLANAR YCbCr input — the fused device program emits YCbCr
//     planes at zero cost (color conversion fuses into the XLA program),
//     so the host pays no color convert and no deinterleave;
//   * 8x8 forward DCT as two 8x8 f32 matrix passes (orthonormal DCT-II
//     basis == the JPEG FDCT) with AVX2/AVX-512 FMA when available;
//   * 64-bit shift-register Huffman writer with standard Annex K tables
//     (byte-identical table segments to libjpeg's q100 non-optimized
//     output; coefficient streams differ only by rounding mode, invisible
//     at decode).
//
// Exposed as plain C ABI via ctypes (like tiffcodec.cpp).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <mutex>
#include <thread>
#include <vector>

#if defined(__AVX2__) || defined(__AVX512BW__)
#include <immintrin.h>
#endif

namespace {

// --------------------------------------------------------------------------
// Standard Annex K Huffman tables (verified byte-identical to libjpeg DHT
// output at q100): BITS (codes per length 1..16) + HUFFVAL.
// --------------------------------------------------------------------------
static const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
static const uint8_t kDcLumVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t kDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
static const uint8_t kDcChrVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t kAcLumVals[162] = {
    1, 2, 3, 0, 4, 17, 5, 18, 33, 49, 65, 6, 19, 81, 97, 7, 34, 113, 20, 50,
    129, 145, 161, 8, 35, 66, 177, 193, 21, 82, 209, 240, 36, 51, 98, 114,
    130, 9, 10, 22, 23, 24, 25, 26, 37, 38, 39, 40, 41, 42, 52, 53, 54, 55,
    56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83, 84, 85, 86, 87, 88, 89,
    90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117, 118, 119, 120,
    121, 122, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149,
    150, 151, 152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169, 170,
    178, 179, 180, 181, 182, 183, 184, 185, 186, 194, 195, 196, 197, 198,
    199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218, 225,
    226, 227, 228, 229, 230, 231, 232, 233, 234, 241, 242, 243, 244, 245,
    246, 247, 248, 249, 250};
static const uint8_t kAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t kAcChrVals[162] = {
    0, 1, 2, 3, 17, 4, 5, 33, 49, 6, 18, 65, 81, 7, 97, 113, 19, 34, 50,
    129, 8, 20, 66, 145, 161, 177, 193, 9, 35, 51, 82, 240, 21, 98, 114,
    209, 10, 22, 36, 52, 225, 37, 241, 23, 24, 25, 26, 38, 39, 40, 41, 42,
    53, 54, 55, 56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83, 84, 85, 86,
    87, 88, 89, 90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117,
    118, 119, 120, 121, 122, 130, 131, 132, 133, 134, 135, 136, 137, 138,
    146, 147, 148, 149, 150, 151, 152, 153, 154, 162, 163, 164, 165, 166,
    167, 168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185, 186, 194,
    195, 196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215,
    216, 217, 218, 226, 227, 228, 229, 230, 231, 232, 233, 234, 242, 243,
    244, 245, 246, 247, 248, 249, 250};

// zigzag order k -> (row, col) flat index of the TRANSPOSED coefficient
// matrix (the DCT below leaves its result transposed; mapping (c,r) here
// saves the second 8x8 transpose).
static int kZigzagT[64];
static const int kZigzagRC[64][2] = {
    {0,0},{0,1},{1,0},{2,0},{1,1},{0,2},{0,3},{1,2},
    {2,1},{3,0},{4,0},{3,1},{2,2},{1,3},{0,4},{0,5},
    {1,4},{2,3},{3,2},{4,1},{5,0},{6,0},{5,1},{4,2},
    {3,3},{2,4},{1,5},{0,6},{0,7},{1,6},{2,5},{3,4},
    {4,3},{5,2},{6,1},{7,0},{7,1},{6,2},{5,3},{4,4},
    {3,5},{2,6},{1,7},{2,7},{3,6},{4,5},{5,4},{6,3},
    {7,2},{7,3},{6,4},{5,5},{4,6},{3,7},{4,7},{5,6},
    {6,5},{7,4},{7,5},{6,6},{5,7},{6,7},{7,6},{7,7}};

struct HuffTable {
    uint16_t code[256];
    uint8_t len[256];
};

static HuffTable gDcLum, gDcChr, gAcLum, gAcChr;
// Merged run=0 AC tables keyed by coefficient VALUE (v+1024 for |v|<=1023):
// entry = total_len<<32 | (huff_code<<s)|value_bits. Replaces clz + two
// table reads + shifts with ONE load on the dominant path (q100 SAR blocks
// are almost all nonzero coefficients with run 0) — measured 67 -> 53 ms
// entropy time on the 2048^2 frame, byte-identical stream.
static uint64_t gAcLumByVal[2048], gAcChrByVal[2048];
// NOTE (negative result, measured): a compact 1 KB first-try table
// (|v| <= 63, which covers >99.99% of nonzero ACs on the bench frame) ran
// ~4% SLOWER than indexing the full 16 KB tables — both fit this host's
// 48 KB L1d alongside the streams, so the extra range branch bought
// nothing. Keep the single full-range table.
#if defined(__AVX512BW__)
// vpermi2w index vectors = kZigzagT as u16 (filled in init_tables_impl):
// one 64-coeff block zigzag-reorders with two permutes over (lo32, hi32)
alignas(64) static uint16_t gZzPerm[64];
#endif
static float gDctT[8][8];  // orthonormal DCT-II basis
static std::once_flag gInitOnce;  // ctypes releases the GIL: first encodes
                                  // can race from several Python threads

static void build_table(const uint8_t* bits, const uint8_t* vals, int nvals,
                        HuffTable* t) {
    std::memset(t->len, 0, sizeof(t->len));
    uint16_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; ++l) {
        for (int i = 0; i < bits[l]; ++i) {
            t->code[vals[k]] = code;
            t->len[vals[k]] = static_cast<uint8_t>(l);
            ++code;
            ++k;
        }
        code <<= 1;
    }
    (void)nvals;
}

static inline int bit_category(int v) {
    const unsigned a = static_cast<unsigned>(v < 0 ? -v : v);
    return a ? 32 - __builtin_clz(a) : 0;
}

static void build_by_value(const HuffTable& ac, uint64_t* m) {
    for (int v = -1023; v <= 1023; ++v) {
        if (v == 0) { m[1024] = 0; continue; }
        const int s = bit_category(v);
        const uint32_t valbits =
            static_cast<uint32_t>(v >= 0 ? v : v - 1) & ((1u << s) - 1);
        m[v + 1024] = (static_cast<uint64_t>(ac.len[s] + s) << 32) |
                      ((static_cast<uint64_t>(ac.code[s]) << s) | valbits);
    }
}

static void init_tables_impl() {
    build_table(kDcLumBits, kDcLumVals, 12, &gDcLum);
    build_table(kDcChrBits, kDcChrVals, 12, &gDcChr);
    build_table(kAcLumBits, kAcLumVals, 162, &gAcLum);
    build_table(kAcChrBits, kAcChrVals, 162, &gAcChr);
    build_by_value(gAcLum, gAcLumByVal);
    build_by_value(gAcChr, gAcChrByVal);
    const double pi = 3.14159265358979323846;
    for (int u = 0; u < 8; ++u) {
        const double s = (u == 0) ? std::sqrt(1.0 / 8.0) : std::sqrt(2.0 / 8.0);
        for (int x = 0; x < 8; ++x)
            gDctT[u][x] = static_cast<float>(
                s * std::cos((2 * x + 1) * u * pi / 16.0));
    }
    for (int kk = 0; kk < 64; ++kk)
        kZigzagT[kk] = kZigzagRC[kk][1] * 8 + kZigzagRC[kk][0];
#if defined(__AVX512BW__)
    for (int kk = 0; kk < 64; ++kk)
        gZzPerm[kk] = static_cast<uint16_t>(kZigzagT[kk]);
#endif
}

static void init_tables() {
    std::call_once(gInitOnce, init_tables_impl);
}

struct BitWriter {
    uint8_t* out;
    int64_t cap;
    int64_t pos = 0;
    uint64_t acc = 0;
    int nbits = 0;
    bool ok = true;

    // Flush whole 32-bit groups from the top of the accumulator. The fast
    // path (no 0xFF byte in the group, ~98% of groups on q100 SAR content)
    // emits 4 bytes with one bswap store; only groups containing 0xFF take
    // the byte-stuffing loop.
    inline void flush32() {
        while (nbits >= 32) {
            const uint32_t v = static_cast<uint32_t>(acc >> (nbits - 32));
            const uint32_t x = v ^ 0xFFFFFFFFu;  // FF bytes become 00
            if (((x - 0x01010101u) & ~x & 0x80808080u) == 0) {
                if (pos + 4 > cap) { ok = false; nbits = 0; return; }
                const uint32_t be = __builtin_bswap32(v);
                std::memcpy(out + pos, &be, 4);
                pos += 4;
            } else {
                if (pos + 8 > cap) { ok = false; nbits = 0; return; }
                for (int i = 3; i >= 0; --i) {
                    const uint8_t b = static_cast<uint8_t>((v >> (8 * i)) & 0xFF);
                    out[pos++] = b;
                    if (b == 0xFF) out[pos++] = 0x00;
                }
            }
            nbits -= 32;
        }
    }

    // len <= 27 (16-bit Huffman code + up to 11 value bits); nbits stays
    // < 32 after flush, so acc never overflows 64 bits.
    inline void put(uint64_t code, int len) {
        acc = (acc << len) | code;
        nbits += len;
        if (nbits >= 32) flush32();
    }

    inline void byte(uint8_t b) {
        if (pos + 1 > cap) { ok = false; return; }
        out[pos++] = b;
    }

    void bytes(const uint8_t* p, int64_t n) {
        if (pos + n > cap) { ok = false; return; }
        std::memcpy(out + pos, p, n);
        pos += n;
    }

    void flush_bits() {  // pad to byte with 1s, drain everything
        const int pad = (8 - (nbits & 7)) & 7;
        if (pad) {
            acc = (acc << pad) | ((1u << pad) - 1);
            nbits += pad;
        }
        while (nbits >= 8) {
            if (pos + 2 > cap) { ok = false; nbits = 0; return; }
            const uint8_t b = static_cast<uint8_t>((acc >> (nbits - 8)) & 0xFF);
            out[pos++] = b;
            if (b == 0xFF) out[pos++] = 0x00;
            nbits -= 8;
        }
    }
};

// --- 8x8 forward DCT: coeffs = (T · block · Tᵀ)ᵀ, stored transposed ------
#if defined(__AVX2__)
static inline void transpose8(__m256 r[8]) {
    __m256 t0 = _mm256_unpacklo_ps(r[0], r[1]);
    __m256 t1 = _mm256_unpackhi_ps(r[0], r[1]);
    __m256 t2 = _mm256_unpacklo_ps(r[2], r[3]);
    __m256 t3 = _mm256_unpackhi_ps(r[2], r[3]);
    __m256 t4 = _mm256_unpacklo_ps(r[4], r[5]);
    __m256 t5 = _mm256_unpackhi_ps(r[4], r[5]);
    __m256 t6 = _mm256_unpacklo_ps(r[6], r[7]);
    __m256 t7 = _mm256_unpackhi_ps(r[6], r[7]);
    __m256 s0 = _mm256_shuffle_ps(t0, t2, 0x44);
    __m256 s1 = _mm256_shuffle_ps(t0, t2, 0xEE);
    __m256 s2 = _mm256_shuffle_ps(t1, t3, 0x44);
    __m256 s3 = _mm256_shuffle_ps(t1, t3, 0xEE);
    __m256 s4 = _mm256_shuffle_ps(t4, t6, 0x44);
    __m256 s5 = _mm256_shuffle_ps(t4, t6, 0xEE);
    __m256 s6 = _mm256_shuffle_ps(t5, t7, 0x44);
    __m256 s7 = _mm256_shuffle_ps(t5, t7, 0xEE);
    r[0] = _mm256_permute2f128_ps(s0, s4, 0x20);
    r[1] = _mm256_permute2f128_ps(s1, s5, 0x20);
    r[2] = _mm256_permute2f128_ps(s2, s6, 0x20);
    r[3] = _mm256_permute2f128_ps(s3, s7, 0x20);
    r[4] = _mm256_permute2f128_ps(s0, s4, 0x31);
    r[5] = _mm256_permute2f128_ps(s1, s5, 0x31);
    r[6] = _mm256_permute2f128_ps(s2, s6, 0x31);
    r[7] = _mm256_permute2f128_ps(s3, s7, 0x31);
}

static inline void dct_pass(const __m256 in[8], __m256 out[8]) {
    for (int i = 0; i < 8; ++i) {
        __m256 acc = _mm256_mul_ps(_mm256_set1_ps(gDctT[i][0]), in[0]);
        acc = _mm256_fmadd_ps(_mm256_set1_ps(gDctT[i][1]), in[1], acc);
        acc = _mm256_fmadd_ps(_mm256_set1_ps(gDctT[i][2]), in[2], acc);
        acc = _mm256_fmadd_ps(_mm256_set1_ps(gDctT[i][3]), in[3], acc);
        acc = _mm256_fmadd_ps(_mm256_set1_ps(gDctT[i][4]), in[4], acc);
        acc = _mm256_fmadd_ps(_mm256_set1_ps(gDctT[i][5]), in[5], acc);
        acc = _mm256_fmadd_ps(_mm256_set1_ps(gDctT[i][6]), in[6], acc);
        acc = _mm256_fmadd_ps(_mm256_set1_ps(gDctT[i][7]), in[7], acc);
        out[i] = acc;
    }
}

static void fdct8x8(const float in[64], int32_t out[64]) {
    __m256 rows[8], tmp[8];
    for (int i = 0; i < 8; ++i) rows[i] = _mm256_loadu_ps(in + 8 * i);
    dct_pass(rows, tmp);       // T · B
    transpose8(tmp);           // (T·B)ᵀ = Bᵀ·Tᵀ
    dct_pass(tmp, rows);       // T·Bᵀ·Tᵀ = (T·B·Tᵀ)ᵀ  (stored transposed)
    for (int i = 0; i < 8; ++i)
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(out + 8 * i),
                            _mm256_cvtps_epi32(rows[i]));
}
#else
static void fdct8x8(const float in[64], int32_t out[64]) {
    float m1[64], m2[64];
    for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j) {
            float a = 0;
            for (int k = 0; k < 8; ++k) a += gDctT[i][k] * in[k * 8 + j];
            m1[i * 8 + j] = a;
        }
    for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j) {
            float a = 0;
            for (int k = 0; k < 8; ++k) a += m1[i * 8 + k] * gDctT[j][k];
            m2[j * 8 + i] = a;  // store transposed like the AVX path
        }
    for (int i = 0; i < 64; ++i)
        out[i] = static_cast<int32_t>(std::lrintf(m2[i]));
}
#endif

// NOTE (negative results, measured phase-fair on the 2048² frame —
// interleaved reps of both builds in one process):
//   * tzcnt mask-walk instead of the scalar zero scan: 1.75x slower in its
//     original heavy form (141 vs 80 ms), and STILL slower re-tested in a
//     light form where the mask falls out of the AVX-512 permute for free
//     (65 vs 62 ms) — the ctz/blsr chain costs more than the ~12%
//     mispredicted zero-branches it removes. Keep the SCAN scalar.
//   * 128-bit accumulator with 64-bit flush groups: 88 vs 65 ms — the
//     variable __int128 shift in every put dwarfs the halved flush count.
// The zigzag PERMUTE itself is a win: blocks arrive as contiguous
// zigzag-ordered int16 with an out-of-range sentinel at [64] (two
// vpermi2w per block in CoeffSource), so the scan drops the
// per-coefficient index-table load, the int16→int32 widening copy, and
// all bound checks (sentinel fails both the zero test and the value-table
// range test). With 3-/4-code grouped appends: 68.7 → 57.8 ms phase-fair,
// byte-identical stream.
static inline void encode_block(BitWriter& bw, const int16_t* zz,
                                int& dc_prev, const HuffTable& dc,
                                const HuffTable& ac, const uint64_t* ac_by_val) {
    // DC: Huffman code and value bits append as ONE shift (halves flush
    // checks). For negative v the JPEG value bits v + (1<<s) - 1 equal
    // (v - 1) & ((1<<s)-1) in two's complement.
    const int dcv = zz[0];
    int diff = dcv - dc_prev;
    {
        // 8-bit-input DCTs bound the DC diff to ±2040 (category <= 11);
        // clamp out-of-range EXTERNAL coefficient input rather than index
        // past the Annex K DC table (categories stop at 11)
        if (diff > 2047) diff = 2047;
        else if (diff < -2047) diff = -2047;
        dc_prev += diff;  // track what the decoder reconstructs
        const int s = bit_category(diff);
        const uint32_t valbits =
            static_cast<uint32_t>(diff >= 0 ? diff : diff - 1) & ((1u << s) - 1);
        bw.put((static_cast<uint64_t>(dc.code[s]) << s) | valbits,
               dc.len[s] + s);
    }
    // AC. On q100 SAR content almost every coefficient is nonzero with
    // run 0: the value-keyed table gives (code|bits, len) in one load, and
    // two consecutive such codes whose lengths fit 32 bits append as ONE
    // accumulator shift (measured 53 -> 42 ms on the 2048² frame,
    // byte-identical stream). Zero runs scan sentinel-bounded: zz[64] is
    // nonzero, so the run loop needs no k < 64 check.
    int k = 1;
    for (;;) {
        int run = 0;
        while (zz[k] == 0) {
            ++k;
            ++run;
        }
        if (k >= 64) {
            if (run > 0) bw.put(ac.code[0x00], ac.len[0x00]);  // EOB
            return;
        }
        int v = zz[k];
        // value-keyed table covers |v| <= 1023 (v = -1024 maps to index 0,
        // which build_by_value does NOT fill — it must take the generic
        // path, where it clamps to the AC category-10 ceiling below).
        // zz[64] is the OUT-OF-RANGE sentinel (2000): reading it as v2 at
        // k == 63 fails the range check, so no k+1 bound check is needed.
        if (run == 0 && static_cast<uint32_t>(v + 1023) < 2047u) {
            const uint64_t e1 = ac_by_val[v + 1024];
            const int v2 = zz[k + 1];
            if (v2 != 0 && static_cast<uint32_t>(v2 + 1023) < 2047u) {
                const uint64_t e2 = ac_by_val[v2 + 1024];
                const int l1 = static_cast<int>(e1 >> 32);
                const int l2 = static_cast<int>(e2 >> 32);
                if (l1 + l2 <= 32) {
                    // extend to 3- and 4-code groups while they fit one
                    // 32-bit append: q100 SAR codes average ~5.4 bits, so
                    // most groups of four fit (measured 65.0 → 58.8 ms
                    // phase-fair on the 2048² frame, byte-identical). A
                    // group can only grow while k + n <= 64, and zz[64]
                    // (the out-of-range sentinel) stops it, so no bound
                    // checks are needed.
                    const int v3 = zz[k + 2];
                    if (v3 != 0 && static_cast<uint32_t>(v3 + 1023) < 2047u) {
                        const uint64_t e3 = ac_by_val[v3 + 1024];
                        const int l3 = static_cast<int>(e3 >> 32);
                        if (l1 + l2 + l3 <= 32) {
                            const int v4 = zz[k + 3];
                            if (v4 != 0 &&
                                static_cast<uint32_t>(v4 + 1023) < 2047u) {
                                const uint64_t e4 = ac_by_val[v4 + 1024];
                                const int l4 = static_cast<int>(e4 >> 32);
                                if (l1 + l2 + l3 + l4 <= 32) {
                                    bw.put(((((((e1 & 0xFFFFFFFFu) << l2)
                                               | (e2 & 0xFFFFFFFFu)) << l3)
                                             | (e3 & 0xFFFFFFFFu)) << l4)
                                               | (e4 & 0xFFFFFFFFu),
                                           l1 + l2 + l3 + l4);
                                    k += 4;
                                    continue;
                                }
                            }
                            bw.put(((((e1 & 0xFFFFFFFFu) << l2)
                                     | (e2 & 0xFFFFFFFFu)) << l3)
                                       | (e3 & 0xFFFFFFFFu),
                                   l1 + l2 + l3);
                            k += 3;
                            continue;
                        }
                    }
                    bw.put(((e1 & 0xFFFFFFFFu) << l2) | (e2 & 0xFFFFFFFFu),
                           l1 + l2);
                    k += 2;
                    continue;
                }
            }
            bw.put(static_cast<uint32_t>(e1), static_cast<int>(e1 >> 32));
            ++k;
            continue;
        }
        while (run > 15) {
            bw.put(ac.code[0xF0], ac.len[0xF0]);  // ZRL
            run -= 16;
        }
        // baseline AC categories stop at 10 (|v| <= 1023); 8-bit-input
        // DCTs stay within ±1016, so this clamp only fires on
        // out-of-range external coefficient input
        if (v > 1023) v = 1023;
        else if (v < -1023) v = -1023;
        const int s = bit_category(v);
        const int sym = (run << 4) | s;
        const uint32_t valbits =
            static_cast<uint32_t>(v >= 0 ? v : v - 1) & ((1u << s) - 1);
        bw.put((static_cast<uint64_t>(ac.code[sym]) << s) | valbits,
               ac.len[sym] + s);
        ++k;
    }
}

// Load one 8x8 block from a u8 plane with edge replication, level-shifted.
static inline void load_block(const uint8_t* plane, int64_t w, int64_t h,
                              int64_t bx, int64_t by, float out[64]) {
    const int64_t x0 = bx * 8, y0 = by * 8;
    if (x0 + 8 <= w && y0 + 8 <= h) {
#if defined(__AVX2__)
        const __m256 off = _mm256_set1_ps(128.0f);
        for (int r = 0; r < 8; ++r) {
            const __m128i b = _mm_loadl_epi64(reinterpret_cast<const __m128i*>(
                plane + (y0 + r) * w + x0));
            _mm256_storeu_ps(out + r * 8, _mm256_sub_ps(
                _mm256_cvtepi32_ps(_mm256_cvtepu8_epi32(b)), off));
        }
#else
        for (int r = 0; r < 8; ++r) {
            const uint8_t* p = plane + (y0 + r) * w + x0;
            for (int c = 0; c < 8; ++c)
                out[r * 8 + c] = static_cast<float>(p[c]) - 128.0f;
        }
#endif
        return;
    }
    for (int r = 0; r < 8; ++r) {
        const int64_t y = y0 + r < h ? y0 + r : h - 1;
        const uint8_t* p = plane + y * w;
        for (int c = 0; c < 8; ++c) {
            const int64_t x = x0 + c < w ? x0 + c : w - 1;
            out[r * 8 + c] = static_cast<float>(p[x]) - 128.0f;
        }
    }
}

static void emit_headers(BitWriter& bw, int w, int h, int ncomp,
                         int restart_interval) {
    auto u16be = [&](int v) {
        bw.byte(static_cast<uint8_t>(v >> 8));
        bw.byte(static_cast<uint8_t>(v & 0xFF));
    };
    bw.byte(0xFF); bw.byte(0xD8);  // SOI
    // APP0 JFIF
    bw.byte(0xFF); bw.byte(0xE0); u16be(16);
    const uint8_t jfif[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    bw.bytes(jfif, sizeof(jfif));
    // DQT: all-ones tables (quality 100)
    for (int t = 0; t < (ncomp == 1 ? 1 : 2); ++t) {
        bw.byte(0xFF); bw.byte(0xDB); u16be(67);
        bw.byte(static_cast<uint8_t>(t));
        for (int i = 0; i < 64; ++i) bw.byte(1);
    }
    // SOF0
    bw.byte(0xFF); bw.byte(0xC0); u16be(8 + 3 * ncomp);
    bw.byte(8); u16be(h); u16be(w); bw.byte(static_cast<uint8_t>(ncomp));
    for (int c = 0; c < ncomp; ++c) {
        bw.byte(static_cast<uint8_t>(c + 1));
        bw.byte(0x11);  // 1x1 sampling (4:4:4)
        bw.byte(c == 0 ? 0 : 1);
    }
    // DHT
    auto dht = [&](int cls, int id, const uint8_t* bits, const uint8_t* vals) {
        int n = 0;
        for (int l = 1; l <= 16; ++l) n += bits[l];
        bw.byte(0xFF); bw.byte(0xC4); u16be(19 + n);
        bw.byte(static_cast<uint8_t>((cls << 4) | id));
        for (int l = 1; l <= 16; ++l) bw.byte(bits[l]);
        bw.bytes(vals, n);
    };
    dht(0, 0, kDcLumBits, kDcLumVals);
    dht(1, 0, kAcLumBits, kAcLumVals);
    if (ncomp == 3) {
        dht(0, 1, kDcChrBits, kDcChrVals);
        dht(1, 1, kAcChrBits, kAcChrVals);
    }
    if (restart_interval > 0) {  // DRI
        bw.byte(0xFF); bw.byte(0xDD); u16be(4);
        u16be(restart_interval);
    }
    // SOS
    bw.byte(0xFF); bw.byte(0xDA); u16be(6 + 2 * ncomp);
    bw.byte(static_cast<uint8_t>(ncomp));
    for (int c = 0; c < ncomp; ++c) {
        bw.byte(static_cast<uint8_t>(c + 1));
        bw.byte(c == 0 ? 0x00 : 0x11);
    }
    bw.byte(0); bw.byte(63); bw.byte(0);
}

// Block sources: where the quantized (q100: just rounded) coefficients come
// from. PixelSource runs the host DCT on u8 planes; CoeffSource consumes
// pre-quantized int16 blocks the device DCT emitted (transposed 8x8 layout,
// block raster order) — the device computes the JPEG front-end (level shift +
// FDCT + quantize) in-graph and the host pays entropy coding only.
// Both emit the block ZIGZAG-ORDERED as contiguous int16 into zz[0..63]
// with a sentinel at zz[64]: nonzero (stops the zero-run scan with no
// bound check) AND outside the value-keyed table range (fails the pair
// path's range check, so reading it as v2 at k == 63 is harmless).
static const int16_t kSentinel = 2000;
struct PixelSource {
    const uint8_t* const* planes;
    int64_t w, h;
    inline void get_zz(int64_t bx, int64_t by, int c, int16_t zz[66]) const {
        float fblock[64];
        int32_t coeffs[64];
        load_block(planes[c], w, h, bx, by, fblock);
        fdct8x8(fblock, coeffs);
        // 8-bit-input DCT coefficients are bounded |c| <= 1024: int16-safe
        for (int i = 0; i < 64; ++i)
            zz[i] = static_cast<int16_t>(coeffs[kZigzagT[i]]);
        zz[64] = kSentinel;
    }
};

struct CoeffSource {
    const int16_t* const* comps;  // per-component (bh_n*bw_n*64) int16
    int64_t bw_n;
    inline void get_zz(int64_t bx, int64_t by, int c, int16_t zz[66]) const {
        const int16_t* p = comps[c] + (by * bw_n + bx) * 64;
#if defined(__AVX512BW__)
        // the whole 64-coeff block is two zmm registers: zigzag reorder is
        // two cross-register word permutes (replaces the int32 widening
        // copy + 64 scalar index-table loads in the scan)
        const __m512i a = _mm512_loadu_si512(p);
        const __m512i b = _mm512_loadu_si512(p + 32);
        const __m512i i0 = _mm512_load_si512(gZzPerm);
        const __m512i i1 = _mm512_load_si512(gZzPerm + 32);
        _mm512_storeu_si512(zz, _mm512_permutex2var_epi16(a, i0, b));
        _mm512_storeu_si512(zz + 32, _mm512_permutex2var_epi16(a, i1, b));
#else
        for (int i = 0; i < 64; ++i) zz[i] = p[kZigzagT[i]];
#endif
        zz[64] = kSentinel;
    }
};

// Encode MCU rows [by0, by1) of all components into `bw` (DC predictors
// reset at band start — JPEG restart-interval semantics), byte-padded.
template <typename Source>
static bool encode_band(const Source& src, int ncomp,
                        int64_t w, int64_t h, int64_t by0, int64_t by1,
                        BitWriter& bw) {
    const int64_t bw_n = (w + 7) / 8;
    int dc[3] = {0, 0, 0};
    alignas(64) int16_t zz[66];
    for (int64_t by = by0; by < by1; ++by) {
        for (int64_t bx = 0; bx < bw_n; ++bx) {
            for (int c = 0; c < ncomp; ++c) {
                src.get_zz(bx, by, c, zz);
                encode_block(bw, zz, dc[c],
                             c == 0 ? gDcLum : gDcChr,
                             c == 0 ? gAcLum : gAcChr,
                             c == 0 ? gAcLumByVal : gAcChrByVal);
                if (!bw.ok) return false;
            }
        }
    }
    bw.flush_bits();
    return bw.ok;
}

// Shared driver. n_threads <= 1 emits the classic single-scan stream (no
// DRI). n_threads > 1 splits MCU rows into bands encoded in parallel and
// joined with restart markers (DRI = MCUs per band) — JPEG's only legal
// way to parallelize baseline entropy coding. Single-core hosts see no
// change; multi-core production hosts scale the dominant q100 entropy
// stage nearly linearly.
template <typename Source>
static int64_t encode_multi(const Source& src, int ncomp,
                            int64_t w, int64_t h, uint8_t* out, int64_t cap,
                            int n_threads) {
    init_tables();
    const int64_t bw_n = (w + 7) / 8, bh_n = (h + 7) / 8;
    int64_t bands = n_threads < 1 ? 1 : n_threads;
    if (bands > bh_n) bands = bh_n;
    int64_t band_rows = (bh_n + bands - 1) / bands;
    // DRI is u16 MCUs: shrink bands if a band would exceed it
    if (bands > 1 && band_rows * bw_n > 65535) {
        band_rows = 65535 / bw_n;
        if (band_rows < 1) bands = 1;  // absurdly wide image: single scan
        else bands = (bh_n + band_rows - 1) / band_rows;
    }
    if (bands <= 1) {
        BitWriter bw{out, cap};
        emit_headers(bw, static_cast<int>(w), static_cast<int>(h), ncomp, 0);
        if (!encode_band(src, ncomp, w, h, 0, bh_n, bw)) return -1;
        bw.byte(0xFF); bw.byte(0xD9);  // EOI
        return bw.ok ? bw.pos : -1;
    }
    const int restart = static_cast<int>(band_rows * bw_n);
    std::vector<std::vector<uint8_t>> bufs(bands);
    std::vector<int64_t> lens(bands, -1);
    std::atomic<int64_t> cursor{0};
    auto worker = [&]() {
        for (;;) {
            const int64_t b = cursor.fetch_add(1);
            if (b >= bands) return;
            const int64_t by0 = b * band_rows;
            const int64_t by1 = by0 + band_rows < bh_n ? by0 + band_rows : bh_n;
            // worst case ~27 bits/coeff + stuffing: 5 bytes/px/comp is safe
            bufs[b].resize((by1 - by0) * 8 * w * ncomp * 5 + (1 << 16));
            BitWriter bw{bufs[b].data(), static_cast<int64_t>(bufs[b].size())};
            lens[b] = encode_band(src, ncomp, w, h, by0, by1, bw)
                          ? bw.pos : -1;
        }
    };
    {
        std::vector<std::thread> pool;
        for (int t = 0; t < n_threads && t < bands; ++t)
            pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
    BitWriter bw{out, cap};
    emit_headers(bw, static_cast<int>(w), static_cast<int>(h), ncomp, restart);
    for (int64_t b = 0; b < bands; ++b) {
        if (lens[b] < 0) return -1;
        bw.bytes(bufs[b].data(), lens[b]);
        if (b + 1 < bands) {  // RSTm between intervals
            bw.byte(0xFF);
            bw.byte(static_cast<uint8_t>(0xD0 + (b & 7)));
        }
        if (!bw.ok) return -1;
    }
    bw.byte(0xFF); bw.byte(0xD9);  // EOI
    return bw.ok ? bw.pos : -1;
}

}  // namespace

extern "C" {

// Planar YCbCr 4:4:4 → baseline JPEG q100. Returns bytes written, -1 on
// overflow. Planes are u8 row-major h*w (full-range JFIF YCbCr).
// n_threads > 1 parallelizes entropy coding via restart intervals.
int64_t jpeg_encode_ycbcr444(const uint8_t* y, const uint8_t* cb,
                             const uint8_t* cr, int64_t w, int64_t h,
                             uint8_t* out, int64_t cap, int32_t n_threads) {
    const uint8_t* planes[3] = {y, cb, cr};
    const PixelSource src{planes, w, h};
    return encode_multi(src, 3, w, h, out, cap, n_threads);
}

// Grayscale u8 → baseline JPEG q100.
int64_t jpeg_encode_gray(const uint8_t* y, int64_t w, int64_t h,
                         uint8_t* out, int64_t cap, int32_t n_threads) {
    const uint8_t* planes[3] = {y, nullptr, nullptr};
    const PixelSource src{planes, w, h};
    return encode_multi(src, 1, w, h, out, cap, n_threads);
}

// Pre-quantized DCT coefficients → baseline JPEG q100 (entropy-only host
// path: the device computes level shift + FDCT + rounding in the fused XLA
// program). Each component is (ceil(h/8)*ceil(w/8)) consecutive 64-coeff
// int16 blocks in block raster order, each block the TRANSPOSED 8x8
// coefficient matrix row-major (the same layout fdct8x8 emits).
int64_t jpeg_encode_coeffs444(const int16_t* y, const int16_t* cb,
                              const int16_t* cr, int64_t w, int64_t h,
                              uint8_t* out, int64_t cap, int32_t n_threads) {
    const int16_t* comps[3] = {y, cb, cr};
    const CoeffSource src{comps, (w + 7) / 8};
    return encode_multi(src, 3, w, h, out, cap, n_threads);
}

int64_t jpeg_encode_coeffs_gray(const int16_t* y, int64_t w, int64_t h,
                                uint8_t* out, int64_t cap, int32_t n_threads) {
    const int16_t* comps[3] = {y, nullptr, nullptr};
    const CoeffSource src{comps, (w + 7) / 8};
    return encode_multi(src, 1, w, h, out, cap, n_threads);
}

}  // extern "C"
