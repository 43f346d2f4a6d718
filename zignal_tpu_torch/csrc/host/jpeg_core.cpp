// JPEG decoder (host side, C++).
//
// Covers the reference's decode scope (reference: src/codecs/jpeg.zig):
// baseline + progressive DCT, Huffman coding, DQT/DHT/SOF0/1/2/SOS/DRI,
// restart markers, arbitrary 1-4x sampling factors (4:4:4/4:2:2/4:2:0),
// grayscale and YCbCr. Coefficients are fully buffered, then dequantized,
// IDCT'd (AAN float) and color-converted with the same fixed-point BT.601
// math as the color stack (src/color.zig:1057-1078).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <chrono>
#include <vector>

namespace {

// ZT_JPEG_PROFILE=1 prints per-stage wall times to stderr (entropy /
// IDCT / upsample+color) so stage costs can be attributed without a
// separate instrumented build.
inline bool prof_enabled() {
    static const bool on = std::getenv("ZT_JPEG_PROFILE") != nullptr;
    return on;
}

inline double prof_now() {
    return std::chrono::duration<double>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

struct HuffTable {
    // canonical code -> value decode via count/offset tables, plus an
    // 8-bit prefix LUT that resolves ~99% of symbols in one lookup,
    // plus a 12-bit FUSED AC LUT that resolves run/size AND the
    // extended coefficient value in one lookup when the whole
    // (code + value bits) fits 12 bits — the common case even in
    // high-bitrate images, where 9-14-bit codes made the 8-bit LUT
    // fall back to a linear length scan per coefficient.
    uint8_t counts[17] = {0};
    uint8_t values[256] = {0};
    int32_t mincode[17] = {0};
    int32_t maxcode[18] = {0};
    int32_t valptr[17] = {0};
    uint8_t lut_len[256] = {0};  // 0 = code longer than 8 bits
    uint8_t lut_val[256] = {0};
    // lut12 entry: bits0-4 total consumed bits (code + value bits for
    // regular coefficients — the value bits are extracted branchlessly
    // from the pre-shift 64-bit window, so code+value may exceed the
    // 12-bit LUT index), bits5-8 run, bits9-12 size s, bit13 EOB,
    // bit14 ZRL, bit15 slow (code longer than 12 bits). One predicted-
    // rare branch covers EOB/ZRL/slow together; the regular path has
    // NO data-dependent branches (the old fused/non-fused split
    // mispredicted constantly on noisy content where value sizes
    // straddle the 12-bit fusion boundary).
    int32_t lut12[4096];
    bool present = false;

    static const int32_t L12_EOB = 1 << 13;
    static const int32_t L12_ZRL = 1 << 14;
    static const int32_t L12_SLOW = 1 << 15;
    static const int32_t L12_RARE = L12_EOB | L12_ZRL | L12_SLOW;

    // false when the counts over-subscribe the code space (corrupt
    // stream — a canonical code of length l must fit in l bits)
    bool build() {
        int code = 0, k = 0;
        std::memset(lut_len, 0, sizeof lut_len);
        for (int l = 1; l <= 16; ++l) {
            valptr[l] = k;
            mincode[l] = code;
            if (counts[l] && code + counts[l] - 1 > (1 << l) - 1)
                return false;
            for (int i = 0; i < counts[l]; ++i, ++k, ++code) {
                if (l <= 8) {
                    int base = code << (8 - l);
                    for (int j = 0; j < (1 << (8 - l)); ++j) {
                        lut_len[base + j] = (uint8_t)l;
                        lut_val[base + j] = values[k];
                    }
                }
            }
            maxcode[l] = code - 1;
            code <<= 1;
        }
        maxcode[17] = 0x7FFFFFFF;
        build_lut12();
        return true;
    }

    void build_lut12() {
        for (int idx = 0; idx < 4096; ++idx) {
            // decode the symbol from the 12-bit window
            int L = 0, sym = -1;
            int c = 0;
            for (int l = 1; l <= 12; ++l) {
                c = idx >> (12 - l);
                if (counts[l] && c <= maxcode[l]) {
                    L = l;
                    sym = values[valptr[l] + c - mincode[l]];
                    break;
                }
            }
            if (sym < 0) { lut12[idx] = L12_SLOW; continue; }
            int r = sym >> 4, s = sym & 15;
            if (s == 0) {
                lut12[idx] = r == 15 ? (L | L12_ZRL) : (L | L12_EOB);
                continue;
            }
            lut12[idx] = (L + s) | (r << 5) | (s << 9);
        }
    }
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int dc_tbl = 0, ac_tbl = 0;
    int dc_pred = 0;
    int bx = 0, by = 0;          // blocks per row / col allocated
    std::vector<int16_t> coef;   // bx*by*64
};

struct BitReader {
    // 64-bit MSB-aligned buffer refilled a byte at a time with
    // 0xFF00-unstuffing; refill never consumes past a marker, so `pos`
    // points at the 0xFF when `marker_hit` is set (restart handling
    // relies on this). At end of data / marker the buffer's tail reads
    // as zeros, matching the old reader's zero-padding semantics.
    const uint8_t* data;
    int64_t len, pos;
    uint64_t buf = 0;  // next bit = MSB
    int cnt = 0;       // number of real (non-pad) bits in buf
    bool marker_hit = false;

    inline void refill() {
        // bulk fast path: load 8 bytes at once when none is 0xFF
        if (cnt <= 56 && pos + 8 <= len) {
            uint64_t w;
            std::memcpy(&w, data + pos, 8);
            uint64_t v = ~w;  // byte == 0xFF  <=>  ~byte == 0x00
            if (!((v - 0x0101010101010101ULL) & ~v
                  & 0x8080808080808080ULL)) {
                int nbytes = (63 - cnt) >> 3;
                uint64_t be = __builtin_bswap64(w)
                              & (~0ULL << (64 - 8 * nbytes));
                buf |= be >> cnt;
                cnt += 8 * nbytes;
                pos += nbytes;
                return;
            }
        }
        while (cnt <= 56) {
            if (pos >= len) return;  // EOF: cnt stops growing
            uint8_t b = data[pos];
            if (b == 0xFF) {
                if (pos + 1 < len && data[pos + 1] == 0x00) {
                    pos += 2;  // stuffed 0xFF data byte
                } else {
                    marker_hit = true;  // marker (incl. RSTn) or dangling FF
                    return;
                }
            } else {
                pos++;
            }
            buf |= (uint64_t)b << (56 - cnt);
            cnt += 8;
        }
    }

    // returns bit or -1 at marker/end
    inline int bit() {
        if (cnt < 1) {
            refill();
            if (cnt < 1) return -1;
        }
        int v = (int)(buf >> 63);
        buf <<= 1;
        cnt--;
        return v;
    }

    inline int bits(int n) {
        if (n <= 0) return 0;
        if (cnt < n) {
            refill();
            if (cnt < n) {
                // truncated: high bits = whatever is real, low bits zero
                int v = (int)(buf >> (64 - n));
                buf = 0;
                cnt = 0;
                return v;
            }
        }
        int v = (int)(buf >> (64 - n));
        buf <<= n;
        cnt -= n;
        return v;
    }

    void reset() { buf = 0; cnt = 0; marker_hit = false; }
};

inline int huff_decode(BitReader& br, const HuffTable& t) {
    if (br.cnt < 16) br.refill();
    if (br.cnt >= 8) {
        // one-lookup fast path for codes <= 8 bits (~99% of symbols)
        int idx = (int)(br.buf >> 56);
        int l = t.lut_len[idx];
        if (l) {
            br.buf <<= l;
            br.cnt -= l;
            return t.lut_val[idx];
        }
        if (br.cnt >= 16) {
            int code16 = (int)(br.buf >> 48);
            for (int l2 = 9; l2 <= 16; ++l2) {
                int c = code16 >> (16 - l2);
                if (t.counts[l2] && c <= t.maxcode[l2]) {
                    br.buf <<= l2;
                    br.cnt -= l2;
                    return t.values[t.valptr[l2] + c - t.mincode[l2]];
                }
            }
            return -1;  // invalid code
        }
    }
    // slow path near stream end (marker/EOF): bit-by-bit, -1 on pad
    int code = 0;
    for (int l = 1; l <= 16; ++l) {
        int b = br.bit();
        if (b < 0) return -1;
        code = (code << 1) | b;
        if (t.counts[l] && code <= t.maxcode[l]) {
            return t.values[t.valptr[l] + code - t.mincode[l]];
        }
    }
    return -1;
}

inline int extend(int v, int n) {
    return (n && v < (1 << (n - 1))) ? v - (1 << n) + 1 : v;
}

// AAN IDCT output scale s[u]*s[v]/8 (s[0]=1, s[k]=sqrt(2)*cos(k*pi/16)),
// folded into dequantization (see idct8x8).
static const double kAanScale[8] = {
    1.0, 1.387039845, 1.306562965, 1.175875602,
    1.0, 0.785694958, 0.541196100, 0.275899379,
};

const uint8_t ZIGZAG[64] = {
    0,  1,  8, 16,  9,  2,  3, 10,
   17, 24, 32, 25, 18, 11,  4,  5,
   12, 19, 26, 33, 40, 48, 41, 34,
   27, 20, 13,  6,  7, 14, 21, 28,
   35, 42, 49, 56, 57, 50, 43, 36,
   29, 22, 15, 23, 30, 37, 44, 51,
   58, 59, 52, 45, 38, 31, 39, 46,
   53, 60, 61, 54, 47, 55, 62, 63,
};

// Separable float AAN IDCT, 8x8 (Arai-Agui-Nakajima fast DCT flowgraph
// from the textbook description; 5 multiplies per 1-D transform). The
// AAN output scale s[u]*s[v]/8 (s[0]=1, s[k]=sqrt(2)*cos(k*pi/16)) is
// folded into the dequantization table by the caller. Validated against
// the direct basis-product IDCT to < 1e-3 over random +/-500 inputs.
// Column pass with x innermost: the same butterfly runs on all 8
// columns per step, which the compiler turns into 8-wide SIMD.
static inline void aan_cols(float* b) {
    for (int x = 0; x < 8; ++x) {
        float s0 = b[0 * 8 + x], s1 = b[1 * 8 + x], s2 = b[2 * 8 + x];
        float s3 = b[3 * 8 + x], s4 = b[4 * 8 + x], s5 = b[5 * 8 + x];
        float s6 = b[6 * 8 + x], s7 = b[7 * 8 + x];
        float t10 = s0 + s4;
        float t11 = s0 - s4;
        float t13 = s2 + s6;
        float t12 = (s2 - s6) * 1.414213562f - t13;
        float e0 = t10 + t13;
        float e3 = t10 - t13;
        float e1 = t11 + t12;
        float e2 = t11 - t12;
        float z13 = s5 + s3;
        float z10 = s5 - s3;
        float z11 = s1 + s7;
        float z12 = s1 - s7;
        float t7 = z11 + z13;
        float t11b = (z11 - z13) * 1.414213562f;
        float z5 = (z10 + z12) * 1.847759065f;
        float t10b = 1.082392200f * z12 - z5;
        float t12b = -2.613125930f * z10 + z5;
        float t6 = t12b - t7;
        float t5 = t11b - t6;
        float t4 = t10b + t5;
        b[0 * 8 + x] = e0 + t7;
        b[7 * 8 + x] = e0 - t7;
        b[1 * 8 + x] = e1 + t6;
        b[6 * 8 + x] = e1 - t6;
        b[2 * 8 + x] = e2 + t5;
        b[5 * 8 + x] = e2 - t5;
        b[4 * 8 + x] = e3 + t4;
        b[3 * 8 + x] = e3 - t4;
    }
}

// Register-resident variant: the whole 2-D transform lives in eight
// 8-float GCC vector registers — the butterflies are elementwise vector
// ops across registers and the two transposes are 24-shuffle networks
// (__builtin_shufflevector), so no scalar transpose loads/stores touch
// memory. The scalar fallback above keeps the math definition readable;
// per-element operations and their order are identical, so outputs are
// bit-identical.
typedef float v8f __attribute__((vector_size(32)));

static inline v8f load8f(const float* p) {
    v8f v;
    std::memcpy(&v, p, 32);
    return v;
}

#define ZT_SHUF(a, b, ...) __builtin_shufflevector(a, b, __VA_ARGS__)

static inline void transpose8(v8f r[8]) {
    v8f t0 = ZT_SHUF(r[0], r[1], 0, 8, 1, 9, 4, 12, 5, 13);
    v8f t1 = ZT_SHUF(r[0], r[1], 2, 10, 3, 11, 6, 14, 7, 15);
    v8f t2 = ZT_SHUF(r[2], r[3], 0, 8, 1, 9, 4, 12, 5, 13);
    v8f t3 = ZT_SHUF(r[2], r[3], 2, 10, 3, 11, 6, 14, 7, 15);
    v8f t4 = ZT_SHUF(r[4], r[5], 0, 8, 1, 9, 4, 12, 5, 13);
    v8f t5 = ZT_SHUF(r[4], r[5], 2, 10, 3, 11, 6, 14, 7, 15);
    v8f t6 = ZT_SHUF(r[6], r[7], 0, 8, 1, 9, 4, 12, 5, 13);
    v8f t7 = ZT_SHUF(r[6], r[7], 2, 10, 3, 11, 6, 14, 7, 15);
    v8f u0 = ZT_SHUF(t0, t2, 0, 1, 8, 9, 4, 5, 12, 13);
    v8f u1 = ZT_SHUF(t0, t2, 2, 3, 10, 11, 6, 7, 14, 15);
    v8f u2 = ZT_SHUF(t1, t3, 0, 1, 8, 9, 4, 5, 12, 13);
    v8f u3 = ZT_SHUF(t1, t3, 2, 3, 10, 11, 6, 7, 14, 15);
    v8f u4 = ZT_SHUF(t4, t6, 0, 1, 8, 9, 4, 5, 12, 13);
    v8f u5 = ZT_SHUF(t4, t6, 2, 3, 10, 11, 6, 7, 14, 15);
    v8f u6 = ZT_SHUF(t5, t7, 0, 1, 8, 9, 4, 5, 12, 13);
    v8f u7 = ZT_SHUF(t5, t7, 2, 3, 10, 11, 6, 7, 14, 15);
    r[0] = ZT_SHUF(u0, u4, 0, 1, 2, 3, 8, 9, 10, 11);
    r[4] = ZT_SHUF(u0, u4, 4, 5, 6, 7, 12, 13, 14, 15);
    r[1] = ZT_SHUF(u1, u5, 0, 1, 2, 3, 8, 9, 10, 11);
    r[5] = ZT_SHUF(u1, u5, 4, 5, 6, 7, 12, 13, 14, 15);
    r[2] = ZT_SHUF(u2, u6, 0, 1, 2, 3, 8, 9, 10, 11);
    r[6] = ZT_SHUF(u2, u6, 4, 5, 6, 7, 12, 13, 14, 15);
    r[3] = ZT_SHUF(u3, u7, 0, 1, 2, 3, 8, 9, 10, 11);
    r[7] = ZT_SHUF(u3, u7, 4, 5, 6, 7, 12, 13, 14, 15);
}

// same flowgraph as aan_cols, one step = one vector op across registers;
// templated so the 8-lane (one block) and 16-lane (two blocks, AVX-512)
// variants share the exact per-element operations
template <typename V>
static inline void aan_v(V r[8]) {
    V s0 = r[0], s1 = r[1], s2 = r[2], s3 = r[3];
    V s4 = r[4], s5 = r[5], s6 = r[6], s7 = r[7];
    V t10 = s0 + s4;
    V t11 = s0 - s4;
    V t13 = s2 + s6;
    V t12 = (s2 - s6) * 1.414213562f - t13;
    V e0 = t10 + t13;
    V e3 = t10 - t13;
    V e1 = t11 + t12;
    V e2 = t11 - t12;
    V z13 = s5 + s3;
    V z10 = s5 - s3;
    V z11 = s1 + s7;
    V z12 = s1 - s7;
    V t7 = z11 + z13;
    V t11b = (z11 - z13) * 1.414213562f;
    V z5 = (z10 + z12) * 1.847759065f;
    V t10b = 1.082392200f * z12 - z5;
    V t12b = -2.613125930f * z10 + z5;
    V t6 = t12b - t7;
    V t5 = t11b - t6;
    V t4 = t10b + t5;
    r[0] = e0 + t7;
    r[7] = e0 - t7;
    r[1] = e1 + t6;
    r[6] = e1 - t6;
    r[2] = e2 + t5;
    r[5] = e2 - t5;
    r[4] = e3 + t4;
    r[3] = e3 - t4;
}

static inline void aan_v8(v8f r[8]) { aan_v(r); }

typedef int16_t v8i16 __attribute__((vector_size(16)));

// blk: natural-order int16 coefficients; dqs: AAN-scaled dequant table.
// The dequant multiply happens in the vector loads (int16 -> f32 convert
// is exact), so the 64-float intermediate never touches memory.
void idct8x8(const int16_t* blk, const float* dqs, uint8_t* out,
             int out_stride) {
    v8f r[8];
    for (int v = 0; v < 8; ++v) {
        v8i16 c;
        std::memcpy(&c, blk + v * 8, 16);
        r[v] = __builtin_convertvector(c, v8f) * load8f(dqs + v * 8);
    }
    transpose8(r);  // r[u] = coefficient column u
    aan_v8(r);      // row transforms, 8 at a time
    transpose8(r);
    aan_v8(r);
    float b[64];
    for (int y = 0; y < 8; ++y) std::memcpy(b + y * 8, &r[y], 32);
    for (int y = 0; y < 8; ++y) {
        const float* row = b + y * 8;
        uint8_t* o = out + (size_t)y * out_stride;
        for (int x = 0; x < 8; ++x) {
            // lrintf compiles to one cvt instruction (round-to-nearest-
            // even; JPEG decoders legitimately differ at exact halves)
            int v = (int)lrintf(row[x]) + 128;
            o[x] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
        }
    }
}

// Planar r/g/b rows -> interleaved rgb row. The scalar form is three
// strided stores per pixel, which the vectorizer refuses; two chained
// 16-lane byte shuffles build each 16-byte output chunk instead
// (3 chunks per 16 px). Order is exactly o[3x]=r, o[3x+1]=g, o[3x+2]=b.
typedef uint8_t v16u8 __attribute__((vector_size(16)));

static inline v16u8 load16u8(const uint8_t* p) {
    v16u8 v;
    std::memcpy(&v, p, 16);
    return v;
}

static void interleave3(const uint8_t* r, const uint8_t* g,
                        const uint8_t* b, uint8_t* o, int n) {
    int x = 0;
    for (; x + 16 <= n; x += 16) {
        v16u8 vr = load16u8(r + x), vg = load16u8(g + x),
              vb = load16u8(b + x);
        v16u8 t0 = ZT_SHUF(vr, vg, 0, 16, 0, 1, 17, 0, 2, 18, 0, 3, 19, 0,
                           4, 20, 0, 5);
        v16u8 o0 = ZT_SHUF(t0, vb, 0, 1, 16, 3, 4, 17, 6, 7, 18, 9, 10, 19,
                           12, 13, 20, 15);
        v16u8 t1 = ZT_SHUF(vr, vg, 21, 0, 6, 22, 0, 7, 23, 0, 8, 24, 0, 9,
                           25, 0, 10, 26);
        v16u8 o1 = ZT_SHUF(t1, vb, 0, 21, 2, 3, 22, 5, 6, 23, 8, 9, 24, 11,
                           12, 25, 14, 15);
        v16u8 t2 = ZT_SHUF(vr, vg, 0, 11, 27, 0, 12, 28, 0, 13, 29, 0, 14,
                           30, 0, 15, 31, 0);
        v16u8 o2 = ZT_SHUF(t2, vb, 26, 1, 2, 27, 4, 5, 28, 7, 8, 29, 10, 11,
                           30, 13, 14, 31);
        std::memcpy(o + 3 * x, &o0, 16);
        std::memcpy(o + 3 * x + 16, &o1, 16);
        std::memcpy(o + 3 * x + 32, &o2, 16);
    }
    for (; x < n; ++x) {
        o[3 * x] = r[x];
        o[3 * x + 1] = g[x];
        o[3 * x + 2] = b[x];
    }
}

// Free function with __restrict on every pointer: six distinct arrays
// feed the BT.601 loop, which exceeds GCC's runtime alias-check budget
// (vect-max-version-for-alias-checks) when they are member-vector
// loads — restrict parameters let it vectorize unconditionally.
static void bt601_row(const uint8_t* __restrict yrow,
                      const uint8_t* __restrict cbb,
                      const uint8_t* __restrict crb,
                      uint8_t* __restrict rb, uint8_t* __restrict gb,
                      uint8_t* __restrict bb, int width) {
    // chroma stays u8 (4x less upsample-buffer traffic; the 4:4:4 case
    // reads the band row directly with no expand pass at all): the -128
    // centering is folded into the rounding constants — identical int32
    // values, and all terms stay well inside int32 (|num| < 2^26).
    const int32_t rk = 32768 - 91881 * 128;
    const int32_t gk = 32768 + (22554 + 46802) * 128;
    const int32_t bk = 32768 - 116130 * 128;
    for (int x = 0; x < width; ++x) {
        int32_t Y = (int32_t)yrow[x] << 16;
        int32_t cb = (int32_t)cbb[x];
        int32_t cr = (int32_t)crb[x];
        int32_t r = (Y + 91881 * cr + rk) >> 16;
        int32_t g = (Y - 22554 * cb - 46802 * cr + gk) >> 16;
        int32_t b = (Y + 116130 * cb + bk) >> 16;
        rb[x] = (uint8_t)(r < 0 ? 0 : r > 255 ? 255 : r);
        gb[x] = (uint8_t)(g < 0 ? 0 : g > 255 ? 255 : g);
        bb[x] = (uint8_t)(b < 0 ? 0 : b > 255 ? 255 : b);
    }
}

// Shared per-row upsample + color-convert pipeline used by both the
// buffered reconstruct() and the band-streaming decode so their outputs
// are byte-identical by construction. Two vectorizable phases per row:
// (1) expand each chroma row to full width into an int32 buffer
// (pixel-doubling fast path for the ubiquitous 2:1 case, generic map
// otherwise) so (2) the BT.601 convert loop reads every operand at
// identity stride — sequential loads + branchless clamps autovectorize,
// where a per-pixel xmap gather would force scalar code.
struct RowPipe {
    int width = 0;
    std::vector<int32_t> xmap[4];
    bool xident[4] = {false, false, false, false};
    bool chalf[4] = {false, false, false, false};
    std::vector<uint8_t> cbbuf, crbuf;
    std::vector<uint8_t> ybuf, rbuf, gbuf, bbuf;

    void init(const Component* comp, int ncomp, int w, int hmax) {
        width = w;
        for (int i = 0; i < ncomp; ++i) {
            xident[i] = comp[i].h == hmax;
            chalf[i] = comp[i].h * 2 == hmax;
            if (!xident[i]) {
                xmap[i].resize(w);
                for (int x = 0; x < w; ++x)
                    xmap[i][x] = x * comp[i].h / hmax;
            }
        }
        cbbuf.resize(w);
        crbuf.resize(w);
        ybuf.resize(w);
        rbuf.resize(w);
        gbuf.resize(w);
        bbuf.resize(w);
    }

    // src chroma row -> full-width u8 row (centering happens inside
    // bt601_row's folded constants)
    void expand_c(const uint8_t* src, int ci, uint8_t* __restrict dst) {
        const int width = this->width;
        if (chalf[ci]) {
            int half = width >> 1;
            for (int x = 0; x < half; ++x) {
                dst[2 * x] = src[x];
                dst[2 * x + 1] = src[x];
            }
            if (width & 1) dst[width - 1] = src[half];
        } else {
            const int32_t* xm = xmap[ci].data();
            for (int x = 0; x < width; ++x)
                dst[x] = src[xm[x]];
        }
    }

    void emit_color(const uint8_t* yrow, const uint8_t* cbrow,
                    const uint8_t* crrow, uint8_t* o) {
        const int width = this->width;
        if (!xident[0]) {
            const int32_t* xm0 = xmap[0].data();
            uint8_t* __restrict yb = ybuf.data();
            for (int x = 0; x < width; ++x) yb[x] = yrow[xm0[x]];
            yrow = ybuf.data();
        }
        if (!xident[1]) {
            expand_c(cbrow, 1, cbbuf.data());
            cbrow = cbbuf.data();
        }
        if (!xident[2]) {
            expand_c(crrow, 2, crbuf.data());
            crrow = crbuf.data();
        }
        // planar convert (interleaved stride-3 stores defeat the
        // vectorizer; planar u8 stores do not), then one interleave
        // pass over literal stride 3
        bt601_row(yrow, cbrow, crrow, rbuf.data(),
                  gbuf.data(), bbuf.data(), width);
        interleave3(rbuf.data(), gbuf.data(), bbuf.data(), o, width);
    }

    void emit_gray(const uint8_t* yrow, uint8_t* o, int out_ncomp) {
        const int width = this->width;
        const int32_t* xm0 = xident[0] ? nullptr : xmap[0].data();
        if (out_ncomp == 1 && !xm0) {
            std::memcpy(o, yrow, width);
        } else {
            for (int x = 0; x < width; ++x, o += out_ncomp) {
                uint8_t v = yrow[xm0 ? xm0[x] : x];
                o[0] = v;
                if (out_ncomp == 3) { o[1] = v; o[2] = v; }
            }
        }
    }
};

struct Decoder {
    const uint8_t* data;
    int64_t len, pos = 0;
    uint16_t qt[4][64] = {{0}};
    HuffTable dc_tables[4], ac_tables[4];
    Component comp[4];
    int ncomp = 0, width = 0, height = 0;
    int hmax = 1, vmax = 1;
    int mcux = 0, mcuy = 0;
    int restart_interval = 0;
    bool progressive = false;
    bool seen_sos = false;
    bool seen_sof = false;
    int eobrun = 0;
    // Band-streaming sequential decode (see decode_sequential_streaming):
    // set by zt_jpeg_decode; when the first scan is a full interleave,
    // entropy decode, IDCT and color conversion run per MCU row with
    // small cache-resident band buffers and no full-image coefficient /
    // plane intermediates. ZT_JPEG_STREAM=0 forces the buffered path
    // (stage profiling / fallback).
    uint8_t* stream_out = nullptr;
    int stream_ncomp = 3;
    bool streamed = false;
    bool coef_alloced = false;
    RowPipe pipe;

    int u8() { return pos < len ? data[pos++] : -1; }
    int u16() {
        int a = u8(), b = u8();
        return (a < 0 || b < 0) ? -1 : (a << 8) | b;
    }

    int parse_headers(bool scan_only_info) {
        if (u16() != 0xFFD8) return -1;  // SOI
        for (;;) {
            int m = u8();
            while (m == 0xFF) m = u8();  // fill bytes; m now low byte
            if (m < 0) return -1;
            int marker = 0xFF00 | m;
            if (marker == 0xFFD9) return seen_sos ? 0 : -1;  // EOI
            if (marker >= 0xFFD0 && marker <= 0xFFD7) continue;
            int L = u16();
            if (L < 2) return -1;
            int64_t seg_end = pos + L - 2;
            switch (marker) {
                case 0xFFC0: case 0xFFC1: case 0xFFC2: {
                    // a second SOF would change dimensions after the
                    // caller sized its output buffer — reject
                    if (seen_sof) return -1;
                    seen_sof = true;
                    progressive = (marker == 0xFFC2);
                    int prec = u8();
                    if (prec != 8) return -2;
                    height = u16();
                    width = u16();
                    ncomp = u8();
                    if (ncomp < 1 || ncomp > 4) return -2;
                    for (int i = 0; i < ncomp; ++i) {
                        comp[i].id = u8();
                        int hv = u8();
                        comp[i].h = hv >> 4;
                        comp[i].v = hv & 15;
                        comp[i].tq = u8();
                        if (comp[i].h < 1 || comp[i].h > 4 ||
                            comp[i].v < 1 || comp[i].v > 4) return -2;
                        if (comp[i].tq < 0 || comp[i].tq > 3) return -1;
                        hmax = comp[i].h > hmax ? comp[i].h : hmax;
                        vmax = comp[i].v > vmax ? comp[i].v : vmax;
                    }
                    if (scan_only_info) return 0;
                    mcux = (width + 8 * hmax - 1) / (8 * hmax);
                    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
                    for (int i = 0; i < ncomp; ++i) {
                        comp[i].bx = mcux * comp[i].h;
                        comp[i].by = mcuy * comp[i].v;
                    }
                    // full coefficient buffers allocate lazily at the
                    // first non-streamable scan (progressive / partial
                    // scans); a streamed decode never needs them
                    break;
                }
                case 0xFFC4: {  // DHT
                    while (pos < seg_end) {
                        int tc_th = u8();
                        int tc = tc_th >> 4, th = tc_th & 15;
                        if (tc > 1 || th > 3) return -1;
                        HuffTable& t = tc ? ac_tables[th] : dc_tables[th];
                        int total = 0;
                        for (int i = 1; i <= 16; ++i) {
                            int c = u8();
                            if (c < 0) return -1;  // truncated segment
                            t.counts[i] = (uint8_t)c;
                            total += c;
                        }
                        if (total > 256) return -1;
                        for (int i = 0; i < total; ++i) t.values[i] = (uint8_t)u8();
                        if (!t.build()) return -1;
                        t.present = true;
                    }
                    break;
                }
                case 0xFFDB: {  // DQT
                    while (pos < seg_end) {
                        int pq_tq = u8();
                        int pq = pq_tq >> 4, tq = pq_tq & 15;
                        if (tq > 3) return -1;
                        for (int i = 0; i < 64; ++i)
                            qt[tq][ZIGZAG[i]] = pq ? (uint16_t)u16() : (uint16_t)u8();
                    }
                    break;
                }
                case 0xFFDD:  // DRI
                    restart_interval = u16();
                    break;
                case 0xFFDA:  // SOS
                    if (scan_only_info) return 0;
                    seen_sos = true;
                    if (decode_scan(seg_end) < 0) return -1;
                    continue;  // more scans (progressive / multi-scan) until EOI
                default:
                    break;  // skip APPn/COM/etc
            }
            if (pos < seg_end) pos = seg_end;
        }
    }

    void alloc_coef() {
        if (coef_alloced) return;
        for (int i = 0; i < ncomp; ++i)
            comp[i].coef.assign((size_t)comp[i].bx * comp[i].by * 64, 0);
        coef_alloced = true;
    }

    Component* find_comp(int id) {
        for (int i = 0; i < ncomp; ++i)
            if (comp[i].id == id) return &comp[i];
        return nullptr;
    }

    int decode_scan(int64_t header_end) {
        if (!seen_sof) return -1;  // SOS before SOF
        int ns = u8();
        if (ns < 1 || ns > 4) return -1;
        Component* scomp[4];
        for (int i = 0; i < ns; ++i) {
            int cs = u8();
            int td_ta = u8();
            Component* c = find_comp(cs);
            if (!c) return -1;
            c->dc_tbl = td_ta >> 4;
            c->ac_tbl = td_ta & 15;
            if (c->dc_tbl > 3 || c->ac_tbl > 3 || td_ta < 0) return -1;
            scomp[i] = c;
        }
        int ss = u8();       // spectral start
        int se = u8();       // spectral end
        int ah_al = u8();
        int ah = ah_al >> 4, al = ah_al & 15;
        if (progressive && (ss < 0 || se < ss || se > 63)) return -1;
        (void)header_end;

        BitReader br{data, len, pos};
        eobrun = 0;
        for (int i = 0; i < ncomp; ++i) comp[i].dc_pred = 0;

        if (!progressive) {
            const char* env = std::getenv("ZT_JPEG_STREAM");
            bool streamable = stream_out && !streamed && !coef_alloced
                              && ns == ncomp && ncomp >= 1
                              && (ns > 1 || (comp[0].h == 1
                                             && comp[0].v == 1))
                              && !(env && env[0] == '0');
            if (streamable) {
                int rc = decode_sequential_streaming(br, scomp, ns);
                pos = br.pos;
                if (rc == 0) streamed = true;
                return rc;
            }
            alloc_coef();
            int rc = decode_sequential(br, scomp, ns);
            pos = br.pos;
            return rc;
        }
        alloc_coef();
        int rc = decode_progressive(br, scomp, ns, ss, se, ah, al);
        pos = br.pos;
        return rc;
    }

    void handle_restart(BitReader& br, int& mcu_count) {
        if (restart_interval && mcu_count == restart_interval) {
            mcu_count = 0;
            // align to byte, expect RSTn (refill stops at markers, so
            // br.pos points at the 0xFF; unconsumed pad bits discarded)
            br.buf = 0;
            br.cnt = 0;
            if (br.pos + 1 < br.len && br.data[br.pos] == 0xFF &&
                br.data[br.pos + 1] >= 0xD0 && br.data[br.pos + 1] <= 0xD7) {
                br.pos += 2;
            }
            br.marker_hit = false;
            for (int i = 0; i < ncomp; ++i) comp[i].dc_pred = 0;
            eobrun = 0;
        }
    }

    // returns -1 on error, else 1 if any AC coefficient was written
    // (0 = DC-only) — lets the streaming path skip both the per-block
    // AC scan and the full IDCT for flat blocks
    int decode_block_seq(BitReader& br, Component* c, int16_t* blk) {
        const HuffTable& dct = dc_tables[c->dc_tbl];
        const HuffTable& act = ac_tables[c->ac_tbl];
        int has_ac = 0;
        int t = huff_decode(br, dct);
        if (t < 0) return br.marker_hit ? has_ac : -1;
        if (t > 15) return -1;  // corrupt table: DC size category > 15
        int diff = t ? extend(br.bits(t), t) : 0;
        c->dc_pred += diff;
        blk[0] = (int16_t)c->dc_pred;
        int k = 1;
        while (k < 64) {
            if (br.cnt < 32) br.refill();
            if (br.cnt >= 32) {
                // fast path: one refill covers symbol (<=16 bits) +
                // receive (<=15 bits). The 12-bit LUT gives total
                // consumed bits + run + size; the value bits come
                // branchlessly from the pre-shift window (cmov
                // extend), so the regular-coefficient path retires
                // with no data-dependent branches.
                int32_t e = act.lut12[(uint32_t)(br.buf >> 52)];
                if (!(e & HuffTable::L12_RARE)) {
                    int consumed = e & 31;
                    uint64_t w = br.buf;
                    br.buf <<= consumed;
                    br.cnt -= consumed;
                    k += (e >> 5) & 15;
                    if (k > 63) break;
                    int s = (e >> 9) & 15;
                    int v = (int)((w >> (64 - consumed)) & ((1 << s) - 1));
                    int val = v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
                    blk[ZIGZAG[k]] = (int16_t)val;
                    has_ac = 1;
                    k++;
                    continue;
                }
                if (!(e & HuffTable::L12_SLOW)) {
                    int consumed = e & 31;
                    br.buf <<= consumed;
                    br.cnt -= consumed;
                    if (e & HuffTable::L12_ZRL) { k += 16; continue; }
                    break;  // EOB
                }
                // code longer than 12 bits: resolve by length scan
                int code16 = (int)(br.buf >> 48);
                int rs = -1;
                for (int l2 = 13; l2 <= 16; ++l2) {
                    int cd = code16 >> (16 - l2);
                    if (act.counts[l2] && cd <= act.maxcode[l2]) {
                        br.buf <<= l2;
                        br.cnt -= l2;
                        rs = act.values[act.valptr[l2] + cd
                                        - act.mincode[l2]];
                        break;
                    }
                }
                if (rs < 0) return -1;  // invalid code (real bits)
                int r = rs >> 4, s = rs & 15;
                if (s == 0) {
                    if (r == 15) { k += 16; continue; }
                    break;  // EOB
                }
                k += r;
                if (k > 63) break;
                int v = (int)(br.buf >> (64 - s));
                br.buf <<= s;
                br.cnt -= s;
                blk[ZIGZAG[k]] = (int16_t)extend(v, s);
                has_ac = 1;
                k++;
                continue;
            }
            // tail near marker/EOF: checked path
            int rs = huff_decode(br, act);
            if (rs < 0) return br.marker_hit ? has_ac : -1;
            int r = rs >> 4, s = rs & 15;
            if (s == 0) {
                if (r == 15) { k += 16; continue; }
                break;  // EOB
            }
            k += r;
            if (k > 63) break;
            blk[ZIGZAG[k]] = (int16_t)extend(br.bits(s), s);
            has_ac = 1;
            k++;
        }
        return has_ac;
    }

    int decode_sequential(BitReader& br, Component** scomp, int ns) {
        int mcu_count = 0;
        if (ns == 1) {
            // non-interleaved single-component scan
            Component* c = scomp[0];
            int bw = (width * c->h / hmax + 7) / 8;
            int bh = (height * c->v / vmax + 7) / 8;
            for (int byi = 0; byi < bh; ++byi) {
                for (int bxi = 0; bxi < bw; ++bxi) {
                    handle_restart(br, mcu_count);
                    int16_t* blk = &c->coef[((size_t)byi * c->bx + bxi) * 64];
                    if (decode_block_seq(br, c, blk) < 0) return -1;
                    mcu_count++;
                }
            }
            return 0;
        }
        for (int my = 0; my < mcuy; ++my) {
            for (int mx = 0; mx < mcux; ++mx) {
                handle_restart(br, mcu_count);
                for (int i = 0; i < ns; ++i) {
                    Component* c = scomp[i];
                    for (int v = 0; v < c->v; ++v) {
                        for (int h = 0; h < c->h; ++h) {
                            int bxi = mx * c->h + h;
                            int byi = my * c->v + v;
                            int16_t* blk = &c->coef[((size_t)byi * c->bx + bxi) * 64];
                            if (decode_block_seq(br, c, blk) < 0) return -1;
                        }
                    }
                }
                mcu_count++;
            }
        }
        return 0;
    }

    // AAN-scaled dequantization table for component ci (see idct8x8)
    void build_dqs(int ci, float* dqs) {
        const uint16_t* q = qt[comp[ci].tq];
        for (int v = 0; v < 8; ++v)
            for (int u = 0; u < 8; ++u)
                dqs[v * 8 + u] = (float)(q[v * 8 + u] * kAanScale[u]
                                         * kAanScale[v] / 8.0);
    }

    // one coefficient block -> 8x8 u8 pixels (DC-only shortcut for
    // constant blocks — very common in smooth regions). has_ac: 1 = AC
    // present, 0 = DC-only, -1 = unknown (buffered paths without the
    // entropy decoder's flag scan the block)
    static void dequant_idct_block(const int16_t* blk, const float* dqs,
                                   uint8_t* dst, int stride,
                                   int has_ac = -1) {
        if (has_ac < 0) {
            int32_t ac = 0;
            for (int k = 1; k < 64; ++k) ac |= blk[k];
            has_ac = ac != 0;
        }
        if (!has_ac) {
            int val = (int)lrintf(blk[0] * dqs[0]) + 128;
            uint8_t px = (uint8_t)(val < 0 ? 0 : val > 255 ? 255 : val);
            for (int yy = 0; yy < 8; ++yy)
                std::memset(dst + (size_t)yy * stride, px, 8);
            return;
        }
        idct8x8(blk, dqs, dst, stride);
    }

    // shared band-decode setup: per-component band buffers (v*8 plane
    // rows), padded widths, dequant tables, and the row pipeline
    void init_bands(std::vector<uint8_t>* band, int* pw,
                    float (*dqs)[64]) {
        for (int i = 0; i < ncomp; ++i) {
            pw[i] = comp[i].bx * 8;
            band[i].assign((size_t)pw[i] * (comp[i].v * 8), 0);
            build_dqs(i, dqs[i]);
        }
        pipe.init(comp, ncomp, width, hmax);
    }

    // emit the output rows MCU row `my` fully determines, reading from
    // per-component band buffers of v*8 plane rows
    void emit_band_rows(int my, const std::vector<uint8_t>* band,
                        const int* pw, uint8_t* out, int out_ncomp) {
        const int band_h = 8 * vmax;
        int y1 = (my + 1) * band_h;
        if (y1 > height) y1 = height;
        for (int y = my * band_h; y < y1; ++y) {
            uint8_t* o = out + (size_t)y * width * out_ncomp;
            if (ncomp >= 3) {
                pipe.emit_color(
                    &band[0][(size_t)(y * comp[0].v / vmax
                                      - my * 8 * comp[0].v) * pw[0]],
                    &band[1][(size_t)(y * comp[1].v / vmax
                                      - my * 8 * comp[1].v) * pw[1]],
                    &band[2][(size_t)(y * comp[2].v / vmax
                                      - my * 8 * comp[2].v) * pw[2]],
                    o);
            } else {
                pipe.emit_gray(
                    &band[0][(size_t)(y * comp[0].v / vmax
                                      - my * 8 * comp[0].v) * pw[0]],
                    o, out_ncomp);
            }
        }
    }

    // Band-streaming sequential decode: entropy decode, dequant+IDCT
    // and upsample/color-convert run per MCU row with band buffers of
    // v*8 plane rows per component — no full-image coefficient or
    // plane intermediates, so for large images every stage works on
    // cache-resident data and each output byte is written exactly once.
    // Gated by decode_scan to full-interleave first scans (ns == ncomp;
    // single-component scans only when h == v == 1, where the block
    // raster IS the MCU raster). Per-block and per-row math is the
    // exact code the buffered path runs (decode_block_seq + RowPipe),
    // so outputs are byte-identical (tests/test_native_parity.py).
    int decode_sequential_streaming(BitReader& br, Component** scomp,
                                    int ns) {
        float dqs[4][64];
        std::vector<uint8_t> band[4];
        int pw[4];
        init_bands(band, pw, dqs);
        int16_t blk[64];
        int mcu_count = 0;
        for (int my = 0; my < mcuy; ++my) {
            for (int mx = 0; mx < mcux; ++mx) {
                handle_restart(br, mcu_count);
                for (int i = 0; i < ns; ++i) {
                    Component* c = scomp[i];
                    int ci = (int)(c - comp);
                    for (int v = 0; v < c->v; ++v) {
                        for (int h = 0; h < c->h; ++h) {
                            std::memset(blk, 0, sizeof blk);
                            int has_ac = decode_block_seq(br, c, blk);
                            if (has_ac < 0) return -1;
                            dequant_idct_block(
                                blk, dqs[ci],
                                &band[ci][(size_t)(v * 8) * pw[ci]
                                          + (size_t)(mx * c->h + h) * 8],
                                pw[ci], has_ac);
                        }
                    }
                }
                mcu_count++;
            }
            emit_band_rows(my, band, pw, stream_out, stream_ncomp);
        }
        return 0;
    }

    int decode_prog_dc(BitReader& br, Component* c, int16_t* blk, int ah, int al) {
        if (ah == 0) {
            const HuffTable& dct = dc_tables[c->dc_tbl];
            int t = huff_decode(br, dct);
            if (t < 0) return br.marker_hit ? 0 : -1;
            if (t > 15) return -1;  // corrupt table: DC size category
            int diff = t ? extend(br.bits(t), t) : 0;
            c->dc_pred += diff;
            blk[0] = (int16_t)((uint32_t)c->dc_pred << al);
        } else {
            if (br.bit() > 0) blk[0] |= (int16_t)(1 << al);
        }
        return 0;
    }

    int decode_prog_ac(BitReader& br, Component* c, int16_t* blk,
                       int ss, int se, int ah, int al) {
        const HuffTable& act = ac_tables[c->ac_tbl];
        if (ah == 0) {
            // first pass
            if (eobrun > 0) { eobrun--; return 0; }
            int k = ss;
            while (k <= se) {
                int rs = huff_decode(br, act);
                if (rs < 0) return br.marker_hit ? 0 : -1;
                int r = rs >> 4, s = rs & 15;
                if (s == 0) {
                    if (r < 15) {
                        eobrun = (1 << r) - 1;
                        if (r) eobrun += br.bits(r);
                        break;
                    }
                    k += 16;
                    continue;
                }
                k += r;
                if (k > 63) break;
                blk[ZIGZAG[k]] = (int16_t)((uint32_t)extend(br.bits(s), s)
                                           << al);
                k++;
            }
            return 0;
        }
        // refinement pass
        int p1 = 1 << al, m1 = -(1 << al);
        int k = ss;
        if (eobrun == 0) {
            while (k <= se) {
                int rs = huff_decode(br, act);
                if (rs < 0) return br.marker_hit ? 0 : -1;
                int r = rs >> 4, s = rs & 15;
                int coef_val = 0;
                if (s == 0) {
                    if (r < 15) {
                        eobrun = (1 << r);
                        if (r) eobrun += br.bits(r);
                        break;
                    }
                    // r == 15: skip 16 zero-history coefficients
                } else {
                    coef_val = br.bit() ? p1 : m1;
                }
                while (k <= se) {
                    int16_t* p = &blk[ZIGZAG[k]];
                    if (*p != 0) {
                        if (br.bit() > 0 && ((*p) & p1) == 0)
                            *p += (int16_t)((*p >= 0) ? p1 : m1);
                    } else {
                        if (r == 0) {
                            if (coef_val) *p = (int16_t)coef_val;
                            k++;
                            break;
                        }
                        r--;
                    }
                    k++;
                }
            }
        }
        if (eobrun > 0) {
            while (k <= se) {
                int16_t* p = &blk[ZIGZAG[k]];
                if (*p != 0) {
                    if (br.bit() > 0 && ((*p) & p1) == 0)
                        *p += (int16_t)((*p >= 0) ? p1 : m1);
                }
                k++;
            }
            eobrun--;
        }
        return 0;
    }

    int decode_progressive(BitReader& br, Component** scomp, int ns,
                           int ss, int se, int ah, int al) {
        int mcu_count = 0;
        if (ss == 0 && ns > 1) {
            // interleaved DC scan
            for (int my = 0; my < mcuy; ++my) {
                for (int mx = 0; mx < mcux; ++mx) {
                    handle_restart(br, mcu_count);
                    for (int i = 0; i < ns; ++i) {
                        Component* c = scomp[i];
                        for (int v = 0; v < c->v; ++v)
                            for (int h = 0; h < c->h; ++h) {
                                int16_t* blk = &c->coef[
                                    ((size_t)(my * c->v + v) * c->bx + mx * c->h + h) * 64];
                                if (decode_prog_dc(br, c, blk, ah, al) < 0) return -1;
                            }
                    }
                    mcu_count++;
                }
            }
            return 0;
        }
        // non-interleaved (DC single comp or AC scans)
        Component* c = scomp[0];
        int bw = (width * c->h / hmax + 7) / 8;
        int bh = (height * c->v / vmax + 7) / 8;
        for (int byi = 0; byi < bh; ++byi) {
            for (int bxi = 0; bxi < bw; ++bxi) {
                handle_restart(br, mcu_count);
                int16_t* blk = &c->coef[((size_t)byi * c->bx + bxi) * 64];
                int rc = (ss == 0)
                             ? decode_prog_dc(br, c, blk, ah, al)
                             : decode_prog_ac(br, c, blk, ss, se, ah, al);
                if (rc < 0) return -1;
                mcu_count++;
            }
        }
        return 0;
    }

    // Reconstruct from buffered coefficients (progressive files and
    // non-streamable sequential layouts), band-wise: dequant+IDCT one
    // MCU row into v*8-row band buffers, emit its output rows, move on
    // — no full-resolution plane intermediates, so the convert stage
    // reads IDCT output while it is still cache-resident. Same
    // per-block / per-row code as the streaming path (byte-identical).
    void reconstruct(uint8_t* out, int out_ncomp) {
        double t_start = prof_now();
        float dqs[4][64];
        std::vector<uint8_t> band[4];
        int pw[4];
        init_bands(band, pw, dqs);
        double t_idct = 0.0;
        for (int my = 0; my < mcuy; ++my) {
            double t0 = prof_enabled() ? prof_now() : 0.0;
            for (int i = 0; i < ncomp; ++i) {
                Component& c = comp[i];
                for (int v = 0; v < c.v; ++v) {
                    int byi = my * c.v + v;
                    if (byi >= c.by) {
                        // unreachable today (by == mcuy*v exactly, and
                        // a second SOF is rejected) — but a skipped
                        // band row must not emit the PREVIOUS MCU
                        // row's pixels from the reused buffer
                        std::memset(&band[i][(size_t)(v * 8) * pw[i]],
                                    0, (size_t)8 * pw[i]);
                        continue;
                    }
                    for (int bxi = 0; bxi < c.bx; ++bxi)
                        dequant_idct_block(
                            &c.coef[((size_t)byi * c.bx + bxi) * 64],
                            dqs[i],
                            &band[i][(size_t)(v * 8) * pw[i]
                                     + (size_t)bxi * 8],
                            pw[i]);
                }
            }
            if (prof_enabled()) t_idct += prof_now() - t0;
            emit_band_rows(my, band, pw, out, out_ncomp);
        }
        if (prof_enabled()) {
            double t_end = prof_now();
            std::fprintf(stderr,
                         "zt_jpeg_profile idct_ms=%.2f upsample_color_ms=%.2f\n",
                         t_idct * 1e3, (t_end - t_start - t_idct) * 1e3);
        }
    }
};

// ---------------------------------------------------------------------------
// Native baseline encoder: deinterleave + BT.601 + chroma subsample +
// forward AAN DCT + quantize + entropy coding in ONE streaming pass per
// MCU row (reference scope: src/codecs/jpeg.zig:307 encode). This is a
// from-scratch float-AAN design, not a port: the python numpy encoder
// (codecs/jpeg.py _encode_plane_blocks, sgemm DCT) remains the
// fallback and the two are validated against each other by decoded-
// image closeness, not byte equality — any conformant stream is valid.
// ---------------------------------------------------------------------------

// forward Arai-Agui-Nakajima flowgraph across registers (one step = one
// vector op, lanes carry the orthogonal axis); output coefficient
// (u,v) = r[u] lane v after two passes + transpose, scaled by
// 8*aan[u]*aan[v] — the scale is folded into the quantization
// reciprocal table (validated to ~1.5e-4 of the orthonormal basis DCT
// over +/-255 inputs)
template <typename V>
static inline void aan_fwd_v(V r[8]) {
    V tmp0 = r[0] + r[7], tmp7 = r[0] - r[7];
    V tmp1 = r[1] + r[6], tmp6 = r[1] - r[6];
    V tmp2 = r[2] + r[5], tmp5 = r[2] - r[5];
    V tmp3 = r[3] + r[4], tmp4 = r[3] - r[4];
    V tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    V tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    r[0] = tmp10 + tmp11;
    r[4] = tmp10 - tmp11;
    V z1 = (tmp12 + tmp13) * 0.707106781f;
    r[2] = tmp13 + z1;
    r[6] = tmp13 - z1;
    tmp10 = tmp4 + tmp5;
    tmp11 = tmp5 + tmp6;
    tmp12 = tmp6 + tmp7;
    V z5 = (tmp10 - tmp12) * 0.382683433f;
    V z2 = 0.541196100f * tmp10 + z5;
    V z4 = 1.306562965f * tmp12 + z5;
    V z3 = tmp11 * 0.707106781f;
    V z11 = tmp7 + z3, z13 = tmp7 - z3;
    r[5] = z13 + z2;
    r[3] = z13 - z2;
    r[1] = z11 + z4;
    r[7] = z11 - z4;
}

// interleaved u8 row -> planar r/g/b (inverse of interleave3): chained
// two-source byte shuffles, 6 per 16 px
static void uninterleave3(const uint8_t* s, uint8_t* __restrict r,
                          uint8_t* __restrict g, uint8_t* __restrict b,
                          int n) {
    int x = 0;
    for (; x + 16 <= n; x += 16) {
        v16u8 i0 = load16u8(s + 3 * x);
        v16u8 i1 = load16u8(s + 3 * x + 16);
        v16u8 i2 = load16u8(s + 3 * x + 32);
        v16u8 tr = ZT_SHUF(i0, i1, 0, 3, 6, 9, 12, 15, 18, 21, 24, 27, 30,
                           0, 0, 0, 0, 0);
        v16u8 vr = ZT_SHUF(tr, i2, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 17,
                           20, 23, 26, 29);
        v16u8 tg = ZT_SHUF(i0, i1, 1, 4, 7, 10, 13, 16, 19, 22, 25, 28, 31,
                           0, 0, 0, 0, 0);
        v16u8 vg = ZT_SHUF(tg, i2, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 18,
                           21, 24, 27, 30);
        v16u8 tb = ZT_SHUF(i0, i1, 2, 5, 8, 11, 14, 17, 20, 23, 26, 29, 0,
                           0, 0, 0, 0, 0);
        v16u8 vb = ZT_SHUF(tb, i2, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 19,
                           22, 25, 28, 31);
        std::memcpy(r + x, &vr, 16);
        std::memcpy(g + x, &vg, 16);
        std::memcpy(b + x, &vb, 16);
    }
    for (; x < n; ++x) {
        r[x] = s[3 * x];
        g[x] = s[3 * x + 1];
        b[x] = s[3 * x + 2];
    }
}

static void uninterleave4(const uint8_t* s, uint8_t* __restrict r,
                          uint8_t* __restrict g, uint8_t* __restrict b,
                          int n) {
    for (int x = 0; x < n; ++x) {
        r[x] = s[4 * x];
        g[x] = s[4 * x + 1];
        b[x] = s[4 * x + 2];
    }
}

// planar u8 -> centered float Y and chroma differences (same float
// formulas as the numpy fallback: jpeg.py encode(); the -128 centering
// is folded in)
static void rgb_to_ycc_row(const uint8_t* __restrict r,
                           const uint8_t* __restrict g,
                           const uint8_t* __restrict b,
                           float* __restrict y, float* __restrict cb,
                           float* __restrict cr, int n) {
    for (int x = 0; x < n; ++x) {
        float rf = (float)r[x], gf = (float)g[x], bf = (float)b[x];
        float yf = 0.299f * rf + 0.587f * gf + 0.114f * bf;
        y[x] = yf - 128.0f;
        cb[x] = (bf - yf) / 1.772f;
        cr[x] = (rf - yf) / 1.402f;
    }
}

struct BitEnc {
    uint8_t* out;
    long cap, di = 0;
    uint64_t acc = 0;
    int nbits = 0;

    // len <= 27 (16-bit code + 11 value bits fused by the callers);
    // nbits stays < 32 between calls, so acc never overflows 59 bits.
    // Emission drains 4 bytes at a time when none is 0xFF (the common
    // case — a put crosses 32 pending bits only every ~1.2 calls, and
    // per-byte stuffing checks run only when an 0xFF is present).
    inline bool put(uint32_t code, int len) {
        acc = (acc << len) | (code & ((1u << len) - 1));
        nbits += len;
        while (nbits >= 32) {
            uint32_t w = (uint32_t)(acc >> (nbits - 32));
            if (!((~w - 0x01010101u) & w & 0x80808080u)
                && di + 4 <= cap) {
                w = __builtin_bswap32(w);
                std::memcpy(out + di, &w, 4);
                di += 4;
                nbits -= 32;
            } else {
                // rare: an 0xFF byte needs stuffing (or cap is near) —
                // emit one byte and re-check
                nbits -= 8;
                uint8_t b = (uint8_t)((acc >> nbits) & 0xFF);
                if (di >= cap) return false;
                out[di++] = b;
                if (b == 0xFF) {
                    if (di >= cap) return false;
                    out[di++] = 0x00;
                }
            }
        }
        return true;
    }

    bool flush() {
        int pad = (8 - (nbits & 7)) & 7;
        if (pad) {
            acc = (acc << pad) | ((1u << pad) - 1);
            nbits += pad;
        }
        while (nbits >= 8) {
            nbits -= 8;
            uint8_t b = (uint8_t)((acc >> nbits) & 0xFF);
            if (di >= cap) return false;
            out[di++] = b;
            if (b == 0xFF) {
                if (di >= cap) return false;
                out[di++] = 0x00;
            }
        }
        return true;
    }
};

static inline int enc_magnitude(int v) {
    unsigned u = v > 0 ? (unsigned)v : (unsigned)(-v);
    return u ? 32 - __builtin_clz(u) : 0;
}

// zigzag-ordered quantized block -> Huffman-coded bits (same coding
// scheme as codec_core.cpp zt_jpeg_entropy_encode, restated here so the
// streaming encoder needs no cross-TU plumbing)
static bool encode_block_bits(BitEnc& be, const int16_t* blk, int& pred,
                              const uint32_t* dct_c, const uint8_t* dct_l,
                              const uint32_t* act_c, const uint8_t* act_l) {
    int dc = blk[0];
    int diff = dc - pred;
    pred = dc;
    int s = enc_magnitude(diff);
    // code + value bits in ONE put (<= 16 + 11 = 27 bits)
    uint32_t db = (uint32_t)(diff > 0 ? diff : diff + (1 << s) - 1)
                  & ((1u << s) - 1);
    if (!be.put((dct_c[s] << s) | db, dct_l[s] + s)) return false;
    int last = 0;
    for (int k = 63; k >= 1; k--)
        if (blk[k] != 0) { last = k; break; }
    int run = 0;
    for (int k = 1; k <= last; k++) {
        int v = blk[k];
        if (v == 0) { run++; continue; }
        while (run >= 16) {
            if (!be.put(act_c[0xF0], act_l[0xF0])) return false;
            run -= 16;
        }
        int sv = enc_magnitude(v);
        int sym = (run << 4) | sv;
        uint32_t vb = (uint32_t)(v > 0 ? v : v + (1 << sv) - 1)
                      & ((1u << sv) - 1);
        if (!be.put((act_c[sym] << sv) | vb, act_l[sym] + sv))
            return false;
        run = 0;
    }
    if (last < 63 && !be.put(act_c[0x00], act_l[0x00])) return false;
    return true;
}

// 8x8 float block (stride between rows) -> quantized int16 zigzag
static inline void fdct_quant_block(const float* base, int stride,
                                    const float* qinv_t,  // [u*8+v]
                                    const uint8_t* zzt, int16_t* zz) {
    v8f r[8];
    for (int i = 0; i < 8; ++i) r[i] = load8f(base + (size_t)i * stride);
    aan_fwd_v(r);   // vertical pass (across registers, lanes = x)
    transpose8(r);  // register = x, lane = v
    aan_fwd_v(r);   // horizontal pass -> register = u, lane = v
    float fq[64];
    for (int u = 0; u < 8; ++u) {
        v8f p = r[u] * load8f(qinv_t + u * 8);
        std::memcpy(fq + u * 8, &p, 32);
    }
    int32_t qi[64];
    for (int i = 0; i < 64; ++i) qi[i] = (int32_t)lrintf(fq[i]);
    for (int k = 0; k < 64; ++k) zz[k] = (int16_t)qi[zzt[k]];
}

}  // namespace

extern "C" {

int zt_jpeg_info(const uint8_t* data, int64_t len, int* w, int* h, int* ncomp) {
    Decoder d;
    d.data = data;
    d.len = len;
    int rc = d.parse_headers(true);
    if (rc < 0) return rc;
    *w = d.width;
    *h = d.height;
    *ncomp = d.ncomp;
    return 0;
}

// out must hold width*height*out_ncomp bytes; out_ncomp: 1 (gray) or 3 (rgb).
int zt_jpeg_decode(const uint8_t* data, int64_t len, uint8_t* out, int out_ncomp) {
    Decoder d;
    d.data = data;
    d.len = len;
    if (out_ncomp != 1 && out_ncomp != 3) return -1;
    {
        // the color emit path writes 3 bytes per pixel unconditionally;
        // a color stream with out_ncomp=1 would overflow the caller's
        // buffer, so pre-parse the header and reject the combination
        // (the python wrapper always passes out_ncomp=3 for color)
        Decoder probe;
        probe.data = data;
        probe.len = len;
        if (probe.parse_headers(true) < 0) return -1;
        if (probe.ncomp >= 3 && out_ncomp != 3) return -1;
    }
    d.stream_out = out;
    d.stream_ncomp = out_ncomp;
    double t0 = prof_now();
    int rc = d.parse_headers(false);
    if (rc < 0) return rc;
    if (d.width <= 0 || d.height <= 0) return -1;
    if (prof_enabled())
        std::fprintf(stderr, "zt_jpeg_profile %s_ms=%.2f\n",
                     d.streamed ? "stream" : "entropy",
                     (prof_now() - t0) * 1e3);
    if (!d.streamed) d.reconstruct(out, out_ncomp);
    return 0;
}

// Full scan encode: interleaved u8 image -> Huffman-coded scan bytes
// (headers are assembled by the python caller). ncomp 1 = grayscale
// (channel 0 of ch_in), 3 = YCbCr with sampling sh x sv in {1,2}.
// ql/qc: 64 uint16 quant tables in natural order. dc/ac code tables
// packed [2][12] / [2][256] as codes u32 + lens u8 (class 0 = luma).
// Returns scan bytes written, or -1 on overflow / bad args.
long zt_jpeg_encode_scan(const uint8_t* img, int64_t h, int64_t w,
                         int ch_in, int ncomp, int sh, int sv,
                         const uint16_t* ql, const uint16_t* qc,
                         const uint32_t* dc_codes, const uint8_t* dc_lens,
                         const uint32_t* ac_codes, const uint8_t* ac_lens,
                         uint8_t* out, long cap) {
    if (h <= 0 || w <= 0 || ch_in < 1 || ch_in > 4) return -1;
    if (ncomp != 1 && ncomp != 3) return -1;
    if (sh < 1 || sh > 2 || sv < 1 || sv > 2) return -1;
    if (ncomp == 1) { sh = 1; sv = 1; }
    if (ncomp == 3 && ch_in < 3) return -1;
    static const double aan[8] = {
        1.0, 1.387039845, 1.306562965, 1.175875602,
        1.0, 0.785694958, 0.541196100, 0.275899379,
    };
    const uint8_t ZZ[64] = {
        0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
        12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    };
    uint8_t zzt[64];  // zigzag k -> register-major (u*8+v) FDCT index
    for (int k = 0; k < 64; ++k)
        zzt[k] = (uint8_t)((ZZ[k] & 7) * 8 + (ZZ[k] >> 3));
    // quant reciprocals in the FDCT's register-major layout with the
    // AAN descale 8*aan[u]*aan[v] folded in
    float qinvY[64], qinvC[64];
    for (int u = 0; u < 8; ++u)
        for (int v = 0; v < 8; ++v) {
            qinvY[u * 8 + v] = (float)(1.0 / (ql[v * 8 + u] * 8.0
                                              * aan[u] * aan[v]));
            if (ncomp == 3)
                qinvC[u * 8 + v] = (float)(1.0 / (qc[v * 8 + u] * 8.0
                                                  * aan[u] * aan[v]));
        }
    const int mcux = (int)((w + 8 * sh - 1) / (8 * sh));
    const int mcuy = (int)((h + 8 * sv - 1) / (8 * sv));
    const int wy = mcux * 8 * sh;   // padded luma width
    const int wc = mcux * 8;        // padded chroma width
    const int band_h = 8 * sv;
    std::vector<uint8_t> rrow(wy), grow(wy), brow(wy);
    std::vector<float> yband((size_t)band_h * wy);
    std::vector<float> cbrow(wy), crrow(wy);
    std::vector<float> cbhalf(wc), crhalf(wc), cbprev(wc), crprev(wc);
    std::vector<float> cbband((size_t)8 * wc), crband((size_t)8 * wc);
    BitEnc be{out, cap};
    int predY = 0, predCb = 0, predCr = 0;
    int16_t zz[64];
    for (int my = 0; my < mcuy; ++my) {
        for (int ry = 0; ry < band_h; ++ry) {
            int64_t sy = (int64_t)my * band_h + ry;
            if (sy >= h) sy = h - 1;
            const uint8_t* src = img + (size_t)sy * w * ch_in;
            float* yrow = &yband[(size_t)ry * wy];
            if (ncomp == 1) {
                if (ch_in == 1) {
                    for (int64_t x = 0; x < w; ++x)
                        yrow[x] = (float)src[x] - 128.0f;
                } else {
                    for (int64_t x = 0; x < w; ++x)
                        yrow[x] = (float)src[x * ch_in] - 128.0f;
                }
                for (int x = (int)w; x < wy; ++x) yrow[x] = yrow[w - 1];
                continue;
            }
            if (ch_in == 3)
                uninterleave3(src, rrow.data(), grow.data(), brow.data(),
                              (int)w);
            else
                uninterleave4(src, rrow.data(), grow.data(), brow.data(),
                              (int)w);
            for (int x = (int)w; x < wy; ++x) {
                rrow[x] = rrow[w - 1];
                grow[x] = grow[w - 1];
                brow[x] = brow[w - 1];
            }
            rgb_to_ycc_row(rrow.data(), grow.data(), brow.data(), yrow,
                           cbrow.data(), crrow.data(), wy);
            // horizontal then vertical chroma averaging (float means,
            // matching the numpy fallback's 2x2 mean up to association)
            float* cbh = cbhalf.data();
            float* crh = crhalf.data();
            if (sh == 2) {
                const float* cbs = cbrow.data();
                const float* crs = crrow.data();
                for (int x = 0; x < wc; ++x) {
                    cbh[x] = (cbs[2 * x] + cbs[2 * x + 1]) * 0.5f;
                    crh[x] = (crs[2 * x] + crs[2 * x + 1]) * 0.5f;
                }
            } else {
                std::memcpy(cbh, cbrow.data(), sizeof(float) * wc);
                std::memcpy(crh, crrow.data(), sizeof(float) * wc);
            }
            if (sv == 1) {
                std::memcpy(&cbband[(size_t)ry * wc], cbh,
                            sizeof(float) * wc);
                std::memcpy(&crband[(size_t)ry * wc], crh,
                            sizeof(float) * wc);
            } else if (ry & 1) {
                float* cbd = &cbband[(size_t)(ry >> 1) * wc];
                float* crd = &crband[(size_t)(ry >> 1) * wc];
                const float* cbp = cbprev.data();
                const float* crp = crprev.data();
                for (int x = 0; x < wc; ++x) {
                    cbd[x] = (cbp[x] + cbh[x]) * 0.5f;
                    crd[x] = (crp[x] + crh[x]) * 0.5f;
                }
            } else {
                std::swap(cbhalf, cbprev);
                std::swap(crhalf, crprev);
            }
        }
        for (int mx = 0; mx < mcux; ++mx) {
            for (int v = 0; v < sv; ++v)
                for (int hh = 0; hh < sh; ++hh) {
                    fdct_quant_block(
                        &yband[(size_t)(v * 8) * wy + (mx * sh + hh) * 8],
                        wy, qinvY, zzt, zz);
                    if (!encode_block_bits(be, zz, predY, dc_codes,
                                           dc_lens, ac_codes, ac_lens))
                        return -1;
                }
            if (ncomp == 3) {
                fdct_quant_block(&cbband[(size_t)mx * 8], wc, qinvC, zzt,
                                 zz);
                if (!encode_block_bits(be, zz, predCb, dc_codes + 12,
                                       dc_lens + 12, ac_codes + 256,
                                       ac_lens + 256))
                    return -1;
                fdct_quant_block(&crband[(size_t)mx * 8], wc, qinvC, zzt,
                                 zz);
                if (!encode_block_bits(be, zz, predCr, dc_codes + 12,
                                       dc_lens + 12, ac_codes + 256,
                                       ac_lens + 256))
                    return -1;
            }
        }
    }
    if (!be.flush()) return -1;
    return be.di;
}

}  // extern "C"
