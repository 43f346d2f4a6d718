// Native host-side codec hot loops for zignal-tpu.
//
// The reference implements its codecs in native Zig (src/codecs/); here the
// sequential hot loops (PNG scanline unfiltering, GIF LZW) are C++ compiled
// to a shared library and driven from Python via ctypes. Decompression and
// bulk transforms stay in numpy/zlib.
//
// Build: zignal_tpu/native/build.py (g++ -O3 -shared -fPIC).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <ctime>
#if defined(__AVX512BW__) || defined(__AVX2__)
#include <immintrin.h>
#endif
#include <vector>
#include <algorithm>

extern "C" {

// PNG scanline unfilter (reference behavior: src/codecs/png.zig decode).
// `src`: H scanlines, each 1 filter byte + `stride` bytes.
// `dst`: H*stride reconstructed bytes.
// Returns 0 on success, -1 on bad filter byte.
int zt_png_unfilter(const uint8_t* src, uint8_t* dst,
                    int64_t rows, int64_t stride, int64_t bpp) {
    const uint8_t* prev = nullptr;
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t filter = src[r * (stride + 1)];
        const uint8_t* in = src + r * (stride + 1) + 1;
        uint8_t* out = dst + r * stride;
        switch (filter) {
            case 0:  // None
                std::memcpy(out, in, (size_t)stride);
                break;
            case 1:  // Sub
                for (int64_t i = 0; i < bpp && i < stride; ++i) out[i] = in[i];
                for (int64_t i = bpp; i < stride; ++i)
                    out[i] = (uint8_t)(in[i] + out[i - bpp]);
                break;
            case 2:  // Up
                if (prev) {
                    for (int64_t i = 0; i < stride; ++i)
                        out[i] = (uint8_t)(in[i] + prev[i]);
                } else {
                    std::memcpy(out, in, (size_t)stride);
                }
                break;
            case 3:  // Average
                for (int64_t i = 0; i < stride; ++i) {
                    const int a = (i >= bpp) ? out[i - bpp] : 0;
                    const int b = prev ? prev[i] : 0;
                    out[i] = (uint8_t)(in[i] + ((a + b) >> 1));
                }
                break;
            case 4:  // Paeth
                for (int64_t i = 0; i < stride; ++i) {
                    const int a = (i >= bpp) ? out[i - bpp] : 0;
                    const int b = prev ? prev[i] : 0;
                    const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                    const int p = a + b - c;
                    const int pa = p > a ? p - a : a - p;
                    const int pb = p > b ? p - b : b - p;
                    const int pc = p > c ? p - c : c - p;
                    int pred;
                    if (pa <= pb && pa <= pc) pred = a;
                    else if (pb <= pc) pred = b;
                    else pred = c;
                    out[i] = (uint8_t)(in[i] + pred);
                }
                break;
            default:
                return -1;
        }
        prev = out;
    }
    return 0;
}

// GIF LZW decode (reference behavior: src/codecs/gif/lzw.zig).
// Variable-width LSB-first codes. Returns number of bytes written to dst,
// or -1 on malformed stream / dst overflow.
int64_t zt_gif_lzw_decode(const uint8_t* src, int64_t src_len,
                          uint8_t* dst, int64_t dst_cap,
                          int min_code_size) {
    const int clear_code = 1 << min_code_size;
    const int end_code = clear_code + 1;
    // dictionary: prefix/suffix representation
    static const int MAX_CODES = 4096;
    int16_t* prefix = (int16_t*)std::malloc(MAX_CODES * sizeof(int16_t));
    uint8_t* suffix = (uint8_t*)std::malloc(MAX_CODES * sizeof(uint8_t));
    uint8_t* stack = (uint8_t*)std::malloc(MAX_CODES * sizeof(uint8_t));
    if (!prefix || !suffix || !stack) {
        std::free(prefix); std::free(suffix); std::free(stack);
        return -1;
    }

    int code_size = min_code_size + 1;
    int next_code = end_code + 1;
    int prev_code = -1;
    uint32_t bitbuf = 0;
    int bitcnt = 0;
    int64_t si = 0, di = 0;
    int64_t result = -1;

    for (int i = 0; i < clear_code; ++i) { prefix[i] = -1; suffix[i] = (uint8_t)i; }

    for (;;) {
        while (bitcnt < code_size) {
            if (si >= src_len) { result = di; goto done; }  // truncated: accept
            bitbuf |= (uint32_t)src[si++] << bitcnt;
            bitcnt += 8;
        }
        int code = (int)(bitbuf & ((1u << code_size) - 1));
        bitbuf >>= code_size;
        bitcnt -= code_size;

        if (code == clear_code) {
            code_size = min_code_size + 1;
            next_code = end_code + 1;
            prev_code = -1;
            continue;
        }
        if (code == end_code) { result = di; goto done; }

        int sp = 0;
        int cur = code;
        if (cur >= next_code) {
            // KwKwK case: emit prev + first char of prev
            if (prev_code < 0 || cur > next_code) goto done;
            stack[sp++] = 0;  // placeholder for first char, fixed below
            cur = prev_code;
        }
        while (cur >= 0) {
            if (sp >= MAX_CODES) goto done;
            stack[sp++] = suffix[cur];
            cur = prefix[cur];
        }
        // first char of expansion:
        uint8_t first = stack[sp - 1];
        if (code >= next_code) stack[0] = first;  // fix placeholder

        if (di + sp > dst_cap) { result = di; goto done; }
        for (int i = sp - 1; i >= 0; --i) dst[di++] = stack[i];

        if (prev_code >= 0 && next_code < MAX_CODES) {
            prefix[next_code] = (int16_t)prev_code;
            suffix[next_code] = first;
            next_code++;
            if (next_code == (1 << code_size) && code_size < 12)
                code_size++;
        }
        prev_code = code;
    }
done:
    std::free(prefix); std::free(suffix); std::free(stack);
    return result;
}

// Error-diffusion dithering (reference behavior: src/image/dither.zig).
// img: interleaved RGB u8 (h*w*3), modified in place to palette colors.
// palette: pal_n*3 u8. lut: 32768 entries (5-bit RGB -> palette index).
// mode: 0 = Floyd-Steinberg, 1 = Atkinson.
int zt_dither_error_diffusion(uint8_t* img, int64_t h, int64_t w,
                              const uint8_t* palette, int pal_n,
                              const uint8_t* lut, int mode) {
    (void)pal_n;
    struct Tap { int dx, dy, weight, shift; };
    static const Tap fs[] = {{1, 0, 7, 4}, {-1, 1, 3, 4}, {0, 1, 5, 4}, {1, 1, 1, 4}};
    static const Tap at[] = {{1, 0, 1, 3}, {2, 0, 1, 3}, {-1, 1, 1, 3},
                             {0, 1, 1, 3}, {1, 1, 1, 3}, {0, 2, 1, 3}};
    const Tap* taps = mode == 0 ? fs : at;
    const int ntaps = mode == 0 ? 4 : 6;

    auto div_trunc_pow2 = [](int v, int s) {
        if (s == 0) return v;
        if (v >= 0) return v >> s;
        const int d = 1 << s;
        return (v + d - 1) >> s;
    };
    auto clamp8 = [](int v) -> uint8_t {
        return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    };

    for (int64_t r = 0; r < h; ++r) {
        for (int64_t c = 0; c < w; ++c) {
            uint8_t* p = img + (r * w + c) * 3;
            const int r5 = p[0] >> 3, g5 = p[1] >> 3, b5 = p[2] >> 3;
            const uint8_t idx = lut[(r5 << 10) | (g5 << 5) | b5];
            const uint8_t* q = palette + idx * 3;
            const int re = (int)p[0] - q[0];
            const int ge = (int)p[1] - q[1];
            const int be = (int)p[2] - q[2];
            p[0] = q[0]; p[1] = q[1]; p[2] = q[2];
            for (int t = 0; t < ntaps; ++t) {
                const int64_t nc = c + taps[t].dx;
                const int64_t nr = r + taps[t].dy;
                if (nr < 0 || nr >= h || nc < 0 || nc >= w) continue;
                uint8_t* n = img + (nr * w + nc) * 3;
                n[0] = clamp8((int)n[0] + div_trunc_pow2(re * taps[t].weight, taps[t].shift));
                n[1] = clamp8((int)n[1] + div_trunc_pow2(ge * taps[t].weight, taps[t].shift));
                n[2] = clamp8((int)n[2] + div_trunc_pow2(be * taps[t].weight, taps[t].shift));
            }
        }
    }
    return 0;
}

// GIF LZW encode (reference behavior: src/codecs/gif/lzw.zig encoder).
// Variable-width LSB-first codes with CLEAR/END, dictionary reset at 4096.
// Returns bytes written to dst, or -1 on overflow.
int64_t zt_gif_lzw_encode(const uint8_t* src, int64_t src_len,
                          uint8_t* dst, int64_t dst_cap,
                          int min_code_size) {
    const int clear_code = 1 << min_code_size;
    const int end_code = clear_code + 1;
    static const int MAX_CODES = 4096;

    // hash-based dictionary: key = (prefix << 8) | byte
    std::vector<int32_t> table((size_t)MAX_CODES * 256, -1);

    uint32_t bitbuf = 0;
    int bitcnt = 0;
    int64_t di = 0;
    int code_size = min_code_size + 1;
    int next_code = end_code + 1;

    auto emit = [&](int code) -> bool {
        bitbuf |= (uint32_t)code << bitcnt;
        bitcnt += code_size;
        while (bitcnt >= 8) {
            if (di >= dst_cap) return false;
            dst[di++] = (uint8_t)(bitbuf & 0xFF);
            bitbuf >>= 8;
            bitcnt -= 8;
        }
        return true;
    };

    if (!emit(clear_code)) return -1;
    if (src_len == 0) {
        if (!emit(end_code)) return -1;
        if (bitcnt > 0) {
            if (di >= dst_cap) return -1;
            dst[di++] = (uint8_t)(bitbuf & 0xFF);
        }
        return di;
    }

    int prefix = src[0];
    for (int64_t i = 1; i < src_len; ++i) {
        const int byte = src[i];
        const size_t key = (size_t)prefix * 256 + byte;
        if (table[key] >= 0) {
            prefix = table[key];
            continue;
        }
        if (!emit(prefix)) return -1;
        if (next_code < MAX_CODES) {
            table[key] = next_code++;
            if (next_code - 1 == (1 << code_size) && code_size < 12) {
                // widen when the next emitted code could need more bits
            }
            if (next_code > (1 << code_size) && code_size < 12) code_size++;
        } else {
            if (!emit(clear_code)) return -1;
            std::fill(table.begin(), table.end(), -1);
            code_size = min_code_size + 1;
            next_code = end_code + 1;
        }
        prefix = byte;
    }
    if (!emit(prefix)) return -1;
    if (!emit(end_code)) return -1;
    if (bitcnt > 0) {
        if (di >= dst_cap) return -1;
        dst[di++] = (uint8_t)(bitbuf & 0xFF);
    }
    return di;
}

// PNG encode: per-row filter selection by minimum sum of absolute
// residuals (the standard MSD heuristic) + filtering, single pass.
// src: [h][stride] raw rows; out: [h][1 + stride] filter byte + data.
// The hot interior loop is branchless (selects instead of &&-chains,
// no per-byte bounds conditionals) so the autovectorizer turns the
// Paeth predictor into SIMD compare/blend chains.
#if defined(__AVX512BW__)
// Fused minimum-sum-of-absolute-differences PNG filter pass: one
// read-only SIMD sweep computes all five filter costs per row (no
// candidate stores), then only the WINNING filter is generated. The
// portable path below materializes all 5 candidates and re-reads them
// (13 passes of memory traffic per row vs ~3 here). Costs, tie-breaks
// and output bytes are identical.
static long filter_msd_avx512(const uint8_t* src, long h, long stride,
                              long bpp, uint8_t* out) {
    std::vector<uint8_t> zero_row((size_t)stride, 0);
    const __m256i z256 = _mm256_setzero_si256();
    const __m256i lo7 = _mm256_set1_epi8(0x7F);
    for (long r = 0; r < h; r++) {
        const uint8_t* row = src + r * stride;
        const uint8_t* prev = r > 0 ? src + (r - 1) * stride
                                    : zero_row.data();
        uint64_t cost[5] = {0, 0, 0, 0, 0};
        // head [0, bpp): a = c = 0
        long i = 0;
        for (; i < bpp && i < stride; i++) {
            int x = row[i], b = prev[i];
            auto a8 = [](uint8_t v) {
                uint8_t m = (uint8_t)-v;
                return (uint64_t)(v < m ? v : m);
            };
            cost[0] += a8((uint8_t)x);
            cost[1] += a8((uint8_t)x);
            cost[2] += a8((uint8_t)(x - b));
            cost[3] += a8((uint8_t)(x - (b >> 1)));
            cost[4] += a8((uint8_t)(x - b));
        }
        __m256i acc0 = z256, acc1 = z256, acc2 = z256, acc3 = z256,
                acc4 = z256;
        auto sadabs = [&](__m256i f, __m256i& acc) {
            // |int8(v)| = min_u8(v, -v); SAD vs zero widens to 4x u64
            __m256i m = _mm256_sub_epi8(z256, f);
            __m256i a = _mm256_min_epu8(f, m);
            acc = _mm256_add_epi64(acc, _mm256_sad_epu8(a, z256));
        };
        for (; i + 32 <= stride; i += 32) {
            __m256i x = _mm256_loadu_si256((const __m256i*)(row + i));
            __m256i a = _mm256_loadu_si256(
                (const __m256i*)(row + i - bpp));
            __m256i b = _mm256_loadu_si256((const __m256i*)(prev + i));
            __m256i c = _mm256_loadu_si256(
                (const __m256i*)(prev + i - bpp));
            sadabs(x, acc0);
            sadabs(_mm256_sub_epi8(x, a), acc1);
            sadabs(_mm256_sub_epi8(x, b), acc2);
            // truncating byte average: (a & b) + ((a ^ b) >> 1)
            __m256i avg = _mm256_add_epi8(
                _mm256_and_si256(a, b),
                _mm256_and_si256(
                    _mm256_srli_epi16(_mm256_xor_si256(a, b), 1), lo7));
            sadabs(_mm256_sub_epi8(x, avg), acc3);
            // Paeth in 16-bit lanes (a+b-c spans [-255, 510]); the
            // 512-bit widen/narrow pair preserves element order
            __m512i a16 = _mm512_cvtepu8_epi16(a);
            __m512i b16 = _mm512_cvtepu8_epi16(b);
            __m512i c16 = _mm512_cvtepu8_epi16(c);
            __m512i p = _mm512_sub_epi16(_mm512_add_epi16(a16, b16), c16);
            __m512i pa = _mm512_abs_epi16(_mm512_sub_epi16(p, a16));
            __m512i pb = _mm512_abs_epi16(_mm512_sub_epi16(p, b16));
            __m512i pc = _mm512_abs_epi16(_mm512_sub_epi16(p, c16));
            __mmask32 ka = _mm512_cmple_epi16_mask(pa, pb)
                           & _mm512_cmple_epi16_mask(pa, pc);
            __mmask32 kb = _mm512_cmple_epi16_mask(pb, pc);
            __m512i pred16 = _mm512_mask_blend_epi16(
                ka, _mm512_mask_blend_epi16(kb, c16, b16), a16);
            __m256i pred = _mm512_cvtepi16_epi8(pred16);
            sadabs(_mm256_sub_epi8(x, pred), acc4);
        }
        auto hsum = [](__m256i v) -> uint64_t {
            alignas(32) uint64_t t[4];
            _mm256_store_si256((__m256i*)t, v);
            return t[0] + t[1] + t[2] + t[3];
        };
        cost[0] += hsum(acc0);
        cost[1] += hsum(acc1);
        cost[2] += hsum(acc2);
        cost[3] += hsum(acc3);
        cost[4] += hsum(acc4);
        for (; i < stride; i++) {  // tail
            int x = row[i], a = row[i - bpp], b = prev[i],
                c = prev[i - bpp];
            auto a8 = [](uint8_t v) {
                uint8_t m = (uint8_t)-v;
                return (uint64_t)(v < m ? v : m);
            };
            cost[0] += a8((uint8_t)x);
            cost[1] += a8((uint8_t)(x - a));
            cost[2] += a8((uint8_t)(x - b));
            cost[3] += a8((uint8_t)(x - ((a + b) >> 1)));
            int p = a + b - c;
            int pa = p > a ? p - a : a - p;
            int pb = p > b ? p - b : b - p;
            int pc = p > c ? p - c : c - p;
            int pred = ((pa <= pb) & (pa <= pc)) ? a
                                                 : (pb <= pc ? b : c);
            cost[4] += a8((uint8_t)(x - pred));
        }
        int best = 0;
        for (int f = 1; f < 5; f++)
            if (cost[f] < cost[best]) best = f;
        uint8_t* dst = out + r * (stride + 1);
        dst[0] = (uint8_t)best;
        uint8_t* d = dst + 1;
        switch (best) {
            case 0:
                std::memcpy(d, row, (size_t)stride);
                break;
            case 1:
                for (long k = 0; k < bpp && k < stride; k++) d[k] = row[k];
                for (long k = bpp; k < stride; k++)
                    d[k] = (uint8_t)(row[k] - row[k - bpp]);
                break;
            case 2:
                for (long k = 0; k < stride; k++)
                    d[k] = (uint8_t)(row[k] - prev[k]);
                break;
            case 3:
                for (long k = 0; k < bpp && k < stride; k++)
                    d[k] = (uint8_t)(row[k] - (prev[k] >> 1));
                for (long k = bpp; k < stride; k++)
                    d[k] = (uint8_t)(row[k]
                                     - ((row[k - bpp] + prev[k]) >> 1));
                break;
            case 4:
                for (long k = 0; k < bpp && k < stride; k++)
                    d[k] = (uint8_t)(row[k] - prev[k]);
                for (long k = bpp; k < stride; k++) {
                    int a = row[k - bpp], b = prev[k], c = prev[k - bpp];
                    int p = a + b - c;
                    int pa = p > a ? p - a : a - p;
                    int pb = p > b ? p - b : b - p;
                    int pc = p > c ? p - c : c - p;
                    int pred = ((pa <= pb) & (pa <= pc))
                                   ? a : (pb <= pc ? b : c);
                    d[k] = (uint8_t)(row[k] - pred);
                }
                break;
        }
    }
    return 0;
}
#endif

long zt_png_filter_msd(const uint8_t* src, long h, long stride, long bpp,
                       uint8_t* out) {
#if defined(__AVX512BW__)
    if (stride >= 32 && bpp >= 1) return filter_msd_avx512(src, h, stride, bpp, out);
#endif
    std::vector<uint8_t> cand((size_t)5 * stride);
    std::vector<uint8_t> zero_row((size_t)stride, 0);
    for (long r = 0; r < h; r++) {
        const uint8_t* row = src + r * stride;
        // row 0's "up" row is all zeros; using a real zero buffer keeps
        // the interior loop conditional-free for every row
        const uint8_t* prev = r > 0 ? src + (r - 1) * stride
                                    : zero_row.data();
        uint8_t* c0 = cand.data();
        uint8_t* c1 = c0 + stride;
        uint8_t* c2 = c1 + stride;
        uint8_t* c3 = c2 + stride;
        uint8_t* c4 = c3 + stride;
        for (long i = 0; i < bpp && i < stride; i++) {
            int x = row[i];
            int b = prev[i];
            c0[i] = (uint8_t)x;
            c1[i] = (uint8_t)x;                 // a = 0
            c2[i] = (uint8_t)(x - b);
            c3[i] = (uint8_t)(x - (b >> 1));
            // Paeth with a = c = 0: p = b; pa = |b|, pb = 0, pc = |b|
            // -> pred = b unless b == 0 (then a); x - b either way
            c4[i] = (uint8_t)(x - b);
        }
        for (long i = bpp; i < stride; i++) {
            int x = row[i];
            int a = row[i - bpp];
            int b = prev[i];
            int c = prev[i - bpp];
            c0[i] = (uint8_t)x;
            c1[i] = (uint8_t)(x - a);
            c2[i] = (uint8_t)(x - b);
            c3[i] = (uint8_t)(x - ((a + b) >> 1));
            int p = a + b - c;
            int pa = p > a ? p - a : a - p;
            int pb = p > b ? p - b : b - p;
            int pc = p > c ? p - c : c - p;
            int na = (pa <= pb) & (pa <= pc);
            int nb = pb <= pc;
            int pred = na ? a : (nb ? b : c);
            c4[i] = (uint8_t)(x - pred);
        }
        long best = 0;
        long best_cost = -1;
        for (int f = 0; f < 5; f++) {
            const uint8_t* cf = cand.data() + (size_t)f * stride;
            long cost = 0;
            // |int8(v)| == min(v, -v) in u8 arithmetic — byte-typed so
            // the vectorizer uses 8-bit lanes (4x the elements of the
            // old int formulation) with a widening-sum reduction
            long i = 0;
            for (; i + 4096 <= stride; i += 4096) {
                uint32_t part = 0;
                for (long j = i; j < i + 4096; j++) {
                    uint8_t v = cf[j];
                    uint8_t m = (uint8_t)-v;
                    part += v < m ? v : m;
                }
                cost += part;
            }
            uint32_t part = 0;
            for (; i < stride; i++) {
                uint8_t v = cf[i];
                uint8_t m = (uint8_t)-v;
                part += v < m ? v : m;
            }
            cost += part;
            if (best_cost < 0 || cost < best_cost) { best_cost = cost; best = f; }
        }
        uint8_t* dst = out + r * (stride + 1);
        dst[0] = (uint8_t)best;
        std::memcpy(dst + 1, cand.data() + (size_t)best * stride, stride);
    }
    return 0;
}

// JPEG baseline entropy coding for pre-ordered zigzag blocks.
// blocks: [nblocks][64] int16; tbl_class: 0=luma,1=chroma tables;
// pred_group: DC predictor chain id (component index).
// dc_codes/dc_lens: [2*12]; ac_codes/ac_lens: [2*256].
// Returns bytes written or -1 on overflow.
long zt_jpeg_entropy_encode(const int16_t* blocks, long nblocks,
                            const uint8_t* tbl_class,
                            const uint8_t* pred_group,
                            const uint32_t* dc_codes, const uint8_t* dc_lens,
                            const uint32_t* ac_codes, const uint8_t* ac_lens,
                            uint8_t* out, long cap) {
    uint64_t acc = 0;
    int nbits = 0;
    long di = 0;
    int pred[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    auto put = [&](uint32_t code, int len) -> bool {
        acc = (acc << len) | (code & ((1u << len) - 1));
        nbits += len;
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
    };
    auto magnitude = [](int v) -> int {
        unsigned u = v > 0 ? (unsigned)v : (unsigned)(-v);
        int s = 0;
        while (u) { s++; u >>= 1; }
        return s;
    };
    for (long n = 0; n < nblocks; n++) {
        const int16_t* blk = blocks + n * 64;
        int cls = tbl_class[n];
        const uint32_t* dct_c = dc_codes + cls * 12;
        const uint8_t* dct_l = dc_lens + cls * 12;
        const uint32_t* act_c = ac_codes + cls * 256;
        const uint8_t* act_l = ac_lens + cls * 256;
        int g = pred_group[n] & 7;
        int dc = blk[0];
        int diff = dc - pred[g];
        pred[g] = dc;
        int s = magnitude(diff);
        if (!put(dct_c[s], dct_l[s])) return -1;
        if (s && !put((uint32_t)(diff > 0 ? diff : diff + (1 << s) - 1), s))
            return -1;
        int last = 0;
        for (int k = 63; k >= 1; k--) {
            if (blk[k] != 0) { last = k; break; }
        }
        int run = 0;
        for (int k = 1; k <= last; k++) {
            int v = blk[k];
            if (v == 0) { run++; continue; }
            while (run >= 16) {
                if (!put(act_c[0xF0], act_l[0xF0])) return -1;
                run -= 16;
            }
            int sv = magnitude(v);
            int sym = (run << 4) | sv;
            if (!put(act_c[sym], act_l[sym])) return -1;
            if (!put((uint32_t)(v > 0 ? v : v + (1 << sv) - 1), sv)) return -1;
            run = 0;
        }
        if (last < 63) {
            if (!put(act_c[0x00], act_l[0x00])) return -1;
        }
    }
    if (nbits > 0) {
        int pad = 8 - nbits;
        if (!put((1u << pad) - 1, pad)) return -1;
    }
    return di;
}

// ---------------------------------------------------------------------------
// Adaptive median-cut palette (reference: quantize.zig medianCut).
// Exactly replicates the python implementation in ops/quantize.py:
// 5-bit binning in ascending key order, boxes split at the weighted
// median of the widest channel (first-max channel on ties), next box
// chosen by max volume*population score with earliest-insertion
// tie-break, final palette = floor of per-box weighted means in box
// insertion order. Verified palette-identical in tests.
namespace mcut {
struct Item { uint8_t c[3]; int32_t cnt; };
struct Box {
    std::vector<Item> items;
    int64_t pop = 0, score = 0;
    int lo[3], hi[3];
    bool dead = false;
};
inline void finish_box(Box& b) {
    for (int d = 0; d < 3; ++d) { b.lo[d] = 255; b.hi[d] = 0; }
    for (const Item& it : b.items)
        for (int d = 0; d < 3; ++d) {
            if (it.c[d] < b.lo[d]) b.lo[d] = it.c[d];
            if (it.c[d] > b.hi[d]) b.hi[d] = it.c[d];
        }
    bool splittable = b.items.size() > 1 &&
        (b.hi[0] > b.lo[0] || b.hi[1] > b.lo[1] || b.hi[2] > b.lo[2]);
    if (splittable) {
        int64_t vol = (int64_t)(b.hi[0] - b.lo[0] + 1)
                      * (b.hi[1] - b.lo[1] + 1) * (b.hi[2] - b.lo[2] + 1);
        b.score = vol * b.pop;
    } else {
        b.score = 0;
    }
}
}  // namespace mcut

// rgb: [npix*3] u8. palette_out: [max_colors*3]. Returns palette size.
long zt_median_cut(const uint8_t* rgb, long npix, long max_colors,
                   uint8_t* palette_out) {
    using namespace mcut;
    if (npix <= 0 || max_colors <= 0) return -1;
    if (max_colors > 256) max_colors = 256;
    std::vector<int32_t> count(32768, 0);
    for (long i = 0; i < npix; ++i) {
        int key = ((rgb[3 * i] >> 3) << 10) | ((rgb[3 * i + 1] >> 3) << 5)
                  | (rgb[3 * i + 2] >> 3);
        count[key]++;
    }
    std::vector<Box> boxes;
    boxes.reserve(2 * max_colors + 2);
    boxes.emplace_back();
    Box& root = boxes[0];
    for (int key = 0; key < 32768; ++key) {
        if (!count[key]) continue;
        int r5 = key >> 10, g5 = (key >> 5) & 31, b5 = key & 31;
        Item it;
        it.c[0] = (uint8_t)((r5 << 3) | (r5 >> 2));
        it.c[1] = (uint8_t)((g5 << 3) | (g5 >> 2));
        it.c[2] = (uint8_t)((b5 << 3) | (b5 >> 2));
        it.cnt = count[key];
        root.items.push_back(it);
        root.pop += count[key];
    }
    long n_colors = (long)root.items.size();
    long target = n_colors < max_colors ? n_colors : max_colors;
    finish_box(root);

    // max-heap on (score, earliest insertion seq); lazy deletion
    struct HE { int64_t score; long seq; size_t bi; };
    auto cmp = [](const HE& a, const HE& b) {
        if (a.score != b.score) return a.score < b.score;
        return a.seq > b.seq;
    };
    std::vector<HE> heap;
    auto hpush = [&](size_t bi, long seq) {
        heap.push_back({boxes[bi].score, seq, bi});
        std::push_heap(heap.begin(), heap.end(), cmp);
    };
    long seq = 0;
    hpush(0, seq++);
    long n_live = 1;
    while (n_live < target && !heap.empty()) {
        std::pop_heap(heap.begin(), heap.end(), cmp);
        HE top = heap.back();
        heap.pop_back();
        if (boxes[top.bi].dead) continue;
        if (top.score == 0) break;
        Box src = std::move(boxes[top.bi]);
        boxes[top.bi].dead = true;
        n_live--;
        int dim = 0;
        int ext = src.hi[0] - src.lo[0];
        for (int d = 1; d < 3; ++d)  // strict >: first max wins ties
            if (src.hi[d] - src.lo[d] > ext) { ext = src.hi[d] - src.lo[d]; dim = d; }
        std::stable_sort(src.items.begin(), src.items.end(),
                         [dim](const Item& a, const Item& b) {
                             return a.c[dim] < b.c[dim];
                         });
        int64_t half = src.pop / 2;
        int64_t acc = 0;
        size_t cut = src.items.size();
        for (size_t i = 0; i < src.items.size(); ++i) {
            acc += src.items[i].cnt;
            if (acc >= half) { cut = i + 1; break; }
        }
        if (cut < 1) cut = 1;
        if (cut > src.items.size() - 1) cut = src.items.size() - 1;
        Box left, right;
        left.items.assign(src.items.begin(), src.items.begin() + cut);
        right.items.assign(src.items.begin() + cut, src.items.end());
        for (const Item& it : left.items) left.pop += it.cnt;
        right.pop = src.pop - left.pop;
        finish_box(left);
        finish_box(right);
        boxes.push_back(std::move(left));
        hpush(boxes.size() - 1, seq++);
        boxes.push_back(std::move(right));
        hpush(boxes.size() - 1, seq++);
        n_live += 2;
    }
    long out = 0;
    for (const Box& b : boxes) {
        if (b.dead) continue;
        uint64_t s[3] = {0, 0, 0}, wsum = 0;
        for (const Item& it : b.items) {
            for (int d = 0; d < 3; ++d)
                s[d] += (uint64_t)it.c[d] * (uint64_t)it.cnt;
            wsum += (uint64_t)it.cnt;
        }
        for (int d = 0; d < 3; ++d)
            palette_out[3 * out + d] = (uint8_t)(s[d] / wsum);
        out++;
    }
    return out;
}

// ---------------------------------------------------------------------------
// 5-bit RGB cube -> nearest-palette-index table (reference:
// quantize.zig ColorLookupTable). Brute force over the palette per
// cell with FIRST-minimum tie-break (lowest palette index), identical
// to np.argmin over the distance matrix. The palette loop is branch-
// light and autovectorizes over entries.
int zt_clt_build(const uint8_t* palette, long n, uint8_t* table) {
    if (n <= 0 || n > 256) return -1;
    int32_t pr[256], pg[256], pb[256];
    for (long i = 0; i < n; ++i) {
        pr[i] = palette[3 * i];
        pg[i] = palette[3 * i + 1];
        pb[i] = palette[3 * i + 2];
    }
    for (int r = 0; r < 32; ++r) {
        int cr = (r << 3) | (r >> 2);
        for (int g = 0; g < 32; ++g) {
            int cg = (g << 3) | (g >> 2);
            for (int b = 0; b < 32; ++b) {
                int cb = (b << 3) | (b >> 2);
                int32_t bestd = INT32_MAX;
                int best = 0;
                for (long i = 0; i < n; ++i) {
                    int32_t dr = cr - pr[i];
                    int32_t dg = cg - pg[i];
                    int32_t db = cb - pb[i];
                    int32_t d = dr * dr + dg * dg + db * db;
                    // strict < keeps the FIRST index among ties
                    if (d < bestd) { bestd = d; best = (int)i; }
                }
                table[(r * 32 + g) * 32 + b] = (uint8_t)best;
            }
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Sixel band emitter (reference: src/terminal/sixel.zig emit loop).
// idx: [h][w] palette indices; emits the band section of the sixel
// stream (everything between the palette definitions and the ST):
// per 6-row band, per used color ascending: "#<c>" + RLE'd sixel
// chars ('!'<run><ch> for runs > 3), colors separated by "$", bands by
// "-" (no trailing "-"). Byte-identical to the python fallback.
long zt_sixel_emit(const uint8_t* idx, long h, long w, uint8_t* out,
                   long cap) {
    std::vector<uint8_t> bits((size_t)256 * w);
    bool used[256];
    long pos = 0;
    auto put = [&](const char* s, long n) -> bool {
        if (pos + n > cap) return false;
        std::memcpy(out + pos, s, n);
        pos += n;
        return true;
    };
    char tmp[32];
    for (long band = 0; band < h; band += 6) {
        int rows = (int)(h - band < 6 ? h - band : 6);
        std::memset(bits.data(), 0, bits.size());
        std::memset(used, 0, sizeof used);
        for (int r = 0; r < rows; ++r) {
            const uint8_t* row = idx + (band + r) * w;
            uint8_t bit = (uint8_t)(1 << r);
            for (long x = 0; x < w; ++x) {
                bits[(size_t)row[x] * w + x] |= bit;
                used[row[x]] = true;
            }
        }
        bool first = true;
        for (int c = 0; c < 256; ++c) {
            if (!used[c]) continue;
            if (!first && !put("$", 1)) return -1;
            first = false;
            int n = snprintf(tmp, sizeof tmp, "#%d", c);
            if (!put(tmp, n)) return -1;
            const uint8_t* b = &bits[(size_t)c * w];
            long end = w;
            while (end > 0 && b[end - 1] == 0) end--;
            long x = 0;
            while (x < end) {
                uint8_t v = b[x];
                long run = 1;
                while (x + run < end && b[x + run] == v) run++;
                char ch = (char)(v + 63);
                if (run > 3) {
                    n = snprintf(tmp, sizeof tmp, "!%ld%c", run, ch);
                    if (!put(tmp, n)) return -1;
                } else {
                    for (long k = 0; k < run; ++k)
                        if (!put(&ch, 1)) return -1;
                }
                x += run;
            }
        }
        if (band + 6 < h && !put("-", 1)) return -1;
    }
    return pos;
}

// ---------------------------------------------------------------------------
// One-shot zlib-stream DEFLATE encoder specialised for PNG scanlines:
// distance-1 run matches only (the same token stream zlib's Z_RLE
// strategy produces) coded with a single dynamic-Huffman block and a
// 64-bit LSB-first bit buffer. On photographic MSD residuals this is
// ~3x faster than zlib at near-identical output size; the Python layer
// keeps zlib's default strategy for smooth synthetic content where
// real LZ77 matching wins (codecs/png.py _deflate).

namespace zdef {

struct BitWriter {
    // Byte-granular flushing keeps nbits < 8 after every put, so a
    // single put may append up to 56 bits — three fused literal codes
    // (<= 45 bits) land in ONE append instead of three.
    uint8_t* dst;
    long cap, pos = 0;
    uint64_t acc = 0;
    int nbits = 0;
    bool fail = false;

    inline void put(uint64_t code, int len) {  // LSB-first, len <= 56
        acc |= code << nbits;
        nbits += len;
        if (pos + 8 > cap) { fail = true; nbits = 0; acc = 0; return; }
        std::memcpy(dst + pos, &acc, 8);  // little-endian host
        pos += nbits >> 3;
        acc >>= (unsigned)(nbits & ~7);
        nbits &= 7;
    }
    void flush_byte() {
        if (nbits > 0) {
            if (pos >= cap) { fail = true; return; }
            dst[pos++] = (uint8_t)(acc & 0xFF);
        }
        acc = 0;
        nbits = 0;
    }
};

// canonical Huffman code lengths (max 15) from symbol counts; writes
// lens[0..n); symbols with zero count get length 0
inline void huff_lengths(const uint32_t* counts, int n, uint8_t* lens,
                         int maxlen) {
    struct Node { uint64_t w; int sym, l, r; };
    std::vector<Node> nodes;
    std::vector<int> heap;
    nodes.reserve(2 * n);
    for (int i = 0; i < n; i++) {
        lens[i] = 0;
        if (counts[i]) {
            nodes.push_back({counts[i], i, -1, -1});
            heap.push_back((int)nodes.size() - 1);
        }
    }
    if (heap.empty()) return;
    if (heap.size() == 1) { lens[nodes[heap[0]].sym] = 1; return; }
    auto cmp = [&](int a, int b) { return nodes[a].w > nodes[b].w; };
    std::make_heap(heap.begin(), heap.end(), cmp);
    while (heap.size() > 1) {
        std::pop_heap(heap.begin(), heap.end(), cmp);
        int a = heap.back(); heap.pop_back();
        std::pop_heap(heap.begin(), heap.end(), cmp);
        int b = heap.back(); heap.pop_back();
        nodes.push_back({nodes[a].w + nodes[b].w, -1, a, b});
        heap.push_back((int)nodes.size() - 1);
        std::push_heap(heap.begin(), heap.end(), cmp);
    }
    // depth-assign iteratively
    std::vector<std::pair<int, int>> stack;  // (node, depth)
    int over = 0;
    stack.push_back({heap[0], 0});
    while (!stack.empty()) {
        auto [ni, d] = stack.back(); stack.pop_back();
        const Node& nd = nodes[ni];
        if (nd.sym >= 0) {
            int l = d < 1 ? 1 : d;
            if (l > maxlen) { l = maxlen; over++; }
            lens[nd.sym] = (uint8_t)l;
        } else {
            stack.push_back({nd.l, d + 1});
            stack.push_back({nd.r, d + 1});
        }
    }
    if (over) {
        // Clamping overfull leaves broke the Kraft equality; restore it
        // exactly (inflate rejects both over-subscribed AND incomplete
        // multi-symbol codes). Phase 1: lengthen shallowest leaves
        // until the sum fits; phase 2: shorten maxlen leaves (each
        // step adds exactly 1 to the sum in 2^0 units) to land on
        // equality.
        auto kraft = [&]() {
            long long k = 0;
            for (int i = 0; i < n; i++)
                if (lens[i]) k += 1LL << (maxlen - lens[i]);
            return k;
        };
        while (kraft() > (1LL << maxlen)) {
            // deepest non-max leaf: rarest symbol, cheapest to lengthen
            int best = -1;
            for (int i = 0; i < n; i++)
                if (lens[i] && lens[i] < maxlen
                    && (best < 0 || lens[i] > lens[best])) best = i;
            lens[best]++;
        }
        long long deficit = (1LL << maxlen) - kraft();
        while (deficit > 0) {
            int best = -1;  // deepest leaf; maxlen leaves gain exactly 1
            for (int i = 0; i < n; i++)
                if (lens[i] > 1 && (best < 0 || lens[i] > lens[best]))
                    best = i;
            long long gain = 1LL << (maxlen - lens[best]);
            if (gain <= deficit) { lens[best]--; deficit -= gain; }
            else break;  // cannot happen: maxlen leaves exist while over
        }
    }
}

// canonical codes (DEFLATE bit order: emitted LSB-first means the code
// value must be bit-reversed)
inline void huff_codes(const uint8_t* lens, int n, uint32_t* codes) {
    int bl_count[16] = {0};
    for (int i = 0; i < n; i++) bl_count[lens[i]]++;
    bl_count[0] = 0;
    uint32_t next[16] = {0};
    uint32_t code = 0;
    for (int b = 1; b <= 15; b++) {
        code = (code + bl_count[b - 1]) << 1;
        next[b] = code;
    }
    for (int i = 0; i < n; i++) {
        if (!lens[i]) { codes[i] = 0; continue; }
        uint32_t c = next[lens[i]]++;
        uint32_t r = 0;  // bit-reverse to lens[i] bits
        for (int b = 0; b < lens[i]; b++) r = (r << 1) | ((c >> b) & 1);
        codes[i] = r;
    }
}

// DEFLATE length code table: code 257+k, base lengths / extra bits
static const int LBASE[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,
                              35,43,51,59,67,83,99,115,131,163,195,227,258};
static const int LXBITS[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,
                               3,3,3,3,4,4,4,4,5,5,5,5,0};

inline int length_code(int len) {  // len in [3, 258] -> 0..28
    static int lut[259];
    static bool init = false;
    if (!init) {
        for (int c = 0; c < 29; c++) {
            int hi = (c == 28) ? 258 : LBASE[c + 1] - 1;
            for (int l = LBASE[c]; l <= hi && l <= 258; l++) lut[l] = c;
        }
        lut[258] = 28;
        init = true;
    }
    return lut[len];
}

}  // namespace zdef

// src -> zlib stream in dst; returns bytes written or -1 (cap too
// small — caller falls back to zlib). Cap contract: BitWriter::put
// memcpy's a full 8-byte window, so the writer requires 8 bytes of
// headroom past the final bit position — size dst at least
// (worst-case stream + 8); the Python wrapper's 2*n + 4096 satisfies
// this with huge margin.
long zt_zlib_rle_compress(const uint8_t* src, long n, uint8_t* dst,
                          long cap) {
    using namespace zdef;
    if (cap < 16) return -1;
    // ZT_PNG_PROFILE=1: per-pass stderr timers (tokenize / histogram /
    // header / emit / adler) for stage attribution without a separate
    // instrumented build.
    static const bool prof = std::getenv("ZT_PNG_PROFILE") != nullptr;
    auto now = []() {
        struct timespec ts;
        clock_gettime(CLOCK_MONOTONIC, &ts);
        return ts.tv_sec * 1e3 + ts.tv_nsec * 1e-6;
    };
    double t0 = prof ? now() : 0.0, t_tok = 0, t_hist = 0, t_hdr = 0,
           t_emit = 0;

    // pass 1: tokenize into (literal | run) ONCE, recording runs so the
    // emit pass never re-scans. Runs are distance-1 matches: at i, match
    // length = count of src[i] == src[i-1] forward, >= 3 to take (mirrors
    // Z_RLE's emission). Equal-neighbor pairs are located 8 bytes at a
    // time via the XOR zero-byte trick — photographic residuals are
    // nearly run-free, so the fast path dominates.
    uint32_t lit_cnt[286] = {0};
    static thread_local std::vector<long> run_pos;
    static thread_local std::vector<int> run_len;
    run_pos.clear();
    run_len.clear();
    // take runs of >= 3 equal-to-previous bytes, each capped at 258,
    // exactly as a serial tokenizer would (a stretch of length L yields
    // floor(L/258) full runs + remainder-if->=3; remainders < 3 fall
    // back to literals — inside a uniform stretch the next byte still
    // equals its predecessor, so chained re-takes are legal)
    auto take_runs = [&](long p, long stretch) {
        while (stretch >= 3) {
            long take = stretch < 258 ? stretch : 258;
            run_pos.push_back(p);
            run_len.push_back((int)take);
            lit_cnt[257 + length_code((int)take)]++;
            p += take;
            stretch -= take;
        }
    };
    {
        long i = 1;
#if defined(__AVX512BW__)
        // 64-byte equal-neighbor masks: bit k of m = (src[i+k] ==
        // src[i+k-1]), so a stretch of S equal bytes = S consecutive
        // mask bits. m & m>>1 & m>>2 is nonzero only where >= 3
        // consecutive bits start, which skips the ubiquitous 1-2 byte
        // stretches of smooth content wholesale (the old code dropped
        // to a byte-at-a-time loop for EVERY equal pair). Bits 62-63 of
        // m3 see shifted-in garbage, so windows step by 62: any
        // stretch's first three mask bits then land fully inside some
        // window, and the first window to see them has the stretch
        // START at its detected bit (an earlier start would have been
        // detected by an earlier window), so no backtracking.
        while (i < n) {
            long s = -1;
            while (i + 64 <= n) {
                __m512i a = _mm512_loadu_si512(src + i);
                __m512i b = _mm512_loadu_si512(src + i - 1);
                uint64_t m = _mm512_cmpeq_epi8_mask(a, b);
                uint64_t m3 = m & (m >> 1) & (m >> 2)
                              & ((1ULL << 62) - 1);
                if (m3) {
                    s = i + (long)__builtin_ctzll(m3);
                    break;
                }
                i += 62;
            }
            if (s < 0) break;  // tail handled by the scalar loop below
            // measure the stretch end with 64-wide compares against v
            uint8_t v = src[s - 1];
            long j = s;
            __m512i vb = _mm512_set1_epi8((char)v);
            while (j + 64 <= n) {
                uint64_t eq = _mm512_cmpeq_epi8_mask(
                    _mm512_loadu_si512(src + j), vb);
                uint64_t ne = ~eq;
                if (ne) {
                    j += (long)__builtin_ctzll(ne);
                    goto measured;
                }
                j += 64;
            }
            while (j < n && src[j] == v) j++;
        measured:
            take_runs(s, j - s);
            i = j;
        }
#endif
        while (i < n) {
            // skip to the next position with src[i] == src[i-1]
            while (i + 8 <= n) {
                uint64_t a, b;
                std::memcpy(&a, src + i, 8);
                std::memcpy(&b, src + i - 1, 8);
                uint64_t x = a ^ b;
                // zero-byte detect
                uint64_t z = (x - 0x0101010101010101ULL) & ~x
                             & 0x8080808080808080ULL;
                if (z) {
                    i += __builtin_ctzll(z) >> 3;
                    break;
                }
                i += 8;
            }
            if (i + 8 > n) {  // scalar tail
                while (i < n && src[i] != src[i - 1]) i++;
            }
            if (i >= n) break;
            uint8_t v = src[i - 1];
            long j = i;
            while (j < n && src[j] == v) j++;
            take_runs(i, j - i);
            i = j;
        }
    }
    if (prof) t_tok = now();
    // literal histogram: all bytes, 4 banks to break the carried
    // dependency, then subtract the run-covered bytes
    {
        uint32_t h0[256] = {0}, h1[256] = {0}, h2[256] = {0}, h3[256] = {0};
        long i = 0;
        for (; i + 4 <= n; i += 4) {
            h0[src[i]]++;
            h1[src[i + 1]]++;
            h2[src[i + 2]]++;
            h3[src[i + 3]]++;
        }
        for (; i < n; i++) h0[src[i]]++;
        for (int s = 0; s < 256; s++)
            lit_cnt[s] += h0[s] + h1[s] + h2[s] + h3[s];
        for (size_t r = 0; r < run_pos.size(); r++)
            lit_cnt[src[run_pos[r]]] -= (uint32_t)run_len[r];
    }
    if (prof) t_hist = now();
    lit_cnt[256] = 1;  // EOB
    // empty input would leave EOB as the sole symbol -> a 1-bit
    // incomplete code that strict inflaters may reject; add a dummy
    // literal so the tree is complete for any decoder
    if (n == 0) lit_cnt[0] = 1;

    uint8_t lit_len[286];
    uint32_t lit_code[286];
    // 14-bit cap (DEFLATE allows 15): four literal codes then fit one
    // 56-bit byte-granular put below; the size cost is ~0 (depth-15
    // leaves need skew beyond photographic residual histograms)
    huff_lengths(lit_cnt, 286, lit_len, 14);
    huff_codes(lit_len, 286, lit_code);
    // distance tree: a single code (dist 1) of length 1; if no match
    // exists the unused tree is still valid per the spec
    uint8_t dst_len[30] = {1};
    uint32_t dst_code[30] = {0};

    BitWriter bw{dst, cap};
    // zlib header: CM=8 CINFO=7, FCHECK makes it a multiple of 31
    dst[0] = 0x78; dst[1] = 0x01; bw.pos = 2;
    bw.put(1, 1);   // BFINAL
    bw.put(2, 2);   // BTYPE = dynamic

    // header: HLIT/HDIST/HCLEN + code-length code (RFC1951 3.2.7)
    int hlit = 286;
    while (hlit > 257 && lit_len[hlit - 1] == 0) hlit--;
    int hdist = 1;
    // RLE the concatenated length arrays with codes 16/17/18
    std::vector<std::pair<int, int>> cl;  // (symbol, extra-value)
    {
        std::vector<uint8_t> all(lit_len, lit_len + hlit);
        all.insert(all.end(), dst_len, dst_len + hdist);
        size_t p = 0;
        while (p < all.size()) {
            uint8_t v = all[p];
            size_t q = p;
            while (q < all.size() && all[q] == v) q++;
            size_t cnt = q - p;
            if (v == 0) {
                while (cnt >= 11) {
                    size_t take = cnt < 138 ? cnt : 138;
                    cl.push_back({18, (int)take - 11});
                    cnt -= take;
                }
                while (cnt >= 3) {
                    size_t take = cnt < 10 ? cnt : 10;
                    cl.push_back({17, (int)take - 3});
                    cnt -= take;
                }
                while (cnt--) cl.push_back({0, -1});
            } else {
                cl.push_back({v, -1});
                cnt--;
                while (cnt >= 3) {
                    size_t take = cnt < 6 ? cnt : 6;
                    cl.push_back({16, (int)take - 3});
                    cnt -= take;
                }
                while (cnt--) cl.push_back({v, -1});
            }
            p = q;
        }
    }
    uint32_t cl_cnt[19] = {0};
    for (auto& t : cl) cl_cnt[t.first]++;
    uint8_t cl_len[19];
    uint32_t cl_code[19];
    huff_lengths(cl_cnt, 19, cl_len, 7);
    huff_codes(cl_len, 19, cl_code);
    static const int CL_ORDER[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,
                                     13,2,14,1,15};
    int hclen = 19;
    while (hclen > 4 && cl_len[CL_ORDER[hclen - 1]] == 0) hclen--;
    bw.put(hlit - 257, 5);
    bw.put(hdist - 1, 5);
    bw.put(hclen - 4, 4);
    for (int k = 0; k < hclen; k++) bw.put(cl_len[CL_ORDER[k]], 3);
    for (auto& t : cl) {
        bw.put(cl_code[t.first], cl_len[t.first]);
        if (t.first == 16) bw.put(t.second, 2);
        else if (t.first == 17) bw.put(t.second, 3);
        else if (t.first == 18) bw.put(t.second, 7);
    }

    if (prof) t_hdr = now();
    // pass 2: emit straight from the pass-1 token records — the literal
    // loop is a pure table-load + bit-append with no run probing. Fused
    // (code | len<<20) entries keep it to one load per literal; the
    // bounds check hoists out (<= 15 bits per literal, so 128 literals
    // stay 256 bytes clear of cap).
    uint32_t fused[286];
    for (int s = 0; s < 286; s++)
        fused[s] = lit_code[s] | ((uint32_t)lit_len[s] << 20);
    auto emit_literals = [&](long p, long e) -> bool {
        while (p < e) {
            if (bw.pos + 512 > cap) return false;
            long lim = p + 128 < e ? p + 128 : e;
            // combine literal QUADS off the accumulator's dependency
            // chain (codes <= 14 bits each by the tree cap above, so a
            // quad is <= 56 bits — one byte-granular put), then feed
            // the chain one put each
            for (; lim - p >= 4; p += 4) {
                uint32_t e0 = fused[src[p]], e1 = fused[src[p + 1]];
                uint32_t e2 = fused[src[p + 2]], e3 = fused[src[p + 3]];
                int l0 = (int)(e0 >> 20), l1 = (int)(e1 >> 20);
                int l2 = (int)(e2 >> 20), l3 = (int)(e3 >> 20);
                uint64_t code = (e0 & 0xFFFFF)
                                | ((uint64_t)(e1 & 0xFFFFF) << l0)
                                | ((uint64_t)(e2 & 0xFFFFF) << (l0 + l1))
                                | ((uint64_t)(e3 & 0xFFFFF)
                                   << (l0 + l1 + l2));
                bw.put(code, l0 + l1 + l2 + l3);
            }
            for (; p < lim; p++) {
                uint32_t e0 = fused[src[p]];
                bw.put(e0 & 0xFFFFF, (int)(e0 >> 20));
            }
        }
        return true;
    };
    long lp = 0;
    for (size_t r = 0; r < run_pos.size(); r++) {
        if (!emit_literals(lp, run_pos[r])) return -1;
        if (bw.pos + 64 > cap) return -1;
        int run = run_len[r];
        int lc = length_code(run);
        bw.put(lit_code[257 + lc], lit_len[257 + lc]);
        if (LXBITS[lc]) bw.put((uint32_t)(run - LBASE[lc]), LXBITS[lc]);
        bw.put(dst_code[0], dst_len[0]);  // dist 1
        lp = run_pos[r] + run;
    }
    if (!emit_literals(lp, n)) return -1;
    if (bw.fail) return -1;
    bw.put(lit_code[256], lit_len[256]);  // EOB
    bw.flush_byte();
    if (bw.fail) return -1;

    if (prof) t_emit = now();
    // adler32, blockwise closed form so the inner loops vectorize: for
    // a block b[0..k), s2' = s2 + k*s1 + sum((k-j)*b[j]) and
    // s1' = s1 + sum(b[j]) — two independent reductions instead of the
    // serial s1+=b; s2+=s1 chain (~1 cycle/byte scalar). k = 4096 keeps
    // sum(j*b[j]) <= 4095*4096/2*255 < 2^32.
    uint32_t s1 = 1, s2 = 0;
    long p = 0;
    while (p < n) {
        long k = (n - p) < 4096 ? (n - p) : 4096;
        const uint8_t* b = src + p;
        uint32_t sum = 0, jsum = 0;
        for (long j = 0; j < k; j++) {
            sum += b[j];
            jsum += (uint32_t)j * b[j];
        }
        s2 = (uint32_t)((s2 + (uint64_t)(s1 % 65521) * (uint64_t)(k % 65521)
                         + (uint64_t)k * sum - jsum) % 65521);
        s1 = (s1 + sum) % 65521;
        p += k;
    }
    if (bw.pos + 4 > cap) return -1;
    uint32_t adler = (s2 << 16) | s1;
    dst[bw.pos++] = (uint8_t)(adler >> 24);
    dst[bw.pos++] = (uint8_t)(adler >> 16);
    dst[bw.pos++] = (uint8_t)(adler >> 8);
    dst[bw.pos++] = (uint8_t)adler;
    if (prof) {
        double t_end = now();
        std::fprintf(stderr,
                     "zt_png_profile tok=%.2f hist=%.2f hdr=%.2f "
                     "emit=%.2f adler=%.2f ms\n",
                     t_tok - t0, t_hist - t_tok, t_hdr - t_hist,
                     t_emit - t_hdr, t_end - t_emit);
    }
    return bw.pos;
}

// ---------------------------------------------------------------------------
// Host-side u8 resize, bit-identical to the device lowerings
// (ops/interpolation.py _resize_bilinear_u8 / _resize_nearest): same f32
// align-centers coordinate math ((dst+0.5)*ratio-0.5), 8.8 fixed-point
// weights with truncation, mirror borders, >>16 truncating final divide.
// Used by the transfer-aware placement layer when the device link cost
// exceeds host compute (remote-tunnel CLI paths).

static inline long zt_mirror_index(long i, long n) {
    if (i >= 0 && i < n) return i;
    if (n == 1) return 0;
    long period = 2 * (n - 1);
    long m = i % period;
    if (m < 0) m += period;
    return m >= n ? period - m : m;
}

long zt_resize_bilinear_u8(const uint8_t* src, long sh, long sw, long c,
                           uint8_t* dst, long dh, long dw) {
    if (sh < 1 || sw < 1 || dh < 1 || dw < 1 || c < 1 || c > 4) return -1;
    const long sstride = sw * c;
    const long dstride = dw * c;
    // per-output-column taps: indices premultiplied by c, weights 8-bit
    std::vector<int32_t> xa(dw), xb(dw), fx(dw);
    {
        float ratio = (float)sw / (float)dw;
        for (long ox = 0; ox < dw; ox++) {
            float sf = ((float)ox + 0.5f) * ratio - 0.5f;
            float fl = std::floor(sf);
            long i0 = (long)fl;
            int f = (int)((sf - fl) * 256.0f);  // trunc, matches np.trunc
            xa[ox] = (int32_t)(zt_mirror_index(i0, sw) * c);
            xb[ox] = (int32_t)(zt_mirror_index(i0 + 1, sw) * c);
            fx[ox] = f;
        }
    }
    std::vector<uint16_t> trow(sstride);  // row pass max 255*256 = 65280
    uint16_t* t = trow.data();
    float ratio_y = (float)sh / (float)dh;
    for (long oy = 0; oy < dh; oy++) {
        float sf = ((float)oy + 0.5f) * ratio_y - 0.5f;
        float fl = std::floor(sf);
        long i0 = (long)fl;
        int fy = (int)((sf - fl) * 256.0f);
        const uint8_t* ra = src + zt_mirror_index(i0, sh) * sstride;
        const uint8_t* rb = src + zt_mirror_index(i0 + 1, sh) * sstride;
        const int wy0 = 256 - fy, wy1 = fy;
        for (long k = 0; k < sstride; k++)  // autovectorizes (widening MAC)
            t[k] = (uint16_t)(ra[k] * wy0 + rb[k] * wy1);
        uint8_t* out = dst + oy * dstride;
        if (c == 3) {
            for (long ox = 0; ox < dw; ox++) {
                const int32_t a = xa[ox], b = xb[ox];
                const int32_t w0 = 256 - fx[ox], w1 = fx[ox];
                out[ox * 3 + 0] = (uint8_t)(((int32_t)t[a] * w0 + (int32_t)t[b] * w1) >> 16);
                out[ox * 3 + 1] = (uint8_t)(((int32_t)t[a + 1] * w0 + (int32_t)t[b + 1] * w1) >> 16);
                out[ox * 3 + 2] = (uint8_t)(((int32_t)t[a + 2] * w0 + (int32_t)t[b + 2] * w1) >> 16);
            }
        } else {
            for (long ox = 0; ox < dw; ox++) {
                const int32_t a = xa[ox], b = xb[ox];
                const int32_t w0 = 256 - fx[ox], w1 = fx[ox];
                for (long ch = 0; ch < c; ch++)
                    out[ox * c + ch] = (uint8_t)(
                        ((int32_t)t[a + ch] * w0 + (int32_t)t[b + ch] * w1) >> 16);
            }
        }
    }
    return 0;
}

// 4x4 cubic-family resampling from caller-built tables (ops/
// interpolation.py _cubic_axis_table: mirror-resolved indices [n, 4],
// 8.8 fixed-point weights [n, 4]). All-integer math: per-tap weights
// trunc(wy*wx/256), truncating final divide — bit-identical to the
// device lowering and the numpy fallback.
long zt_resize_cubic_u8(const uint8_t* src, long sh, long sw, long c,
                        uint8_t* dst, long dh, long dw,
                        const int32_t* y_idx, const int32_t* wy,
                        const int32_t* x_idx, const int32_t* wx) {
    if (sh < 1 || sw < 1 || dh < 1 || dw < 1 || c < 1 || c > 4) return -1;
    const long sstride = sw * c;
    std::vector<int32_t> xoff(dw * 4);
    for (long ox = 0; ox < dw; ox++)
        for (int k = 0; k < 4; k++)
            xoff[ox * 4 + k] = x_idx[ox * 4 + k] * (int32_t)c;
    for (long oy = 0; oy < dh; oy++) {
        const uint8_t* rows[4];
        int32_t wyv[4];
        for (int k = 0; k < 4; k++) {
            rows[k] = src + (size_t)y_idx[oy * 4 + k] * sstride;
            wyv[k] = wy[oy * 4 + k];
        }
        uint8_t* o = dst + (size_t)oy * dw * c;
        for (long ox = 0; ox < dw; ox++) {
            const int32_t* xo = &xoff[ox * 4];
            const int32_t* wxv = &wx[ox * 4];
            int64_t tot[4] = {0, 0, 0, 0};
            int64_t wsum = 0;
            for (int ky = 0; ky < 4; ky++) {
                const uint8_t* r = rows[ky];
                for (int kx = 0; kx < 4; kx++) {
                    int64_t w = ((int64_t)wyv[ky] * wxv[kx]) / 256; // trunc
                    wsum += w;
                    const uint8_t* p = r + xo[kx];
                    for (long ch = 0; ch < c; ch++)
                        tot[ch] += (int64_t)p[ch] * w;
                }
            }
            for (long ch = 0; ch < c; ch++) {
                int64_t v = wsum != 0 ? tot[ch] / wsum : 0;  // trunc
                o[ox * c + ch] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
            }
        }
    }
    return 0;
}

// 6x6 Lanczos3 with f32 weights (tables from _lanczos_axis_table);
// matches the device within +-1 (fma contraction differences).
long zt_resize_lanczos_u8(const uint8_t* src, long sh, long sw, long c,
                          uint8_t* dst, long dh, long dw,
                          const int32_t* y_idx, const float* wy,
                          const int32_t* x_idx, const float* wx) {
    if (sh < 1 || sw < 1 || dh < 1 || dw < 1 || c < 1 || c > 4) return -1;
    const long sstride = sw * c;
    std::vector<int32_t> xoff(dw * 6);
    for (long ox = 0; ox < dw; ox++)
        for (int k = 0; k < 6; k++)
            xoff[ox * 6 + k] = x_idx[ox * 6 + k] * (int32_t)c;
    for (long oy = 0; oy < dh; oy++) {
        const uint8_t* rows[6];
        float wyv[6];
        for (int k = 0; k < 6; k++) {
            rows[k] = src + (size_t)y_idx[oy * 6 + k] * sstride;
            wyv[k] = wy[oy * 6 + k];
        }
        uint8_t* o = dst + (size_t)oy * dw * c;
        for (long ox = 0; ox < dw; ox++) {
            const int32_t* xo = &xoff[ox * 6];
            const float* wxv = &wx[ox * 6];
            float tot[4] = {0, 0, 0, 0};
            float wsum = 0;
            for (int ky = 0; ky < 6; ky++) {
                const uint8_t* r = rows[ky];
                for (int kx = 0; kx < 6; kx++) {
                    // XLA lowers the device accumulation as a ROUNDED
                    // f32 weight product followed by fma into the
                    // accumulator (verified bit-exact vs the CPU XLA
                    // backend; tests/test_native_parity.py). Reproduce
                    // it exactly: the f64 product is exact and the
                    // cast rounds once == f32 mul, and -ffp-contract
                    // cannot re-fuse across the cast; the accumulate
                    // is an explicit fmaf.
                    float w = (float)((double)wyv[ky] * (double)wxv[kx]);
                    wsum += w;
                    const uint8_t* p = r + xo[kx];
                    for (long ch = 0; ch < c; ch++)
                        tot[ch] = __builtin_fmaf((float)p[ch], w, tot[ch]);
                }
            }
            for (long ch = 0; ch < c; ch++) {
                float v = wsum != 0.0f
                              ? std::floor(tot[ch] / wsum + 0.5f) : 0.0f;
                o[ox * c + ch] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
            }
        }
    }
    return 0;
}

long zt_resize_nearest_u8(const uint8_t* src, long sh, long sw, long c,
                          uint8_t* dst, long dh, long dw) {
    if (sh < 1 || sw < 1 || dh < 1 || dw < 1 || c < 1 || c > 4) return -1;
    const long sstride = sw * c;
    std::vector<int32_t> xs(dw);
    {
        float ratio = (float)sw / (float)dw;
        for (long ox = 0; ox < dw; ox++) {
            // Zig @round = half away from zero; coords > -0.5 so floor(x+0.5)
            float sf = ((float)ox + 0.5f) * ratio - 0.5f;
            long x = (long)std::floor(sf + 0.5f);
            if (x < 0) x = 0;
            if (x >= sw) x = sw - 1;
            xs[ox] = (int32_t)(x * c);
        }
    }
    float ratio_y = (float)sh / (float)dh;
    for (long oy = 0; oy < dh; oy++) {
        float sf = ((float)oy + 0.5f) * ratio_y - 0.5f;
        long y = (long)std::floor(sf + 0.5f);
        if (y < 0) y = 0;
        if (y >= sh) y = sh - 1;
        const uint8_t* row = src + y * sstride;
        uint8_t* out = dst + oy * dw * c;
        for (long ox = 0; ox < dw; ox++)
            std::memcpy(out + ox * c, row + xs[ox], (size_t)c);
    }
    return 0;
}

}  // extern "C"
