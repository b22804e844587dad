// libmodjpeg_tpu native entropy codec
//
// From-scratch JPEG (ITU-T T.81) entropy-layer codec: it moves between the
// compressed bitstream and dense quantized-DCT coefficient arrays.  There is
// deliberately NO IDCT, color conversion or upsampling here — all pixel-domain
// math lives on the TPU (JAX/Pallas).  This replaces the reference's
// delegation to libjpeg (image.c:94,191-194) with a
// parallel design: restart-marker-segmented scans decode on multiple threads,
// and encode can emit restart-segmented streams whose byte-aligned segments
// are produced concurrently.
//
// Supported: baseline (SOF0) + extended sequential (SOF1) Huffman decode,
// progressive (SOF2) Huffman decode (DC/AC, first/refine, EOB runs),
// sequential + progressive arithmetic decode (SOF9/SOF10, T.81 Annex D/F),
// baseline/progressive Huffman encode with fixed (Annex K) or optimized
// tables, sequential + progressive arithmetic encode, restart markers both
// directions, APPn/COM marker preservation.

#include <algorithm>
#include <array>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <climits>
#include <cstring>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif
#if defined(__BMI2__)
#include <immintrin.h>
#endif

namespace mjt {

static const int kDctSize2 = 64;

// zigzag index -> natural index
static const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

enum Marker : uint16_t {
  M_SOF0 = 0xFFC0, M_SOF1 = 0xFFC1, M_SOF2 = 0xFFC2, M_SOF3 = 0xFFC3,
  M_DHT = 0xFFC4, M_SOF5 = 0xFFC5, M_SOF6 = 0xFFC6, M_SOF7 = 0xFFC7,
  M_JPG = 0xFFC8, M_SOF9 = 0xFFC9, M_SOF10 = 0xFFCA, M_SOF11 = 0xFFCB,
  M_DAC = 0xFFCC, M_SOF13 = 0xFFCD, M_SOF14 = 0xFFCE, M_SOF15 = 0xFFCF,
  M_RST0 = 0xFFD0, M_RST7 = 0xFFD7, M_SOI = 0xFFD8, M_EOI = 0xFFD9,
  M_SOS = 0xFFDA, M_DQT = 0xFFDB, M_DNL = 0xFFDC, M_DRI = 0xFFDD,
  M_APP0 = 0xFFE0, M_APP14 = 0xFFEE, M_APP15 = 0xFFEF, M_COM = 0xFFFE,
};

struct Error : std::runtime_error {
  explicit Error(const std::string& m) : std::runtime_error(m) {}
};

static inline int idiv_ceil(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// data model
// ---------------------------------------------------------------------------

struct ComponentInfo {
  int id = 0;
  int h_samp = 1, v_samp = 1;
  int quant_tbl_no = 0;
  int width_in_blocks = 0;   // true dims, ceil(comp_samples/8) (T.81 A.1.1)
  int height_in_blocks = 0;
  int padded_w = 0, padded_h = 0;  // dims padded to the MCU multiple
  int dc_tbl_no = 0, ac_tbl_no = 0;  // current scan's selectors
};

struct HuffTable {
  uint8_t counts[17] = {0};
  std::vector<uint8_t> symbols;
  bool present = false;
};

struct Image {
  int width = 0, height = 0, ncomps = 0;
  int precision = 8;  // sample precision: 8 or 12 (T.81 B.2.2)
  int max_h = 1, max_v = 1;
  int mcus_wide = 0, mcus_high = 0;
  bool progressive = false;
  bool arithmetic = false;
  int restart_interval = 0;
  // 0 unknown, 1 gray, 2 rgb, 3 ycbcr, 4 cmyk, 5 ycck
  int jpeg_color_space = 0;
  ComponentInfo comps[4];
  uint16_t qtables[4][64] = {};  // natural order
  bool qtable_present[4] = {false, false, false, false};
  std::vector<int16_t> coefs[4];  // [padded_h][padded_w][64] natural order
  // encode fast path: borrow caller-owned coefficient planes (zero copy)
  const int16_t* ext_coefs[4] = {nullptr, nullptr, nullptr, nullptr};
  // decode fast path: caller-owned output planes (written in-place)
  int16_t* ext_out[4] = {nullptr, nullptr, nullptr, nullptr};
  std::vector<std::pair<uint16_t, std::vector<uint8_t>>> markers;
  // arithmetic conditioning (DAC)
  int arith_dc_L[4] = {0, 0, 0, 0};
  int arith_dc_U[4] = {1, 1, 1, 1};
  int arith_ac_K[4] = {5, 5, 5, 5};

  int16_t* block(int c, int row, int col) {
    int16_t* base = ext_out[c] ? ext_out[c] : coefs[c].data();
    return base + ((size_t)row * comps[c].padded_w + col) * kDctSize2;
  }
  const int16_t* block(int c, int row, int col) const {
    const int16_t* base = ext_coefs[c] ? ext_coefs[c] : coefs[c].data();
    return base + ((size_t)row * comps[c].padded_w + col) * kDctSize2;
  }
};

// ---------------------------------------------------------------------------
// QM-coder state table (ITU-T T.81 Table D.3): {Qe, NMPS, NLPS, switch}
// ---------------------------------------------------------------------------

struct QmEntry { uint16_t qe; uint8_t nmps, nlps, sw; };

static const QmEntry kQmTable[114] = {
    {0x5A1D,1,1,1},     {0x2586,2,14,0},    {0x1114,3,16,0},    {0x080B,4,18,0},
    {0x03D8,5,20,0},    {0x01DA,6,23,0},    {0x00E5,7,25,0},    {0x006F,8,28,0},
    {0x0036,9,30,0},    {0x001A,10,33,0},   {0x000D,11,35,0},   {0x0006,12,9,0},
    {0x0003,13,10,0},   {0x0001,13,12,0},   {0x5A7F,15,15,1},   {0x3F25,16,36,0},
    {0x2CF2,17,38,0},   {0x207C,18,39,0},   {0x17B9,19,40,0},   {0x1182,20,42,0},
    {0x0CEF,21,43,0},   {0x09A1,22,45,0},   {0x072F,23,46,0},   {0x055C,24,48,0},
    {0x0406,25,49,0},   {0x0303,26,51,0},   {0x0240,27,52,0},   {0x01B1,28,54,0},
    {0x0144,29,56,0},   {0x00F5,30,57,0},   {0x00B7,31,59,0},   {0x008A,32,60,0},
    {0x0068,33,62,0},   {0x004E,34,63,0},   {0x003B,35,32,0},   {0x002C,9,33,0},
    {0x5AE1,37,37,1},   {0x484C,38,64,0},   {0x3A0D,39,65,0},   {0x2EF1,40,67,0},
    {0x261F,41,68,0},   {0x1F33,42,69,0},   {0x19A8,43,70,0},   {0x1518,44,72,0},
    {0x1177,45,73,0},   {0x0E74,46,74,0},   {0x0BFB,47,75,0},   {0x09F8,48,77,0},
    {0x0861,49,78,0},   {0x0706,50,79,0},   {0x05CD,51,48,0},   {0x04DE,52,50,0},
    {0x040F,53,50,0},   {0x0363,54,51,0},   {0x02D4,55,52,0},   {0x025C,56,53,0},
    {0x01F8,57,54,0},   {0x01A4,58,55,0},   {0x0160,59,56,0},   {0x0125,60,57,0},
    {0x00F6,61,58,0},   {0x00CB,62,59,0},   {0x00AB,63,61,0},   {0x008F,32,61,0},
    {0x5B12,65,65,1},   {0x4D04,66,80,0},   {0x412C,67,81,0},   {0x37D8,68,82,0},
    {0x2FE8,69,83,0},   {0x293C,70,84,0},   {0x2379,71,86,0},   {0x1EDF,72,87,0},
    {0x1AA9,73,87,0},   {0x174E,74,72,0},   {0x1424,75,72,0},   {0x119C,76,74,0},
    {0x0F6B,77,74,0},   {0x0D51,78,75,0},   {0x0BB6,79,77,0},   {0x0A40,48,77,0},
    {0x5832,81,80,1},   {0x4D1C,82,88,0},   {0x438E,83,89,0},   {0x3BDD,84,90,0},
    {0x34EE,85,91,0},   {0x2EAE,86,92,0},   {0x299A,87,93,0},   {0x2516,71,86,0},
    {0x5570,89,88,1},   {0x4CA9,90,95,0},   {0x44D9,91,96,0},   {0x3E22,92,97,0},
    {0x3824,93,99,0},   {0x32B4,94,99,0},   {0x2E17,86,93,0},   {0x56A8,96,95,1},
    {0x4F46,97,101,0},  {0x47E5,98,102,0},  {0x41CF,99,103,0},  {0x3C3D,100,104,0},
    {0x375E,93,99,0},   {0x5231,102,105,0}, {0x4C0F,103,106,0}, {0x4639,104,107,0},
    {0x415E,99,103,0},  {0x5627,106,105,1}, {0x50E7,107,108,0}, {0x4B85,103,109,0},
    {0x5597,109,110,0}, {0x504F,107,111,0}, {0x5A10,111,110,1}, {0x5522,109,112,0},
    {0x59EB,111,112,1}, {0x5A1D,113,113,0},
};

// ---------------------------------------------------------------------------
// bit reader (entropy-coded segment, 0xFF00 destuffing, zero-fed past marker)
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;

  BitReader(const uint8_t* data, const uint8_t* data_end) : p(data), end(data_end) {}

  // Complete resumable position: restoring (p, acc, nbits) reproduces the
  // exact bit stream from this point, including 0xFF00 destuffing state.
  // This is what makes two-pass parallel decode of restart-free scans
  // possible: the index pass snapshots state at chunk boundaries and
  // workers resume from the snapshots bit-for-bit.
  struct State {
    const uint8_t* p;
    uint64_t acc;
    int nbits;
  };
  State state() const { return State{p, acc, nbits}; }
  BitReader(const State& st, const uint8_t* data_end)
      : p(st.p), end(data_end), acc(st.acc), nbits(st.nbits) {}

  inline void refill() {
    // Bulk path: when the next 8 bytes are plain data (no 0xFF, so no
    // destuffing and no marker can terminate the segment), splice them into
    // the accumulator in one step.  The byte-at-a-time loop below is on the
    // critical dependency chain of every Huffman symbol; this removes ~7/8
    // of its iterations for typical streams.
    if (p + 8 <= end) {
      uint64_t x;
      std::memcpy(&x, p, 8);
      uint64_t ff = x & 0x8080808080808080ull &
                    ((x & 0x7F7F7F7F7F7F7F7Full) + 0x0101010101010101ull);
      if (ff == 0) {
        uint64_t be = __builtin_bswap64(x);
        if (nbits == 0) {
          acc = be;
          nbits = 64;
          p += 8;
        } else {
          int k = (64 - nbits) >> 3;  // bytes the scalar loop would consume
          acc = (acc << (8 * k)) | (be >> (64 - 8 * k));
          p += k;
          nbits += 8 * k;
        }
        return;
      }
    }
    while (nbits <= 56) {
      int byte;
      if (p >= end) {
        byte = 0;
      } else if (*p == 0xFF) {
        if (p + 1 < end && p[1] == 0x00) {
          byte = 0xFF;
          p += 2;
        } else {
          byte = 0;  // real marker terminates the segment; pad with zeros
        }
      } else {
        byte = *p++;
      }
      acc = (acc << 8) | (uint64_t)byte;
      nbits += 8;
    }
  }

  inline uint32_t peek(int n) {
    if (nbits < n) refill();
    return (uint32_t)((acc >> (nbits - n)) & ((1ull << n) - 1));
  }
  inline void consume(int n) { nbits -= n; }
  inline uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    consume(n);
    return v;
  }
  inline int get_bit() { return (int)get(1); }

  // fast path: guarantee bits up front, then read without bounds checks
  inline void ensure(int n) {
    if (nbits < n) refill();
  }
  inline uint32_t peek_nc(int n) const {
    return (uint32_t)((acc >> (nbits - n)) & ((1ull << n) - 1));
  }
  inline uint32_t get_nc(int n) {
    if (n == 0) return 0;
    uint32_t v = peek_nc(n);
    nbits -= n;
    return v;
  }
};

// Position of the n-th (0-based) set bit of `m`, or 64 when absent.
static inline int nth_set_pos(uint64_t m, int n) {
#if defined(__BMI2__)
  uint64_t d = _pdep_u64(1ull << n, m);
  return d ? __builtin_ctzll(d) : 64;
#else
  while (n-- > 0) m &= m - 1;
  return m ? __builtin_ctzll(m) : 64;
#endif
}

// EXTEND per T.81 F.2.2.1.  Branchless: the sign of (v - 2^(s-1)) selects
// the -(2^s - 1) offset, so the data-dependent 50/50 branch (DC sign) never
// reaches the predictor.
static inline int huff_extend(int v, int s) {
  return v + (((v - (1 << (s - 1))) >> 31) & (int)((~0u << s) + 1));
}

// ---------------------------------------------------------------------------
// nonzero-coefficient bitmasks (encoder hot path)
//
// The encoder's dominant cost is walking 64 mostly-zero coefficients per
// block in zigzag order (a scatter).  Instead: one vectorized pass computes
// a natural-order nonzero bitmask, a table-driven bit permutation moves it
// to zigzag order, and the emission loop then jumps nonzero-to-nonzero with
// ctz, loading only the coefficients that actually encode.
// ---------------------------------------------------------------------------

struct ZigTables {
  uint8_t nat_to_zig[64];
  uint64_t spread[8][256];  // [natural byte index][byte value] -> zigzag bits
  ZigTables() {
    for (int k = 0; k < 64; ++k) nat_to_zig[kZigzag[k]] = (uint8_t)k;
    for (int byte = 0; byte < 8; ++byte)
      for (int val = 0; val < 256; ++val) {
        uint64_t m = 0;
        for (int b = 0; b < 8; ++b)
          if (val & (1 << b)) m |= 1ull << nat_to_zig[byte * 8 + b];
        spread[byte][val] = m;
      }
  }
};
static const ZigTables kZig;

static inline uint64_t nonzero_mask_natural(const int16_t* blk) {
#if defined(__SSE2__)
  const __m128i zero = _mm_setzero_si128();
  uint64_t mask = 0;
  for (int i = 0; i < 4; ++i) {
    __m128i a = _mm_loadu_si128((const __m128i*)(blk + i * 16));
    __m128i b = _mm_loadu_si128((const __m128i*)(blk + i * 16 + 8));
    // saturating pack preserves zero-ness exactly (nonzero never packs to 0)
    __m128i eq = _mm_cmpeq_epi8(_mm_packs_epi16(a, b), zero);
    uint32_t z = (uint32_t)_mm_movemask_epi8(eq);
    mask |= (uint64_t)(~z & 0xFFFFu) << (i * 16);
  }
  return mask;
#else
  uint64_t mask = 0;
  for (int i = 0; i < 64; ++i) mask |= (uint64_t)(blk[i] != 0) << i;
  return mask;
#endif
}

static inline uint64_t zigzag_nonzero_mask(const int16_t* blk) {
  uint64_t nat = nonzero_mask_natural(blk);
  uint64_t m = 0;
  for (int byte = 0; byte < 8; ++byte)
    m |= kZig.spread[byte][(nat >> (byte * 8)) & 0xFF];
  return m;
}

// Significance mask: abs(v) >= thresh (thresh = 1 << Al), zigzag order.
// Progressive AC walks with Al > 0 loop over THIS instead of the raw
// nonzero mask, so point-transform zeros never enter the scalar loop —
// they contribute to run lengths purely as mask gaps (round-5 encoder
// profile: the Al=2 high-band first scan spent most of its time
// discovering that raw nonzeros shift to zero).
static inline uint64_t zigzag_significant_mask(const int16_t* blk,
                                               int16_t thresh) {
#if defined(__SSE2__)
  const __m128i t = _mm_set1_epi16((short)(thresh - 1));
  const __m128i zero = _mm_setzero_si128();
  uint64_t nat = 0;
  for (int i = 0; i < 4; ++i) {
    __m128i a = _mm_loadu_si128((const __m128i*)(blk + i * 16));
    __m128i b = _mm_loadu_si128((const __m128i*)(blk + i * 16 + 8));
    // abs via max(v, -v); INT16_MIN saturates to INT16_MAX which still
    // compares >= any valid threshold
    __m128i aa = _mm_max_epi16(a, _mm_subs_epi16(zero, a));
    __m128i ab = _mm_max_epi16(b, _mm_subs_epi16(zero, b));
    __m128i ga = _mm_cmpgt_epi16(aa, t);
    __m128i gb = _mm_cmpgt_epi16(ab, t);
    uint32_t bits = (uint32_t)_mm_movemask_epi8(_mm_packs_epi16(ga, gb));
    nat |= (uint64_t)(bits & 0xFFFFu) << (i * 16);
  }
#else
  uint64_t nat = 0;
  for (int i = 0; i < 64; ++i) {
    int v = blk[i];
    nat |= (uint64_t)((v < 0 ? -v : v) >= thresh) << i;
  }
#endif
  uint64_t m = 0;
  for (int byte = 0; byte < 8; ++byte)
    m |= kZig.spread[byte][(nat >> (byte * 8)) & 0xFF];
  return m;
}

// ---------------------------------------------------------------------------
// Huffman decode tables
// ---------------------------------------------------------------------------

// Primary flat lookup width: one L1 load resolves any code up to this many
// bits (99%+ of symbols even for optimized tables, by the Huffman property
// that length-l codes occur with frequency ~2^-l).  The 8 KB table is
// filled by canonical range-fill (~4 us), so it is built unconditionally.
static const int kHuffFlatBits = 12;

struct HuffDecoder {
  uint16_t lookup[256];   // (nbits<<8)|symbol; 0 = slow path
  int32_t maxcode[18];
  int32_t valoffset[18];
  std::vector<uint8_t> symbols;
  std::vector<uint16_t> flat;  // 1<<kHuffFlatBits entries, same encoding

  void build(const HuffTable& t) {
    symbols = t.symbols;
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      if (t.counts[l]) {
        valoffset[l] = k - code;
        k += t.counts[l];
        code += t.counts[l];
        // over-subscribed table (more codes than the l-bit space holds)
        // would overflow the lookup fill below — reject (T.81 B.2.4.2)
        if (code > (1 << l)) throw Error("invalid Huffman table");
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
        valoffset[l] = 0;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    std::memset(lookup, 0, sizeof(lookup));
    flat.assign((size_t)1 << kHuffFlatBits, 0);
    int idx = 0;
    code = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < t.counts[l]; ++i, ++idx, ++code) {
        uint16_t e = (uint16_t)((l << 8) | symbols[idx]);
        if (l <= 8) {
          int shift = 8 - l;
          int lo = code << shift;
          for (int f = 0; f < (1 << shift); ++f) lookup[lo | f] = e;
        }
        if (l <= kHuffFlatBits) {
          int shift = kHuffFlatBits - l;
          int lo = code << shift;
          for (int f = 0; f < (1 << shift); ++f) flat[lo | f] = e;
        }
      }
      code <<= 1;
    }
  }

  inline int decode(BitReader& br) const {
    uint32_t look = br.peek(kHuffFlatBits);
    uint16_t entry = flat[look];
    if (entry != 0) {
      br.consume(entry >> 8);
      return entry & 0xFF;
    }
    return decode_slow(br, look >> (kHuffFlatBits - 8));
  }

  // fast variant: caller has already ensured >= 26 bits are buffered
  inline int decode_nc(BitReader& br) const {
    uint32_t look = br.peek_nc(kHuffFlatBits);
    uint16_t entry = flat[look];
    if (entry != 0) {
      br.nbits -= entry >> 8;
      return entry & 0xFF;
    }
    return decode_slow(br, look >> (kHuffFlatBits - 8));
  }

  int decode_slow(BitReader& br, uint32_t look) const {
    int l = 8;
    int32_t code = (int32_t)look;
    br.consume(8);
    while (code > maxcode[l]) {
      code = (code << 1) | br.get_bit();
      if (++l > 16) throw Error("bad Huffman code");
    }
    int idx = valoffset[l] + code;
    if (idx < 0 || idx >= (int)symbols.size())
      throw Error("corrupt Huffman code");
    return symbols[idx];
  }
};

}  // namespace mjt

#include "decoder.inc"
#include "arith.inc"
#include "encoder.inc"
#include "api.inc"
