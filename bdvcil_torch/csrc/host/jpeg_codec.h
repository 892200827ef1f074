// Host code, not a kernel: the port's own baseline JPEG decoder. It needs no
// libjpeg and reproduces libjpeg-turbo 2.1's output bit for bit (the library
// the JAX package's decoder links), with the library's default settings:
// ISLOW IDCT, fancy upsampling, DCT scaling by 1/2, 1/4 and 1/8.
//
// Takes baseline (SOF0) and extended-sequential (SOF1) Huffman JPEGs, 8-bit,
// with 1 component (gray) or 3 (YCbCr) at 4:2:0, 4:2:2 or 4:4:4, in one
// interleaved scan or one scan per component, with or without restart
// intervals. Refuses everything else (progressive, arithmetic coding,
// lossless, hierarchical, 12-bit, 2 or 4 components, RGB-coded, other
// sampling) and truncated or corrupt streams, by throwing Failure with a
// message that names the form. libjpeg accepts a truncated stream with a
// warning and fills the rest of the image; this decoder does not.
//
// The stages follow libjpeg's sources: jdmarker.c (markers), jdhuff.c
// (entropy decoding), jidctint.c (8x8 ISLOW IDCT), jidctred.c (4x4, 2x2,
// 1x1), jdmaster.c (output dimensions, range-limit table, per-component IDCT
// sizes), jdsample.c (upsampling) and jdcolor.c (YCbCr -> RGB).
//
// Used by decoder.cpp (the batch decode entry points); the encoder is
// jpeg_write.cpp. Header only, so each library compiles it in.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace bdvc_jpeg {

struct Failure : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// zigzag position -> natural (row-major) position in an 8x8 block
inline constexpr int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Read a whole file into buf; throws Failure when it cannot be opened or read.
inline void read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) throw Failure(std::string("cannot open ") + path);
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize(size > 0 ? static_cast<size_t>(size) : 0);
  const size_t got = size > 0 ? std::fread(buf.data(), 1, buf.size(), f) : 0;
  std::fclose(f);
  if (size < 0 || got != buf.size()) throw Failure(std::string("cannot read ") + path);
}

namespace detail {

// ---------------------------------------------------------------------------
// Range limiting after the IDCT: libjpeg's idct range-limit table
// (jdmaster.c prepare_range_limit_table), indexed by (x & RANGE_MASK) with
// RANGE_MASK = 1023. x in [-128, 127] maps to x + 128; [128, 511] to 255;
// [512, 895] wraps to 0; [896, 1023] (x in [-128, -1] + 1024) to x - 896.
// ---------------------------------------------------------------------------
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) t[i] = static_cast<uint8_t>(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = static_cast<uint8_t>(i - 896);
    }
  }
};
inline const uint8_t* range_limit() {
  static const RangeLimit table;
  return table.t;
}
constexpr int kRangeMask = 1023;

// libjpeg's JLONG (a 64-bit long on the hosts this builds for): the IDCTs'
// intermediates, which corrupt coefficients can push past 32 bits
using jlong = int64_t;

// libjpeg's DESCALE: round-half-up arithmetic right shift, cast to int
inline int descale(jlong x, int n) { return static_cast<int>((x + (jlong{1} << (n - 1))) >> n); }

// a dequantized coefficient times 2^shift, as libjpeg's int LEFT_SHIFT of
// DEQUANTIZE (wrapping where it would overflow)
inline int dq_shift(int coef, int q, int shift) {
  return static_cast<int>(static_cast<jlong>(coef * q) * (jlong{1} << shift));
}

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
// FIX(x) = x * 2^13 rounded, as jidctint.c / jidctred.c define them
constexpr jlong F0_211164243 = 1730, F0_298631336 = 2446, F0_390180644 = 3196,
                  F0_509795579 = 4176, F0_541196100 = 4433, F0_601344887 = 4926,
                  F0_720959822 = 5906, F0_765366865 = 6270, F0_850430095 = 6967,
                  F0_899976223 = 7373, F1_061594337 = 8697, F1_175875602 = 9633,
                  F1_272758580 = 10426, F1_451774981 = 11893, F1_501321110 = 12299,
                  F1_847759065 = 15137, F1_961570560 = 16069, F2_053119869 = 16819,
                  F2_172734803 = 17799, F2_562915447 = 20995, F3_072711026 = 25172,
                  F3_624509785 = 29692;

// 8x8 ISLOW inverse DCT (jidctint.c jpeg_idct_islow) with dequantization;
// coef in natural order, q the component's quantization table.
inline void idct_8x8(const int16_t* coef, const int16_t* q, uint8_t* out, int stride) {
  const uint8_t* rl = range_limit();
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int16_t* qq = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      const int dc = dq_shift(in[0], qq[0], kPass1Bits);
      for (int r = 0; r < 8; ++r) w[r * 8] = dc;
      continue;
    }
    jlong z2 = in[16] * qq[16], z3 = in[48] * qq[48];
    jlong z1 = (z2 + z3) * F0_541196100;
    jlong tmp2 = z1 + z3 * -F1_847759065;
    jlong tmp3 = z1 + z2 * F0_765366865;
    z2 = in[0] * qq[0];
    z3 = in[32] * qq[32];
    jlong tmp0 = (z2 + z3) * (jlong{1} << kConstBits);
    jlong tmp1 = (z2 - z3) * (jlong{1} << kConstBits);
    const jlong tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const jlong tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * qq[56];
    tmp1 = in[40] * qq[40];
    tmp2 = in[24] * qq[24];
    tmp3 = in[8] * qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    jlong z4 = tmp1 + tmp3;
    const jlong z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 = z3 * -F1_961570560 + z5;
    z4 = z4 * -F0_390180644 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, s);
    w[56] = descale(tmp10 - tmp3, s);
    w[8] = descale(tmp11 + tmp2, s);
    w[48] = descale(tmp11 - tmp2, s);
    w[16] = descale(tmp12 + tmp1, s);
    w[40] = descale(tmp12 - tmp1, s);
    w[24] = descale(tmp13 + tmp0, s);
    w[32] = descale(tmp13 - tmp0, s);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      const uint8_t v = rl[descale(w[0], kPass1Bits + 3) & kRangeMask];
      std::memset(o, v, 8);
      continue;
    }
    jlong z2 = w[2], z3 = w[6];
    jlong z1 = (z2 + z3) * F0_541196100;
    jlong tmp2 = z1 + z3 * -F1_847759065;
    jlong tmp3 = z1 + z2 * F0_765366865;
    jlong tmp0 = (jlong{w[0]} + w[4]) * (jlong{1} << kConstBits);
    jlong tmp1 = (jlong{w[0]} - w[4]) * (jlong{1} << kConstBits);
    const jlong tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const jlong tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    jlong z4 = tmp1 + tmp3;
    const jlong z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 = z3 * -F1_961570560 + z5;
    z4 = z4 * -F0_390180644 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits + kPass1Bits + 3;
    o[0] = rl[descale(tmp10 + tmp3, s) & kRangeMask];
    o[7] = rl[descale(tmp10 - tmp3, s) & kRangeMask];
    o[1] = rl[descale(tmp11 + tmp2, s) & kRangeMask];
    o[6] = rl[descale(tmp11 - tmp2, s) & kRangeMask];
    o[2] = rl[descale(tmp12 + tmp1, s) & kRangeMask];
    o[5] = rl[descale(tmp12 - tmp1, s) & kRangeMask];
    o[3] = rl[descale(tmp13 + tmp0, s) & kRangeMask];
    o[4] = rl[descale(tmp13 - tmp0, s) & kRangeMask];
  }
}

// 4x4 output from an 8x8 block (jidctred.c jpeg_idct_4x4).
inline void idct_4x4(const int16_t* coef, const int16_t* q, uint8_t* out, int stride) {
  const uint8_t* rl = range_limit();
  int ws[32];
  for (int c = 0; c < 8; ++c) {
    if (c == 4) continue;  // the second pass does not use column 4
    const int16_t* in = coef + c;
    const int16_t* qq = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[40] == 0 && in[48] == 0 &&
        in[56] == 0) {
      const int dc = dq_shift(in[0], qq[0], kPass1Bits);
      for (int r = 0; r < 4; ++r) w[r * 8] = dc;
      continue;
    }
    jlong tmp0 = (in[0] * qq[0]) * (jlong{1} << (kConstBits + 1));
    const jlong tmp2e = (in[16] * qq[16]) * F1_847759065 + (in[48] * qq[48]) * -F0_765366865;
    const jlong tmp10 = tmp0 + tmp2e, tmp12 = tmp0 - tmp2e;
    const jlong z1 = in[56] * qq[56], z2 = in[40] * qq[40], z3 = in[24] * qq[24],
                  z4 = in[8] * qq[8];
    tmp0 = z1 * -F0_211164243 + z2 * F1_451774981 + z3 * -F2_172734803 + z4 * F1_061594337;
    const jlong tmp2 =
        z1 * -F0_509795579 + z2 * -F0_601344887 + z3 * F0_899976223 + z4 * F2_562915447;
    constexpr int s = kConstBits - kPass1Bits + 1;
    w[0] = descale(tmp10 + tmp2, s);
    w[24] = descale(tmp10 - tmp2, s);
    w[8] = descale(tmp12 + tmp0, s);
    w[16] = descale(tmp12 - tmp0, s);
  }
  for (int r = 0; r < 4; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[5] == 0 && w[6] == 0 && w[7] == 0) {
      const uint8_t v = rl[descale(w[0], kPass1Bits + 3) & kRangeMask];
      std::memset(o, v, 4);
      continue;
    }
    jlong tmp0 = w[0] * (jlong{1} << (kConstBits + 1));
    const jlong tmp2e = w[2] * F1_847759065 + w[6] * -F0_765366865;
    const jlong tmp10 = tmp0 + tmp2e, tmp12 = tmp0 - tmp2e;
    const jlong z1 = w[7], z2 = w[5], z3 = w[3], z4 = w[1];
    tmp0 = z1 * -F0_211164243 + z2 * F1_451774981 + z3 * -F2_172734803 + z4 * F1_061594337;
    const jlong tmp2 =
        z1 * -F0_509795579 + z2 * -F0_601344887 + z3 * F0_899976223 + z4 * F2_562915447;
    constexpr int s = kConstBits + kPass1Bits + 3 + 1;
    o[0] = rl[descale(tmp10 + tmp2, s) & kRangeMask];
    o[3] = rl[descale(tmp10 - tmp2, s) & kRangeMask];
    o[1] = rl[descale(tmp12 + tmp0, s) & kRangeMask];
    o[2] = rl[descale(tmp12 - tmp0, s) & kRangeMask];
  }
}

// 2x2 output from an 8x8 block (jidctred.c jpeg_idct_2x2).
inline void idct_2x2(const int16_t* coef, const int16_t* q, uint8_t* out, int stride) {
  const uint8_t* rl = range_limit();
  int ws[16];
  for (int c = 0; c < 8; ++c) {
    if (c == 2 || c == 4 || c == 6) continue;  // not used by the second pass
    const int16_t* in = coef + c;
    const int16_t* qq = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[24] == 0 && in[40] == 0 && in[56] == 0) {
      const int dc = dq_shift(in[0], qq[0], kPass1Bits);
      w[0] = dc;
      w[8] = dc;
      continue;
    }
    const jlong tmp10 = (in[0] * qq[0]) * (jlong{1} << (kConstBits + 2));
    const jlong tmp0 = (in[56] * qq[56]) * -F0_720959822 + (in[40] * qq[40]) * F0_850430095 +
                         (in[24] * qq[24]) * -F1_272758580 + (in[8] * qq[8]) * F3_624509785;
    constexpr int s = kConstBits - kPass1Bits + 2;
    w[0] = descale(tmp10 + tmp0, s);
    w[8] = descale(tmp10 - tmp0, s);
  }
  for (int r = 0; r < 2; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    if (w[1] == 0 && w[3] == 0 && w[5] == 0 && w[7] == 0) {
      const uint8_t v = rl[descale(w[0], kPass1Bits + 3) & kRangeMask];
      o[0] = v;
      o[1] = v;
      continue;
    }
    const jlong tmp10 = w[0] * (jlong{1} << (kConstBits + 2));
    const jlong tmp0 = w[7] * -F0_720959822 + w[5] * F0_850430095 + w[3] * -F1_272758580 +
                         w[1] * F3_624509785;
    constexpr int s = kConstBits + kPass1Bits + 3 + 2;
    o[0] = rl[descale(tmp10 + tmp0, s) & kRangeMask];
    o[1] = rl[descale(tmp10 - tmp0, s) & kRangeMask];
  }
}

// 1x1 output: the DC term alone (jidctred.c jpeg_idct_1x1).
inline void idct_1x1(const int16_t* coef, const int16_t* q, uint8_t* out, int) {
  out[0] = range_limit()[descale(coef[0] * q[0], 3) & kRangeMask];
}

// ---------------------------------------------------------------------------
// Huffman decoding tables (jdhuff.c jpeg_make_d_derived_tbl): a 9-bit
// lookahead table for short codes and maxcode/valoffset for the rest.
// ---------------------------------------------------------------------------
constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t look_len[1 << kLookBits];  // 0: code longer than kLookBits
  uint8_t look_sym[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];

  void build(const uint8_t* counts, const uint8_t* symbols, int nsym, bool dc) {
    if (dc)
      for (int i = 0; i < nsym; ++i)
        if (symbols[i] > 15) throw Failure("corrupt JPEG: bad DC Huffman table");
    std::memcpy(vals, symbols, nsym);
    std::memset(look_len, 0, sizeof(look_len));
    int code = 0, p = 0;
    for (int l = 1; l <= 16; ++l) {
      // the codes of l bits must leave the all-ones code free (jdhuff.c)
      if (code + counts[l - 1] >= (1 << l)) throw Failure("corrupt JPEG: bad Huffman table");
      valoffset[l] = p - code;
      for (int i = 0; i < counts[l - 1]; ++i, ++p, ++code) {
        if (l <= kLookBits) {
          const int shift = kLookBits - l;
          for (int j = 0; j < (1 << shift); ++j) {
            look_len[(code << shift) | j] = static_cast<uint8_t>(l);
            look_sym[(code << shift) | j] = symbols[p];
          }
        }
      }
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    valoffset[17] = 0;
    defined = true;
  }
};

// Entropy-coded segment reader: 0xFF00 unstuffing, 0xFF fill bytes before a
// marker, zero bits once a marker (or the end) is reached. Consuming any of
// those zero bits means the segment was truncated or corrupt.
struct BitReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t acc = 0;  // next bit is the top bit
  int nbits = 0;
  int pad_bits = 0;   // zero bits appended after the marker or the end
  bool at_marker = false;

  void reset(const uint8_t* pos, const uint8_t* stop) {
    p = pos;
    end = stop;
    acc = 0;
    nbits = 0;
    pad_bits = 0;
    at_marker = false;
  }

  void fill() {
    while (nbits <= 56) {
      uint64_t byte = 0;
      if (!at_marker && p < end) {
        byte = *p;
        if (byte != 0xFF) {
          ++p;
        } else {
          const uint8_t* r = p + 1;
          while (r < end && *r == 0xFF) ++r;  // fill bytes
          if (r < end && *r == 0) {
            p = r + 1;  // stuffed 0xFF data byte
          } else {
            at_marker = true;  // p stays on the marker's first 0xFF
            byte = 0;
            pad_bits += 8;
          }
        }
      } else {
        at_marker = true;
        pad_bits += 8;
      }
      acc |= byte << (56 - nbits);
      nbits += 8;
    }
  }

  int get(int n) {  // n in [1, 16], after fill
    const int v = static_cast<int>(acc >> (64 - n));
    acc <<= n;
    nbits -= n;
    return v;
  }

  int decode(const HuffTable& t) {
    const int look = static_cast<int>(acc >> (64 - kLookBits));
    int len = t.look_len[look];
    if (len) {
      acc <<= len;
      nbits -= len;
      return t.look_sym[look];
    }
    for (len = kLookBits + 1; len <= 16; ++len) {
      const int32_t code = static_cast<int32_t>(acc >> (64 - len));
      if (code <= t.maxcode[len]) {
        acc <<= len;
        nbits -= len;
        return t.vals[(t.valoffset[len] + code) & 0xFF];
      }
    }
    throw Failure("corrupt JPEG: bad Huffman code");
  }

  bool overran() const { return nbits < pad_bits; }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

}  // namespace detail

// ---------------------------------------------------------------------------
// The decoder. Construct on a whole file in memory: the constructor reads
// the markers up to the first scan (the header probe needs no more). Then
// one call of decode_raw420 or decode_rgb decodes every scan and reads to
// EOI; a Decoder decodes once.
// ---------------------------------------------------------------------------
class Decoder {
 public:
  struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int td = 0, ta = 0;            // Huffman tables of the current scan
    int bw = 0, bh = 0;            // blocks holding image data (width_in_blocks)
    int mw = 0, mh = 0;            // blocks covered by the interleaved MCUs
    int ss = 8;                    // IDCT output size (8, 4, 2 or 1)
    bool latched = false;
    int16_t q[64];                 // quantization table, natural order
  };

  Decoder(const uint8_t* data, size_t size) : data_(data), end_(data + size) {
    read_header();
  }

  int width() const { return width_; }
  int height() const { return height_; }

  // YCbCr with 2x2 luma and 1x1 chroma sampling: the raw-plane wire's form
  bool is_ycc420() const {
    return ncomp_ == 3 && comp_[0].h == 2 && comp_[0].v == 2 && comp_[1].h == 1 &&
           comp_[1].v == 1 && comp_[2].h == 1 && comp_[2].v == 1;
  }

  // Full-resolution raw planes of a 4:2:0 file, libjpeg's raw_data_out
  // layout: y at ystride = 16 * MCU columns over 16 * MCU rows, cb and cr at
  // cstride = ystride / 2 over half the rows. Only the image's own w x h and
  // ceil(w/2) x ceil(h/2) samples are defined.
  void decode_raw420(std::vector<uint8_t>& y, std::vector<uint8_t>& cb, std::vector<uint8_t>& cr,
                     int& ystride, int& cstride) {
    if (!is_ycc420()) throw Failure("raw planes need a 4:2:0 YCbCr JPEG");
    for (int c = 0; c < 3; ++c) comp_[c].ss = 8;
    std::vector<uint8_t>* planes[3] = {&y, &cb, &cr};
    decode_planes(planes);
    ystride = stride_[0];
    cstride = stride_[1];
  }

  // RGB at 1/denom (denom 1, 2, 4 or 8), as libjpeg outputs it with
  // out_color_space = JCS_RGB, scale_num = 1, scale_denom = denom.
  void decode_rgb(int denom, std::vector<uint8_t>& out, int& out_w, int& out_h) {
    const int min_ss = denom == 1 ? 8 : denom == 2 ? 4 : denom == 4 ? 2 : 1;
    // jdmaster.c: scale chroma up by IDCT rather than by upsampling where the
    // sampling ratios allow it
    for (int c = 0; c < ncomp_; ++c) {
      int ss = min_ss;
      while (ss < 8 && (max_h_ * min_ss) % (comp_[c].h * ss * 2) == 0 &&
             (max_v_ * min_ss) % (comp_[c].v * ss * 2) == 0)
        ss *= 2;
      comp_[c].ss = ss;
    }
    std::vector<uint8_t> planes_store[3];
    std::vector<uint8_t>* planes[3] = {&planes_store[0], &planes_store[1], &planes_store[2]};
    decode_planes(planes);
    out_w = static_cast<int>((static_cast<long>(width_) * min_ss + 7) / 8);
    out_h = static_cast<int>((static_cast<long>(height_) * min_ss + 7) / 8);
    out.resize(static_cast<size_t>(out_w) * out_h * 3);
    to_rgb(planes_store, min_ss, out.data(), out_w, out_h);
  }

 private:
  // --------------------------------------------------------------- markers
  int u16(const uint8_t* at) const {
    if (at + 2 > end_) throw Failure("truncated JPEG: marker segment");
    return (at[0] << 8) | at[1];
  }

  // The segment after the marker at pos_: its payload [begin, end) and pos_
  // moved past it.
  const uint8_t* segment(int& len) {
    len = u16(pos_) - 2;
    const uint8_t* begin = pos_ + 2;
    if (len < 0 || begin + len > end_) throw Failure("truncated JPEG: marker segment");
    pos_ = begin + len;
    return begin;
  }

  // Next marker code from pos_, skipping anything before it (jdmarker.c
  // next_marker) and 0xFF fill bytes.
  int next_marker() {
    for (;;) {
      while (pos_ < end_ && *pos_ != 0xFF) ++pos_;
      while (pos_ < end_ && *pos_ == 0xFF) ++pos_;
      if (pos_ >= end_) throw Failure("truncated JPEG: no EOI marker");
      const int m = *pos_++;
      if (m != 0) return m;
    }
  }

  // the coding process of SOFn, n in 2..15 but 4, 8, 12 (ITU T.81 Table B.1)
  static std::string sof_form(int n) {
    std::string f;
    if (n == 5 || n == 6 || n == 7 || n >= 13) f = "hierarchical ";
    if (n % 4 == 2) f += "progressive";
    else if (n % 4 == 3) f += "lossless";
    else f += "sequential";
    if (n >= 9) f += " arithmetic-coded";
    return f;
  }

  static std::string hex(int m) {
    char buf[8];
    std::snprintf(buf, sizeof(buf), "%02X", m);
    return buf;
  }

  void read_header() {
    if (end_ - data_ < 2 || data_[0] != 0xFF || data_[1] != 0xD8)
      throw Failure("not a JPEG file (no SOI marker)");
    pos_ = data_ + 2;
    for (;;) {
      const int m = next_marker();
      if (m == 0xDA) {
        if (!have_frame_) throw Failure("corrupt JPEG: scan before frame header");
        read_sos();
        return;
      }
      if (!read_table_or_skip(m)) {
        if (m == 0xC0 || m == 0xC1) {
          read_sof();
        } else if (m == 0xD9) {
          throw Failure("corrupt JPEG: EOI before any scan");
        } else {
          throw Failure("unsupported or unknown JPEG marker FF" + hex(m));
        }
      }
    }
  }

  // DQT, DHT, DRI, APPn, COM, DAC and stray RSTn; SOFn forms that are not
  // taken are refused here. Returns false for markers left to the caller.
  bool read_table_or_skip(int m) {
    int len;
    if (m == 0xDB) {
      const uint8_t* s = segment(len);
      read_dqt(s, len);
    } else if (m == 0xC4) {
      const uint8_t* s = segment(len);
      read_dht(s, len);
    } else if (m == 0xDD) {
      const uint8_t* s = segment(len);
      if (len < 2) throw Failure("corrupt JPEG: DRI segment");
      restart_interval_ = (s[0] << 8) | s[1];
    } else if (m >= 0xE0 && m <= 0xEF) {
      const uint8_t* s = segment(len);
      if (m == 0xE0 && len >= 14 && std::memcmp(s, "JFIF\0", 5) == 0) saw_jfif_ = true;
      if (m == 0xEE && len >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
        saw_adobe_ = true;
        adobe_transform_ = s[11];
      }
    } else if (m == 0xFE || m == 0xCC) {
      segment(len);  // COM; DAC (arithmetic conditioning) is refused at SOF
    } else if (m >= 0xD0 && m <= 0xD7) {
      // a stray RSTn outside a scan carries nothing (jdmarker.c ignores it)
    } else if (m >= 0xC2 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      throw Failure(sof_form(m - 0xC0) + " JPEG (SOF" + std::to_string(m - 0xC0) +
                    ") is not supported");
    } else {
      return false;
    }
    return true;
  }

  void read_dqt(const uint8_t* s, int len) {
    const uint8_t* e = s + len;
    while (s < e) {
      const int pq = s[0] >> 4, tq = s[0] & 15;
      ++s;
      if (tq > 3 || pq > 1) throw Failure("corrupt JPEG: DQT segment");
      const int n = pq ? 128 : 64;
      if (s + n > e) throw Failure("corrupt JPEG: DQT segment");
      for (int i = 0; i < 64; ++i) {
        const int v = pq ? (s[2 * i] << 8) | s[2 * i + 1] : s[i];
        qt_[tq][kNatural[i]] = static_cast<int16_t>(v);
      }
      qt_defined_[tq] = true;
      s += n;
    }
  }

  void read_dht(const uint8_t* s, int len) {
    const uint8_t* e = s + len;
    while (s < e) {
      if (s + 17 > e) throw Failure("corrupt JPEG: DHT segment");
      const int tc = s[0] >> 4, th = s[0] & 15;
      if (tc > 1 || th > 3) throw Failure("corrupt JPEG: DHT segment");
      int total = 0;
      for (int i = 0; i < 16; ++i) total += s[1 + i];
      if (total > 256 || s + 17 + total > e) throw Failure("corrupt JPEG: DHT segment");
      (tc ? ac_[th] : dc_[th]).build(s + 1, s + 17, total, tc == 0);
      s += 17 + total;
    }
  }

  void read_sof() {
    if (have_frame_) throw Failure("corrupt JPEG: two frame headers");
    int len;
    const uint8_t* s = segment(len);
    if (len < 6) throw Failure("corrupt JPEG: SOF segment");
    if (s[0] != 8) throw Failure(std::to_string(s[0]) + "-bit JPEG is not supported");
    height_ = (s[1] << 8) | s[2];
    width_ = (s[3] << 8) | s[4];
    ncomp_ = s[5];
    if (height_ == 0) throw Failure("JPEG with a DNL-defined height is not supported");
    if (width_ == 0) throw Failure("corrupt JPEG: empty image");
    if (ncomp_ != 1 && ncomp_ != 3)
      throw Failure(std::to_string(ncomp_) + "-component JPEG is not supported");
    if (len < 6 + 3 * ncomp_) throw Failure("corrupt JPEG: SOF segment");
    max_h_ = max_v_ = 1;
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      k.id = s[6 + 3 * c];
      k.h = s[7 + 3 * c] >> 4;
      k.v = s[7 + 3 * c] & 15;
      k.tq = s[8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
        throw Failure("corrupt JPEG: SOF component");
      max_h_ = k.h > max_h_ ? k.h : max_h_;
      max_v_ = k.v > max_v_ ? k.v : max_v_;
    }
    if (ncomp_ == 3) {
      // jdapimin.c default_decompress_parms: the colour space
      bool rgb;
      if (saw_jfif_) rgb = false;
      else if (saw_adobe_) rgb = adobe_transform_ == 0;
      else rgb = comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B';
      if (rgb) throw Failure("RGB-coded 3-component JPEG is not supported");
      const Component &y = comp_[0], &cb = comp_[1], &cr = comp_[2];
      const bool chroma_1x1 = cb.h == 1 && cb.v == 1 && cr.h == 1 && cr.v == 1;
      const bool ok = (chroma_1x1 && ((y.h == 2 && y.v == 2) || (y.h == 2 && y.v == 1) ||
                                      (y.h == 1 && y.v == 1))) ||
                      (y.h == cb.h && y.h == cr.h && y.v == cb.v && y.v == cr.v);
      if (!ok) {
        std::string f = "JPEG sampling ";
        for (int c = 0; c < 3; ++c)
          f += (c ? "," : "") + std::to_string(comp_[c].h) + "x" + std::to_string(comp_[c].v);
        throw Failure(f + " is not supported (takes 4:2:0, 4:2:2, 4:4:4)");
      }
    }
    mcu_cols_ = static_cast<int>((width_ + 8L * max_h_ - 1) / (8L * max_h_));
    mcu_rows_ = static_cast<int>((height_ + 8L * max_v_ - 1) / (8L * max_v_));
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      k.bw = static_cast<int>((static_cast<long>(width_) * k.h + 8L * max_h_ - 1) / (8L * max_h_));
      k.bh = static_cast<int>((static_cast<long>(height_) * k.v + 8L * max_v_ - 1) / (8L * max_v_));
      k.mw = mcu_cols_ * k.h;
      k.mh = mcu_rows_ * k.v;
    }
    have_frame_ = true;
  }

  void read_sos() {
    int len;
    const uint8_t* s = segment(len);
    if (len < 1) throw Failure("corrupt JPEG: SOS segment");
    ns_ = s[0];
    if (ns_ < 1 || ns_ > 4 || len < 1 + 2 * ns_ + 3) throw Failure("corrupt JPEG: SOS segment");
    int blocks = 0;
    for (int i = 0; i < ns_; ++i) {
      const int id = s[1 + 2 * i];
      int c = 0;
      while (c < ncomp_ && comp_[c].id != id) ++c;
      if (c == ncomp_) throw Failure("corrupt JPEG: SOS names an unknown component");
      for (int j = 0; j < i; ++j)
        if (scan_comp_[j] == c) throw Failure("corrupt JPEG: component twice in a scan");
      scan_comp_[i] = c;
      comp_[c].td = s[2 + 2 * i] >> 4;
      comp_[c].ta = s[2 + 2 * i] & 15;
      if (comp_[c].td > 3 || comp_[c].ta > 3) throw Failure("corrupt JPEG: SOS segment");
      blocks += ns_ == 1 ? 1 : comp_[c].h * comp_[c].v;
    }
    if (blocks > 10) throw Failure("corrupt JPEG: too many blocks in an MCU");
    pos_scan_ = pos_;
  }

  // ------------------------------------------------------------ scan data
  // Decode every scan from the one read_header stopped at through EOI into
  // per-component coefficient blocks, then run each component's IDCT into
  // its plane at the component's IDCT size.
  void decode_planes(std::vector<uint8_t>* planes[3]) {
    // every coded block takes at least 2 bits (a DC code and an AC one), so
    // a frame of more blocks than that is truncated or its header corrupt:
    // refuse it before allocating for it
    long blocks = 0;
    for (int c = 0; c < ncomp_; ++c) blocks += static_cast<long>(comp_[c].bw) * comp_[c].bh;
    if (blocks > 4 * (end_ - data_))
      throw Failure("truncated or corrupt JPEG: the file is too short for the frame's blocks");
    std::vector<int16_t> coefs[3];
    for (int c = 0; c < ncomp_; ++c) {
      const Component& k = comp_[c];
      stride_[c] = k.mw * k.ss;
      planes[c]->resize(static_cast<size_t>(stride_[c]) * k.mh * k.ss);
      coefs[c].assign(static_cast<size_t>(k.mw) * k.mh * 64, 0);
    }
    bool scanned[3] = {false, false, false};
    for (;;) {
      for (int i = 0; i < ns_; ++i) {
        const int c = scan_comp_[i];
        if (scanned[c]) throw Failure("corrupt JPEG: component in two scans");
        scanned[c] = true;
        Component& k = comp_[c];
        if (!k.latched) {  // jdinput.c latch_quant_tables
          if (!qt_defined_[k.tq]) throw Failure("corrupt JPEG: missing quantization table");
          std::memcpy(k.q, qt_[k.tq], sizeof(k.q));
          k.latched = true;
        }
        if (!dc_[k.td].defined || !ac_[k.ta].defined)
          throw Failure("corrupt JPEG: missing Huffman table");
      }
      decode_scan(coefs);
      // markers between scans, then the next scan or EOI
      for (;;) {
        const int m = next_marker();
        if (m == 0xD9) {
          idct(planes, coefs);
          return;
        }
        if (m == 0xDA) {
          read_sos();
          break;
        }
        if (!read_table_or_skip(m)) throw Failure("corrupt JPEG: marker FF" + hex(m) + " after a scan");
      }
    }
  }

  void decode_scan(std::vector<int16_t>* coefs) {
    detail::BitReader br;
    br.reset(pos_scan_, end_);
    int dc_pred[3] = {0, 0, 0};
    // interleaved: MCUs of h x v blocks of each component; one component:
    // its own blocks one at a time (no dummy blocks)
    const bool single = ns_ == 1;
    const Component& k0 = comp_[scan_comp_[0]];
    const int cols = single ? k0.bw : mcu_cols_;
    const int rows = single ? k0.bh : mcu_rows_;
    const long total = static_cast<long>(cols) * rows;
    int restarts_to_go = restart_interval_;
    int next_rst = 0;
    for (long mcu = 0; mcu < total; ++mcu) {
      if (restart_interval_) {
        if (restarts_to_go == 0) {
          restart(br, next_rst);
          next_rst = (next_rst + 1) & 7;
          dc_pred[0] = dc_pred[1] = dc_pred[2] = 0;
          restarts_to_go = restart_interval_;
        }
        --restarts_to_go;
      }
      const int mx = static_cast<int>(mcu % cols), my = static_cast<int>(mcu / cols);
      for (int i = 0; i < ns_; ++i) {
        const Component& k = comp_[scan_comp_[i]];
        const int bh = single ? 1 : k.h, bv = single ? 1 : k.v;
        for (int yy = 0; yy < bv; ++yy)
          for (int xx = 0; xx < bh; ++xx)
            decode_block(br, dc_[k.td], ac_[k.ta], dc_pred[i],
                         coefs[scan_comp_[i]].data() +
                             (static_cast<size_t>(my * bv + yy) * k.mw + mx * bh + xx) * 64);
      }
      if (br.overran()) throw Failure("truncated or corrupt JPEG: entropy-coded data ends early");
    }
    pos_ = br.p;  // on the marker that ends the scan, or before it
  }

  static void decode_block(detail::BitReader& br, const detail::HuffTable& dc,
                           const detail::HuffTable& ac, int& pred, int16_t* block) {
    br.fill();  // >= 57 bits: a DC code and its value take at most 31
    int s = br.decode(dc);
    // libjpeg's int sum, wrapping where corrupt data would overflow it
    if (s) pred = static_cast<int>(static_cast<uint32_t>(pred) +
                                   static_cast<uint32_t>(detail::extend(br.get(s), s)));
    block[0] = static_cast<int16_t>(pred);
    for (int k = 1; k < 64; ++k) {
      if (br.nbits < 32) br.fill();
      const int rs = br.decode(ac);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) throw Failure("corrupt JPEG: coefficient index past 63");
        block[kNatural[k]] = static_cast<int16_t>(detail::extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // jdhuff.c process_restart: drop the bits left, read RSTn, reset.
  void restart(detail::BitReader& br, int expect) {
    pos_ = br.p;
    while (pos_ < end_ && *pos_ != 0xFF) ++pos_;  // bytes that held the fill bits
    while (pos_ < end_ && *pos_ == 0xFF) ++pos_;
    if (pos_ >= end_) throw Failure("truncated JPEG: entropy-coded data ends early");
    const int m = *pos_++;
    if (m != 0xD0 + expect)
      throw Failure("corrupt JPEG: expected RST" + std::to_string(expect) + ", found FF" + hex(m));
    br.reset(pos_, end_);
  }

  // The blocks that hold image data; libjpeg leaves the dummy blocks of the
  // last MCU column and row unwritten, and nothing reads them.
  void idct(std::vector<uint8_t>* planes[3], std::vector<int16_t>* coefs) {
    for (int c = 0; c < ncomp_; ++c) {
      const Component& k = comp_[c];
      const auto f = k.ss == 8 ? detail::idct_8x8 : k.ss == 4 ? detail::idct_4x4
                   : k.ss == 2 ? detail::idct_2x2 : detail::idct_1x1;
      for (int by = 0; by < k.bh; ++by)
        for (int bx = 0; bx < k.bw; ++bx)
          f(coefs[c].data() + (static_cast<size_t>(by) * k.mw + bx) * 64, k.q,
            planes[c]->data() + static_cast<size_t>(by) * k.ss * stride_[c] +
                static_cast<size_t>(bx) * k.ss,
            stride_[c]);
    }
  }

  // ------------------------------------------------- upsampling and colour
  // jdsample.c's choice per component, then jdcolor.c's YCbCr -> RGB (or the
  // gray value three times).
  void to_rgb(std::vector<uint8_t>* planes, int min_ss, uint8_t* out, int out_w, int out_h) {
    const bool fancy_ok = min_ss > 1;  // no context rows at 1/8 (jdsample.c)
    struct Up {
      const uint8_t* plane;
      int stride, ds_w, ds_h, rh, rv;
      bool fancy;
      std::vector<uint8_t> row;
    } up[3];
    for (int c = 0; c < ncomp_; ++c) {
      const Component& k = comp_[c];
      Up& u = up[c];
      u.plane = planes[c].data();
      u.stride = stride_[c];
      u.ds_w = static_cast<int>((static_cast<long>(width_) * k.h * k.ss + 8L * max_h_ - 1) /
                                (8L * max_h_));
      u.ds_h = static_cast<int>((static_cast<long>(height_) * k.v * k.ss + 8L * max_v_ - 1) /
                                (8L * max_v_));
      const int h_in = k.h * k.ss / min_ss, v_in = k.v * k.ss / min_ss;
      u.rh = max_h_ / h_in;
      u.rv = max_v_ / v_in;
      if (u.rh * h_in != max_h_ || u.rv * v_in != max_v_)
        throw Failure("JPEG sampling ratio not supported");
      // fancy (triangle-filter) upsampling for 2h1v and 2h2v when the row
      // holds more than two samples; plain replication otherwise
      u.fancy = fancy_ok && u.rh == 2 && (u.rv == 1 || u.rv == 2) && u.ds_w > 2;
      u.row.resize(static_cast<size_t>(u.ds_w) * u.rh + 2);
    }
    std::vector<int> sums;
    for (int y = 0; y < out_h; ++y) {
      const uint8_t* rows[3];
      for (int c = 0; c < ncomp_; ++c) {
        Up& u = up[c];
        if (u.rh == 1 && u.rv == 1) {
          rows[c] = u.plane + static_cast<size_t>(y) * u.stride;
          continue;
        }
        const int tr = y / u.rv;
        const uint8_t* in = u.plane + static_cast<size_t>(tr) * u.stride;
        uint8_t* o = u.row.data();
        rows[c] = o;
        const int n = u.ds_w;
        if (!u.fancy) {
          for (int x = 0; x < n; ++x)
            for (int r = 0; r < u.rh; ++r) o[x * u.rh + r] = in[x];
        } else if (u.rv == 1) {  // h2v1_fancy_upsample
          o[0] = in[0];
          o[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
          for (int x = 1; x < n - 1; ++x) {
            const int v3 = in[x] * 3;
            o[2 * x] = static_cast<uint8_t>((v3 + in[x - 1] + 1) >> 2);
            o[2 * x + 1] = static_cast<uint8_t>((v3 + in[x + 1] + 2) >> 2);
          }
          o[2 * n - 2] = static_cast<uint8_t>((in[n - 1] * 3 + in[n - 2] + 1) >> 2);
          o[2 * n - 1] = in[n - 1];
        } else {  // h2v2_fancy_upsample: the nearer row and the one above/below
          const int vr = (y & 1) ? (tr + 1 < u.ds_h ? tr + 1 : u.ds_h - 1) : (tr > 0 ? tr - 1 : 0);
          const uint8_t* nb = u.plane + static_cast<size_t>(vr) * u.stride;
          sums.resize(n);
          for (int x = 0; x < n; ++x) sums[x] = in[x] * 3 + nb[x];
          const int* s = sums.data();
          o[0] = static_cast<uint8_t>((s[0] * 4 + 8) >> 4);
          o[1] = static_cast<uint8_t>((s[0] * 3 + s[1] + 7) >> 4);
          for (int x = 1; x < n - 1; ++x) {
            o[2 * x] = static_cast<uint8_t>((s[x] * 3 + s[x - 1] + 8) >> 4);
            o[2 * x + 1] = static_cast<uint8_t>((s[x] * 3 + s[x + 1] + 7) >> 4);
          }
          o[2 * n - 2] = static_cast<uint8_t>((s[n - 1] * 3 + s[n - 2] + 8) >> 4);
          o[2 * n - 1] = static_cast<uint8_t>((s[n - 1] * 4 + 7) >> 4);
        }
      }
      uint8_t* d = out + static_cast<size_t>(y) * out_w * 3;
      if (ncomp_ == 1) {
        const uint8_t* g = rows[0];
        for (int x = 0; x < out_w; ++x) d[3 * x] = d[3 * x + 1] = d[3 * x + 2] = g[x];
        continue;
      }
      const uint8_t *yr = rows[0], *cbr = rows[1], *crr = rows[2];
      for (int x = 0; x < out_w; ++x) {
        const int yy = yr[x], cb = cbr[x] - 128, cr = crr[x] - 128;
        const int r = yy + ((91881 * cr + 32768) >> 16);              // FIX(1.40200)
        const int g = yy + ((-22554 * cb - 46802 * cr + 32768) >> 16);  // FIX(.34414/.71414)
        const int b = yy + ((116130 * cb + 32768) >> 16);             // FIX(1.77200)
        d[3 * x] = static_cast<uint8_t>(r < 0 ? 0 : (r > 255 ? 255 : r));
        d[3 * x + 1] = static_cast<uint8_t>(g < 0 ? 0 : (g > 255 ? 255 : g));
        d[3 * x + 2] = static_cast<uint8_t>(b < 0 ? 0 : (b > 255 ? 255 : b));
      }
    }
  }

  const uint8_t* data_;
  const uint8_t* end_;
  const uint8_t* pos_ = nullptr;
  const uint8_t* pos_scan_ = nullptr;
  int width_ = 0, height_ = 0, ncomp_ = 0, max_h_ = 1, max_v_ = 1;
  int mcu_cols_ = 0, mcu_rows_ = 0;
  int restart_interval_ = 0;
  bool have_frame_ = false, saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = -1;
  Component comp_[3];
  int stride_[3] = {0, 0, 0};
  int ns_ = 0;
  int scan_comp_[4] = {0, 0, 0, 0};
  int16_t qt_[4][64] = {};
  bool qt_defined_[4] = {false, false, false, false};
  detail::HuffTable dc_[4], ac_[4];
};

}  // namespace bdvc_jpeg
