// Host code, not a kernel: write RGB uint8 frames as baseline JPEG files over
// a pool of std::threads, with no libjpeg. The corpus writer
// (bdvcil_torch/data/corpus.py) uses it, so the frames on disk are the same
// bytes on every machine, whatever encoder cv2 carries there. Its files are
// byte-identical to libjpeg-turbo's after jpeg_set_defaults and
// jpeg_set_quality(quality, force_baseline = TRUE):
//   JFIF 1.01 APP0 (no density, no thumbnail); YCbCr at 4:2:0 (component ids
//   1, 2, 3, quantization tables 0, 1, 1, Huffman tables 0, 1, 1); the
//   Annex K tables scaled by jpeg_quality_scaling and capped at 255; the
//   Annex K Huffman tables (no optimization); one interleaved scan and no
//   restart interval.
// The stages follow jccolor.c (fixed-point RGB -> YCbCr), jcsample.c
// (h2v2_downsample with its 1, 2 alternating bias, edges replicated),
// jcprepct.c / jccoefct.c (bottom and right padding, dummy blocks),
// jfdctint.c (ISLOW forward DCT), jcdctmgr.c (quantization), jchuff.c and
// jcmarker.c (entropy coding, markers).
//
// C ABI (ctypes):
//   bdvc_write_jpeg_batch(paths, n, rgb, w, h, quality, num_threads) -> int
//     rgb holds n frames of h x w x 3 bytes back to back; returns 0, or
//     1 + the index of the first frame that could not be written.
//
// Built by bdvcil_torch/data/native.py beside the decoder:
//   g++ -O3 -march=native -funroll-loops -fPIC -shared -std=c++17 jpeg_write.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <thread>
#include <vector>

#include "jpeg_codec.h"

namespace {

using bdvc_jpeg::kNatural;

// ITU T.81 Annex K.1, natural order (jcparam.c std_luminance_quant_tbl)
constexpr int kStdQuant[2][64] = {
    {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
     14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
     18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

// ITU T.81 Annex K.3 (jstdhuff.c): code counts per length 1..16, then symbols
constexpr uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffCodes {
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
  uint16_t code[256];
  uint8_t size[256];
};

// jchuff.c jpeg_make_c_derived_tbl: canonical codes by length
void make_codes(HuffCodes& t) {
  int code = 0, p = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < t.bits[l - 1]; ++i, ++p, ++code) {
      t.code[t.vals[p]] = static_cast<uint16_t>(code);
      t.size[t.vals[p]] = static_cast<uint8_t>(l);
    }
    code <<= 1;
  }
}

struct Tables {
  HuffCodes dc[2] = {{kDcLumBits, kDcVals, 12, {}, {}}, {kDcChromBits, kDcVals, 12, {}, {}}};
  HuffCodes ac[2] = {{kAcLumBits, kAcLumVals, 162, {}, {}},
                     {kAcChromBits, kAcChromVals, 162, {}, {}}};
  Tables() {
    for (int i = 0; i < 2; ++i) {
      make_codes(dc[i]);
      make_codes(ac[i]);
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// jcparam.c jpeg_quality_scaling + jpeg_add_quant_table(force_baseline)
void quant_tables(int quality, int q[2][64]) {
  quality = std::clamp(quality, 1, 100);
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i)
      q[t][i] = std::clamp((kStdQuant[t][i] * scale + 50) / 100, 1, 255);
}

// jcdctmgr.c compute_reciprocal: quantization by multiply and shift, as
// libjpeg-turbo does it for 16-bit DCT elements
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor make_divisor(int divisor) {
  int b = 0;
  while ((2 << b) <= divisor) ++b;  // floor(log2(divisor))
  int r = 16 + b;
  uint32_t fq = static_cast<uint32_t>((uint64_t{1} << r) / divisor);
  const uint32_t fr = static_cast<uint32_t>((uint64_t{1} << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {  // a power of two
    fq >>= 1;
    --r;
  } else if (fr <= static_cast<uint32_t>(divisor / 2)) {
    ++c;
  } else {
    ++fq;
  }
  return {fq, c, r};
}

// jfdctint.c jpeg_fdct_islow: output scaled up by 8
void fdct_islow(int* d) {
  using namespace bdvc_jpeg::detail;
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8;   // rows, then columns
    const int next = pass == 0 ? 8 : 1;
    for (int k = 0; k < 8; ++k) {
      int* p = d + k * next;
      const int32_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      const int32_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      const int32_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      const int32_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      const int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int even = pass == 0 ? kConstBits - kPass1Bits : kConstBits + kPass1Bits;
      if (pass == 0) {
        p[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
        p[4 * step] = (tmp10 - tmp11) * (1 << kPass1Bits);
      } else {
        p[0] = descale(tmp10 + tmp11, kPass1Bits);
        p[4 * step] = descale(tmp10 - tmp11, kPass1Bits);
      }
      const int32_t z1e = (tmp12 + tmp13) * F0_541196100;
      p[2 * step] = descale(z1e + tmp13 * F0_765366865, even);
      p[6 * step] = descale(z1e + tmp12 * -F1_847759065, even);
      int32_t z1 = tmp4 + tmp7, z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      const int32_t z5 = (z3 + z4) * F1_175875602;
      const int32_t t4 = tmp4 * F0_298631336, t5 = tmp5 * F2_053119869;
      const int32_t t6 = tmp6 * F3_072711026, t7 = tmp7 * F1_501321110;
      z1 *= -F0_899976223;
      z2 *= -F2_562915447;
      z3 = z3 * -F1_961570560 + z5;
      z4 = z4 * -F0_390180644 + z5;
      p[7 * step] = descale(t4 + z1 + z3, even);
      p[5 * step] = descale(t5 + z2 + z4, even);
      p[3 * step] = descale(t6 + z2 + z3, even);
      p[step] = descale(t7 + z1 + z4, even);
    }
  }
}

// jchuff.c's bit sink: big-endian bits, 0xFF stuffed with 0x00, the last
// byte filled with ones
struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int nbits = 0;

  void put(uint32_t bits, int n) {
    acc = (acc << n) | (bits & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      nbits -= 8;
      const uint8_t b = static_cast<uint8_t>(acc >> nbits);
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
    }
  }
  void flush() {
    if (nbits) put(0x7F, 8 - nbits);
  }
};

int nbits_of(int v) {
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
}

void encode_block(BitWriter& bw, const int16_t* blk, int& last_dc, const HuffCodes& dc,
                  const HuffCodes& ac) {
  int temp = blk[0] - last_dc, temp2 = temp;
  last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  int nb = nbits_of(temp);
  bw.put(dc.code[nb], dc.size[nb]);
  if (nb) bw.put(static_cast<uint32_t>(temp2), nb);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    temp = blk[kNatural[k]];
    if (temp == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    nb = nbits_of(temp);
    const int sym = (run << 4) + nb;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(static_cast<uint32_t>(temp2), nb);
    run = 0;
  }
  if (run > 0) bw.put(ac.code[0], ac.size[0]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

void write_dht(std::vector<uint8_t>& o, int cls_id, const HuffCodes& t) {
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + t.nvals);
  o.push_back(static_cast<uint8_t>(cls_id));
  o.insert(o.end(), t.bits, t.bits + 16);
  o.insert(o.end(), t.vals, t.vals + t.nvals);
}

// One frame, h x w x 3 RGB, to a complete JPEG stream in out.
void encode_rgb420(const uint8_t* rgb, int w, int h, int quality, std::vector<uint8_t>& out) {
  const Tables& T = tables();
  int q[2][64];
  quant_tables(quality, q);
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = make_divisor(q[t][i] << 3);

  // markers: SOI, JFIF APP0, DQT 0 and 1, SOF0, DHT x4, SOS (jcmarker.c)
  out.clear();
  out.reserve(static_cast<size_t>(w) * h / 2 + 1024);
  const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0,
                          1,    1,    0,    0,    1, 0,  1,   0,   0};
  out.insert(out.end(), head, head + sizeof(head));
  for (int t = 0; t < 2; ++t) {
    out.push_back(0xFF);
    out.push_back(0xDB);
    put16(out, 67);
    out.push_back(static_cast<uint8_t>(t));
    for (int i = 0; i < 64; ++i) out.push_back(static_cast<uint8_t>(q[t][kNatural[i]]));
  }
  out.push_back(0xFF);
  out.push_back(0xC0);
  put16(out, 17);
  out.push_back(8);
  put16(out, h);
  put16(out, w);
  out.push_back(3);
  const uint8_t comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  out.insert(out.end(), comps, comps + 9);
  write_dht(out, 0x00, T.dc[0]);
  write_dht(out, 0x10, T.ac[0]);
  write_dht(out, 0x01, T.dc[1]);
  write_dht(out, 0x11, T.ac[1]);
  const uint8_t sos[] = {0xFF, 0xDA, 0, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  out.insert(out.end(), sos, sos + sizeof(sos));

  // planes padded to whole MCUs by replicating the last column and row:
  // luma over ceil16(w) x ceil16(h), chroma the 2x2 downsample of the
  // padded full-resolution Cb/Cr (jcsample.c h2v2_downsample)
  const int mcu_cols = (w + 15) / 16, mcu_rows = (h + 15) / 16;
  const int pw = mcu_cols * 16, ph = mcu_rows * 16;
  const int cw = pw / 2, ch = ph / 2;
  std::vector<uint8_t> Y(static_cast<size_t>(pw) * ph), Cb(static_cast<size_t>(cw) * ch),
      Cr(static_cast<size_t>(cw) * ch);
  std::vector<uint8_t> cbf(static_cast<size_t>(pw) * 2), crf(static_cast<size_t>(pw) * 2);
  const int yrows = (h + 1) / 2 * 2, crows = (h + 1) / 2;
  for (int r2 = 0; r2 < crows; ++r2) {
    for (int dy = 0; dy < 2; ++dy) {
      const int r = std::min(2 * r2 + dy, h - 1);
      const uint8_t* src = rgb + static_cast<size_t>(r) * w * 3;
      uint8_t* yrow = Y.data() + static_cast<size_t>(2 * r2 + dy) * pw;
      uint8_t* cbrow = cbf.data() + static_cast<size_t>(dy) * pw;
      uint8_t* crrow = crf.data() + static_cast<size_t>(dy) * pw;
      for (int x = 0; x < w; ++x) {
        const int R = src[3 * x], G = src[3 * x + 1], B = src[3 * x + 2];
        // jccolor.c rgb_ycc_convert; the 0.5-epsilon rounding of Cb/Cr
        yrow[x] = static_cast<uint8_t>((19595 * R + 38470 * G + 7471 * B + 32768) >> 16);
        cbrow[x] = static_cast<uint8_t>((-11059 * R - 21709 * G + 32768 * B + (128 << 16) +
                                         32767) >> 16);
        crrow[x] = static_cast<uint8_t>((32768 * R - 27439 * G - 5329 * B + (128 << 16) +
                                         32767) >> 16);
      }
      for (int x = w; x < pw; ++x) {
        yrow[x] = yrow[w - 1];
        cbrow[x] = cbrow[w - 1];
        crrow[x] = crrow[w - 1];
      }
    }
    uint8_t* cbo = Cb.data() + static_cast<size_t>(r2) * cw;
    uint8_t* cro = Cr.data() + static_cast<size_t>(r2) * cw;
    for (int x = 0, bias = 1; x < cw; ++x, bias ^= 3) {
      cbo[x] = static_cast<uint8_t>((cbf[2 * x] + cbf[2 * x + 1] + cbf[pw + 2 * x] +
                                     cbf[pw + 2 * x + 1] + bias) >> 2);
      cro[x] = static_cast<uint8_t>((crf[2 * x] + crf[2 * x + 1] + crf[pw + 2 * x] +
                                     crf[pw + 2 * x + 1] + bias) >> 2);
    }
  }
  // rows past the image's last row group repeat the last sample row of each
  // component (jcprepct.c expand_bottom_edge on the downsampled output)
  for (int r = yrows; r < ph; ++r)
    std::copy_n(Y.data() + static_cast<size_t>(yrows - 1) * pw, pw,
                Y.data() + static_cast<size_t>(r) * pw);
  for (int r = crows; r < ch; ++r) {
    std::copy_n(Cb.data() + static_cast<size_t>(crows - 1) * cw, cw,
                Cb.data() + static_cast<size_t>(r) * cw);
    std::copy_n(Cr.data() + static_cast<size_t>(crows - 1) * cw, cw,
                Cr.data() + static_cast<size_t>(r) * cw);
  }

  // blocks holding image data; the rest of each MCU is dummy blocks (zero
  // AC, the DC of the block before them, jccoefct.c compress_data)
  const int ybw = (w + 7) / 8, ybh = (h + 7) / 8;
  BitWriter bw{out};
  int last_dc[3] = {0, 0, 0};
  int16_t blocks[6][64];
  int data[64];
  auto fdct_quant = [&](const uint8_t* plane, int stride, int bx, int by, const Divisor* dv,
                        int16_t* blk) {
    for (int r = 0; r < 8; ++r) {
      const uint8_t* row = plane + static_cast<size_t>(by * 8 + r) * stride + bx * 8;
      for (int c = 0; c < 8; ++c) data[r * 8 + c] = row[c] - 128;
    }
    fdct_islow(data);
    for (int i = 0; i < 64; ++i) {
      const int t = data[i];
      const uint32_t a = static_cast<uint32_t>(t < 0 ? -t : t);
      const int v = static_cast<int>(((a + dv[i].corr) * dv[i].recip) >> dv[i].shift);
      blk[i] = static_cast<int16_t>(t < 0 ? -v : v);
    }
  };
  for (int my = 0; my < mcu_rows; ++my) {
    for (int mx = 0; mx < mcu_cols; ++mx) {
      for (int yy = 0; yy < 2; ++yy) {
        for (int xx = 0; xx < 2; ++xx) {
          const int bx = mx * 2 + xx, by = my * 2 + yy, b = yy * 2 + xx;
          if (by >= ybh) {  // a row of dummy blocks under the image
            std::fill_n(blocks[b], 64, int16_t{0});
            blocks[b][0] = blocks[1][0];
          } else if (bx >= ybw) {  // a dummy block right of the image
            std::fill_n(blocks[b], 64, int16_t{0});
            blocks[b][0] = blocks[b - 1][0];
          } else {
            fdct_quant(Y.data(), pw, bx, by, div[0], blocks[b]);
          }
        }
      }
      fdct_quant(Cb.data(), cw, mx, my, div[1], blocks[4]);
      fdct_quant(Cr.data(), cw, mx, my, div[1], blocks[5]);
      for (int b = 0; b < 4; ++b) encode_block(bw, blocks[b], last_dc[0], T.dc[0], T.ac[0]);
      encode_block(bw, blocks[4], last_dc[1], T.dc[1], T.ac[1]);
      encode_block(bw, blocks[5], last_dc[2], T.dc[1], T.ac[1]);
    }
  }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
}

bool write_one(const char* path, const uint8_t* rgb, int w, int h, int quality,
               std::vector<uint8_t>& buf) {
  if (w <= 0 || h <= 0 || w > 65535 || h > 65535) return false;
  encode_rgb420(rgb, w, h, quality, buf);
  FILE* f = std::fopen(path, "wb");
  if (f == nullptr) return false;
  const bool wrote = std::fwrite(buf.data(), 1, buf.size(), f) == buf.size();
  return std::fclose(f) == 0 && wrote;
}

}  // namespace

extern "C" int bdvc_write_jpeg_batch(const char** paths, int n, const uint8_t* rgb, int w,
                                     int h, int quality, int num_threads) {
  if (n <= 0) return 0;
  num_threads = std::max(1, std::min(num_threads, n));
  const size_t frame = static_cast<size_t>(w) * h * 3;
  std::atomic<int> next(0);
  std::atomic<int> first_bad(n);
  auto worker = [&]() {
    std::vector<uint8_t> buf;
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      if (!write_one(paths[i], rgb + i * frame, w, h, quality, buf)) {
        int seen = first_bad.load();
        while (i < seen && !first_bad.compare_exchange_weak(seen, i)) {
        }
      }
    }
  };
  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  const int bad = first_bad.load();
  return bad < n ? bad + 1 : 0;
}
