// 8-bit JPEG decoder on the host, pixel for pixel as libjpeg-turbo 3.1 decodes a file with the defaults
// that `cv2.imread(path, cv2.IMREAD_COLOR)` leaves it: the integer ISLOW IDCT (jidctint.c), fancy
// upsampling (jdsample.c: h2v1, h1v2 and h2v2 with edge replication at the component's own width and
// height; plain replication for other integral ratios, and for h2 ratios when the component is at
// most 2 samples wide), the fixed-point YCbCr -> RGB tables of jdcolor.c, grey repeated in three
// channels, YCCK -> CMYK as jdcolor.c and CMYK -> RGB as OpenCV's icvCvt_CMYK2BGR (Adobe's inverted
// inks), and the EXIF orientation applied as OpenCV applies it.
//
// Takes sequential (SOF0/SOF1) and progressive (SOF2) files with Huffman coding, the same with
// arithmetic coding (SOF9/SOF10: the T.81 Annex D QM decoder of jdarith.c, its conditioning tables
// set by DAC), and lossless files (SOF3: the predictors of Annex H, samples of 2-8 bits scaled by the
// point transform, as jdlossls.c gives them to an 8-bit reader): interleaved and single-component
// scans, restart intervals, spectral selection, successive approximation and EOB runs; 1, 3 or 4
// components (grey, YCbCr or RGB, CMYK or YCCK). Refuses, with its name, each mode that cv2.imread
// reads as None: 12-bit samples (OpenCV reads through libjpeg's 8-bit interface), lossless samples
// of more than 8 bits, lossless files that need a colour conversion (libjpeg refuses one in lossless
// mode), lossless arithmetic coding (SOF11) and hierarchical coding.
//
// C interface, loaded with ctypes by `multiply_tpu_torch/utils/jpeg.py`:
//   jpeg_dims(data, n, dims[2], err, errlen)        -> 0, dims = (height, width) after orientation
//   jpeg_decode_rgb(data, n, out, cap, err, errlen) -> 0, out = (height, width, 3) uint8 RGB
// A non-zero return is 1 for a malformed file and 2 for a mode this decoder does not take; `err`
// then holds the message.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

// zigzag position -> natural (row-major) position; 16 extra entries guard a corrupt run past 63
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
    6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
    39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Failure {
  int code;  // 1 malformed, 2 not supported
  std::string msg;
};

[[noreturn]] void malformed(const std::string& msg) { throw Failure{1, "malformed JPEG: " + msg}; }
[[noreturn]] void unread(const std::string& mode) {
  throw Failure{2, mode + " JPEG: OpenCV's cv2.imread reads none either (it returns None), so the port refuses it"};
}

// T.81 Table D.2 as jaricom.c packs it: Qe << 16 | next index after an MPS << 8 | switch << 7 | after an LPS;
// entry 113 is the fixed estimate of one half
const uint32_t kQe[114] = {
#define V(qe, lps, mps, sw) ((uint32_t)(qe) << 16 | (mps) << 8 | (sw) << 7 | (lps))
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),    V(0x080b, 18, 4, 0),
    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),
    V(0x0036, 30, 9, 0),    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),   V(0x3f25, 36, 16, 0),
    V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),   V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),
    V(0x0cef, 43, 21, 0),   V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),   V(0x01b1, 54, 28, 0),
    V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),   V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),
    V(0x0068, 62, 33, 0),   V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),   V(0x2ef1, 67, 40, 0),
    V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),   V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),
    V(0x1177, 73, 45, 0),   V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),   V(0x04de, 50, 52, 0),
    V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),   V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),
    V(0x01f8, 54, 57, 0),   V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),   V(0x008f, 61, 32, 0),
    V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),   V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),
    V(0x2fe8, 83, 69, 0),   V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),   V(0x119c, 74, 76, 0),
    V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),   V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),
    V(0x5832, 80, 81, 1),   V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),   V(0x2516, 86, 71, 0),
    V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),   V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),
    V(0x3824, 99, 93, 0),   V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),  V(0x3c3d, 104, 100, 0),
    V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0), V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0),
    V(0x415e, 103, 99, 0),  V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1), V(0x5522, 112, 109, 0),
    V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)
#undef V
};

constexpr int kFastBits = 9;

struct HuffTable {
  bool defined = false;
  int maxsym = 0;
  uint8_t fast_len[1 << kFastBits];  // 0: code longer than kFastBits
  uint8_t fast_val[1 << kFastBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
};

void build_huff(HuffTable& t, const uint8_t* counts, const uint8_t* vals, int nvals) {
  std::memset(t.fast_len, 0, sizeof(t.fast_len));
  std::memcpy(t.vals, vals, nvals);
  t.maxsym = 0;
  for (int i = 0; i < nvals; i++) t.maxsym = std::max(t.maxsym, (int)vals[i]);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; len++) {
    t.valoffset[len] = k - code;
    for (int i = 0; i < counts[len - 1]; i++, k++, code++) {
      if (len <= kFastBits) {
        int shift = kFastBits - len;
        for (int j = 0; j < (1 << shift); j++) {
          t.fast_len[(code << shift) | j] = (uint8_t)len;
          t.fast_val[(code << shift) | j] = vals[k];
        }
      }
    }
    t.maxcode[len] = counts[len - 1] ? code - 1 : -1;
    if (code > (1 << len)) malformed("bad Huffman table");
    code <<= 1;
  }
  t.maxcode[17] = INT_MAX;
  t.defined = true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;       // blocks stored: MCUs across x h, MCUs down x v
  int width = 0, height = 0;  // samples: ceil(image * h / hmax), ceil(image * v / vmax)
  bool quant_latched = false;
  uint16_t quant[64];        // natural order, latched at the component's first scan
  std::vector<int16_t> coef;  // bh x bw blocks of 64, natural order
  std::vector<uint16_t> samp;  // lossless: (mcuy x v) rows of (mcux x h) samples
  int dc_pred = 0;
  int dc_context = 0;  // arithmetic coding: the DC conditioning category
  int first_row = 0;   // lossless: the sample row at which the current restart interval began
  int dc_table = 0, ac_table = 0;
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n) : d_(data), n_(n) {
    std::memset(dac_l_, 0, sizeof(dac_l_));
    std::memset(dac_u_, 1, sizeof(dac_u_));
    std::memset(dac_k_, 5, sizeof(dac_k_));
  }

  // Parses up to the first scan (headers_only) or the whole file.
  void run(bool headers_only) {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) malformed("no SOI marker");
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m < 0 || m == 0xD9) break;  // end of data or EOI
      if (m >= 0xD0 && m <= 0xD7) continue;  // a stray RSTn
      if (m == 0x01) continue;               // TEM
      size_t len = segment_length();
      const uint8_t* s = d_ + pos_ + 2;
      size_t sn = len - 2;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: parse_sof(s, sn, m == 0xC2, false, false); break;
        case 0xC3: parse_sof(s, sn, false, false, true); break;
        case 0xC9: case 0xCA: parse_sof(s, sn, m == 0xCA, true, false); break;
        case 0xCB: unread("lossless arithmetic-coded (SOF11)");
        case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF: unread("hierarchical (differential) coded");
        case 0xC4: parse_dht(s, sn); break;
        case 0xCC: parse_dac(s, sn); break;
        case 0xDB: parse_dqt(s, sn); break;
        case 0xDD:
          if (sn < 2) malformed("short DRI");
          restart_interval_ = (s[0] << 8) | s[1];
          break;
        case 0xE0:
          if (sn >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) saw_jfif_ = true;
          break;
        case 0xE1:
          if (!saw_exif_ && sn >= 6 && std::memcmp(s, "Exif\0\0", 6) == 0) {
            saw_exif_ = true;
            orientation_ = exif_orientation(s + 6, sn - 6);
          }
          break;
        case 0xEE:
          if (sn >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
            saw_adobe_ = true;
            adobe_transform_ = s[11];
          }
          break;
        case 0xDA:
          if (!have_frame_) malformed("scan before frame header");
          if (headers_only) return;
          pos_ += len;
          decode_scan(s, sn);
          continue;
        default: break;  // other APPn, COM, DNL: skipped
      }
      pos_ += len;
    }
    if (!have_frame_) malformed("no frame header");
  }

  int out_height() const { return orientation_ >= 5 ? width_ : height_; }
  int out_width() const { return orientation_ >= 5 ? height_ : width_; }

  void render(uint8_t* out);

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  bool have_frame_ = false, progressive_ = false, arithmetic_ = false, lossless_ = false;
  int precision_ = 8;
  bool saw_jfif_ = false, saw_adobe_ = false, saw_exif_ = false;
  int adobe_transform_ = -1, orientation_ = 1, point_transform_ = 0;
  int width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0;
  std::vector<Component> comps_;
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  HuffTable dc_[4], ac_[4];
  uint8_t dac_l_[16], dac_u_[16], dac_k_[16];  // DAC: DC conditioning bounds L and U, AC Kx, by table

  // arithmetic decoding (jdarith.c)
  int64_t ac_c_ = 0, ac_a_ = 0;
  int ac_ct_ = 0;
  bool ac_bad_ = false;  // a bad code: the rest of the restart interval decodes as zeros, as libjpeg's ct = -1
  uint8_t dc_stats_[4][64], ac_stats_[4][256], fixed_bin_ = 113;

  // entropy-coded data
  uint64_t bitbuf_ = 0;
  int bitcnt_ = 0;
  bool marker_hit_ = false;
  int eobrun_ = 0;

  int next_marker() {
    // libjpeg's next_marker: skip anything up to 0xFF, then fill bytes 0xFF
    while (pos_ < n_ && d_[pos_] != 0xFF) pos_++;
    while (pos_ < n_ && d_[pos_] == 0xFF) pos_++;
    if (pos_ >= n_) return -1;
    return d_[pos_++];
  }

  size_t segment_length() {
    if (pos_ + 2 > n_) malformed("truncated segment");
    size_t len = (d_[pos_] << 8) | d_[pos_ + 1];
    if (len < 2 || pos_ + len > n_) malformed("bad segment length");
    return len;
  }

  int exif_orientation(const uint8_t* t, size_t n) {
    if (n < 8) return 1;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return 1;
    auto u16 = [&](size_t o) -> uint32_t { return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1]; };
    auto u32 = [&](size_t o) -> uint32_t {
      return le ? t[o] | (t[o + 1] << 8) | (t[o + 2] << 16) | ((uint32_t)t[o + 3] << 24)
                : ((uint32_t)t[o] << 24) | (t[o + 1] << 16) | (t[o + 2] << 8) | t[o + 3];
    };
    if (u16(2) != 42) return 1;
    size_t ifd = u32(4);
    if (ifd + 2 > n) return 1;
    int entries = u16(ifd);
    for (int i = 0; i < entries; i++) {
      size_t e = ifd + 2 + 12 * (size_t)i;
      if (e + 12 > n) break;
      if (u16(e) == 0x0112) {
        int value = u16(e + 2) == 3 ? (int)u16(e + 8) : (int)u32(e + 8);
        return value >= 1 && value <= 8 ? value : 1;
      }
    }
    return 1;
  }

  void parse_sof(const uint8_t* s, size_t n, bool progressive, bool arithmetic, bool lossless) {
    if (have_frame_) malformed("two frame headers");
    if (n < 6) malformed("short SOF");
    precision_ = s[0];
    if (lossless) {
      if (precision_ < 2 || precision_ > 16) malformed(std::to_string(precision_) + "-bit lossless");
      if (precision_ > 8) unread("lossless " + std::to_string(precision_) + "-bit");
    } else if (precision_ != 8) {
      unread(std::to_string(precision_) + "-bit");
    }
    height_ = (s[1] << 8) | s[2];
    width_ = (s[3] << 8) | s[4];
    int nc = s[5];
    if (height_ == 0) malformed("height 0 (DNL) is not taken");
    if (width_ == 0) malformed("width 0");
    if (nc != 1 && nc != 3 && nc != 4) malformed(std::to_string(nc) + " components");
    if (n < 6 + 3 * (size_t)nc) malformed("short SOF");
    comps_.resize(nc);
    for (int i = 0; i < nc; i++) {
      Component& c = comps_[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) malformed("bad component");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    const int unit = lossless ? 1 : 8;  // a lossless MCU holds h x v samples of each component
    mcux_ = (width_ + unit * hmax_ - 1) / (unit * hmax_);
    mcuy_ = (height_ + unit * vmax_ - 1) / (unit * vmax_);
    for (Component& c : comps_) {
      if (hmax_ % c.h || vmax_ % c.v) malformed("fractional sampling");
      c.width = (int)(((long)width_ * c.h + hmax_ - 1) / hmax_);
      c.height = (int)(((long)height_ * c.v + vmax_ - 1) / vmax_);
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      if (lossless) c.samp.assign((size_t)c.bw * c.bh, 0);
      else c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    progressive_ = progressive;
    arithmetic_ = arithmetic;
    lossless_ = lossless;
    have_frame_ = true;
  }

  void parse_dac(const uint8_t* s, size_t n) {
    for (size_t p = 0; p < n; p += 2) {
      if (p + 2 > n) malformed("short DAC");
      int index = s[p], val = s[p + 1];
      if (index >= 32) malformed("bad DAC index");
      if (index >= 16) {
        dac_k_[index - 16] = (uint8_t)val;
      } else {
        dac_l_[index] = (uint8_t)(val & 15);
        dac_u_[index] = (uint8_t)(val >> 4);
        if (dac_l_[index] > dac_u_[index]) malformed("bad DAC value");
      }
    }
  }

  void parse_dht(const uint8_t* s, size_t n) {
    size_t p = 0;
    while (p < n) {
      if (p + 17 > n) malformed("short DHT");
      int tc = s[p] >> 4, th = s[p] & 15;
      if (tc > 1 || th > 3) malformed("bad DHT");
      int total = 0;
      for (int i = 0; i < 16; i++) total += s[p + 1 + i];
      if (total > 256 || p + 17 + total > n) malformed("bad DHT");
      for (int i = 0; tc == 0 && i < total; i++)
        if (s[p + 17 + i] > 16) malformed("DC Huffman table with a size above 16");
      build_huff(tc ? ac_[th] : dc_[th], s + p + 1, s + p + 17, total);
      p += 17 + total;
    }
  }

  void parse_dqt(const uint8_t* s, size_t n) {
    size_t p = 0;
    while (p < n) {
      int pq = s[p] >> 4, tq = s[p] & 15;
      if (tq > 3 || pq > 1) malformed("bad DQT");
      if (p + 1 + 64 * (pq + 1) > n) malformed("short DQT");
      for (int k = 0; k < 64; k++)
        qt_[tq][kNatural[k]] = pq ? (s[p + 1 + 2 * k] << 8) | s[p + 2 + 2 * k] : s[p + 1 + k];
      qt_defined_[tq] = true;
      p += 1 + 64 * (pq + 1);
    }
  }

  // ---- bits ----
  void fill() {
    while (bitcnt_ <= 56) {
      uint32_t c = 0;
      if (!marker_hit_ && pos_ < n_) {
        c = d_[pos_];
        if (c == 0xFF) {
          size_t p = pos_ + 1;
          while (p < n_ && d_[p] == 0xFF) p++;
          if (p < n_ && d_[p] == 0) {
            pos_ = p + 1;
          } else {
            marker_hit_ = true;  // zeros from here on, as libjpeg inserts them
            c = 0;
          }
        } else {
          pos_++;
        }
      }
      bitbuf_ = (bitbuf_ << 8) | c;
      bitcnt_ += 8;
    }
  }

  inline int get_bits(int k) {
    if (k == 0) return 0;
    if (bitcnt_ < k) fill();
    bitcnt_ -= k;
    return (int)((bitbuf_ >> bitcnt_) & ((1u << k) - 1));
  }

  inline int get_bit() { return get_bits(1); }

  static inline int extend(int x, int s) { return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x; }

  inline int decode(const HuffTable& t) {
    if (bitcnt_ < 16) fill();
    int peek = (int)((bitbuf_ >> (bitcnt_ - kFastBits)) & ((1 << kFastBits) - 1));
    int len = t.fast_len[peek];
    if (len) {
      bitcnt_ -= len;
      return t.fast_val[peek];
    }
    for (len = kFastBits + 1; len <= 16; len++) {
      int code = (int)((bitbuf_ >> (bitcnt_ - len)) & ((1u << len) - 1));
      if (code <= t.maxcode[len]) {
        bitcnt_ -= len;
        return t.vals[code + t.valoffset[len]];
      }
    }
    bitcnt_ -= 16;  // a code that is in no table: libjpeg warns and takes 0
    return 0;
  }

  void restart(std::vector<Component*>& scomps) {
    bitbuf_ = 0;
    bitcnt_ = 0;
    marker_hit_ = false;
    size_t p = pos_;
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0 && d_[p + 1] != 0xFF)) p++;
    if (p + 1 < n_ && d_[p + 1] >= 0xD0 && d_[p + 1] <= 0xD7) pos_ = p + 2;
    else pos_ = p;  // no RST where one was due: leave the marker for the parser
    for (Component* c : scomps) c->dc_pred = 0;
    eobrun_ = 0;
  }

  // ---- blocks ----
  void block_sequential(Component& c, int16_t* blk) {
    const HuffTable& dct = dc_[c.dc_table];
    const HuffTable& act = ac_[c.ac_table];
    int s = decode(dct);
    if (s) s = extend(get_bits(s), s);
    c.dc_pred += s;
    blk[0] = (int16_t)c.dc_pred;
    for (int k = 1; k < 64; k++) {
      int rs = decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)extend(get_bits(s), s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void block_dc_first(Component& c, int16_t* blk, int al) {
    int s = decode(dc_[c.dc_table]);
    if (s) s = extend(get_bits(s), s);
    c.dc_pred += s;
    blk[0] = (int16_t)((unsigned)c.dc_pred << al);
  }

  void block_dc_refine(int16_t* blk, int al) {
    if (get_bit()) blk[0] = (int16_t)(blk[0] | (1 << al));
  }

  void block_ac_first(Component& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun_ > 0) {
      eobrun_--;
      return;
    }
    const HuffTable& act = ac_[c.ac_table];
    for (int k = ss; k <= se; k++) {
      int rs = decode(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = (int16_t)((unsigned)extend(get_bits(s), s) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += get_bits(r);
        eobrun_--;
        break;
      }
    }
  }

  void block_ac_refine(Component& c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    const HuffTable& act = ac_[c.ac_table];
    int k = ss;
    if (eobrun_ == 0) {
      for (; k <= se; k++) {
        int rs = decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = get_bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += get_bits(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (get_bit() && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && get_bit() && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      eobrun_--;
    }
  }

  // ---- arithmetic decoding (jdarith.c) ----
  int arith_byte() {  // the next data byte; zeros once a marker (left for the parser) or the end is reached
    if (marker_hit_ || pos_ >= n_) {
      marker_hit_ = true;
      return 0;
    }
    int c = d_[pos_++];
    if (c != 0xFF) return c;
    while (pos_ < n_ && d_[pos_] == 0xFF) pos_++;
    if (pos_ < n_ && d_[pos_] == 0) {
      pos_++;
      return 0xFF;
    }
    marker_hit_ = true;
    pos_--;  // at an 0xFF before the marker's code
    return 0;
  }

  int arith_decode(uint8_t* st) {
    while (ac_a_ < 0x8000) {
      if (--ac_ct_ < 0) {
        ac_c_ = (ac_c_ << 8) | arith_byte();
        if ((ac_ct_ += 8) < 0)      // more initial bytes needed
          if (++ac_ct_ == 0) ac_a_ = 0x8000;  // two initial bytes: A becomes 0x10000 below
      }
      ac_a_ <<= 1;
    }
    int sv = *st;
    uint32_t qe = kQe[sv & 0x7F];
    int nl = qe & 0xFF, nm = (qe >> 8) & 0xFF;
    int64_t q = qe >> 16;
    int64_t temp = ac_a_ - q;
    ac_a_ = temp;
    temp <<= ac_ct_;
    if (ac_c_ >= temp) {
      ac_c_ -= temp;
      if (ac_a_ < q) {  // conditional LPS exchange
        ac_a_ = q;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        ac_a_ = q;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ac_a_ < 0x8000) {  // conditional MPS exchange
      if (ac_a_ < q) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // the conditioning state of the scan's components, and the decoder's registers, as a scan or restart begins
  void arith_reset(std::vector<Component*>& scomps, bool dc, bool ac) {
    for (Component* c : scomps) {
      if (dc) {
        std::memset(dc_stats_[c->dc_table], 0, 64);
        c->dc_pred = 0;
        c->dc_context = 0;
      }
      if (ac) std::memset(ac_stats_[c->ac_table], 0, 256);
    }
    ac_c_ = 0;
    ac_a_ = 0;
    ac_ct_ = -16;
    ac_bad_ = false;
  }

  // Figures F.19-F.24: a DC difference, its context updated (Section F.1.4.4.1.2)
  bool arith_dc_diff(Component& c, int* diff) {
    int tbl = c.dc_table;
    uint8_t* st = dc_stats_[tbl] + c.dc_context;
    if (arith_decode(st) == 0) {
      c.dc_context = 0;
      *diff = 0;
      return true;
    }
    int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m) {
      st = dc_stats_[tbl] + 20;
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < ((1 << dac_l_[tbl]) >> 1)) c.dc_context = 0;
    else if (m > ((1 << dac_u_[tbl]) >> 1)) c.dc_context = 12 + sign * 4;
    else c.dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    *diff = sign ? -v : v;
    return true;
  }

  // Figure F.20 over positions ss..se: the coefficients, scaled by 2^al; false on a bad code
  bool arith_ac_run(Component& c, int16_t* blk, int ss, int se, int al) {
    int tbl = c.ac_table;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
      if (arith_decode(st)) break;  // EOB
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > se) return false;
      }
      int sign = arith_decode(&fixed_bin_);
      st += 2;
      int m = arith_decode(st);
      if (m && arith_decode(st)) {
        m <<= 1;
        st = ac_stats_[tbl] + (k <= dac_k_[tbl] ? 189 : 217);
        while (arith_decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (arith_decode(st)) v |= m;
      v += 1;
      blk[kNatural[k]] = (int16_t)((unsigned)(sign ? -v : v) << al);
    }
    return true;
  }

  // Figure G.11: one more bit of positions ss..se
  bool arith_ac_refine(Component& c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;
    for (; kex > 0; kex--)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = ac_stats_[c.ac_table] + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {  // a coefficient already nonzero: its next bit
          if (arith_decode(st + 2)) *coef = (int16_t)(*coef < 0 ? *coef + m1 : *coef + p1);
          break;
        }
        if (arith_decode(st + 1)) {  // newly nonzero
          *coef = (int16_t)(arith_decode(&fixed_bin_) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) return false;
      }
    }
    return true;
  }

  void arith_block(Component& c, int16_t* blk, int ss, int se, int ah, int al) {
    if (ac_bad_) return;
    bool ok = true;
    if (!progressive_) {
      int diff;
      ok = arith_dc_diff(c, &diff);
      if (ok) {
        c.dc_pred += diff;
        blk[0] = (int16_t)c.dc_pred;
        ok = arith_ac_run(c, blk, 1, 63, 0);
      }
    } else if (ss == 0 && ah == 0) {
      int diff;
      ok = arith_dc_diff(c, &diff);
      if (ok) {
        c.dc_pred += diff;
        blk[0] = (int16_t)((unsigned)c.dc_pred << al);
      }
    } else if (ss == 0) {
      if (arith_decode(&fixed_bin_)) blk[0] = (int16_t)(blk[0] | (1 << al));
    } else if (ah == 0) {
      ok = arith_ac_run(c, blk, ss, se, al);
    } else {
      ok = arith_ac_refine(c, blk, ss, se, al);
    }
    if (!ok) ac_bad_ = true;  // libjpeg warns and decodes nothing more until the next restart
  }

  // the RSTn that a restart interval ends with, whatever the entropy coder left unread
  void skip_to_restart() {
    size_t p = pos_;
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0 && d_[p + 1] != 0xFF)) p++;
    if (p + 1 < n_ && d_[p + 1] >= 0xD0 && d_[p + 1] <= 0xD7) pos_ = p + 2;
    else pos_ = p;  // no RST where one was due: leave the marker for the parser
    bitbuf_ = 0;
    bitcnt_ = 0;
    marker_hit_ = false;
    eobrun_ = 0;
  }

  // ---- lossless (Annex H; jdlhuff.c and jddiffct.c) ----
  void decode_lossless_scan(std::vector<Component*>& sc, int predictor, int pt) {
    const int ns = (int)sc.size();
    const int per_row = ns == 1 ? sc[0]->width : mcux_;
    const int rows = ns == 1 ? sc[0]->height : mcuy_;
    if (restart_interval_ && restart_interval_ % per_row)
      malformed("a lossless restart interval that is not a whole number of MCU rows");
    for (Component* c : sc) c->first_row = 0;
    const int initial = 1 << (precision_ - pt - 1);
    for (int my = 0; my < rows; my++) {
      if (restart_interval_ && my && ((long)my * per_row) % restart_interval_ == 0) {
        skip_to_restart();
        for (Component* c : sc) c->first_row = ns == 1 ? my : my * c->v;
      }
      for (int mx = 0; mx < per_row; mx++)
        for (Component* c : sc) {
          const int uh = ns == 1 ? 1 : c->h, uv = ns == 1 ? 1 : c->v;
          for (int yy = 0; yy < uv; yy++)
            for (int xx = 0; xx < uh; xx++) {
              int X = mx * uh + xx, Y = my * uv + yy;
              int s = decode(dc_[c->dc_table]);
              int diff = s == 0 ? 0 : s == 16 ? 32768 : extend(get_bits(s), s);
              uint16_t* row = c->samp.data() + (size_t)Y * c->bw;
              int pred;
              if (Y == c->first_row) {
                pred = X ? row[X - 1] : initial;
              } else if (X == 0) {
                pred = row[X - (int)c->bw];
              } else {
                int ra = row[X - 1], rb = row[X - (int)c->bw], rc = row[X - 1 - (int)c->bw];
                switch (predictor) {
                  case 1: pred = ra; break;
                  case 2: pred = rb; break;
                  case 3: pred = rc; break;
                  case 4: pred = ra + rb - rc; break;
                  case 5: pred = ra + ((rb - rc) >> 1); break;
                  case 6: pred = rb + ((ra - rc) >> 1); break;
                  default: pred = (ra + rb) >> 1; break;
                }
              }
              row[X] = (uint16_t)((pred + diff) & 0xFFFF);
            }
        }
    }
  }

  void decode_scan(const uint8_t* s, size_t n) {
    if (n < 1) malformed("short SOS");
    int ns = s[0];
    if (ns < 1 || ns > 4 || n < 1 + 2 * (size_t)ns + 3) malformed("bad SOS");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; i++) {
      int id = s[1 + 2 * i], tables = s[2 + 2 * i];
      Component* c = nullptr;
      for (Component& cc : comps_)
        if (cc.id == id) c = &cc;
      if (!c) malformed("scan names an unknown component");
      c->dc_table = tables >> 4;
      c->ac_table = tables & 15;
      if (c->dc_table > 3 || c->ac_table > 3) malformed("bad table selector");
      sc.push_back(c);
    }
    int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ah = s[3 + 2 * ns] >> 4, al = s[3 + 2 * ns] & 15;
    if (lossless_) {
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= precision_) malformed("bad lossless scan parameters");
      for (Component* c : sc) {
        if (!dc_[c->dc_table].defined) malformed("scan uses an undefined Huffman table");
        c->quant_latched = true;  // the component has samples
      }
      bitbuf_ = 0;
      bitcnt_ = 0;
      marker_hit_ = false;
      decode_lossless_scan(sc, ss, al);
      point_transform_ = al;
      while (pos_ + 1 < n_ && !(d_[pos_] == 0xFF && d_[pos_ + 1] != 0 && d_[pos_ + 1] != 0xFF &&
                                !(d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7)))
        pos_++;
      return;
    }
    if (!progressive_) {
      ss = 0;
      se = 63;
      ah = al = 0;
    } else if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) || al > 13) {
      malformed("bad progressive scan parameters");
    }
    for (Component* c : sc) {
      if (!c->quant_latched) {
        if (!qt_defined_[c->tq]) malformed("no quantization table for a component");
        std::memcpy(c->quant, qt_[c->tq], sizeof(c->quant));
        c->quant_latched = true;
      }
      bool need_dc = !progressive_ || (ss == 0 && ah == 0);
      bool need_ac = !progressive_ || ss > 0;
      if (!arithmetic_ && ((need_dc && !dc_[c->dc_table].defined) || (need_ac && !ac_[c->ac_table].defined)))
        malformed("scan uses an undefined Huffman table");
      if (!arithmetic_ && need_dc && dc_[c->dc_table].maxsym > 15) malformed("DC Huffman table with a size above 15");
      c->dc_pred = 0;
    }
    bitbuf_ = 0;
    bitcnt_ = 0;
    marker_hit_ = false;
    eobrun_ = 0;
    const bool arith_dc = !progressive_ || (ss == 0 && ah == 0), arith_ac = !progressive_ || ss > 0;
    if (arithmetic_) arith_reset(sc, arith_dc, arith_ac);

    auto block = [&](Component& c, int bx, int by) {
      int16_t* blk = c.coef.data() + ((size_t)by * c.bw + bx) * 64;
      if (arithmetic_) arith_block(c, blk, ss, se, ah, al);
      else if (!progressive_) block_sequential(c, blk);
      else if (ss == 0 && ah == 0) block_dc_first(c, blk, al);
      else if (ss == 0) block_dc_refine(blk, al);
      else if (ah == 0) block_ac_first(c, blk, ss, se, al);
      else block_ac_refine(c, blk, ss, se, al);
    };

    int todo = restart_interval_;
    if (ns == 1) {
      // a single-component scan: its own blocks in raster order, one a unit
      Component& c = *sc[0];
      int nbx = (c.width + 7) / 8, nby = (c.height + 7) / 8;
      for (int by = 0; by < nby; by++)
        for (int bx = 0; bx < nbx; bx++) {
          if (restart_interval_ && todo == 0) {
            restart(sc);
            if (arithmetic_) arith_reset(sc, arith_dc, arith_ac);
            todo = restart_interval_;
          }
          block(c, bx, by);
          todo--;
        }
    } else {
      for (int my = 0; my < mcuy_; my++)
        for (int mx = 0; mx < mcux_; mx++) {
          if (restart_interval_ && todo == 0) {
            restart(sc);
            if (arithmetic_) arith_reset(sc, arith_dc, arith_ac);
            todo = restart_interval_;
          }
          for (Component* c : sc)
            for (int y = 0; y < c->v; y++)
              for (int x = 0; x < c->h; x++) block(*c, mx * c->h + x, my * c->v + y);
          todo--;
        }
    }
    // hand the parser the marker that ends the scan
    while (pos_ + 1 < n_ && !(d_[pos_] == 0xFF && d_[pos_ + 1] != 0 && d_[pos_ + 1] != 0xFF &&
                              !(d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7)))
      pos_++;
  }
};

// ---- jidctint.c: jpeg_idct_islow ----
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0_298631336 = 2446, F0_390180644 = 3196, F0_541196100 = 4433, F0_765366865 = 6270,
                  F0_899976223 = 7373, F1_175875602 = 9633, F1_501321110 = 12299, F1_847759065 = 15137,
                  F1_961570560 = 16069, F2_053119869 = 16819, F2_562915447 = 20995, F3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// the post-IDCT range limit: x (centred on 0) & 1023, then 128 added with wrap-around as libjpeg's table does
inline uint8_t idct_limit(int64_t x) {
  int i = (int)(x & 1023);
  if (i < 128) return (uint8_t)(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return (uint8_t)(i - 896);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int col = 0; col < 8; col++) {
    const int16_t* ip = in + col;
    const uint16_t* qp = q + col;
    int* wp = ws + col;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = (int)((int64_t)ip[0] * qp[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065, tmp3 = z1 + z2 * F0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits), tmp1 = (z2 - z3) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = (int)descale(tmp10 + tmp3, sh);
    wp[56] = (int)descale(tmp10 - tmp3, sh);
    wp[8] = (int)descale(tmp11 + tmp2, sh);
    wp[48] = (int)descale(tmp11 - tmp2, sh);
    wp[16] = (int)descale(tmp12 + tmp1, sh);
    wp[40] = (int)descale(tmp12 - tmp1, sh);
    wp[24] = (int)descale(tmp13 + tmp0, sh);
    wp[32] = (int)descale(tmp13 - tmp0, sh);
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int row = 0; row < 8; row++) {
    const int* wp = ws + 8 * row;
    uint8_t* op = out + (size_t)row * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = idct_limit(descale(wp[0], kPass1Bits + 3));
      for (int i = 0; i < 8; i++) op[i] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0_541196100;
    int64_t tmp2 = z1 + z3 * -F1_847759065, tmp3 = z1 + z2 * F0_765366865;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << kConstBits), tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1_175875602;
    tmp0 *= F0_298631336;
    tmp1 *= F2_053119869;
    tmp2 *= F3_072711026;
    tmp3 *= F1_501321110;
    z1 *= -F0_899976223;
    z2 *= -F2_562915447;
    z3 *= -F1_961570560;
    z4 *= -F0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = idct_limit(descale(tmp10 + tmp3, sh));
    op[7] = idct_limit(descale(tmp10 - tmp3, sh));
    op[1] = idct_limit(descale(tmp11 + tmp2, sh));
    op[6] = idct_limit(descale(tmp11 - tmp2, sh));
    op[2] = idct_limit(descale(tmp12 + tmp1, sh));
    op[5] = idct_limit(descale(tmp12 - tmp1, sh));
    op[3] = idct_limit(descale(tmp13 + tmp0, sh));
    op[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

// A component's dw x dh samples (row stride `stride`) upsampled by hx x vx: (dh * vx) rows of dw * hx,
// which covers the image.
std::vector<uint8_t> upsample(const std::vector<uint8_t>& plane, int stride, int dw, int dh, int hx, int vx) {
  int ow = dw * hx, oh = dh * vx;
  std::vector<uint8_t> out((size_t)ow * oh);
  auto at = [&](int y, int x) -> int { return plane[(size_t)y * stride + x]; };
  if (hx == 1 && vx == 1) {
    for (int y = 0; y < dh; y++) std::memcpy(&out[(size_t)y * ow], &plane[(size_t)y * stride], dw);
  } else if (hx == 2 && vx == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < dh; y++) {
      uint8_t* o = &out[(size_t)y * ow];
      for (int x = 0; x < dw; x++) {
        int c = at(y, x) * 3, l = at(y, x > 0 ? x - 1 : 0), r = at(y, x < dw - 1 ? x + 1 : dw - 1);
        o[2 * x] = (uint8_t)((c + l + 1) >> 2);
        o[2 * x + 1] = (uint8_t)((c + r + 2) >> 2);
      }
    }
  } else if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < dh; y++) {
      int ya = y > 0 ? y - 1 : 0, yb = y < dh - 1 ? y + 1 : dh - 1;
      for (int x = 0; x < dw; x++) {
        int c = at(y, x) * 3;
        out[(size_t)(2 * y) * ow + x] = (uint8_t)((c + at(ya, x) + 1) >> 2);
        out[(size_t)(2 * y + 1) * ow + x] = (uint8_t)((c + at(yb, x) + 2) >> 2);
      }
    }
  } else if (hx == 2 && vx == 2 && dw > 2) {  // h2v2_fancy_upsample
    std::vector<int> sum(dw);
    for (int y = 0; y < dh; y++) {
      for (int v = 0; v < 2; v++) {
        int yn = v == 0 ? (y > 0 ? y - 1 : 0) : (y < dh - 1 ? y + 1 : dh - 1);
        for (int x = 0; x < dw; x++) sum[x] = at(y, x) * 3 + at(yn, x);
        uint8_t* o = &out[(size_t)(2 * y + v) * ow];
        for (int x = 0; x < dw; x++) {
          int c = sum[x] * 3, l = sum[x > 0 ? x - 1 : 0], r = sum[x < dw - 1 ? x + 1 : dw - 1];
          o[2 * x] = (uint8_t)((c + l + 8) >> 4);
          o[2 * x + 1] = (uint8_t)((c + r + 7) >> 4);
        }
      }
    }
  } else {  // int_upsample, h2v1_upsample, h2v2_upsample: replication
    for (int y = 0; y < oh; y++)
      for (int x = 0; x < ow; x++) out[(size_t)y * ow + x] = (uint8_t)at(y / vx, x / hx);
  }
  return out;
}

// ---- jdcolor.c: ycc_rgb_convert ----
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int kScale = 16;
    const int64_t half = (int64_t)1 << (kScale - 1);
    auto fix = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

void Decoder::render(uint8_t* out) {
  const int W = width_, H = height_;
  const int nc = (int)comps_.size();
  std::vector<std::vector<uint8_t>> full(nc);
  std::vector<int> full_stride(nc);
  for (int ci = 0; ci < nc; ci++) {
    Component& c = comps_[ci];
    if (!c.quant_latched) malformed("a component that no scan holds");
    int stride = lossless_ ? c.bw : c.bw * 8;
    std::vector<uint8_t> plane((size_t)stride * c.bh * (lossless_ ? 1 : 8));
    if (lossless_) {  // samples scaled by the point transform, as an 8-bit reader gets them
      for (size_t i = 0; i < plane.size(); i++) plane[i] = (uint8_t)(c.samp[i] << point_transform_);
    } else {
      int nbx = (c.width + 7) / 8, nby = (c.height + 7) / 8;
      for (int by = 0; by < nby; by++)
        for (int bx = 0; bx < nbx; bx++)
          idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, c.quant,
                     &plane[(size_t)by * 8 * stride + bx * 8], stride);
    }
    int hx = hmax_ / c.h, vx = vmax_ / c.v;
    full[ci] = upsample(plane, stride, c.width, c.height, hx, vx);
    full_stride[ci] = c.width * hx;
  }
  // jdapimin.c's colour space: JFIF, then Adobe's transform, then the component ids (lossless: RGB)
  bool ycc = nc == 3;
  if (nc == 3 && !saw_jfif_) {
    if (saw_adobe_) ycc = adobe_transform_ != 0;
    else ycc = !lossless_ && !(comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B');
  }
  const bool ycck = nc == 4 && saw_adobe_ && adobe_transform_ != 0;
  if (lossless_ && (nc == 1 || ycc || ycck))
    unread(nc == 1 ? "lossless greyscale" : "lossless YCbCr or YCCK");  // libjpeg converts no colour in lossless mode
  static const YccTables t;
  std::vector<uint8_t> rgb((size_t)W * H * 3);
  for (int y = 0; y < H; y++) {
    uint8_t* o = &rgb[(size_t)y * W * 3];
    if (nc == 1) {
      const uint8_t* g = &full[0][(size_t)y * full_stride[0]];
      for (int x = 0; x < W; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
      continue;
    }
    const uint8_t* p0 = &full[0][(size_t)y * full_stride[0]];
    const uint8_t* p1 = &full[1][(size_t)y * full_stride[1]];
    const uint8_t* p2 = &full[2][(size_t)y * full_stride[2]];
    if (nc == 4) {
      const uint8_t* p3 = &full[3][(size_t)y * full_stride[3]];
      for (int x = 0; x < W; x++) {
        int c = p0[x], m = p1[x], yv = p2[x], k = p3[x];
        if (ycck) {  // ycck_cmyk_convert
          int yy = p0[x], cb = p1[x], cr = p2[x];
          c = clamp255(255 - (yy + t.cr_r[cr]));
          m = clamp255(255 - (yy + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
          yv = clamp255(255 - (yy + t.cb_b[cb]));
        }
        o[3 * x] = (uint8_t)(k - ((255 - c) * k >> 8));  // OpenCV's icvCvt_CMYK2BGR
        o[3 * x + 1] = (uint8_t)(k - ((255 - m) * k >> 8));
        o[3 * x + 2] = (uint8_t)(k - ((255 - yv) * k >> 8));
      }
      continue;
    }
    for (int x = 0; x < W; x++) {
      if (!ycc) {
        o[3 * x] = p0[x];
        o[3 * x + 1] = p1[x];
        o[3 * x + 2] = p2[x];
        continue;
      }
      int yy = p0[x], cb = p1[x], cr = p2[x];
      o[3 * x] = clamp255(yy + t.cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + t.cb_b[cb]);
    }
  }
  // EXIF orientation, as OpenCV's ExifTransform: out(i, j) = rgb(src_y, src_x)
  const int oh = out_height(), ow = out_width();
  for (int i = 0; i < oh; i++)
    for (int j = 0; j < ow; j++) {
      int sy, sx;
      switch (orientation_) {
        case 2: sy = i; sx = W - 1 - j; break;               // flip horizontally
        case 3: sy = H - 1 - i; sx = W - 1 - j; break;       // rotate 180
        case 4: sy = H - 1 - i; sx = j; break;               // flip vertically
        case 5: sy = j; sx = i; break;                       // transpose
        case 6: sy = H - 1 - j; sx = i; break;               // transpose, then flip horizontally
        case 7: sy = H - 1 - j; sx = W - 1 - i; break;       // flip both, then transpose
        case 8: sy = j; sx = W - 1 - i; break;               // transpose, then flip vertically
        default: sy = i; sx = j; break;
      }
      std::memcpy(out + ((size_t)i * ow + j) * 3, &rgb[((size_t)sy * W + sx) * 3], 3);
    }
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg.c_str(), errlen - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" int jpeg_dims(const uint8_t* data, int64_t n, int32_t* dims, char* err, int errlen) {
  try {
    Decoder dec(data, (size_t)n);
    dec.run(true);
    dims[0] = dec.out_height();
    dims[1] = dec.out_width();
    return 0;
  } catch (const Failure& f) {
    set_error(err, errlen, f.msg);
    return f.code;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

extern "C" int jpeg_decode_rgb(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap, char* err, int errlen) {
  try {
    Decoder dec(data, (size_t)n);
    dec.run(false);
    if ((int64_t)dec.out_height() * dec.out_width() * 3 > cap) malformed("output buffer too small");
    dec.render(out);
    return 0;
  } catch (const Failure& f) {
    set_error(err, errlen, f.msg);
    return f.code;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}
