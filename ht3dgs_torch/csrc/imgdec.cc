// Host-side image decoding for ht3dgs_torch.data.imgcodec: PNG row
// unfiltering and a whole JPEG decoder, behind a plain C interface that
// Python loads with ctypes.
//
// This is host code, not a port of a TPU kernel. The JAX package reads its
// frames through Pillow (libjpeg-turbo and zlib), and the port must give
// the very same bytes on a machine that has no Pillow, so the JPEG path
// follows the published IJG algorithms that libjpeg-turbo runs by default:
//
//   * Huffman decoding of baseline (SOF0), extended 8-bit sequential (SOF1)
//     and progressive (SOF2) scans, with restart intervals (ITU T.81
//     F.2.2 and G.1.2);
//   * the "islow" integer inverse DCT: the Loeffler-Ligtenberg-Moschytz
//     factorisation in 13-bit fixed point with 2 extra bits between the
//     passes (IJG jidctint.c, JDCT_ISLOW);
//   * triangular ("fancy") chroma upsampling for h2v1 and h2v2 with its
//     alternating +1/+2 and +8/+7 rounding biases, and plain replication
//     where the downsampled row is 2 samples or fewer (IJG jdsample.c);
//   * YCbCr -> RGB through fixed-point tables at 16 fraction bits
//     (IJG jdcolor.c).
//
// What Pillow would decode differently (arithmetic coding, 12-bit and
// lossless frames, CMYK/YCCK/RGB component transforms, other sampling
// factors) is refused with a message; the caller raises ValueError.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// zig-zag index -> natural (row-major) index; 16 extra entries absorb a
// run that overshoots the block in a corrupt stream
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct DecodeError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError{msg}; }

struct HuffTable {
  bool present = false;
  uint8_t vals[256];
  int maxcode[18];  // largest code of each length, -1 if none
  int valoff[17];   // vals index of the first code of each length - mincode
  // 9-bit lookahead: code length (0 = longer than 9) and symbol
  uint8_t look_len[512];
  uint8_t look_sym[512];

  // Each code is checked before it is written, so a malformed table fails
  // without touching memory past the lookahead arrays. As in libjpeg, no
  // code may be all ones: code + 1 must still fit in len bits.
  void build(const uint8_t* counts, const uint8_t* symbols, int nsym) {
    std::memcpy(vals, symbols, nsym);
    std::memset(look_len, 0, sizeof look_len);
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      valoff[len] = k - code;
      if (counts[len - 1]) {
        for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
          if (code + 1 >= (1 << len))
            fail("JPEG Huffman table is over-subscribed");
          if (len <= 9) {
            int lo = code << (9 - len), n = 1 << (9 - len);
            if (lo + n > 512) fail("JPEG Huffman table is over-subscribed");
            for (int j = 0; j < n; ++j) {
              look_len[lo + j] = (uint8_t)len;
              look_sym[lo + j] = symbols[k];
            }
          }
        }
        maxcode[len] = code - 1;
      } else {
        maxcode[len] = -1;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;          // blocks allocated across and down
  int dsw = 0, dsh = 0;        // samples of the component in the image
  int dc_tbl = 0, ac_tbl = 0;  // tables of the current scan
  int pred = 0;                // DC predictor
  bool latched = false;        // quantisation table taken at first scan
  uint16_t q[64];
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  int16_t* block(int bx, int by) {
    return &coef[((size_t)by * bw + bx) * 64];
  }
};

class JpegDecoder {
 public:
  JpegDecoder(const uint8_t* data, size_t len) : p_(data), end_(data + len) {}

  // Parses up to the frame header; fills width, height, components.
  void read_header() {
    if (len() < 2 || p_[0] != 0xFF || p_[1] != 0xD8) fail("not a JPEG file");
    p_ += 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        progressive_ = (m == 0xC2);
        read_sof();
        return;
      }
      if (m == 0xDA || m == 0xD9) fail("JPEG has no frame header");
      handle_marker(m);
    }
  }

  int width() const { return width_; }
  int height() const { return height_; }
  int channels() const { return ncomp_ == 1 ? 1 : 3; }

  // Decodes every scan, then writes H x W (gray) or H x W x 3 (RGB) bytes.
  void decode(uint8_t* out) {
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;  // EOI
      if (m == 0xDA) {
        read_sos();
        continue;
      }
      if (m == 0xC0 || m == 0xC1 || m == 0xC2)
        fail("JPEG with more than one frame");
      handle_marker(m);
    }
    if (!saw_scan_) fail("JPEG has no scan");
    output(out);
  }

 private:
  const uint8_t* p_;
  const uint8_t* end_;
  uint16_t qt_[4][64];
  bool qt_present_[4] = {false, false, false, false};
  HuffTable dc_[4], ac_[4];
  int width_ = 0, height_ = 0, ncomp_ = 0, hmax_ = 1, vmax_ = 1;
  int mcux_ = 0, mcuy_ = 0;
  Component comp_[3];
  bool progressive_ = false, saw_scan_ = false;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  int restart_interval_ = 0;
  // entropy-coded segment reader
  uint64_t bits_ = 0;
  int nbits_ = 0;
  bool hit_marker_ = false;
  int eobrun_ = 0;

  size_t len() const { return (size_t)(end_ - p_); }

  int u8() {
    if (p_ >= end_) fail("JPEG data ends early");
    return *p_++;
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  // The next marker code, skipping fill bytes; errors on stray data.
  int next_marker() {
    if (u8() != 0xFF) fail("JPEG marker expected");
    int m;
    do {
      m = u8();
    } while (m == 0xFF);
    return m;
  }

  // Any marker but SOI, EOI, SOS and SOF0-2: reads the tables, notes the
  // JFIF and Adobe markers, refuses the frame types that are not supported
  // and skips the rest.
  void handle_marker(int m) {
    if (m == 0xDB) {
      read_dqt();
    } else if (m == 0xC4) {
      read_dht();
    } else if (m == 0xDD) {
      if (u16() != 4) fail("JPEG DRI segment has a bad length");
      restart_interval_ = u16();
    } else if (m == 0xE0 || m == 0xEE) {  // JFIF, Adobe
      const uint8_t* seg = p_;
      int n = u16();
      if (n < 2 || (size_t)n > len()) fail("JPEG segment overruns the file");
      if (m == 0xE0 && n >= 7 && std::memcmp(seg + 2, "JFIF\0", 5) == 0)
        jfif_ = true;
      if (m == 0xEE && n >= 14 && std::memcmp(seg + 2, "Adobe", 5) == 0) {
        adobe_ = true;
        adobe_transform_ = seg[13];
      }
      p_ = seg + n;
    } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
      fail("lossless JPEG is not supported");
    } else if (m == 0xC5 || m == 0xC6 || m == 0xCD || m == 0xCE) {
      fail("hierarchical JPEG is not supported");
    } else if (m == 0xC9 || m == 0xCA || m == 0xCC) {
      fail("arithmetic-coded JPEG is not supported");
    } else if (m == 0xDC) {
      fail("JPEG with a DNL marker is not supported");
    } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      // a stray restart marker or TEM: no segment follows
    } else {
      int n = u16();
      if (n < 2 || (size_t)(n - 2) > len()) fail("JPEG segment overruns the file");
      p_ += n - 2;
    }
  }

  void read_dqt() {
    int n = u16();
    const uint8_t* stop = p_ + n - 2;
    while (p_ < stop) {
      int pq_tq = u8(), pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("JPEG quantisation table is malformed");
      for (int k = 0; k < 64; ++k)
        qt_[tq][kNatural[k]] = (uint16_t)(pq ? u16() : u8());
      qt_present_[tq] = true;
    }
    if (p_ != stop) fail("JPEG DQT segment has a bad length");
  }

  void read_dht() {
    int n = u16();
    const uint8_t* stop = p_ + n - 2;
    while (p_ < stop) {
      int tc_th = u8(), tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("JPEG Huffman table is malformed");
      uint8_t counts[16], syms[256];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = (uint8_t)u8();
      if (total > 256) fail("JPEG Huffman table is malformed");
      for (int i = 0; i < total; ++i) syms[i] = (uint8_t)u8();
      (tc ? ac_[th] : dc_[th]).build(counts, syms, total);
    }
    if (p_ != stop) fail("JPEG DHT segment has a bad length");
  }

  void read_sof() {
    u16();
    int precision = u8();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit JPEG is not supported");
    height_ = u16();
    width_ = u16();
    ncomp_ = u8();
    if (height_ == 0) fail("JPEG with a DNL-defined height is not supported");
    if (width_ == 0) fail("JPEG has zero width");
    if (ncomp_ == 4) fail("CMYK/YCCK JPEG is not supported");
    if (ncomp_ != 1 && ncomp_ != 3)
      fail("JPEG with " + std::to_string(ncomp_) + " components is not supported");
    for (int c = 0; c < ncomp_; ++c) {
      comp_[c].id = u8();
      int hv = u8();
      comp_[c].h = hv >> 4;
      comp_[c].v = hv & 15;
      comp_[c].tq = u8();
      if (comp_[c].h < 1 || comp_[c].h > 4 || comp_[c].v < 1 || comp_[c].v > 4 ||
          comp_[c].tq > 3)
        fail("JPEG frame header is malformed");
      hmax_ = std::max(hmax_, comp_[c].h);
      vmax_ = std::max(vmax_, comp_[c].v);
    }
    if (ncomp_ == 3) {
      // the colour space libjpeg would infer (jdapimin.c): JFIF means
      // YCbCr; else Adobe's transform flag; else component ids "RGB"
      bool rgb = false;
      if (!jfif_ && adobe_) {
        rgb = adobe_transform_ == 0;
      } else if (!jfif_) {
        rgb = comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B';
      }
      if (rgb) fail("JPEG stored as RGB (Adobe transform 0) is not supported");
      for (int c = 0; c < 3; ++c) {
        int rh = hmax_ / comp_[c].h, rv = vmax_ / comp_[c].v;
        bool ok = hmax_ % comp_[c].h == 0 && vmax_ % comp_[c].v == 0 &&
                  ((rh == 1 && rv == 1) || (rh == 2 && rv == 1) ||
                   (rh == 2 && rv == 2));
        if (!ok) {
          char buf[96];
          std::snprintf(buf, sizeof buf,
                        "JPEG sampling factors %dx%d,%dx%d,%dx%d are not supported",
                        comp_[0].h, comp_[0].v, comp_[1].h, comp_[1].v,
                        comp_[2].h, comp_[2].v);
          fail(buf);
        }
      }
    }
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      k.dsw = (width_ * k.h + hmax_ - 1) / hmax_;
      k.dsh = (height_ * k.v + vmax_ - 1) / vmax_;
      if (ncomp_ == 1) {
        k.bw = (k.dsw + 7) / 8;
        k.bh = (k.dsh + 7) / 8;
      } else {
        k.bw = mcux_ * k.h;
        k.bh = mcuy_ * k.v;
      }
    }
  }

  // ---- entropy-coded data -------------------------------------------------

  void fill() {
    while (nbits_ <= 56) {
      int byte = 0;
      if (!hit_marker_) {
        if (p_ >= end_) fail("JPEG data ends early");
        if (p_[0] == 0xFF) {
          int nxt = p_ + 1 < end_ ? p_[1] : 0xD9;
          if (nxt == 0x00) {
            byte = 0xFF;
            p_ += 2;
          } else {
            hit_marker_ = true;  // pad with zeros past the segment's end
          }
        } else {
          byte = *p_++;
        }
      }
      bits_ |= (uint64_t)byte << (56 - nbits_);
      nbits_ += 8;
    }
  }

  int get_bits(int n) {
    if (n == 0) return 0;
    if (nbits_ < n) fill();
    int v = (int)(bits_ >> (64 - n));
    bits_ <<= n;
    nbits_ -= n;
    return v;
  }

  int get_bit() { return get_bits(1); }

  static int extend(int v, int n) {
    return v < (1 << (n - 1)) ? v - (1 << n) + 1 : v;
  }

  int decode_huff(const HuffTable& t) {
    if (nbits_ < 16) fill();
    int look = (int)(bits_ >> (64 - 9));
    int l = t.look_len[look];
    if (l) {
      bits_ <<= l;
      nbits_ -= l;
      return t.look_sym[look];
    }
    int code = (int)(bits_ >> (64 - 9));
    bits_ <<= 9;
    nbits_ -= 9;
    for (l = 10; l <= 16; ++l) {
      code = (code << 1) | get_bit();
      if (code <= t.maxcode[l]) return t.vals[t.valoff[l] + code];
    }
    fail("JPEG Huffman code is corrupt");
  }

  void reset_bits() {
    bits_ = 0;
    nbits_ = 0;
  }

  // Moves past the segment's end to the next marker, leaving p_ on its 0xFF.
  void seek_marker() {
    reset_bits();
    hit_marker_ = false;
    while (p_ + 1 < end_ && !(p_[0] == 0xFF && p_[1] != 0x00 && p_[1] != 0xFF))
      ++p_;
    if (p_ + 1 >= end_) fail("JPEG data ends early");
  }

  void restart(int expected) {
    seek_marker();
    if (p_[1] != 0xD0 + expected) fail("JPEG restart marker is out of order");
    p_ += 2;
    for (int c = 0; c < ncomp_; ++c) comp_[c].pred = 0;
    eobrun_ = 0;
  }

  // ---- scans ----------------------------------------------------------------

  void read_sos() {
    if (ncomp_ == 0) fail("JPEG scan before the frame header");
    u16();
    int ns = u8();
    if (ns < 1 || ns > ncomp_) fail("JPEG scan header is malformed");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int id = u8(), t = u8();
      Component* k = nullptr;
      for (int c = 0; c < ncomp_; ++c)
        if (comp_[c].id == id) k = &comp_[c];
      if (!k) fail("JPEG scan names an unknown component");
      k->dc_tbl = t >> 4;
      k->ac_tbl = t & 15;
      if (k->dc_tbl > 3 || k->ac_tbl > 3) fail("JPEG scan header is malformed");
      sc[i] = k;
    }
    int ss = u8(), se = u8(), a = u8(), ah = a >> 4, al = a & 15;
    if (!progressive_ && (ss != 0 || se != 63 || a != 0))
      fail("JPEG sequential scan header is malformed");
    if (progressive_ && (se > 63 || ss > se || (ss == 0 && se != 0) ||
                         (ss > 0 && ns != 1) || al > 13))
      fail("JPEG progressive scan header is malformed");
    for (int i = 0; i < ns; ++i) {
      Component* k = sc[i];
      if (!k->latched) {
        if (!qt_present_[k->tq]) fail("JPEG quantisation table is missing");
        std::memcpy(k->q, qt_[k->tq], sizeof k->q);
        k->latched = true;
      }
      if (k->coef.empty()) k->coef.assign((size_t)k->bw * k->bh * 64, 0);
      bool need_dc = ss == 0 && ah == 0;
      bool need_ac = se > 0;
      if (need_dc && !dc_[k->dc_tbl].present) fail("JPEG Huffman table is missing");
      if (need_ac && !ac_[k->ac_tbl].present) fail("JPEG Huffman table is missing");
      k->pred = 0;
    }
    saw_scan_ = true;
    reset_bits();
    hit_marker_ = false;
    eobrun_ = 0;

    auto block_fn = [&](Component* k, int16_t* blk) {
      if (!progressive_)
        decode_sequential(k, blk);
      else if (ss == 0)
        decode_dc(k, blk, ah, al);
      else if (ah == 0)
        decode_ac_first(k, blk, ss, se, al);
      else
        decode_ac_refine(k, blk, ss, se, al);
    };

    int rst = 0, left = restart_interval_;
    auto mcu_boundary = [&]() {
      if (!restart_interval_) return;
      if (--left == 0) {
        left = restart_interval_;
        restart(rst);
        rst = (rst + 1) & 7;
      }
    };
    if (ns == 1) {
      // one component: its blocks in raster order over its own extent
      Component* k = sc[0];
      int nbx = (k->dsw + 7) / 8, nby = (k->dsh + 7) / 8;
      for (int by = 0; by < nby; ++by)
        for (int bx = 0; bx < nbx; ++bx) {
          block_fn(k, k->block(bx, by));
          if (!(by == nby - 1 && bx == nbx - 1)) mcu_boundary();
        }
    } else {
      for (int my = 0; my < mcuy_; ++my)
        for (int mx = 0; mx < mcux_; ++mx) {
          for (int i = 0; i < ns; ++i) {
            Component* k = sc[i];
            for (int v = 0; v < k->v; ++v)
              for (int h = 0; h < k->h; ++h)
                block_fn(k, k->block(mx * k->h + h, my * k->v + v));
          }
          if (!(my == mcuy_ - 1 && mx == mcux_ - 1)) mcu_boundary();
        }
    }
    seek_marker();
  }

  void decode_sequential(Component* k, int16_t* blk) {
    int s = decode_huff(dc_[k->dc_tbl]);
    if (s > 11) fail("JPEG DC coefficient is corrupt");
    int diff = s ? extend(get_bits(s), s) : 0;
    k->pred += diff;
    blk[0] = (int16_t)k->pred;
    const HuffTable& ac = ac_[k->ac_tbl];
    for (int z = 1; z < 64;) {
      int rs = decode_huff(ac), r = rs >> 4;
      s = rs & 15;
      if (s) {
        z += r;
        blk[kNatural[z]] = (int16_t)extend(get_bits(s), s);
        ++z;
      } else {
        if (r != 15) break;
        z += 16;
      }
    }
  }

  void decode_dc(Component* k, int16_t* blk, int ah, int al) {
    if (ah == 0) {
      int s = decode_huff(dc_[k->dc_tbl]);
      if (s > 11) fail("JPEG DC coefficient is corrupt");
      int diff = s ? extend(get_bits(s), s) : 0;
      k->pred += diff;
      blk[0] = (int16_t)(k->pred * (1 << al));
    } else if (get_bit()) {
      blk[0] = (int16_t)(blk[0] | (1 << al));
    }
  }

  void decode_ac_first(Component* k, int16_t* blk, int ss, int se, int al) {
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    const HuffTable& ac = ac_[k->ac_tbl];
    for (int z = ss; z <= se; ++z) {
      int rs = decode_huff(ac), r = rs >> 4, s = rs & 15;
      if (s) {
        z += r;
        blk[kNatural[z]] = (int16_t)(extend(get_bits(s), s) * (1 << al));
      } else {
        if (r < 15) {
          eobrun_ = (1 << r) + get_bits(r) - 1;
          break;
        }
        z += 15;
      }
    }
  }

  // A correction bit for a coefficient that is already nonzero.
  void refine(int16_t* c, int p1, int m1) {
    if (get_bit() && (*c & p1) == 0) *c = (int16_t)(*c + (*c >= 0 ? p1 : m1));
  }

  void decode_ac_refine(Component* k, int16_t* blk, int ss, int se, int al) {
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int z = ss;
    if (eobrun_ == 0) {
      const HuffTable& ac = ac_[k->ac_tbl];
      for (; z <= se; ++z) {
        int rs = decode_huff(ac), r = rs >> 4, s = rs & 15;
        if (s) {
          s = get_bit() ? p1 : m1;  // a new coefficient has magnitude 1
        } else if (r != 15) {
          eobrun_ = (1 << r) + get_bits(r);
          break;
        }
        // pass r zero coefficients, refining the nonzero ones on the way
        for (; z <= se; ++z) {
          int16_t* c = &blk[kNatural[z]];
          if (*c != 0) {
            refine(c, p1, m1);
          } else if (--r < 0) {
            break;
          }
        }
        if (s) blk[kNatural[z]] = (int16_t)s;
      }
    }
    if (eobrun_ > 0) {
      for (; z <= se; ++z) {
        int16_t* c = &blk[kNatural[z]];
        if (*c != 0) refine(c, p1, m1);
      }
      --eobrun_;
    }
  }

  // ---- output ---------------------------------------------------------------

  // The islow inverse DCT of one dequantised block into 8x8 samples.
  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                         int stride, const uint8_t* limit) {
    const int kBits = 13, kPass1 = 2;
    const int64_t c0_298 = 2446, c0_390 = 3196, c0_541 = 4433, c0_765 = 6270,
                  c0_899 = 7373, c1_175 = 9633, c1_501 = 12299, c1_847 = 15137,
                  c1_961 = 16069, c2_053 = 16819, c2_562 = 20995,
                  c3_072 = 25172;
    int ws[64];
    auto descale = [](int64_t x, int n) -> int64_t {
      return (x + ((int64_t)1 << (n - 1))) >> n;
    };
    // the even/odd butterfly shared by both passes: x[0..7] -> y[0..7]
    auto butterfly = [&](const int64_t* x, int64_t* y) {
      int64_t z2 = x[2], z3 = x[6];
      int64_t z1 = (z2 + z3) * c0_541;
      int64_t t2 = z1 + z3 * -c1_847;
      int64_t t3 = z1 + z2 * c0_765;
      int64_t t0 = (x[0] + x[4]) * ((int64_t)1 << kBits);
      int64_t t1 = (x[0] - x[4]) * ((int64_t)1 << kBits);
      int64_t e10 = t0 + t3, e13 = t0 - t3, e11 = t1 + t2, e12 = t1 - t2;
      int64_t o0 = x[7], o1 = x[5], o2 = x[3], o3 = x[1];
      int64_t w1 = o0 + o3, w2 = o1 + o2, w3 = o0 + o2, w4 = o1 + o3;
      int64_t w5 = (w3 + w4) * c1_175;
      o0 *= c0_298;
      o1 *= c2_053;
      o2 *= c3_072;
      o3 *= c1_501;
      w1 *= -c0_899;
      w2 *= -c2_562;
      w3 = w3 * -c1_961 + w5;
      w4 = w4 * -c0_390 + w5;
      o0 += w1 + w3;
      o1 += w2 + w4;
      o2 += w2 + w3;
      o3 += w1 + w4;
      y[0] = e10 + o3;
      y[7] = e10 - o3;
      y[1] = e11 + o2;
      y[6] = e11 - o2;
      y[2] = e12 + o1;
      y[5] = e12 - o1;
      y[3] = e13 + o0;
      y[4] = e13 - o0;
    };
    int64_t x[8], y[8];
    for (int col = 0; col < 8; ++col) {
      bool ac_zero = true;
      for (int r = 1; r < 8; ++r) ac_zero &= in[r * 8 + col] == 0;
      if (ac_zero) {
        int dc = (int)in[col] * q[col] * (1 << kPass1);
        for (int r = 0; r < 8; ++r) ws[r * 8 + col] = dc;
        continue;
      }
      for (int r = 0; r < 8; ++r) x[r] = (int64_t)in[r * 8 + col] * q[r * 8 + col];
      butterfly(x, y);
      for (int r = 0; r < 8; ++r) ws[r * 8 + col] = (int)descale(y[r], kBits - kPass1);
    }
    for (int row = 0; row < 8; ++row) {
      const int* w = &ws[row * 8];
      uint8_t* o = out + (size_t)row * stride;
      bool ac_zero = true;
      for (int c = 1; c < 8; ++c) ac_zero &= w[c] == 0;
      if (ac_zero) {
        uint8_t v = limit[(int)descale(w[0], kPass1 + 3) & 1023];
        for (int c = 0; c < 8; ++c) o[c] = v;
        continue;
      }
      for (int c = 0; c < 8; ++c) x[c] = w[c];
      butterfly(x, y);
      for (int c = 0; c < 8; ++c)
        o[c] = limit[(int)descale(y[c], kBits + kPass1 + 3) & 1023];
    }
  }

  // Each component's samples, (bw*8) x (bh*8), row stride bw*8.
  std::vector<uint8_t> component_plane(Component& k) {
    // post-IDCT range limit, indexed by (value & 1023): value + 128 clamped
    // to [0, 255] for values in [-512, 511]
    uint8_t limit[1024];
    for (int i = 0; i < 1024; ++i) {
      int v = i < 512 ? i : i - 1024;
      v += 128;
      limit[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
    int stride = k.bw * 8;
    std::vector<uint8_t> plane((size_t)stride * k.bh * 8);
    if (k.coef.empty()) k.coef.assign((size_t)k.bw * k.bh * 64, 0);
    if (!k.latched) {
      if (!qt_present_[k.tq]) fail("JPEG quantisation table is missing");
      std::memcpy(k.q, qt_[k.tq], sizeof k.q);
    }
    int nby = (k.dsh + 7) / 8, nbx = (k.dsw + 7) / 8;
    for (int by = 0; by < nby; ++by)
      for (int bx = 0; bx < nbx; ++bx)
        idct_islow(k.block(bx, by), k.q, &plane[(size_t)by * 8 * stride + bx * 8],
                   stride, limit);
    return plane;
  }

  // Upsamples component k to a W x H plane.
  std::vector<uint8_t> full_plane(Component& k) {
    std::vector<uint8_t> src = component_plane(k);
    int sstride = k.bw * 8, W = width_, H = height_;
    int rh = hmax_ / k.h, rv = vmax_ / k.v;
    std::vector<uint8_t> dst((size_t)W * H);
    int dsw = k.dsw, dsh = k.dsh;
    auto srow = [&](int r) -> const uint8_t* {
      r = r < 0 ? 0 : r >= dsh ? dsh - 1 : r;  // edge rows replicated
      return &src[(size_t)r * sstride];
    };
    std::vector<uint8_t> wide(2 * (size_t)dsw);
    for (int y = 0; y < H; ++y) {
      uint8_t* o = &dst[(size_t)y * W];
      if (rh == 1) {
        std::memcpy(o, srow(y), W);
        continue;
      }
      if (dsw <= 2) {  // plain replication
        const uint8_t* s = srow(rv == 2 ? y / 2 : y);
        for (int x = 0; x < W; ++x) o[x] = s[x / 2];
        continue;
      }
      if (rv == 1) {  // h2v1: 3/4 nearer + 1/4 further, biases 1 and 2
        const uint8_t* s = srow(y);
        wide[0] = s[0];
        wide[1] = (uint8_t)((s[0] * 3 + s[1] + 2) >> 2);
        for (int i = 1; i < dsw - 1; ++i) {
          int c = s[i] * 3;
          wide[2 * i] = (uint8_t)((c + s[i - 1] + 1) >> 2);
          wide[2 * i + 1] = (uint8_t)((c + s[i + 1] + 2) >> 2);
        }
        int c = s[dsw - 1];
        wide[2 * dsw - 2] = (uint8_t)((c * 3 + s[dsw - 2] + 1) >> 2);
        wide[2 * dsw - 1] = (uint8_t)c;
      } else {  // h2v2: vertical 3:1 with the nearer row, then 3:1 across
        int r = y / 2;
        const uint8_t* s0 = srow(r);
        const uint8_t* s1 = srow(y % 2 == 0 ? r - 1 : r + 1);
        int last = s0[0] * 3 + s1[0];
        int cur = last;
        int nxt = s0[1] * 3 + s1[1];
        wide[0] = (uint8_t)((cur * 4 + 8) >> 4);
        wide[1] = (uint8_t)((cur * 3 + nxt + 7) >> 4);
        last = cur;
        cur = nxt;
        for (int i = 1; i < dsw - 1; ++i) {
          nxt = s0[i + 1] * 3 + s1[i + 1];
          wide[2 * i] = (uint8_t)((cur * 3 + last + 8) >> 4);
          wide[2 * i + 1] = (uint8_t)((cur * 3 + nxt + 7) >> 4);
          last = cur;
          cur = nxt;
        }
        wide[2 * dsw - 2] = (uint8_t)((cur * 3 + last + 8) >> 4);
        wide[2 * dsw - 1] = (uint8_t)((cur * 4 + 7) >> 4);
      }
      std::memcpy(o, wide.data(), W);
    }
    return dst;
  }

  void output(uint8_t* out) {
    size_t n = (size_t)width_ * height_;
    if (ncomp_ == 1) {
      std::vector<uint8_t> y = full_plane(comp_[0]);
      std::memcpy(out, y.data(), n);
      return;
    }
    std::vector<uint8_t> Y = full_plane(comp_[0]);
    std::vector<uint8_t> Cb = full_plane(comp_[1]);
    std::vector<uint8_t> Cr = full_plane(comp_[2]);
    const int kScale = 16;
    const int64_t half = (int64_t)1 << (kScale - 1);
    auto fix = [](double x) -> int64_t { return (int64_t)(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
    auto clamp = [](int v) -> uint8_t { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    for (size_t i = 0; i < n; ++i) {
      int y = Y[i], cb = Cb[i], cr = Cr[i];
      out[3 * i + 0] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> kScale));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

void copy_error(const std::string& msg, char* err, int errlen) {
  if (err && errlen > 0) {
    std::snprintf(err, (size_t)errlen, "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

// Width, height and channels (1 or 3) of a JPEG in memory, from its headers.
// Returns 0, or 1 with a message in err.
int ht3dgs_jpeg_info(const uint8_t* data, int64_t len, int* dims, char* err,
                     int errlen) {
  try {
    JpegDecoder d(data, (size_t)len);
    d.read_header();
    dims[0] = d.width();
    dims[1] = d.height();
    dims[2] = d.channels();
    return 0;
  } catch (const DecodeError& e) {
    copy_error(e.msg, err, errlen);
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
  }
  return 1;
}

// Decodes a JPEG in memory into out (H x W or H x W x 3 bytes, as
// ht3dgs_jpeg_info gives). Returns 0, or 1 with a message in err.
int ht3dgs_jpeg_decode(const uint8_t* data, int64_t len, uint8_t* out,
                       int64_t out_size, char* err, int errlen) {
  try {
    JpegDecoder d(data, (size_t)len);
    d.read_header();
    if ((int64_t)d.width() * d.height() * d.channels() != out_size) {
      copy_error("JPEG output buffer has the wrong size", err, errlen);
      return 1;
    }
    d.decode(out);
    return 0;
  } catch (const DecodeError& e) {
    copy_error(e.msg, err, errlen);
  } catch (const std::exception& e) {
    copy_error(e.what(), err, errlen);
  }
  return 1;
}

// Undoes PNG row filtering (None/Sub/Up/Average/Paeth). in holds rows of
// 1 filter byte + stride bytes; out receives rows x stride bytes. bpp is the
// filter's byte step (bytes per pixel, at least 1). Returns 0, or the
// 1-based row whose filter type is unknown.
int64_t ht3dgs_png_unfilter(const uint8_t* in, int64_t rows, int64_t stride,
                            int bpp, uint8_t* out) {
  std::vector<uint8_t> zero((size_t)stride, 0);
  for (int64_t y = 0; y < rows; ++y) {
    const uint8_t* f = in + y * (stride + 1);
    const uint8_t* s = f + 1;
    uint8_t* o = out + y * stride;
    const uint8_t* up = y ? o - stride : zero.data();
    switch (f[0]) {
      case 0:
        std::memcpy(o, s, (size_t)stride);
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          o[i] = (uint8_t)(s[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i) o[i] = (uint8_t)(s[i] + up[i]);
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i)
          o[i] = (uint8_t)(s[i] + (((i >= bpp ? o[i - bpp] : 0) + up[i]) >> 1));
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? o[i - bpp] : 0, b = up[i], c = i >= bpp ? up[i - bpp] : 0;
          int p = a + b - c, pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p,
              pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          o[i] = (uint8_t)(s[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
