// The hot loops of the port's image decoder: PNG row unfiltering and JPEG
// decoding.
//
// PNG: the decoder (fsnerf_tpu_torch/native/__init__.py) parses the chunks
// and inflates the image data with Python's zlib; fsnerf_unfilter undoes
// the five PNG row filters (none, sub, up, average, Paeth) of every image,
// one image per thread, writing each image's raw rows to a caller-provided
// buffer.
//
// JPEG: fsnerf_tpu_torch/native/jpeg.py parses the markers and lays out
// the frame, scans and tables; fsnerf_jpeg_decode decodes each image, one
// per thread, as libjpeg-turbo 2.1.5 does with fsnerf_tpu/native's
// settings (JCS_RGB output, the islow IDCT, fancy upsampling), and writes
// float32 pixels. Each step mirrors the library source it names:
// jdhuff.c / jdphuff.c (Huffman decoding, baseline and progressive, with
// restart markers and data cut short), jidctint.c (jpeg_idct_islow),
// jdsample.c with jdmainct.c's context rows (upsampling) and jdcolor.c
// (YCbCr -> RGB). It needs no library headers: libpng and libjpeg are not
// required.
//
// C interface (bound with ctypes):
//   fsnerf_unfilter(n, src, dst, h, rowbytes, bpp, n_threads)
//     src[i]: image i's inflated data, h rows of (1 filter byte + rowbytes);
//     dst[i]: h * rowbytes bytes of unfiltered rows;
//     bpp: bytes per complete pixel (at least 1).
//   Returns 0 on success, else 1 + the index of the first image holding an
//   unknown filter type.
//   fsnerf_jpeg_decode(n, data, size, desc, qt, huff, out, channels,
//                      n_threads)
//     data[i], size[i]: image i's file bytes, ending in 0xFF 0xD9;
//     desc[i], qt[i], huff[i]: its frame, scans and tables (jpeg.py's
//     layout); out[i]: float32 [h, w, channels], channels 3 or 4 (alpha
//     1), each 8-bit value times 1/255.
//   Returns 0 on success, else 1 + the index of the first image that
//   failed (a Huffman table that does not build, or a DC value out of
//   range in a progressive scan).
//
// Built at first use by fsnerf_tpu_torch/native/__init__.py:
//   g++ -O2 -fPIC -std=c++17 -Wall -shared -o <lib> loader.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <functional>
#include <thread>
#include <vector>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

// Unfilters one image; false on an unknown filter type.
bool unfilter(const uint8_t* src, uint8_t* dst, int h, int rowbytes,
              int bpp) {
  const std::vector<uint8_t> zero(rowbytes, 0);
  for (int r = 0; r < h; ++r) {
    const uint8_t* in = src + size_t(r) * (rowbytes + 1);
    const uint8_t filter = in[0];
    ++in;
    uint8_t* out = dst + size_t(r) * rowbytes;
    const uint8_t* up = r ? out - rowbytes : zero.data();
    switch (filter) {
      case 0:
        std::copy(in, in + rowbytes, out);
        break;
      case 1:
        for (int i = 0; i < rowbytes; ++i)
          out[i] = in[i] + (i >= bpp ? out[i - bpp] : 0);
        break;
      case 2:
        for (int i = 0; i < rowbytes; ++i) out[i] = in[i] + up[i];
        break;
      case 3:
        for (int i = 0; i < rowbytes; ++i)
          out[i] = in[i] + ((i >= bpp ? out[i - bpp] : 0) + up[i]) / 2;
        break;
      case 4:
        for (int i = 0; i < rowbytes; ++i)
          out[i] = in[i] + paeth(i >= bpp ? out[i - bpp] : 0, up[i],
                                 i >= bpp ? up[i - bpp] : 0);
        break;
      default:
        return false;
    }
  }
  return true;
}

// Runs job(i) for i < n on n_threads threads (0: one per core), one item
// per thread at a time; returns 0, or 1 + the index of the first item whose
// job returned false (the items after it are not started).
int run_pool(int n, int n_threads, const std::function<bool(int)>& job) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> fail(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n || fail.load()) return;
      if (!job(i)) {
        int expected = 0;
        fail.compare_exchange_strong(expected, i + 1);
        return;
      }
    }
  };
  std::vector<std::thread> pool;
  const int tcount = std::min(n_threads, n);
  pool.reserve(tcount);
  for (int t = 0; t < tcount; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return fail.load();
}

// ---------------------------------------------------------------- JPEG

namespace jpeg {

// jpeg.py's layout of `desc`
constexpr int kWidth = 0, kHeight = 1, kNComp = 2, kColor = 3, kNScans = 4,
              kHMax = 5, kVMax = 6, kProgressive = 7, kComps = 8,
              kScans = 16, kScanWords = 20;
constexpr int kGray = 0, kYcc = 1;

// jutils.c: jpeg_natural_order, with the 16 extra entries that catch a
// coefficient index that corrupt data runs past 63
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookahead = 8;     // jdhuff.h: HUFF_LOOKAHEAD
constexpr int kMinGetBits = 57;   // MIN_GET_BITS of a 64-bit bit buffer

// jdhuff.h: d_derived_tbl
struct Huff {
  int32_t maxcode[18];
  int32_t valoffset[18];
  int32_t lookup[1 << kLookahead];
  uint8_t vals[256];
};

// jdhuff.c: jpeg_make_d_derived_tbl, from jpeg.py's table row (the code
// counts of lengths 1..16, then 256 symbols); false on a bad table.
bool make_huff(const int32_t* spec, Huff* t) {
  const int32_t* bits = spec;
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int i = bits[l - 1];
    if (i < 0 || p + i > 256) return false;
    while (i--) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  for (int i = 0; i < 256; ++i) t->vals[i] = static_cast<uint8_t>(spec[16 + i]);
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (static_cast<int64_t>(code) >= (int64_t{1} << si)) return false;
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l - 1]) {
      t->valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
      p += bits[l - 1];
      t->maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  for (int i = 0; i < (1 << kLookahead); ++i)
    t->lookup[i] = (kLookahead + 1) << kLookahead;
  p = 0;
  for (int l = 1; l <= kLookahead; ++l) {
    for (int i = 1; i <= bits[l - 1]; ++i, ++p) {
      int look = static_cast<int>(huffcode[p]) << (kLookahead - l);
      for (int ctr = 1 << (kLookahead - l); ctr > 0; --ctr)
        t->lookup[look++] = (l << kLookahead) | t->vals[p];
    }
  }
  return true;
}

// HUFF_EXTEND
inline int extend(int x, int s) {
  return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x;
}

// The entropy decoder's bit reader (jdhuff.c: jpeg_fill_bit_buffer,
// HUFF_DECODE, jpeg_huff_decode) and its marker handling (jdmarker.c:
// next_marker, read_restart_marker, jpeg_resync_to_restart).
struct Reader {
  const uint8_t* p;         // next byte
  const uint8_t* end;       // the file's end (after its 0xFF 0xD9)
  uint64_t buf = 0;         // get_buffer: the low `left` bits are unread
  int left = 0;             // bits_left
  int marker = 0;           // unread_marker: the marker the data ran into
  bool insufficient = false;  // insufficient_data: zero bits were read

  int next_byte() { return p < end ? *p++ : 0xD9; }

  void fill(int nbits) {
    if (marker == 0) {
      while (left < kMinGetBits) {
        if (p >= end) {
          marker = 0xD9;
          break;
        }
        int c = *p++;
        if (c == 0xFF) {
          do c = next_byte(); while (c == 0xFF);
          if (c != 0) {
            marker = c;
            break;
          }
          c = 0xFF;
        }
        buf = (buf << 8) | static_cast<uint64_t>(c);
        left += 8;
      }
      if (marker == 0) return;
    }
    // past the marker that ends the data: zero bits, once flagged
    if (nbits > left) {
      insufficient = true;
      buf <<= kMinGetBits - left;
      left = kMinGetBits;
    }
  }

  int get(int n) {
    if (left < n) fill(n);
    left -= n;
    return static_cast<int>((buf >> left) & ((uint64_t{1} << n) - 1));
  }

  int decode_slow(const Huff& h, int l) {
    int32_t code = get(l);
    while (code > h.maxcode[l]) {
      code = (code << 1) | get(1);
      ++l;
    }
    if (l > 16) return 0;   // garbage input: a fake zero
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }

  int decode(const Huff& h) {
    if (left < kLookahead) {
      fill(0);
      if (left < kLookahead) return decode_slow(h, 1);
    }
    const int look =
        static_cast<int>((buf >> (left - kLookahead)) & ((1 << kLookahead) - 1));
    const int nb = h.lookup[look] >> kLookahead;
    if (nb <= kLookahead) {
      left -= nb;
      return h.lookup[look] & ((1 << kLookahead) - 1);
    }
    return decode_slow(h, nb);
  }

  // A coefficient of s bits (s > 0), sign-extended.
  int receive(int s) { return extend(get(s), s); }

  void next_marker() {
    for (;;) {
      if (p >= end) {
        marker = 0xD9;
        return;
      }
      int c = *p++;
      if (c != 0xFF) continue;
      do c = next_byte(); while (c == 0xFF);
      if (c != 0) {
        marker = c;
        return;
      }
    }
  }

  // The marker half of process_restart: drop the buffered bits, then take
  // the restart marker `desired`, resynchronizing when it is not there.
  void restart(int desired) {
    left = 0;
    if (marker == 0) next_marker();
    if (marker == 0xD0 + desired) {
      marker = 0;
      return;
    }
    for (;;) {
      int action;
      if (marker < 0xC0) {
        action = 2;
      } else if (marker < 0xD0 || marker > 0xD7) {
        action = 3;
      } else if (marker == 0xD0 + ((desired + 1) & 7) ||
                 marker == 0xD0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (marker == 0xD0 + ((desired - 1) & 7) ||
                 marker == 0xD0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {   // discard the marker and go on
        marker = 0;
        return;
      }
      if (action == 3) return;   // leave it: the segment reads as empty
      next_marker();
    }
  }
};

// One component's coefficients: blocks on the grid of the interleaved
// MCUs (dummy blocks at the edges included), pre-zeroed.
struct Comp {
  int h = 1, v = 1;
  int dw = 0, dh = 0;     // downsampled width, height (samples)
  int bw = 0, bh = 0;     // width, height in blocks (without dummies)
  int pw = 0, ph = 0;     // width, height of the block grid
  std::vector<int16_t> coef;
  int16_t* block(int by, int bx) {
    return coef.data() + (static_cast<size_t>(by) * pw + bx) * 64;
  }
};

// Decodes one scan (jdhuff.c decode_mcu for a sequential scan, jdphuff.c's
// four decode_mcu_* for a progressive one) into the components'
// coefficients. False on a DC value out of range (JERR_BAD_DCT_COEF).
bool decode_scan(const int32_t* sc, const uint8_t* data, int64_t size,
                 const std::vector<Huff>& tabs, std::vector<Comp>& comps,
                 int width, int height, int hmax, int vmax, bool progressive) {
  const int n = sc[0];
  const int ss = sc[5], se = sc[6], ah = sc[7], al = sc[8], interval = sc[9];
  Reader r;
  r.p = data + sc[10];
  r.end = data + size;
  const Huff* dc[4] = {nullptr, nullptr, nullptr, nullptr};
  const Huff* ac[4] = {nullptr, nullptr, nullptr, nullptr};
  for (int k = 0; k < n; ++k) {
    if (sc[11 + k] >= 0) dc[k] = &tabs[sc[11 + k]];
    if (sc[15 + k] >= 0) ac[k] = &tabs[sc[15 + k]];
  }
  // the blocks of an MCU: (scan component, row, column) within it
  struct Member { int k, yi, xi; };
  std::vector<Member> members;
  int mcus_x, mcus_y;
  if (n == 1) {             // non-interleaved: one block per MCU
    mcus_x = comps[sc[1]].bw;
    mcus_y = comps[sc[1]].bh;
    members.push_back({0, 0, 0});
  } else {
    mcus_x = (width + hmax * 8 - 1) / (hmax * 8);
    mcus_y = (height + vmax * 8 - 1) / (vmax * 8);
    for (int k = 0; k < n; ++k) {
      const Comp& c = comps[sc[1 + k]];
      for (int yi = 0; yi < c.v; ++yi)
        for (int xi = 0; xi < c.h; ++xi) members.push_back({k, yi, xi});
    }
  }
  const int p1 = 1 << al;
  const int m1 = -p1;
  int last_dc[4] = {0, 0, 0, 0};
  unsigned eobrun = 0;
  int restarts_to_go = interval, next_restart = 0;
  std::vector<int16_t*> blocks(members.size());
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      if (interval) {
        if (restarts_to_go == 0) {   // process_restart
          r.restart(next_restart);
          next_restart = (next_restart + 1) & 7;
          for (int k = 0; k < 4; ++k) last_dc[k] = 0;
          eobrun = 0;
          restarts_to_go = interval;
          if (r.marker == 0) r.insufficient = false;
        }
      }
      for (size_t b = 0; b < members.size(); ++b) {
        const Member& m = members[b];
        Comp& c = comps[sc[1 + m.k]];
        blocks[b] = n == 1 ? c.block(my, mx)
                           : c.block(my * c.v + m.yi, mx * c.h + m.xi);
      }
      if (!progressive) {                          // decode_mcu_slow
        if (!r.insufficient) {
          for (size_t b = 0; b < members.size(); ++b) {
            const int k = members[b].k;
            int16_t* blk = blocks[b];
            int s = r.decode(*dc[k]);
            if (s) s = r.receive(s);
            s = static_cast<int>(static_cast<unsigned>(s) +
                                 static_cast<unsigned>(last_dc[k]));
            last_dc[k] = s;
            blk[0] = static_cast<int16_t>(s);
            for (int i = 1; i < 64; ++i) {
              s = r.decode(*ac[k]);
              const int run = s >> 4;
              s &= 15;
              if (s) {
                i += run;
                blk[kNatural[i]] = static_cast<int16_t>(r.receive(s));
              } else {
                if (run != 15) break;
                i += 15;
              }
            }
          }
        }
      } else if (ss == 0 && ah == 0) {             // decode_mcu_DC_first
        if (!r.insufficient) {
          for (size_t b = 0; b < members.size(); ++b) {
            const int k = members[b].k;
            int s = r.decode(*dc[k]);
            if (s) s = r.receive(s);
            if ((last_dc[k] >= 0 && s > INT_MAX - last_dc[k]) ||
                (last_dc[k] < 0 && s < INT_MIN - last_dc[k]))
              return false;
            s += last_dc[k];
            last_dc[k] = s;
            blocks[b][0] = static_cast<int16_t>(static_cast<unsigned>(s) << al);
          }
        }
      } else if (ss == 0) {                        // decode_mcu_DC_refine
        for (size_t b = 0; b < members.size(); ++b)
          if (r.get(1)) blocks[b][0] = static_cast<int16_t>(blocks[b][0] | p1);
      } else if (ah == 0) {                        // decode_mcu_AC_first
        if (!r.insufficient) {
          if (eobrun > 0) {
            --eobrun;
          } else {
            int16_t* blk = blocks[0];
            for (int i = ss; i <= se; ++i) {
              int s = r.decode(*ac[0]);
              int run = s >> 4;
              s &= 15;
              if (s) {
                i += run;
                blk[kNatural[i]] =
                    static_cast<int16_t>(static_cast<unsigned>(r.receive(s)) << al);
              } else if (run == 15) {
                i += 15;
              } else {
                eobrun = 1u << run;
                if (run) eobrun += r.get(run);
                --eobrun;
                break;
              }
            }
          }
        }
      } else {                                     // decode_mcu_AC_refine
        if (!r.insufficient) {
          int16_t* blk = blocks[0];
          int i = ss;
          if (eobrun == 0) {
            for (; i <= se; ++i) {
              int s = r.decode(*ac[0]);
              int run = s >> 4;
              s &= 15;
              if (s) {
                s = r.get(1) ? p1 : m1;
              } else if (run != 15) {
                eobrun = 1u << run;
                if (run) eobrun += r.get(run);
                break;
              }
              // skip the already-nonzero coefficients (appending their
              // correction bits) and `run` zero ones
              do {
                int16_t* coef = blk + kNatural[i];
                if (*coef != 0) {
                  if (r.get(1) && (*coef & p1) == 0)
                    *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
                } else if (--run < 0) {
                  break;
                }
                ++i;
              } while (i <= se);
              if (s) blk[kNatural[i]] = static_cast<int16_t>(s);
            }
          }
          if (eobrun > 0) {
            for (; i <= se; ++i) {
              int16_t* coef = blk + kNatural[i];
              if (*coef != 0 && r.get(1) && (*coef & p1) == 0)
                *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
            }
            --eobrun;
          }
        }
      }
      if (interval) --restarts_to_go;
    }
  }
  return true;
}

// jidctint.c: jpeg_idct_islow, CONST_BITS 13, PASS1_BITS 2
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}
inline int64_t lshift(int64_t a, int b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) << b);
}

// IDCT_range_limit (jdmaster.c's table from CENTERJSAMPLE on), indexed by
// the output value & RANGE_MASK (1023): corrupt data wraps, not clamps
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int x = 0; x < 1024; ++x)
      t[x] = x < 128 ? x + 128 : x < 512 ? 255 : x < 896 ? 0 : x - 896;
  }
};
const RangeLimit kLimit;

// The 1-D odd and even parts shared by both passes: out[0..7] from the
// eight (dequantized or first-pass) inputs, before descaling.
struct Parts {
  int64_t t10, t11, t12, t13, t0, t1, t2, t3;
};

inline Parts idct_parts(int64_t i0, int64_t i1, int64_t i2, int64_t i3,
                        int64_t i4, int64_t i5, int64_t i6, int64_t i7) {
  Parts o;
  int64_t z2 = i2, z3 = i6;
  int64_t z1 = (z2 + z3) * F0541;
  int64_t tmp2 = z1 + z3 * -F1847;
  int64_t tmp3 = z1 + z2 * F0765;
  int64_t tmp0 = lshift(i0 + i4, kConstBits);
  int64_t tmp1 = lshift(i0 - i4, kConstBits);
  o.t10 = tmp0 + tmp3;
  o.t13 = tmp0 - tmp3;
  o.t11 = tmp1 + tmp2;
  o.t12 = tmp1 - tmp2;
  tmp0 = i7;
  tmp1 = i5;
  tmp2 = i3;
  tmp3 = i1;
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int64_t z4 = tmp1 + tmp3;
  int64_t z5 = (z3 + z4) * F1175;
  tmp0 = tmp0 * F0298;
  tmp1 = tmp1 * F2053;
  tmp2 = tmp2 * F3072;
  tmp3 = tmp3 * F1501;
  z1 = z1 * -F0899;
  z2 = z2 * -F2562;
  z3 = z3 * -F1961;
  z4 = z4 * -F0390;
  z3 += z5;
  z4 += z5;
  o.t0 = tmp0 + z1 + z3;
  o.t1 = tmp1 + z2 + z4;
  o.t2 = tmp2 + z2 + z3;
  o.t3 = tmp3 + z1 + z4;
  return o;
}

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                size_t stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {         // pass 1: columns
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      const int dc = static_cast<int>(lshift(ip[0] * qp[0], kPass1Bits));
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    const Parts o = idct_parts(ip[0] * qp[0], ip[8] * qp[8], ip[16] * qp[16],
                               ip[24] * qp[24], ip[32] * qp[32],
                               ip[40] * qp[40], ip[48] * qp[48],
                               ip[56] * qp[56]);
    const int n = kConstBits - kPass1Bits;
    wp[0] = static_cast<int>(descale(o.t10 + o.t3, n));
    wp[56] = static_cast<int>(descale(o.t10 - o.t3, n));
    wp[8] = static_cast<int>(descale(o.t11 + o.t2, n));
    wp[48] = static_cast<int>(descale(o.t11 - o.t2, n));
    wp[16] = static_cast<int>(descale(o.t12 + o.t1, n));
    wp[40] = static_cast<int>(descale(o.t12 - o.t1, n));
    wp[24] = static_cast<int>(descale(o.t13 + o.t0, n));
    wp[32] = static_cast<int>(descale(o.t13 - o.t0, n));
  }
  for (int r = 0; r < 8; ++r) {         // pass 2: rows
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      const uint8_t dc =
          kLimit.t[static_cast<int>(descale(wp[0], kPass1Bits + 3)) & 1023];
      for (int x = 0; x < 8; ++x) op[x] = dc;
      continue;
    }
    const Parts o = idct_parts(wp[0], wp[1], wp[2], wp[3], wp[4], wp[5],
                               wp[6], wp[7]);
    const int n = kConstBits + kPass1Bits + 3;
    auto lim = [&](int64_t v) {
      return kLimit.t[static_cast<int>(descale(v, n)) & 1023];
    };
    op[0] = lim(o.t10 + o.t3);
    op[7] = lim(o.t10 - o.t3);
    op[1] = lim(o.t11 + o.t2);
    op[6] = lim(o.t11 - o.t2);
    op[2] = lim(o.t12 + o.t1);
    op[5] = lim(o.t12 - o.t1);
    op[3] = lim(o.t13 + o.t0);
    op[4] = lim(o.t13 - o.t0);
  }
}

// jdcolor.c: build_ycc_rgb_table (SCALEBITS 16)
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t half = int64_t{1} << 15;
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (int64_t{1} << 16) + 0.5);
    };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYccTab;

inline uint8_t clamp255(int x) {
  return static_cast<uint8_t>(x < 0 ? 0 : x > 255 ? 255 : x);
}

// Output row y of one component, upsampled to at least the image's width
// (jdsample.c as jinit_upsampler picks it with fancy upsampling on, the
// rows above and below the component's first and last from jdmainct.c's
// context: its first and last rows).
void upsample_row(const Comp& c, const uint8_t* plane, size_t stride, int y,
                  int hr, int vr, int width, uint8_t* out) {
  auto row = [&](int i) {
    return plane + static_cast<size_t>(std::min(std::max(i, 0), c.dh - 1)) *
                       stride;
  };
  if (hr == 1 && vr == 1) {                      // fullsize_upsample
    std::copy(row(y), row(y) + width, out);
  } else if (hr == 2 && vr == 1 && c.dw > 2) {   // h2v1_fancy_upsample
    const uint8_t* in = row(y);
    int v = in[0];
    out[0] = static_cast<uint8_t>(v);
    out[1] = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
    for (int i = 1; i < c.dw - 1; ++i) {
      v = in[i] * 3;
      out[2 * i] = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
      out[2 * i + 1] = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
    }
    const int last = c.dw - 1;
    v = in[last];
    out[2 * last] = static_cast<uint8_t>((v * 3 + in[last - 1] + 1) >> 2);
    out[2 * last + 1] = static_cast<uint8_t>(v);
  } else if (hr == 1 && vr == 2) {               // h1v2_fancy_upsample
    const int i = y >> 1, below = y & 1;
    const uint8_t* in0 = row(i);
    const uint8_t* in1 = row(below ? i + 1 : i - 1);
    const int bias = below ? 2 : 1;
    for (int x = 0; x < c.dw; ++x)
      out[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
  } else if (hr == 2 && vr == 2 && c.dw > 2) {   // h2v2_fancy_upsample
    const int i = y >> 1, below = y & 1;
    const uint8_t* in0 = row(i);
    const uint8_t* in1 = row(below ? i + 1 : i - 1);
    int this_sum = in0[0] * 3 + in1[0];
    int next_sum = in0[1] * 3 + in1[1];
    out[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
    out[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
    int last_sum = this_sum;
    this_sum = next_sum;
    for (int x = 1; x < c.dw - 1; ++x) {
      next_sum = in0[x + 1] * 3 + in1[x + 1];
      out[2 * x] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
      out[2 * x + 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
      last_sum = this_sum;
      this_sum = next_sum;
    }
    const int x = c.dw - 1;
    out[2 * x] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * x + 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
  } else {    // h2v1_upsample, h2v2_upsample, int_upsample: replication
    const uint8_t* in = row(y / vr);
    for (int x = 0; x < width; ++x) out[x] = in[x / hr];
  }
}

bool decode(const uint8_t* data, int64_t size, const int32_t* desc,
            const int16_t* qt, const int32_t* huff, float* out,
            int channels) {
  const int width = desc[kWidth], height = desc[kHeight];
  const int ncomp = desc[kNComp], nscans = desc[kNScans];
  const int hmax = desc[kHMax], vmax = desc[kVMax];
  const bool progressive = desc[kProgressive] != 0;
  int ntabs = 0;
  for (int s = 0; s < nscans; ++s)
    for (int w = 11; w < 19; ++w)
      ntabs = std::max(ntabs, desc[kScans + kScanWords * s + w] + 1);
  std::vector<Huff> tabs(ntabs);
  for (int t = 0; t < ntabs; ++t)
    if (!make_huff(huff + t * (16 + 256), &tabs[t])) return false;

  const int mcus_x = (width + hmax * 8 - 1) / (hmax * 8);
  const int mcus_y = (height + vmax * 8 - 1) / (vmax * 8);
  std::vector<Comp> comps(ncomp);
  for (int ci = 0; ci < ncomp; ++ci) {
    Comp& c = comps[ci];
    c.h = desc[kComps + 2 * ci];
    c.v = desc[kComps + 2 * ci + 1];
    c.dw = static_cast<int>((int64_t{width} * c.h + hmax - 1) / hmax);
    c.dh = static_cast<int>((int64_t{height} * c.v + vmax - 1) / vmax);
    c.bw = (c.dw + 7) / 8;
    c.bh = (c.dh + 7) / 8;
    c.pw = mcus_x * c.h;
    c.ph = mcus_y * c.v;
    c.coef.assign(static_cast<size_t>(c.pw) * c.ph * 64, 0);
  }
  for (int s = 0; s < nscans; ++s)
    if (!decode_scan(desc + kScans + kScanWords * s, data, size, tabs, comps,
                     width, height, hmax, vmax, progressive))
      return false;

  // the IDCT of each component's blocks (dummy blocks excluded)
  std::vector<std::vector<uint8_t>> planes(ncomp);
  for (int ci = 0; ci < ncomp; ++ci) {
    Comp& c = comps[ci];
    const size_t stride = static_cast<size_t>(c.bw) * 8;
    planes[ci].resize(stride * c.bh * 8);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(c.block(by, bx), qt + 64 * ci,
                   planes[ci].data() + by * 8 * stride + bx * 8, stride);
    c.coef = std::vector<int16_t>();
  }

  // upsampling, color conversion, float32 output
  std::vector<std::vector<uint8_t>> rows(
      ncomp, std::vector<uint8_t>(static_cast<size_t>(width) + 16));
  const float inv255 = 1.0f / 255.0f;
  const int color = desc[kColor];
  for (int y = 0; y < height; ++y) {
    for (int ci = 0; ci < ncomp; ++ci) {
      const Comp& c = comps[ci];
      upsample_row(c, planes[ci].data(), static_cast<size_t>(c.bw) * 8, y,
                   hmax / c.h, vmax / c.v, width, rows[ci].data());
    }
    float* o = out + static_cast<size_t>(y) * width * channels;
    const uint8_t* r0 = rows[0].data();
    const uint8_t* r1 = rows[ncomp > 1 ? 1 : 0].data();
    const uint8_t* r2 = rows[ncomp > 2 ? 2 : 0].data();
    for (int x = 0; x < width; ++x, o += channels) {
      uint8_t rgb[3];
      if (color == kGray) {                  // gray_rgb_convert
        rgb[0] = rgb[1] = rgb[2] = r0[x];
      } else if (color == kYcc) {            // ycc_rgb_convert
        const int yy = r0[x], cb = r1[x], cr = r2[x];
        rgb[0] = clamp255(yy + kYccTab.cr_r[cr]);
        rgb[1] = clamp255(
            yy + static_cast<int>((kYccTab.cb_g[cb] + kYccTab.cr_g[cr]) >> 16));
        rgb[2] = clamp255(yy + kYccTab.cb_b[cb]);
      } else {                               // rgb_rgb_convert
        rgb[0] = r0[x];
        rgb[1] = r1[x];
        rgb[2] = r2[x];
      }
      o[0] = static_cast<float>(rgb[0]) * inv255;
      o[1] = static_cast<float>(rgb[1]) * inv255;
      o[2] = static_cast<float>(rgb[2]) * inv255;
      if (channels == 4) o[3] = 1.0f;
    }
  }
  return true;
}

}  // namespace jpeg

}  // namespace

extern "C" {

int fsnerf_unfilter(int n, const uint8_t** src, uint8_t** dst, int h,
                    int rowbytes, int bpp, int n_threads) {
  return run_pool(n, n_threads, [&](int i) {
    return unfilter(src[i], dst[i], h, rowbytes, bpp);
  });
}

int fsnerf_jpeg_decode(int n, const uint8_t** data, const int64_t* size,
                       const int32_t** desc, const int16_t** qt,
                       const int32_t** huff, float** out, int channels,
                       int n_threads) {
  return run_pool(n, n_threads, [&](int i) {
    return jpeg::decode(data[i], size[i], desc[i], qt[i], huff[i], out[i],
                        channels);
  });
}

}  // extern "C"
