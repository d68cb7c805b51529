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
// settings (JCS_RGB output, the islow IDCT, fancy upsampling, block
// smoothing on), and writes float32 pixels. Each step mirrors the library
// source it names: jdhuff.c / jdphuff.c (Huffman decoding, baseline and
// progressive, with restart markers and data cut short), jdarith.c and
// jaricom.c (arithmetic decoding, sequential and progressive: the QM
// decoder, DAC conditioning, restarts), jdmarker.c (resynchronization at
// a restart, and the marker reader after a scan), jdcoefct.c
// (decompress_smooth_data: block smoothing of a progressive file whose
// scans leave AC coefficients 1-9 unrefined), jidctint.c
// (jpeg_idct_islow), jdsample.c with jdmainct.c's context rows
// (upsampling) and jdcolor.c (YCbCr -> RGB). It needs no library headers:
// libpng and libjpeg are not required. Not read (jpeg.py refuses them by
// name, as libjpeg-turbo does): lossless, hierarchical, 12-bit, CMYK /
// YCCK, fractional sampling ratios.
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
//   failed (a Huffman table that does not build, a DC value out of range
//   in a progressive Huffman scan, or a marker libjpeg refuses after a
//   scan's data).
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

// jpeg.py's layout of `desc`, and of each scan within it
constexpr int kWidth = 0, kHeight = 1, kNComp = 2, kColor = 3, kNScans = 4,
              kHMax = 5, kVMax = 6, kProgressive = 7, kComps = 8,
              kSmooth = 16, kLatch = 17, kLatchWords = 20,
              kScans = kLatch + 4 * kLatchWords;
constexpr int kScanN = 0, kScanComps = 1, kScanSs = 5, kScanSe = 6,
              kScanAh = 7, kScanAl = 8, kScanRestart = 9, kScanStart = 10,
              kScanDc = 11, kScanAc = 15, kScanArith = 19, kScanLow = 20,
              kScanCond = 21,
              kCondWords = 5, kScanWords = kScanCond + 4 * kCondWords;
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

  // After a scan: whether libjpeg's marker reader, going on from the
  // marker the data ran into or from the next byte (jdmarker.c
  // read_markers), meets a marker it refuses (0x02-0xBF) before the one
  // that ends the scan's data (any from 0xC0 on but RSTn; RSTn and TEM
  // it passes over).
  bool refused_marker_next() {
    for (;;) {
      if (marker == 0) next_marker();
      const int m = marker;
      marker = 0;
      if (m >= 0x02 && m < 0xC0) return true;
      if (m >= 0xC0 && (m < 0xD0 || m > 0xD7)) return false;
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

// A scan's MCUs in order (jdcoefct.c's MCU_buffer): one block each in a
// non-interleaved scan, else each component's h x v blocks.
struct McuWalk {
  struct Member { int k, yi, xi; };   // scan component, row, column
  int n, mcus_x, mcus_y;
  std::vector<Member> members;
  std::vector<int16_t*> blocks;       // the current MCU's blocks

  McuWalk(const int32_t* sc, const std::vector<Comp>& comps, int width,
          int height, int hmax, int vmax)
      : n(sc[kScanN]) {
    if (n == 1) {
      mcus_x = comps[sc[kScanComps]].bw;
      mcus_y = comps[sc[kScanComps]].bh;
      members.push_back({0, 0, 0});
    } else {
      mcus_x = (width + hmax * 8 - 1) / (hmax * 8);
      mcus_y = (height + vmax * 8 - 1) / (vmax * 8);
      for (int k = 0; k < n; ++k) {
        const Comp& c = comps[sc[kScanComps + k]];
        for (int yi = 0; yi < c.v; ++yi)
          for (int xi = 0; xi < c.h; ++xi) members.push_back({k, yi, xi});
      }
    }
    blocks.resize(members.size());
  }

  void at(const int32_t* sc, std::vector<Comp>& comps, int my, int mx) {
    for (size_t b = 0; b < members.size(); ++b) {
      const Member& m = members[b];
      Comp& c = comps[sc[kScanComps + m.k]];
      blocks[b] = n == 1 ? c.block(my, mx)
                         : c.block(my * c.v + m.yi, mx * c.h + m.xi);
    }
  }
};

// Decodes one Huffman-coded scan (jdhuff.c decode_mcu for a sequential
// scan, jdphuff.c's four decode_mcu_* for a progressive one) into the
// components' coefficients. False on a DC value out of range
// (JERR_BAD_DCT_COEF).
//
// *last_good is jdcoefct.c's master->last_good_iMCU_row: before each MCU,
// while the data has not run out, the iMCU row the MCU is in.
bool decode_scan(const int32_t* sc, const uint8_t* data, int64_t size,
                 const std::vector<Huff>& tabs, std::vector<Comp>& comps,
                 int width, int height, int hmax, int vmax, bool progressive,
                 int* last_good) {
  const int n = sc[kScanN];
  const int ss = sc[kScanSs], se = sc[kScanSe], ah = sc[kScanAh],
            al = sc[kScanAl], interval = sc[kScanRestart];
  Reader r;
  r.p = data + sc[kScanStart];
  r.end = data + size;
  const Huff* dc[4] = {nullptr, nullptr, nullptr, nullptr};
  const Huff* ac[4] = {nullptr, nullptr, nullptr, nullptr};
  for (int k = 0; k < n; ++k) {
    if (sc[kScanDc + k] >= 0) dc[k] = &tabs[sc[kScanDc + k]];
    if (sc[kScanAc + k] >= 0) ac[k] = &tabs[sc[kScanAc + k]];
  }
  McuWalk walk(sc, comps, width, height, hmax, vmax);
  const auto& members = walk.members;
  const auto& blocks = walk.blocks;
  const int p1 = 1 << al;
  const int m1 = -p1;
  int last_dc[4] = {0, 0, 0, 0};
  unsigned eobrun = 0;
  int restarts_to_go = interval, next_restart = 0;
  const int rows_per_imcu = n == 1 ? comps[sc[kScanComps]].v : 1;
  for (int my = 0; my < walk.mcus_y; ++my) {
    for (int mx = 0; mx < walk.mcus_x; ++mx) {
      if (!r.insufficient) *last_good = my / rows_per_imcu;
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
      walk.at(sc, comps, my, mx);
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
  return !(sc[kScanLow] && r.refused_marker_next());
}

// jaricom.c: jpeg_aritab, T.81's Table D.2 as libjpeg packs it: Qe_Value
// << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; entry
// 113 is the fixed probability 0.5 of T.851 (the sign and refinement
// bits' bin)
#define QE(qe, lps, mps, sw) \
  ((int64_t{qe} << 16) | (int64_t{mps} << 8) | (int64_t{sw} << 7) | (lps))
constexpr int64_t kAritab[114] = {
    QE(0x5a1d, 1, 1, 1),     QE(0x2586, 14, 2, 0),    QE(0x1114, 16, 3, 0),
    QE(0x080b, 18, 4, 0),    QE(0x03d8, 20, 5, 0),    QE(0x01da, 23, 6, 0),
    QE(0x00e5, 25, 7, 0),    QE(0x006f, 28, 8, 0),    QE(0x0036, 30, 9, 0),
    QE(0x001a, 33, 10, 0),   QE(0x000d, 35, 11, 0),   QE(0x0006, 9, 12, 0),
    QE(0x0003, 10, 13, 0),   QE(0x0001, 12, 13, 0),   QE(0x5a7f, 15, 15, 1),
    QE(0x3f25, 36, 16, 0),   QE(0x2cf2, 38, 17, 0),   QE(0x207c, 39, 18, 0),
    QE(0x17b9, 40, 19, 0),   QE(0x1182, 42, 20, 0),   QE(0x0cef, 43, 21, 0),
    QE(0x09a1, 45, 22, 0),   QE(0x072f, 46, 23, 0),   QE(0x055c, 48, 24, 0),
    QE(0x0406, 49, 25, 0),   QE(0x0303, 51, 26, 0),   QE(0x0240, 52, 27, 0),
    QE(0x01b1, 54, 28, 0),   QE(0x0144, 56, 29, 0),   QE(0x00f5, 57, 30, 0),
    QE(0x00b7, 59, 31, 0),   QE(0x008a, 60, 32, 0),   QE(0x0068, 62, 33, 0),
    QE(0x004e, 63, 34, 0),   QE(0x003b, 32, 35, 0),   QE(0x002c, 33, 9, 0),
    QE(0x5ae1, 37, 37, 1),   QE(0x484c, 64, 38, 0),   QE(0x3a0d, 65, 39, 0),
    QE(0x2ef1, 67, 40, 0),   QE(0x261f, 68, 41, 0),   QE(0x1f33, 69, 42, 0),
    QE(0x19a8, 70, 43, 0),   QE(0x1518, 72, 44, 0),   QE(0x1177, 73, 45, 0),
    QE(0x0e74, 74, 46, 0),   QE(0x0bfb, 75, 47, 0),   QE(0x09f8, 77, 48, 0),
    QE(0x0861, 78, 49, 0),   QE(0x0706, 79, 50, 0),   QE(0x05cd, 48, 51, 0),
    QE(0x04de, 50, 52, 0),   QE(0x040f, 50, 53, 0),   QE(0x0363, 51, 54, 0),
    QE(0x02d4, 52, 55, 0),   QE(0x025c, 53, 56, 0),   QE(0x01f8, 54, 57, 0),
    QE(0x01a4, 55, 58, 0),   QE(0x0160, 56, 59, 0),   QE(0x0125, 57, 60, 0),
    QE(0x00f6, 58, 61, 0),   QE(0x00cb, 59, 62, 0),   QE(0x00ab, 61, 63, 0),
    QE(0x008f, 61, 32, 0),   QE(0x5b12, 65, 65, 1),   QE(0x4d04, 80, 66, 0),
    QE(0x412c, 81, 67, 0),   QE(0x37d8, 82, 68, 0),   QE(0x2fe8, 83, 69, 0),
    QE(0x293c, 84, 70, 0),   QE(0x2379, 86, 71, 0),   QE(0x1edf, 87, 72, 0),
    QE(0x1aa9, 87, 73, 0),   QE(0x174e, 72, 74, 0),   QE(0x1424, 72, 75, 0),
    QE(0x119c, 74, 76, 0),   QE(0x0f6b, 74, 77, 0),   QE(0x0d51, 75, 78, 0),
    QE(0x0bb6, 77, 79, 0),   QE(0x0a40, 77, 48, 0),   QE(0x5832, 80, 81, 1),
    QE(0x4d1c, 88, 82, 0),   QE(0x438e, 89, 83, 0),   QE(0x3bdd, 90, 84, 0),
    QE(0x34ee, 91, 85, 0),   QE(0x2eae, 92, 86, 0),   QE(0x299a, 93, 87, 0),
    QE(0x2516, 86, 71, 0),   QE(0x5570, 88, 89, 1),   QE(0x4ca9, 95, 90, 0),
    QE(0x44d9, 96, 91, 0),   QE(0x3e22, 97, 92, 0),   QE(0x3824, 99, 93, 0),
    QE(0x32b4, 99, 94, 0),   QE(0x2e17, 93, 86, 0),   QE(0x56a8, 95, 96, 1),
    QE(0x4f46, 101, 97, 0),  QE(0x47e5, 102, 98, 0),  QE(0x41cf, 103, 99, 0),
    QE(0x3c3d, 104, 100, 0), QE(0x375e, 99, 93, 0),   QE(0x5231, 105, 102, 0),
    QE(0x4c0f, 106, 103, 0), QE(0x4639, 107, 104, 0), QE(0x415e, 103, 99, 0),
    QE(0x5627, 105, 106, 1), QE(0x50e7, 108, 107, 0), QE(0x4b85, 109, 103, 0),
    QE(0x5597, 110, 109, 0), QE(0x504f, 111, 107, 0), QE(0x5a10, 110, 111, 1),
    QE(0x5522, 112, 109, 0), QE(0x59eb, 112, 111, 1), QE(0x5a1d, 113, 113, 0)};
#undef QE

// jdarith.c's decoder state: the QM decoder (arith_decode with its
// renormalization and byte input) over a Reader's bytes and marker
// handling. ct -1 is the error state of corrupt data: the rest of the
// restart interval decodes nothing.
struct Arith {
  Reader r;
  int64_t c = 0;    // base of the coding interval + input bit buffer
  int64_t a = 0;    // normalized size of the coding interval
  int ct = -16;     // bits left in C's buffer part; -16: 2 bytes to read

  void reset() {
    c = 0;
    a = 0;
    ct = -16;
  }

  // The next data byte: after a marker, zeros (a marker inside the data
  // is legal in arithmetic coding).
  int byte() {
    if (r.marker) return 0;
    if (r.p >= r.end) {
      r.marker = 0xD9;
      return 0;
    }
    int data = *r.p++;
    if (data == 0xFF) {
      do data = r.next_byte(); while (data == 0xFF);
      if (data == 0) return 0xFF;     // a stuffed zero byte
      r.marker = data;
      return 0;
    }
    return data;
  }

  // One binary decision with the statistics bin *st (T.81 D.2.4-D.2.6).
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;  // 2 initial bytes
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);   // LPS index + switch
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);   // MPS index
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {              // conditional LPS exchange
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {     // conditional MPS exchange
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

constexpr int kDcStatBins = 64, kAcStatBins = 256, kArithTables = 16;

// Figure F.20 (jdarith.c: decode_mcu's AC part and decode_mcu_AC_first):
// the AC coefficients k0..k1 of one block, each stored shifted left by
// al; false on corrupt data (the error state is set).
bool decode_ac(Arith& e, uint8_t* ac, uint8_t* fixed_bin, int kx, int k0,
               int k1, int al, int16_t* blk) {
  for (int k = k0; k <= k1; ++k) {
    uint8_t* st = ac + 3 * (k - 1);
    if (e.decode(st)) break;                  // EOB
    while (e.decode(st + 1) == 0) {
      st += 3;
      if (++k > k1) {                         // spectral overflow
        e.ct = -1;
        return false;
      }
    }
    const int sign = e.decode(fixed_bin);     // F.22
    st += 2;
    int m = e.decode(st);                     // F.23: magnitude category
    if (m != 0 && e.decode(st)) {
      m <<= 1;
      st = ac + (k <= kx ? 189 : 217);
      while (e.decode(st)) {
        if ((m <<= 1) == 0x8000) {            // magnitude overflow
          e.ct = -1;
          return false;
        }
        ++st;
      }
    }
    int v = m;                                // F.24: magnitude bits
    st += 14;
    while (m >>= 1)
      if (e.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
  }
  return true;
}

// Decodes one arithmetic-coded scan (jdarith.c: decode_mcu for a
// sequential scan, decode_mcu_DC_first / DC_refine / AC_first / AC_refine
// for a progressive one) into the components' coefficients. Corrupt data
// does not fail (libjpeg warns and leaves the rest of the restart interval
// empty); false on a marker libjpeg refuses after the scan.
bool decode_scan_arith(const int32_t* sc, const uint8_t* data, int64_t size,
                       std::vector<Comp>& comps, int width, int height,
                       int hmax, int vmax, bool progressive) {
  const int n = sc[kScanN];
  const int ss = sc[kScanSs], se = progressive ? sc[kScanSe] : 63,
            ah = sc[kScanAh], al = sc[kScanAl], interval = sc[kScanRestart];
  Arith e;
  e.r.p = data + sc[kScanStart];
  e.r.end = data + size;
  int dct[4], act[4], dc_l[4], dc_u[4], ac_k[4];
  for (int k = 0; k < n; ++k) {
    const int32_t* cond = sc + kScanCond + kCondWords * k;
    dct[k] = cond[0];
    act[k] = cond[1];
    dc_l[k] = cond[2];
    dc_u[k] = cond[3];
    ac_k[k] = cond[4];
  }
  uint8_t dc_stats[kArithTables][kDcStatBins];
  uint8_t ac_stats[kArithTables][kAcStatBins];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};
  int last_dc[4] = {0, 0, 0, 0}, dc_context[4] = {0, 0, 0, 0};
  const bool dc_first = !progressive || (ss == 0 && ah == 0);
  const bool has_ac = !progressive || ss > 0;
  // start_pass and process_restart: the statistics of the scan's tables
  // and the DC predictions start again
  auto reset = [&]() {
    for (int k = 0; k < n; ++k) {
      if (dc_first) {
        std::fill(dc_stats[dct[k]], dc_stats[dct[k]] + kDcStatBins, 0);
        last_dc[k] = 0;
        dc_context[k] = 0;
      }
      if (has_ac)
        std::fill(ac_stats[act[k]], ac_stats[act[k]] + kAcStatBins, 0);
    }
    e.reset();
  };
  reset();
  McuWalk walk(sc, comps, width, height, hmax, vmax);
  const int p1 = 1 << al;
  const int m1 = -p1;
  int restarts_to_go = interval, next_restart = 0;
  for (int my = 0; my < walk.mcus_y; ++my) {
    for (int mx = 0; mx < walk.mcus_x; ++mx) {
      if (interval) {
        if (restarts_to_go == 0) {   // process_restart
          e.r.restart(next_restart);
          next_restart = (next_restart + 1) & 7;
          reset();
          restarts_to_go = interval;
        }
        --restarts_to_go;
      }
      walk.at(sc, comps, my, mx);
      if (progressive && ss == 0 && ah != 0) {     // decode_mcu_DC_refine
        for (int16_t* blk : walk.blocks)
          if (e.decode(fixed_bin)) blk[0] = static_cast<int16_t>(blk[0] | p1);
        continue;
      }
      if (e.ct == -1) continue;
      if (dc_first) {               // decode_mcu and decode_mcu_DC_first
        for (size_t b = 0; b < walk.members.size(); ++b) {
          const int k = walk.members[b].k;
          int16_t* blk = walk.blocks[b];
          uint8_t* st = dc_stats[dct[k]] + dc_context[k];
          if (e.decode(st) == 0) {
            dc_context[k] = 0;
          } else {
            const int sign = e.decode(st + 1);
            st += 2 + sign;
            int m = e.decode(st);
            if (m != 0) {
              st = dc_stats[dct[k]] + 20;
              while (e.decode(st)) {
                if ((m <<= 1) == 0x8000) {
                  e.ct = -1;
                  break;
                }
                ++st;
              }
              if (e.ct == -1) break;
            }
            if (m < ((1 << dc_l[k]) >> 1))
              dc_context[k] = 0;
            else if (m > ((1 << dc_u[k]) >> 1))
              dc_context[k] = 12 + sign * 4;
            else
              dc_context[k] = 4 + sign * 4;
            int v = m;
            st += 14;
            while (m >>= 1)
              if (e.decode(st)) v |= m;
            v += 1;
            if (sign) v = -v;
            last_dc[k] = (last_dc[k] + v) & 0xFFFF;
          }
          if (progressive) {
            blk[0] = static_cast<int16_t>(static_cast<unsigned>(last_dc[k])
                                          << al);
            continue;
          }
          blk[0] = static_cast<int16_t>(last_dc[k]);
          if (!decode_ac(e, ac_stats[act[k]], fixed_bin, ac_k[k], 1, 63, 0,
                         blk))
            break;
        }
      } else if (ah == 0) {                       // decode_mcu_AC_first
        decode_ac(e, ac_stats[act[0]], fixed_bin, ac_k[0], ss, se, al,
                  walk.blocks[0]);
      } else {                                    // decode_mcu_AC_refine
        int16_t* blk = walk.blocks[0];
        uint8_t* ac = ac_stats[act[0]];
        int kex = se;
        for (; kex > 0; --kex)
          if (blk[kNatural[kex]]) break;
        for (int k = ss; k <= se; ++k) {
          uint8_t* st = ac + 3 * (k - 1);
          if (k > kex && e.decode(st)) break;     // EOB
          bool overflow = false;
          for (;;) {
            int16_t* coef = blk + kNatural[k];
            if (*coef) {                          // previously nonzero
              if (e.decode(st + 2))
                *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
              break;
            }
            if (e.decode(st + 1)) {               // newly nonzero
              *coef = static_cast<int16_t>(e.decode(fixed_bin) ? m1 : p1);
              break;
            }
            st += 3;
            if (++k > se) {
              e.ct = -1;                          // spectral overflow
              overflow = true;
              break;
            }
          }
          if (overflow) break;
        }
      }
    }
  }
  return !(sc[kScanLow] && e.r.refused_marker_next());
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

// jdcoefct.c: decompress_smooth_data, libjpeg's block smoothing of a
// progressive file whose scans leave some of the first nine AC
// coefficients (zigzag 1-9) not fully refined. Each block's coefficients
// that are still zero and not known exactly are estimated from the DC
// values of its 5 x 5 neighbourhood of blocks; when no AC coefficient
// of the component was coded at all, its DC is smoothed too. The
// estimates go to a copy of the block, which the islow IDCT takes.
//
// latch: coef_bits_latch[10], then prev_coef_bits_latch[10] (smoothing_ok
// at the output pass: the coef_bits after the last scan, and before the
// component's last scan); rows of iMCU rows after last_good take the
// second (that scan ran out of data there). imcu_rows: total_iMCU_rows.
void smooth_idct(Comp& c, const int32_t* latch, const int16_t* qt,
                 int imcu_rows, int last_good, uint8_t* plane,
                 size_t stride) {
  constexpr int kQPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  int64_t q[10];
  for (int i = 0; i < 10; ++i) q[i] = static_cast<uint16_t>(qt[kQPos[i]]);
  const int last_col = c.bw - 1;
  int16_t ws[64];
  for (int by = 0; by < c.bh; ++by) {
    const int imcu = by / c.v, br = by % c.v;
    const int32_t* bits = latch + (imcu > last_good ? 10 : 0);
    bool change_dc = true;
    for (int i = 1; i < 10; ++i) change_dc = change_dc && bits[i] == -1;
    // the neighbouring block rows as libjpeg picks them: two rows up
    // only from the third iMCU row or the block's third row on, two rows
    // down only in a block's iMCU row or the one after (which may be a
    // row of dummy blocks); else the nearer one, or the block's own row
    const int last = imcu_rows - 1;
    int block_rows = c.v;     // the iMCU row's real block rows
    if (imcu == last && c.bh % c.v) block_rows = c.bh % c.v;
    const int prev = br > 0 || imcu > 0 ? by - 1 : by;
    const int prev_prev = br > 1 || imcu > 1 ? by - 2 : prev;
    const int next = br < block_rows - 1 || imcu < last ? by + 1 : by;
    const int next_next =
        br < block_rows - 2 || imcu + 1 < last ? by + 2 : next;
    const int rows[5] = {prev_prev, prev, by, next, next_next};
    // DC[r][k]: DC01 .. DC25 of jdcoefct.c, a sliding window of columns
    int dc[5][5];
    for (int r = 0; r < 5; ++r)
      for (int k = 0; k < 5; ++k) dc[r][k] = c.block(rows[r], 0)[0];
    for (int bx = 0; bx < c.bw; ++bx) {
      std::copy(c.block(by, bx), c.block(by, bx) + 64, ws);
      if (bx == 0 && bx < last_col)
        for (int r = 0; r < 5; ++r) dc[r][3] = c.block(rows[r], 1)[0];
      if (bx + 1 < last_col)
        for (int r = 0; r < 5; ++r) dc[r][4] = c.block(rows[r], bx + 2)[0];
      auto D = [&](int k) -> int64_t { return dc[(k - 1) / 5][(k - 1) % 5]; };
      // an estimate of coefficient `pos` (zigzag `z`) from num, clamped
      // below the coefficient's next coded bit
      auto predict = [&](int z, int pos, int64_t num) {
        const int al = bits[z];
        if (al == 0 || ws[pos] != 0) return;
        const int64_t qk = q[z];
        int pred = static_cast<int>(((qk << 7) + (num >= 0 ? num : -num)) /
                                    (qk << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        ws[pos] = static_cast<int16_t>(num >= 0 ? pred : -pred);
      };
      const int64_t q00 = q[0];
      if (change_dc) {
        predict(1, 1, q00 * (-D(1) - D(2) + D(4) + D(5) - 3 * D(6) +
                             13 * D(7) - 13 * D(9) + 3 * D(10) - 3 * D(11) +
                             38 * D(12) - 38 * D(14) + 3 * D(15) -
                             3 * D(16) + 13 * D(17) - 13 * D(19) +
                             3 * D(20) - D(21) - D(22) + D(24) + D(25)));
        predict(2, 8, q00 * (-D(1) - 3 * D(2) - 3 * D(3) - 3 * D(4) - D(5) -
                             D(6) + 13 * D(7) + 38 * D(8) + 13 * D(9) -
                             D(10) + D(16) - 13 * D(17) - 38 * D(18) -
                             13 * D(19) + D(20) + D(21) + 3 * D(22) +
                             3 * D(23) + 3 * D(24) + D(25)));
        predict(3, 16, q00 * (D(3) + 2 * D(7) + 7 * D(8) + 2 * D(9) -
                              5 * D(12) - 14 * D(13) - 5 * D(14) +
                              2 * D(17) + 7 * D(18) + 2 * D(19) + D(23)));
        predict(4, 9, q00 * (-D(1) + D(5) + 9 * D(7) - 9 * D(9) - 9 * D(17) +
                             9 * D(19) + D(21) - D(25)));
        predict(5, 2, q00 * (2 * D(7) - 5 * D(8) + 2 * D(9) + D(11) +
                             7 * D(12) - 14 * D(13) + 7 * D(14) + D(15) +
                             2 * D(17) - 5 * D(18) + 2 * D(19)));
        predict(6, 3, q00 * (D(7) - D(9) + 2 * D(12) - 2 * D(14) + D(17) -
                             D(19)));
        predict(7, 10, q00 * (D(7) - 3 * D(8) + D(9) - D(17) + 3 * D(18) -
                              D(19)));
        predict(8, 17, q00 * (D(7) - D(9) - 3 * D(12) + 3 * D(14) + D(17) -
                              D(19)));
        predict(9, 24, q00 * (D(7) + 2 * D(8) + D(9) - D(17) - 2 * D(18) -
                              D(19)));
        // the DC itself (coef_bits[0] >= 0, or smoothing were off)
        const int64_t num =
            q00 * (-2 * D(1) - 6 * D(2) - 8 * D(3) - 6 * D(4) - 2 * D(5) -
                   6 * D(6) + 6 * D(7) + 42 * D(8) + 6 * D(9) - 6 * D(10) -
                   8 * D(11) + 42 * D(12) + 152 * D(13) + 42 * D(14) -
                   8 * D(15) - 6 * D(16) + 6 * D(17) + 42 * D(18) +
                   6 * D(19) - 6 * D(20) - 2 * D(21) - 6 * D(22) -
                   8 * D(23) - 6 * D(24) - 2 * D(25));
        const int pred = static_cast<int>(
            ((q00 << 7) + (num >= 0 ? num : -num)) / (q00 << 8));
        ws[0] = static_cast<int16_t>(num >= 0 ? pred : -pred);
      } else {
        predict(1, 1, q00 * (-7 * D(11) + 50 * D(12) - 50 * D(14) +
                             7 * D(15)));
        predict(2, 8, q00 * (-7 * D(3) + 50 * D(8) - 50 * D(18) +
                             7 * D(23)));
        predict(3, 16, q00 * (-D(3) + 13 * D(8) - 24 * D(13) + 13 * D(18) -
                              D(23)));
        predict(4, 9, q00 * (D(10) + D(16) - 10 * D(17) + 10 * D(19) -
                             D(2) - D(20) + D(22) - D(24) + D(4) - D(6) +
                             10 * D(7) - 10 * D(9)));
        predict(5, 2, q00 * (-D(11) + 13 * D(12) - 24 * D(13) + 13 * D(14) -
                             D(15)));
      }
      idct_islow(ws, qt, plane + by * 8 * stride + bx * 8, stride);
      for (int r = 0; r < 5; ++r)
        for (int k = 0; k < 4; ++k) dc[r][k] = dc[r][k + 1];
    }
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
    for (int w = kScanDc; w < kScanAc + 4; ++w)
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
  int last_good = 0;
  for (int s = 0; s < nscans; ++s) {
    const int32_t* sc = desc + kScans + kScanWords * s;
    if (sc[kScanArith]) {   // jdarith.c never runs out of data
      if (!decode_scan_arith(sc, data, size, comps, width, height, hmax, vmax,
                             progressive))
        return false;
      last_good = mcus_y - 1;
    } else if (!decode_scan(sc, data, size, tabs, comps, width, height, hmax,
                            vmax, progressive, &last_good)) {
      return false;
    }
  }

  // the IDCT of each component's blocks (dummy blocks excluded)
  std::vector<std::vector<uint8_t>> planes(ncomp);
  for (int ci = 0; ci < ncomp; ++ci) {
    Comp& c = comps[ci];
    const size_t stride = static_cast<size_t>(c.bw) * 8;
    planes[ci].resize(stride * c.bh * 8);
    if (desc[kSmooth])
      smooth_idct(c, desc + kLatch + kLatchWords * ci, qt + 64 * ci, mcus_y,
                  last_good, planes[ci].data(), stride);
    else
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
