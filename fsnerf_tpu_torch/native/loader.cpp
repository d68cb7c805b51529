// PNG row unfiltering for the port's image decoder.
//
// The decoder (fsnerf_tpu_torch/native/__init__.py) parses the PNG chunks
// and inflates the image data with Python's zlib; this routine undoes the
// five PNG row filters (none, sub, up, average, Paeth) of every image, one
// image per thread, writing each image's raw rows to a caller-provided
// buffer. It needs no library headers: libpng and libjpeg are not required.
//
// C interface (bound with ctypes):
//   fsnerf_unfilter(n, src, dst, h, rowbytes, bpp, n_threads)
//     src[i]: image i's inflated data, h rows of (1 filter byte + rowbytes);
//     dst[i]: h * rowbytes bytes of unfiltered rows;
//     bpp: bytes per complete pixel (at least 1).
//   Returns 0 on success, else 1 + the index of the first image holding an
//   unknown filter type.
//
// Built at first use by fsnerf_tpu_torch/native/__init__.py:
//   g++ -O2 -fPIC -std=c++17 -Wall -shared -o <lib> loader.cpp -lpthread

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
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

}  // namespace

extern "C" {

int fsnerf_unfilter(int n, const uint8_t** src, uint8_t** dst, int h,
                    int rowbytes, int bpp, int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> fail(0);
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n || fail.load()) return;
      if (!unfilter(src[i], dst[i], h, rowbytes, bpp)) {
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

}  // extern "C"
