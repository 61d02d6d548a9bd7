// Host image work of the input pipeline: PNG row unfiltering and OpenCV's
// 8-bit INTER_LINEAR resize, in C++ with a plain C interface.
//
// Counterpart of what cv2 does for the JAX package's loader
// (monopsr_tpu/train/input_pipeline.py, cv2.imread, and cv2.resize in
// monopsr_tpu/train/trainer.py's prepare_sample): compiled loops that run
// while Python's interpreter lock is released. monopsr_torch/utils/
// image_io.py loads this library with ctypes.CDLL, which releases the lock
// for the length of each call, so the loader's threads decode and resize
// side by side with each other and with the train step's launches.
//
// Inflating stays in Python's zlib.decompress (which releases the lock as
// well); the resize's taps (source indices and 11-bit weights) are
// computed by image_io._resize_taps in numpy. Both functions here do
// integer arithmetic only and give the bytes of the plain numpy versions
// in image_io.py (_unfilter_plain, resize_bilinear_uint8_plain) exactly.
//
// Built by g++ -O3 -std=c++17 -shared -fPIC (no fast math) at first use
// (monopsr_torch/ops/cuda_build.py, HOST_SOURCES).

#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

inline int paeth(int a, int b, int c) {
  const int pa = std::abs(b - c);      // |p - a| with p = a + b - c
  const int pb = std::abs(a - c);      // |p - b|
  const int pc = std::abs(a + b - 2 * c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

// Undoes the PNG row filters. `filtered` holds h rows of 1 + row_bytes
// bytes (the filter type, then the filtered bytes), as zlib inflates a
// non-interlaced image; `out` gets h rows of row_bytes bytes. bpp is the
// bytes per pixel (rounded up to 1). Bytes left of column 0 and above row 0
// count as zero, as the PNG specification defines the filters:
//   0 None: x;  1 Sub: x + a;  2 Up: x + b;  3 Average: x + (a + b) / 2;
//   4 Paeth: x + paeth(a, b, c);  all mod 256, with a the byte bpp to the
// left, b the byte above, c the byte above and bpp to the left. Returns 0,
// or 1 + the first row whose filter type is not one of these.
extern "C" int png_unfilter(const uint8_t* filtered, uint8_t* out,
                            int64_t h, int64_t row_bytes, int64_t bpp) {
  for (int64_t r = 0; r < h; ++r) {
    const uint8_t* src = filtered + r * (row_bytes + 1);
    const uint8_t kind = *src++;
    uint8_t* row = out + r * row_bytes;
    const uint8_t* up = r ? row - row_bytes : nullptr;
    const int64_t lead = bpp < row_bytes ? bpp : row_bytes;
    switch (kind) {
      case 0:
        for (int64_t i = 0; i < row_bytes; ++i) row[i] = src[i];
        break;
      case 1:
        for (int64_t i = 0; i < lead; ++i) row[i] = src[i];
        for (int64_t i = bpp; i < row_bytes; ++i)
          row[i] = static_cast<uint8_t>(src[i] + row[i - bpp]);
        break;
      case 2:
        if (!up) {
          for (int64_t i = 0; i < row_bytes; ++i) row[i] = src[i];
        } else {
          for (int64_t i = 0; i < row_bytes; ++i)
            row[i] = static_cast<uint8_t>(src[i] + up[i]);
        }
        break;
      case 3:
        for (int64_t i = 0; i < lead; ++i)
          row[i] = static_cast<uint8_t>(src[i] + ((up ? up[i] : 0) >> 1));
        for (int64_t i = bpp; i < row_bytes; ++i)
          row[i] = static_cast<uint8_t>(
              src[i] + ((row[i - bpp] + (up ? up[i] : 0)) >> 1));
        break;
      case 4:
        // Paeth with a = c = 0 picks b; with b = c = 0 (first row) it
        // picks a
        for (int64_t i = 0; i < lead; ++i)
          row[i] = static_cast<uint8_t>(src[i] + (up ? up[i] : 0));
        if (!up) {
          for (int64_t i = bpp; i < row_bytes; ++i)
            row[i] = static_cast<uint8_t>(src[i] + row[i - bpp]);
        } else {
          for (int64_t i = bpp; i < row_bytes; ++i)
            row[i] = static_cast<uint8_t>(
                src[i] + paeth(row[i - bpp], up[i], up[i - bpp]));
        }
        break;
      default:
        return static_cast<int>(r + 1);
    }
  }
  return 0;
}

// OpenCV's fixed-point INTER_LINEAR of an (sh, sw, c) uint8 image to
// (dh, dw, c), from the taps of image_io._resize_taps: per output column
// the source columns x0, x1 and their 11-bit weights ax0, ax1, per output
// row the source rows y0, y1 and their weights by0, by1 (indices already
// clamped into the image). Two integer passes, as OpenCV's
// HResizeLinear and VResizeLinear<uchar, int, short, FixedPtCast<...>>:
//   horizontal  R[x] = S[x0] * ax0 + S[x1] * ax1
//   vertical    ((by0 * (R0 >> 4)) >> 16) + ((by1 * (R1 >> 4)) >> 16),
//               then (+ 2) >> 2, clamped to 0..255.
// Each source row's horizontal pass is computed once while the output rows
// that read it are written (two row buffers). Allocates only those.
extern "C" void resize_linear_u8(const uint8_t* src, int64_t sh, int64_t sw,
                                 int64_t c, uint8_t* dst, int64_t dh,
                                 int64_t dw, const int64_t* x0,
                                 const int64_t* x1, const int32_t* ax0,
                                 const int32_t* ax1, const int64_t* y0,
                                 const int64_t* y1, const int32_t* by0,
                                 const int32_t* by1) {
  (void)sh;
  const int64_t width = dw * c;
  std::vector<int32_t> buffers[2] = {std::vector<int32_t>(width),
                                     std::vector<int32_t>(width)};
  int64_t held[2] = {-1, -1};        // source row in each buffer

  auto horizontal = [&](int64_t y, int32_t* rowbuf) {
    const uint8_t* s = src + y * sw * c;
    for (int64_t x = 0; x < dw; ++x) {
      const uint8_t* p0 = s + x0[x] * c;
      const uint8_t* p1 = s + x1[x] * c;
      const int32_t a0 = ax0[x], a1 = ax1[x];
      for (int64_t k = 0; k < c; ++k)
        rowbuf[x * c + k] = p0[k] * a0 + p1[k] * a1;
    }
  };
  // The buffer holding source row y, filled if neither does; `keep` is a
  // buffer index that must not be overwritten (-1: none)
  auto fetch = [&](int64_t y, int keep) -> int {
    for (int i = 0; i < 2; ++i)
      if (held[i] == y) return i;
    const int slot = keep == 0 ? 1 : (keep == 1 ? 0 : (held[0] == -1 ? 0 : 1));
    horizontal(y, buffers[slot].data());
    held[slot] = y;
    return slot;
  };

  for (int64_t y = 0; y < dh; ++y) {
    // fetch y0 first without evicting a buffer that already holds y1
    int keep = -1;
    for (int i = 0; i < 2; ++i)
      if (held[i] == y1[y]) keep = i;
    const int i0 = fetch(y0[y], keep);
    const int i1 = fetch(y1[y], i0);
    const int32_t* r0 = buffers[i0].data();
    const int32_t* r1 = buffers[i1].data();
    const int32_t b0 = by0[y], b1 = by1[y];
    uint8_t* d = dst + y * width;
    for (int64_t i = 0; i < width; ++i) {
      int32_t v = (((b0 * (r0[i] >> 4)) >> 16) +
                   ((b1 * (r1[i] >> 4)) >> 16) + 2) >> 2;
      d[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}
