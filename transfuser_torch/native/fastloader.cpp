// Host-side data-path routines of the port (counterpart of
// transfuser_tpu/native/fastloader.cpp), exposed through a plain C ABI for
// ctypes and built at first use by transfuser_torch/native/__init__.py:
//
//     g++ -O3 -fPIC -shared -std=c++17 -o libfastloader-<hash>.so fastloader.cpp
//
// No library beyond the C++ standard one is linked. The JAX package decodes
// whole PNG files with libpng; here the inflate stays in Python (zlib) and
// png_unfilter undoes the row filters of the inflated bytes.
//
// Each routine computes what the port's numpy version computes, bit for bit:
// the histogram bins by comparisons against the exact bin edges in double
// precision, as numpy's histogram2d does (searchsorted, last edge included;
// the JAX package's C bins in float32 and leaves the last edge out),
// and the depth decode runs numpy's float32 operations in the same order.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int GRID = 256;
constexpr double PPM = 8.0;
constexpr double X_MAX = 16.0;
constexpr double Y_MAX = 32.0;
constexpr double Z_SPLIT = -2.3;
constexpr int HIST_MAX = 5;

// np.histogram2d's bin of v over GRID bins of width 1 / PPM from lo:
// searchsorted(edges, v, 'right') - 1, with v == the last edge in the
// last bin; -1 outside. Every edge lo + k / PPM is exact in double.
inline int bin_of(double v, double lo) {
    const double hi = lo + GRID / PPM;
    if (!(v >= lo && v <= hi)) return -1;  // NaN falls out here too
    if (v == hi) return GRID - 1;
    int b = static_cast<int>((v - lo) * PPM);
    b = std::min(std::max(b, 0), GRID - 1);
    if (v < lo + b / PPM) --b;
    else if (v >= lo + (b + 1) / PPM) ++b;
    return b;
}

template <typename T>
void histogram(const T* points, int64_t n, int64_t row_stride, float* out) {
    // counts[slice][x bin][y bin]; slice 0 above the split, 1 below
    std::vector<uint16_t> counts(2 * GRID * GRID, 0);
    for (int64_t i = 0; i < n; ++i) {
        const T* p = points + i * row_stride;
        const int xb = bin_of(static_cast<double>(p[0]), -X_MAX);
        const int yb = bin_of(static_cast<double>(p[1]), -Y_MAX);
        if (xb < 0 || yb < 0) continue;
        // numpy compares z with the split in the cloud's own precision
        const int slice = p[2] <= static_cast<T>(Z_SPLIT) ? 1 : 0;
        uint16_t& c = counts[(slice * GRID + xb) * GRID + yb];
        if (c < HIST_MAX) ++c;
    }
    // rot90(k=-1) over (X, Y), channels last: out[r][c] = grid[GRID-1-c][r]
    for (int r = 0; r < GRID; ++r) {
        for (int c = 0; c < GRID; ++c) {
            const int src = (GRID - 1 - c) * GRID + r;
            out[(r * GRID + c) * 2 + 0] =
                static_cast<float>(counts[src] / static_cast<double>(HIST_MAX));
            out[(r * GRID + c) * 2 + 1] = static_cast<float>(
                counts[GRID * GRID + src] / static_cast<double>(HIST_MAX));
        }
    }
}

inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

extern "C" {

// LiDAR rows (x, y, z, ...) with `row_stride` values per row -> the
// (256, 256, 2) two-slice histogram, channels [above, below], float32
// (data/lidar_np.py lidar_to_histogram at grid 256; reference
// data.py:446-470): 8 px/m over x in [-16, 16], y in [-32, 0], split at
// z = -2.3, counts clipped at 5 and divided by 5, rot90(k=-1).
void lidar_histogram_f32(const float* points, int64_t n, int64_t row_stride,
                         float* out) {
    histogram(points, n, row_stride, out);
}

void lidar_histogram_f64(const double* points, int64_t n, int64_t row_stride,
                         float* out) {
    histogram(points, n, row_stride, out);
}

// 24-bit RGB depth -> [0, 1], clipped at 50 m (data/decoders.py
// decode_depth; reference data.py:358-372), in numpy's float32 steps.
void decode_depth(const uint8_t* rgb, int64_t n_pixels, float* out) {
    for (int64_t i = 0; i < n_pixels; ++i) {
        float v = static_cast<float>(rgb[i * 3 + 0]) * 65536.0f +
                  static_cast<float>(rgb[i * 3 + 1]) * 256.0f;
        v = v + static_cast<float>(rgb[i * 3 + 2]);
        v = v / 16777215.0f;
        v = std::min(std::max(v, 0.0f), 0.05f);
        out[i] = v * 20.0f;
    }
}

// Semantic ids through a lookup table (data/decoders.py convert_semantics;
// config.py SEMANTIC_CONVERTER). Returns the first position + 1 whose id
// is outside the table, 0 when every id is inside.
int64_t semantic_convert(const uint8_t* in, int64_t n, const uint8_t* lut,
                         int64_t lut_size, uint8_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        if (in[i] >= lut_size) return i + 1;
        out[i] = lut[in[i]];
    }
    return 0;
}

// Bit-packed topdown (H, W, 3) -> road / lane planes (2, H, W) float32:
// channels 10 and 11 of the 15-channel packing are bits 7 and 6 of plane
// 2 (data/decoders.py decode_bev_channels; reference data.py:844-856).
void decode_bev_roadlane(const uint8_t* packed, int64_t h, int64_t w,
                         float* out) {
    const int64_t n = h * w;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t c2 = packed[i * 3 + 2];
        out[i] = static_cast<float>((c2 >> 7) & 1);
        out[n + i] = static_cast<float>((c2 >> 6) & 1);
    }
}

// uint8 HWC image -> float32 crop of (crop_h, crop_w) starting at
// (start_y, start_x) (data/decoders.py crop_image, whose start the caller
// computes and clamps; reference data.py:545-560).
void crop_to_float(const uint8_t* img, int64_t w, int64_t c, int64_t start_y,
                   int64_t start_x, int64_t crop_h, int64_t crop_w,
                   float* out) {
    const int64_t len = crop_w * c;
    for (int64_t y = 0; y < crop_h; ++y) {
        const uint8_t* row = img + ((start_y + y) * w + start_x) * c;
        float* orow = out + y * len;
        for (int64_t i = 0; i < len; ++i) orow[i] = row[i];
    }
}

// Undo the PNG row filters (None, Sub, Up, Average, Paeth) of `h` inflated
// rows of 1 + `stride` bytes (filter type, then the filtered bytes) with
// `bpp` bytes per pixel, into `out` (h x stride). Returns 0, or the first
// row + 1 whose filter type is not one of the five.
int64_t png_unfilter(const uint8_t* raw, int64_t h, int64_t stride,
                     int64_t bpp, uint8_t* out) {
    for (int64_t r = 0; r < h; ++r) {
        const uint8_t kind = raw[r * (stride + 1)];
        const uint8_t* in = raw + r * (stride + 1) + 1;
        uint8_t* cur = out + r * stride;
        const uint8_t* up = r ? out + (r - 1) * stride : nullptr;
        switch (kind) {
            case 0:
                std::memcpy(cur, in, stride);
                break;
            case 1:
                for (int64_t i = 0; i < stride; ++i)
                    cur[i] = in[i] + (i >= bpp ? cur[i - bpp] : 0);
                break;
            case 2:
                for (int64_t i = 0; i < stride; ++i)
                    cur[i] = in[i] + (up ? up[i] : 0);
                break;
            case 3:
                for (int64_t i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? cur[i - bpp] : 0;
                    const int b = up ? up[i] : 0;
                    cur[i] = in[i] + static_cast<uint8_t>((a + b) >> 1);
                }
                break;
            case 4:
                for (int64_t i = 0; i < stride; ++i) {
                    const int a = i >= bpp ? cur[i - bpp] : 0;
                    const int b = up ? up[i] : 0;
                    const int c = (up && i >= bpp) ? up[i - bpp] : 0;
                    cur[i] = in[i] + paeth(a, b, c);
                }
                break;
            default:
                return r + 1;
        }
    }
    return 0;
}

}  // extern "C"
